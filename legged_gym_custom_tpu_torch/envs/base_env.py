"""Vectorized legged-robot environment, torch port of
legged_gym_custom_tpu/envs/base_env.py.

The env is an `EnvState` of batch-leading (B, ...) tensors plus a `step`
that returns a new state; resets are lane-masked `torch.where` rebuilds with
no host sync.  Randomness comes from the `torch.Generator` carried in the
state (the JAX env carries a PRNG key the same way).

Step pipeline order matches the reference (go2.py:345-387,
legged_robot.py:67-100): clip actions -> decimated physics -> derived
quantities -> feet/phase update -> callback (command resample / heading /
pushes) -> termination -> rewards -> masked reset -> observations.

Ported: the flat plane, and heightfield terrain (mesh_type 'heightfield'
or 'trimesh') with custom origins, the terrain and command curricula,
scandot heights (and the upstream layout's height samples in the proprio
stream when `terrain.measure_heights` is set), the parkour hole termination,
the parkour stages' course-progress tracking (`max_x`, the progress-stall
termination and the spawn curriculum), and stateful actuator models: a task
whose `_build_torque_fn` returns a torque function (the ANYmal SEA LSTM)
carries its state in `EnvState.actuator_state`, zeroed on reset, and steps
through `physics.actuated_control_step`.

Data parallel (`mesh`, parallel/mesh.py): the env is rank `mesh.rank`'s
contiguous slice, from `env_offset`, of `num_envs_global` envs.  What the
JAX env derives from the global batch is taken from it and sliced: the
terrain column of each env (JAX base_env.py:463) and the plane's grid of
origins (:466-468).  The command curriculum's mean over the resetting envs
(:632-634) is a sum and a count over all ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from legged_gym_custom_tpu_torch import physics as phys
from legged_gym_custom_tpu_torch import resolve_device
from legged_gym_custom_tpu_torch.ops import fused_step
from legged_gym_custom_tpu_torch.parallel.mesh import all_reduce_sum_
from legged_gym_custom_tpu_torch.physics import patch as patch_lib
from legged_gym_custom_tpu_torch.physics import spatial as sp
from legged_gym_custom_tpu_torch.physics.engine import DomainRandParams, PhysicsState
from legged_gym_custom_tpu_torch.terrain import Terrain
from legged_gym_custom_tpu_torch.utils.profiling import span
from . import rewards as rew_lib
from .rewards import RewardCtx, RewardStatics


class Obs(NamedTuple):
    """The five observation streams (reference base_task.py:76-81)."""

    obs: torch.Tensor          # (B, num_obs) proprio + history
    privileged: torch.Tensor   # (B, num_privileged_obs)
    critic: torch.Tensor       # (B, num_critic_obs)
    estimated: torch.Tensor    # (B, num_estimated_obs) ground-truth targets
    scan: torch.Tensor         # (B, num_scan_obs)


@dataclasses.dataclass
class EnvState:
    physics: PhysicsState                 # batch-leading leaves (B, ...)
    episode_length: torch.Tensor          # (B,) int64
    common_step: int
    commands: torch.Tensor                # (B, 4)
    actions: torch.Tensor                 # (B, A)
    last_actions: torch.Tensor
    last_dof_vel: torch.Tensor
    last_torques: torch.Tensor
    obs_history: torch.Tensor             # (B, H, P)
    measured_heights: torch.Tensor        # (B, n_scan_points)
    feet_air_time: torch.Tensor           # (B, n_feet)
    last_contacts: torch.Tensor           # (B, n_feet) bool
    last_contact_heights: torch.Tensor    # (B, n_feet)
    jump_flags: torch.Tensor              # (B,)
    terrain_levels: torch.Tensor          # (B,) int64
    terrain_types: torch.Tensor           # (B,) int64
    env_origins: torch.Tensor             # (B, 3)
    episode_sums: torch.Tensor            # (B, n_reward_terms)
    max_x: torch.Tensor                   # (B,) largest base x of the episode so far
    stall_time: torch.Tensor              # (B,) s under a moving command without new ground
    command_ranges: torch.Tensor          # (4, 2) [vx, vy, wz, heading]
    dr: DomainRandParams                  # batch-leading per-env params
    rng: torch.Generator
    actuator_state: Any = None            # stateful actuator model (SEA LSTM), batch-leading

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


def _tree_map(fn, tree):
    """`fn` on a tensor, or on each tensor of a (nested) tuple of them."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _where(mask, new, old):
    """Batch-masked select of `new` over `old`; mask is (B,)."""
    return torch.where(mask.reshape(mask.shape + (1,) * (old.dim() - 1)), new, old)


def terrain_types(num_envs: int, num_cols: int) -> np.ndarray:
    """Terrain column of each env, (B,) int64: the reference's
    `arange(B) // (B / num_cols)` (base_env.py:463) in float32, as JAX
    evaluates it."""
    q = np.floor_divide(np.arange(num_envs, dtype=np.float32), np.float32(num_envs / num_cols))
    return q.astype(np.int64)


class ResetDraws(NamedTuple):
    """The random draws of a reset (JAX base_env.py:530-555): the fields the
    config does not ask for are None."""

    dof_off: torch.Tensor             # (B, ndof) U(0, 0.9) added to the default angles
    vel6: torch.Tensor                # (B, 6) U(-0.5, 0.5) linear and angular velocity
    xy: Optional[torch.Tensor]        # (B, 2) U(-1, 1) on custom origins
    x_slot: Optional[torch.Tensor]    # (B,) one of init_state.rand_x_offsets
    x_jitter: Optional[torch.Tensor]  # (B,) U(init_state.rand_x_jitter)
    vx: Optional[torch.Tensor]        # (B,) U(init_state.rand_vx_range)


class LeggedEnv:
    """Static env builder; `reset_all` and `step` return new states."""

    def __init__(self, cfg, urdf_path: str, name: str = "robot", device="cuda",
                 terrain_seed: int = 0, mesh=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh

        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
        self.model = phys.load_urdf(urdf_path, name)
        self.ma = phys.model_arrays(self.model, device=dev)
        self.num_envs = cfg.env.num_envs   # this rank's envs
        world, rank = (mesh.world_size, mesh.rank) if mesh is not None else (1, 0)
        self.num_envs_global = self.num_envs * world
        self.env_offset = self.num_envs * rank
        self.num_actions = cfg.env.num_actions
        self.dt = cfg.sim.dt * cfg.control.decimation
        self.max_episode_length_s = cfg.env.episode_length_s
        self.max_episode_length = int(np.ceil(self.max_episode_length_s / self.dt))
        self.push_interval = int(np.ceil(cfg.domain_rand.push_interval_s / self.dt))
        self.resample_interval = int(cfg.commands.resampling_time / self.dt)

        # ---- terrain (reference base_env.py:94-112): the numpy generator
        # builds the int16 grid on the host; the float32 table and the
        # (rows, cols, 3) course origins live on the device
        self.custom_origins = cfg.terrain.mesh_type in ("heightfield", "trimesh")
        if self.custom_origins:
            self.terrain = Terrain(cfg.terrain, self.num_envs_global,
                                   np.random.default_rng(terrain_seed))
            self.hf = phys.from_raw(self.terrain.height_field_raw, cfg.terrain.horizontal_scale,
                                    cfg.terrain.vertical_scale, cfg.terrain.border_size,
                                    device=dev)
            self.terrain_origins = f32(self.terrain.env_origins)
            self.terrain_types = torch.as_tensor(
                terrain_types(self.num_envs_global, cfg.terrain.num_cols)[self._local],
                device=dev)
        else:
            self.terrain = None
            self.hf = phys.plane()
            self.terrain_origins = None
            cfg.terrain.curriculum = False  # reference _parse_cfg:950-951

        # ---- PD / actuation ----
        m = self.model
        p_gains = np.zeros(m.num_dof)
        d_gains = np.zeros(m.num_dof)
        default_dof_pos = np.zeros(m.num_dof)
        for i, dname in enumerate(m.dof_names):
            default_dof_pos[i] = cfg.init_state.default_joint_angles[dname]
            for key_s in cfg.control.stiffness:
                if key_s in dname:
                    p_gains[i] = cfg.control.stiffness[key_s]
                    d_gains[i] = cfg.control.damping[key_s]
        self.default_dof_pos = f32(default_dof_pos)
        self.pd = phys.PDParams(
            p_gains=f32(p_gains),
            d_gains=f32(d_gains),
            default_dof_pos=self.default_dof_pos,
            torque_limits=f32(m.dof_effort_limits),
            action_scale=cfg.control.action_scale,
            control_type=cfg.control.control_type,
        )
        self.dof_limits = (
            f32(m.dof_pos_limits[:, 0]), f32(m.dof_pos_limits[:, 1]), f32(m.dof_vel_limits),
        )

        def _per_dof(spec):
            """Scalar or {name-substring: value} dict -> (ndof,) tensor, or
            None if all zero (matching control.stiffness name semantics)."""
            vals = np.zeros(m.num_dof)
            if isinstance(spec, dict):
                for i, dname in enumerate(m.dof_names):
                    for key_s, v in spec.items():
                        if key_s in dname:
                            vals[i] = v
            else:
                vals[:] = float(spec)
            return f32(vals) if np.any(vals) else None

        self.sim_params = phys.SimParams(
            dt=cfg.sim.dt,
            decimation=cfg.control.decimation,
            substeps=cfg.sim.substeps,
            gravity=tuple(cfg.sim.gravity),
            contact=phys.ContactParams(
                stiffness=cfg.sim.contact_stiffness,
                damping=cfg.sim.contact_damping,
                friction_vel=cfg.sim.contact_friction_vel,
                terrain_friction=cfg.terrain.static_friction,
            ),
            joint_limit_stiffness=cfg.sim.joint_limit_stiffness,
            joint_limit_damping=cfg.sim.joint_limit_damping,
            dof_damping=_per_dof(getattr(cfg.sim, "joint_damping", 0.0)),
            dof_armature=_per_dof(getattr(cfg.sim, "joint_armature", 0.0)),
            dof_frictionloss=_per_dof(getattr(cfg.sim, "joint_frictionloss", 0.0)),
            frictionloss_implicit=bool(getattr(cfg.sim, "joint_frictionloss_implicit", False)),
        )
        if (self.sim_params.frictionloss_implicit
                and self.sim_params.dof_frictionloss is not None):
            # implicit stiction clamps by fl * dt / m_eff, with m_eff taken
            # at the default joint angles (reference base_env.py:174-186)
            self.sim_params = self.sim_params._replace(
                dof_meff=phys.effective_joint_inertia(
                    self.ma, default_dof_pos.astype(np.float32),
                    armature=self.sim_params.dof_armature))
        # the fused kernel's spec, built once here (None where the config
        # turns the kernel off: sim.fused_kernel, LGC_FUSED_KERNEL=0 when built)
        configured = bool(getattr(cfg.sim, "fused_kernel", True))
        self.fused_spec = phys.kernel_spec(self.ma, self.hf, self.sim_params, self.pd,
                                           self.dof_limits, enabled=configured)
        if self.fused_spec is None:
            print(f"[env] {name}: the fused kernel is off (sim.fused_kernel={configured}, "
                  f"LGC_FUSED_KERNEL={fused_step.env_flag()}): the eager engine steps "
                  f"{self.num_envs} envs on {self.device}", flush=True)

        # ---- link groups (name-substring matching, legged_robot.py:846-894) ----
        self.feet_ids = m.link_ids_matching(cfg.asset.foot_name)
        self.penalized_ids = m.link_ids_matching(cfg.asset.penalize_contacts_on)
        self.termination_ids = m.link_ids_matching(cfg.asset.terminate_after_contacts_on)
        self.calf_link_ids = m.link_ids_matching("calf")
        self.hip_joint_ids = m.dof_ids_matching("hip")
        self.thigh_joint_ids = m.dof_ids_matching("thigh")
        self.calf_joint_ids = m.dof_ids_matching("calf")
        self.n_feet = len(self.feet_ids)

        # ---- scandot grid (legged_robot.py:980-994); heights stay zero on
        # the plane, but the scan stream keeps its width
        gx, gy = np.meshgrid(np.asarray(cfg.terrain.measured_points_x),
                             np.asarray(cfg.terrain.measured_points_y), indexing="ij")
        pts = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=-1)
        self.height_points = f32(pts)                        # (P, 3)
        self.num_height_points = pts.shape[0]
        # scandot window: the grid's worst-case yaw-rotated radius + margin
        self._scan_patch_K = 0 if self.hf.is_plane else patch_lib.patch_size(
            float(np.linalg.norm(pts[:, :2], axis=1).max()) + 0.3, cfg.terrain.horizontal_scale)

        # ---- rewards (legged_robot.py:730-754) ----
        scales = {}
        for k in dir(cfg.rewards.scales):
            if k.startswith("_"):
                continue
            v = getattr(cfg.rewards.scales, k)
            if isinstance(v, (int, float)) and v != 0:
                scales[k] = v
        self.termination_scale = scales.pop("termination", None)
        self.reward_names = sorted(scales)
        missing = [nm for nm in self.reward_names if nm not in rew_lib.REWARD_REGISTRY]
        if missing:
            raise NotImplementedError(f"reward terms not ported yet: {missing}")
        self.reward_terms = [
            (nm, rew_lib.REWARD_REGISTRY[nm], float(scales[nm]) * self.dt)
            for nm in self.reward_names
        ]
        self.episode_sum_names = list(self.reward_names)
        if self.termination_scale is not None:
            self.episode_sum_names.append("termination")

        r = cfg.rewards
        m_soft = (m.dof_pos_limits[:, 0] + m.dof_pos_limits[:, 1]) / 2
        rng_lim = m.dof_pos_limits[:, 1] - m.dof_pos_limits[:, 0]
        soft_limits = np.stack(
            [m_soft - 0.5 * rng_lim * r.soft_dof_pos_limit,
             m_soft + 0.5 * rng_lim * r.soft_dof_pos_limit], axis=-1
        )
        self.reward_statics = RewardStatics(
            dt=self.dt,
            tracking_sigma=r.tracking_sigma,
            base_height_target=r.base_height_target,
            max_contact_force=r.max_contact_force,
            pitch_deg_target=r.pitch_deg_target,
            roll_deg_target=r.roll_deg_target,
            max_foot_height=r.max_foot_height,
            percent_time_on_ground=r.percent_time_on_ground,
            soft_dof_pos_limits=f32(soft_limits),
            soft_dof_vel_limit=r.soft_dof_vel_limit,
            soft_torque_limit=r.soft_torque_limit,
            dof_vel_limits=f32(m.dof_vel_limits),
            torque_limits=f32(m.dof_effort_limits),
            default_dof_pos=self.default_dof_pos,
            feet_ids=self.feet_ids,
            penalized_ids=self.penalized_ids,
            termination_ids=self.termination_ids,
            calf_link_ids=self.calf_link_ids,
            hip_joint_ids=self.hip_joint_ids,
            thigh_joint_ids=self.thigh_joint_ids,
            calf_joint_ids=self.calf_joint_ids,
            heading_command=cfg.commands.heading_command,
            jump_zone_fwd_gate=getattr(r, "jump_zone_fwd_gate", 0.0),
        )

        # progress-stall termination (JAX base_env.py:265-272): under a moving
        # command, `stall_time_s` seconds without new course ground end the
        # episode as a death; 0 turns it off
        term_cfg = getattr(cfg, "termination", None)
        self.stall_time_s = float(getattr(term_cfg, "stall_time_s", 0.0) or 0.0)
        self.stall_min_vel = float(getattr(term_cfg, "stall_min_vel", 0.2))

        self.obs_scales = cfg.normalization.obs_scales
        self.commands_scale = f32(
            [self.obs_scales.lin_vel, self.obs_scales.lin_vel, self.obs_scales.ang_vel])
        self.noise_scale_vec = f32(self._noise_scale_vec())
        self._unit_x = f32([1.0, 0.0, 0.0])
        self._gravity_dir = f32([0.0, 0.0, -1.0])

        init = cfg.init_state
        # reference stores rot as xyzw (Isaac); convert to wxyz
        rx, ry, rz, rw = init.rot
        self.base_init = dict(
            pos=f32(init.pos), quat=f32([rw, rx, ry, rz]),
            lin_vel=f32(init.lin_vel), ang_vel=f32(init.ang_vel),
        )
        # spawn curriculum (JAX base_env.py:521-527): spawns spread over course
        # slots with uniform jitter, and an initial forward velocity
        x_offsets = getattr(init, "rand_x_offsets", None)
        self.spawn_x_slots = f32(x_offsets) if x_offsets else None
        self.spawn_x_jitter = tuple(getattr(init, "rand_x_jitter", (0.0, 0.0)))
        vx_range = getattr(init, "rand_vx_range", None)
        self.spawn_vx_range = None if vx_range is None else tuple(vx_range)

        self._torque_fn = self._build_torque_fn()

    def _vstep(self, physics: PhysicsState, actions, dr: DomainRandParams, actuator_state=None):
        """Run the engine from batch-leading env tensors; returns (physics',
        StepInfo, actuator_state').

        The env stores (B, ...) leaves (convenient for masked resets and
        obs); the engine and the fused kernel take component-major (C, B)
        rows with the batch trailing, contiguous.
        """
        to_cb = lambda x: x.movedim(0, -1).contiguous()
        from_cb = lambda x: x.movedim(-1, 0)
        args = (self.ma, self.hf, self.sim_params, self.pd,
                DomainRandParams(*[to_cb(x) for x in dr]), self.dof_limits,
                PhysicsState(*[to_cb(x) for x in physics]), to_cb(actions))
        if self._torque_fn is None:
            st, info = phys.control_step(*args, spec=self.fused_spec)
        else:
            act = _tree_map(to_cb, actuator_state)
            st, info, actuator_state = phys.actuated_control_step(*args, act, self._torque_fn,
                                                                  spec=self.fused_spec)
            actuator_state = _tree_map(from_cb, actuator_state)
        return (PhysicsState(*[from_cb(x) for x in st]), type(info)(*[from_cb(x) for x in info]),
                actuator_state)

    @property
    def num_proprio(self) -> int:
        return self.cfg.env.num_proprio

    # ------------------------------------------------------------------
    # Stateful actuator hooks (the ANYmal SEA network overrides these)
    # ------------------------------------------------------------------
    def _build_torque_fn(self):
        """`torque_fn(actions, dof_pos, dof_vel, act_state) -> (tau,
        act_state')` on (C, B) tensors, or None for the PD law."""
        return None

    def _init_actuator_state(self):
        """Per-env initial actuator state, batch-leading; a (B,) placeholder
        when stateless."""
        return torch.zeros((self.num_envs,), device=self.device)

    def _reset_actuator_state(self, act_state, reset_mask):
        """Zero the actuator state of the envs that reset."""
        return _tree_map(lambda x: _where(reset_mask, torch.zeros_like(x), x), act_state)

    # ------------------------------------------------------------------
    # Task-specific hooks (overridden by Go2Env)
    # ------------------------------------------------------------------
    def _noise_scale_vec(self) -> np.ndarray:
        """Base layout noise vector (legged_robot.py:594-622), aligned to
        the actual obs layout."""
        cfg = self.cfg
        n = np.zeros(cfg.env.num_proprio, np.float32)
        ns = cfg.noise.noise_scales
        lvl = cfg.noise.noise_level
        osc = cfg.normalization.obs_scales
        a = self.num_actions
        n[0:3] = ns.lin_vel * lvl * osc.lin_vel
        n[3:6] = ns.ang_vel * lvl * osc.ang_vel
        n[6:9] = ns.gravity * lvl
        n[12:12 + a] = ns.dof_pos * lvl * osc.dof_pos
        n[12 + a:12 + 2 * a] = ns.dof_vel * lvl * osc.dof_vel
        if cfg.terrain.measure_heights:
            n[12 + 3 * a:] = ns.height_measurements * lvl * osc.height_measurements
        return n

    def _proprio_obs(self, state: EnvState, derived: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Current-step proprio obs (legged_robot.py:240-256)."""
        ph = state.physics
        parts = [
            derived["base_lin_vel"] * self.obs_scales.lin_vel,
            derived["base_ang_vel"] * self.obs_scales.ang_vel,
            derived["projected_gravity"],
            state.commands[:, :3] * self.commands_scale,
            (ph.dof_pos - self.default_dof_pos) * self.obs_scales.dof_pos,
            ph.dof_vel * self.obs_scales.dof_vel,
            state.actions,
        ]
        if self.cfg.terrain.measure_heights:
            parts.append(torch.clamp(ph.base_pos[:, 2:3] - 0.5 - state.measured_heights,
                                     -1.0, 1.0) * self.obs_scales.height_measurements)
        return torch.cat(parts, dim=-1)

    def _streams(self, state: EnvState, derived, obs_full) -> Obs:
        """Privileged / estimated / scan / critic streams."""
        privileged = self._privileged_obs(state)
        n_est = self.cfg.env.num_estimated_obs
        estimated = (derived["base_lin_vel"] * self.obs_scales.lin_vel)[:, :n_est]
        if estimated.shape[1] < n_est:
            estimated = torch.nn.functional.pad(estimated, (0, n_est - estimated.shape[1]))
        scan = self._scan_obs(state)
        critic = torch.cat([obs_full, privileged, estimated, scan], dim=-1)
        return Obs(obs_full, privileged, critic, estimated, scan)

    def _privileged_obs(self, state: EnvState) -> torch.Tensor:
        """Go2-style privileged stream (go2.py:528-532), truncated/padded to cfg."""
        n = self.cfg.env.num_privileged_obs
        dr = state.dr
        full = torch.cat([
            dr.added_mass[:, None], dr.com_offset, dr.friction[:, None],
            dr.kp_mult - 1.0, dr.kd_mult - 1.0,
        ], dim=-1)
        if full.shape[1] >= n:
            return full[:, :n]
        return torch.nn.functional.pad(full, (0, n - full.shape[1]))

    def _scan_obs(self, state: EnvState) -> torch.Tensor:
        n = self.cfg.env.num_scan_obs
        scan = torch.clamp(
            state.physics.base_pos[:, 2:3] - 0.3 - state.measured_heights, -1.0, 1.0)
        return scan[:, :n]

    def _phases(self, state: EnvState) -> torch.Tensor:
        """Per-leg gait phases [fl, fr, bl, br] (go2.py:277-290)."""
        e = self.cfg.env
        phase = torch.remainder(state.episode_length.float() * self.dt, e.period) / e.period
        legs = torch.stack([
            torch.remainder(phase + e.fl_offset, 1.0),
            torch.remainder(phase + e.fr_offset, 1.0),
            torch.remainder(phase + e.bl_offset, 1.0),
            torch.remainder(phase + e.br_offset, 1.0),
        ], dim=-1)
        small = torch.linalg.norm(state.commands[:, :3], dim=1) < 0.2
        return torch.where(small[:, None], 0.0, legs)

    def _check_termination(self, state: EnvState, derived):
        """legged_robot.py:141-154, plus the parkour hole check (go2.py:200-204)
        and the progress stall (JAX base_env.py:446-449)."""
        f = derived["link_forces"][:, self.termination_ids, :]
        contact_term = torch.any(torch.linalg.norm(f, dim=-1) > 1.0, dim=1)
        time_out = state.episode_length > self.max_episode_length
        upside_down = derived["projected_gravity"][:, 2] > 0.0
        reset = contact_term | time_out | upside_down
        if getattr(self.cfg.terrain, "parkour", False):
            reset = reset | (state.physics.base_pos[:, 2] < -1.0)
        if self.stall_time_s > 0.0:
            # a death, not a time_out: PPO does not bootstrap past a balk
            reset = reset | (state.stall_time > self.stall_time_s)
        return reset, time_out

    def _initial_origins(self, gen):
        """(terrain levels, terrain types, origins) of every env
        (legged_robot.py:897-930): on a heightfield each env starts on a
        random level up to `max_init_terrain_level` of its column's course;
        on the plane the origins form a grid."""
        B = self.num_envs
        if self.custom_origins:
            max_init = self.cfg.terrain.max_init_terrain_level
            if not self.cfg.terrain.curriculum:
                max_init = self.cfg.terrain.num_rows - 1
            levels = torch.randint(0, max_init + 1, (B,), generator=gen, device=self.device)
            return levels, self.terrain_types, self.terrain_origins[levels, self.terrain_types]
        Bg = self.num_envs_global   # the grid of the global batch, this rank's slice
        ncols = int(np.floor(np.sqrt(Bg)))
        nrows = int(np.ceil(Bg / ncols))
        xx, yy = np.meshgrid(np.arange(nrows), np.arange(ncols), indexing="ij")
        spacing = self.cfg.env.env_spacing
        origins = np.zeros((Bg, 3), np.float32)
        origins[:, 0] = spacing * xx.flatten()[:Bg]
        origins[:, 1] = spacing * yy.flatten()[:Bg]
        zeros = torch.zeros(B, dtype=torch.long, device=self.device)
        return zeros, zeros, torch.as_tensor(origins[self._local], device=self.device)

    @property
    def _local(self) -> slice:
        """This rank's envs among the global batch."""
        return slice(self.env_offset, self.env_offset + self.num_envs)

    # ------------------------------------------------------------------
    # Random draws
    # ------------------------------------------------------------------
    def _uniform(self, gen, shape, lo, hi) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=self.device)

    def _sample_dr(self, gen) -> DomainRandParams:
        """Per-env dynamics randomization, sampled once at env creation
        (reference legged_robot.py:306-380)."""
        B = self.num_envs
        cfg = self.cfg.domain_rand
        dev = self.device
        if cfg.randomize_friction:
            buckets = self._uniform(gen, (64,), *cfg.friction_range)
            ids = torch.randint(0, 64, (B,), generator=gen, device=dev)
            friction = buckets[ids]
        else:
            friction = torch.full((B,), float(self.cfg.terrain.dynamic_friction), device=dev)
        added_mass = (self._uniform(gen, (B,), *cfg.added_mass_range)
                      if cfg.randomize_base_mass else torch.zeros(B, device=dev))
        com_offset = (self._uniform(gen, (B, 3), *cfg.added_com_range)
                      if cfg.randomize_center_of_mass else torch.zeros((B, 3), device=dev))
        if cfg.randomize_kp_kd:
            mult = self._uniform(gen, (2, B, self.num_actions), *cfg.kp_kd_range)
            kp_mult, kd_mult = mult[0], mult[1]
        else:
            kp_mult = torch.ones((B, self.num_actions), device=dev)
            kd_mult = torch.ones((B, self.num_actions), device=dev)
        return DomainRandParams(friction, added_mass, com_offset, kp_mult, kd_mult)

    def _sample_reset_physics(self, state: EnvState, gen, origins) -> PhysicsState:
        """New dof/root states for (potentially) resetting envs
        (legged_robot.py:481-532, JAX base_env.py:517-564)."""
        return self._assemble_reset(self._draw_reset(gen), origins)

    def _draw_reset(self, gen) -> ResetDraws:
        """The random draws of a reset, from the env's generator."""
        B = self.num_envs
        dof_off = self._uniform(gen, (B, self.model.num_dof), 0.0, 0.9)
        vel6 = self._uniform(gen, (B, 6), -0.5, 0.5)
        xy = self._uniform(gen, (B, 2), -1.0, 1.0) if self.custom_origins else None
        x_slot = x_jitter = vx = None
        if self.spawn_x_slots is not None:
            slots = self.spawn_x_slots
            x_slot = slots[torch.randint(0, len(slots), (B,), generator=gen, device=self.device)]
            x_jitter = self._uniform(gen, (B,), *self.spawn_x_jitter)
        if self.spawn_vx_range is not None:
            vx = self._uniform(gen, (B,), *self.spawn_vx_range)
        return ResetDraws(dof_off, vel6, xy, x_slot, x_jitter, vx)

    def _assemble_reset(self, d: ResetDraws, origins) -> PhysicsState:
        """The reset states from the draws and the origins: base at the
        initial position over its origin, moved by the xy jitter and by its
        spawn slot plus slot jitter; the initial forward velocity replaces
        the drawn vx.  Deterministic, in the reference's float32 order."""
        pos = self.base_init["pos"] + origins
        zero = torch.zeros_like(pos[:, :1])
        if d.xy is not None:
            pos = pos + torch.cat([d.xy, zero], dim=1)
        if d.x_slot is not None:
            pos = pos + torch.cat([(d.x_slot + d.x_jitter)[:, None], zero, zero], dim=1)
        lin_vel = d.vel6[:, 0:3]
        if d.vx is not None:
            lin_vel = torch.cat([d.vx[:, None], lin_vel[:, 1:]], dim=1)
        dof_pos = self.default_dof_pos + d.dof_off
        return PhysicsState(
            base_pos=pos,
            base_quat=self.base_init["quat"].expand(pos.shape[0], 4),
            lin_vel=lin_vel,
            ang_vel=d.vel6[:, 3:6],
            dof_pos=dof_pos,
            dof_vel=torch.zeros_like(dof_pos),
        )

    def _resample_commands(self, state: EnvState, gen, mask) -> torch.Tensor:
        """Masked command resampling (go2.py:413-464)."""
        cfg = self.cfg.commands
        B = self.num_envs
        cmds = state.commands
        if len(cfg.user_command) > 0:
            new = torch.as_tensor(cfg.user_command, dtype=torch.float32,
                                  device=self.device).expand(B, 4)
            return _where(mask, new, cmds)
        cr = state.command_ranges
        vx = self._uniform(gen, (B,), cr[0, 0], cr[0, 1])
        vy = self._uniform(gen, (B,), cr[1, 0], cr[1, 1])
        new = cmds.clone()
        new[:, 0] = torch.where(mask, vx, cmds[:, 0])
        new[:, 1] = torch.where(mask, vy, cmds[:, 1])
        if cfg.heading_command:
            hd = self._uniform(gen, (B,), cr[3, 0], cr[3, 1])
            new[:, 3] = torch.where(mask, hd, cmds[:, 3])
        else:
            wz = self._uniform(gen, (B,), cr[2, 0], cr[2, 1])
            new[:, 2] = torch.where(mask, wz, cmds[:, 2])
        # zero small xy commands
        big = (torch.linalg.norm(new[:, :2], dim=1) > 0.2).float()
        new[:, :2] = new[:, :2] * torch.where(mask, big, 1.0)[:, None]
        if cfg.zero_command:
            zmask = (torch.rand((B,), generator=gen, device=self.device)
                     < cfg.zero_command_prob) & mask
            new[:, 0:3] = new[:, 0:3] * torch.where(zmask, 0.0, 1.0)[:, None]
            if cfg.heading_command:
                # "zero" heading: target = current heading (go2.py:460-464)
                fwd = sp.quat_rotate(state.physics.base_quat,
                                     self._unit_x.expand(B, 3))
                cur_heading = torch.atan2(fwd[:, 1], fwd[:, 0])
                new[:, 3] = torch.where(zmask, cur_heading, new[:, 3])
        return new

    def _update_terrain_curriculum(self, state: EnvState, gen, reset_mask):
        """Promote/demote terrain levels on reset (legged_robot.py:543-574):
        up after covering `promote_threshold` of a course's length, down
        after less than `demote_threshold` of the commanded distance; past
        the last row an env goes to a random level."""
        if not (self.cfg.terrain.curriculum and self.custom_origins):
            return state.terrain_levels, state.env_origins
        cfg = self.cfg.terrain
        dist = torch.linalg.norm(state.physics.base_pos[:, :2] - state.env_origins[:, :2], dim=1)
        move_up = dist > self.terrain.env_length * cfg.promote_threshold
        expected = torch.linalg.norm(state.commands[:, :2], dim=1) * self.max_episode_length_s
        move_down = dist < expected * cfg.demote_threshold
        levels = state.terrain_levels + move_up.long() - move_down.long()
        rand_levels = torch.randint(0, cfg.num_rows, levels.shape, generator=gen,
                                    device=self.device)
        levels = torch.where(levels >= cfg.num_rows, rand_levels, torch.clamp(levels, min=0))
        levels = torch.where(reset_mask, levels, state.terrain_levels)
        origins = self.terrain_origins[levels, state.terrain_types]
        return levels, _where(reset_mask, origins, state.env_origins)

    def _update_command_curriculum(self, state: EnvState, reset_mask) -> torch.Tensor:
        """Widen the lin_vel_x range when the resetting envs tracked it well
        (go2.py:80-107, JAX base_env.py:621-648), on the steps where
        common_step % max_episode_length == 0 (go2.py:222)."""
        cfg = self.cfg.commands
        cr = state.command_ranges
        if not cfg.curriculum or "tracking_lin_vel" not in self.reward_names or \
                state.common_step % self.max_episode_length != 0:
            return cr
        idx = self.episode_sum_names.index("tracking_lin_vel")
        term_scale = next(s for n, _, s in self.reward_terms if n == "tracking_lin_vel")
        rew_sum = torch.where(reset_mask, state.episode_sums[:, idx], 0.0).sum()
        n_reset = reset_mask.sum()
        if self.mesh is not None and self.mesh.distributed:
            stats = torch.stack([rew_sum.double(), n_reset.double()])
            all_reduce_sum_(self.mesh, [stats])
            rew_sum, n_reset = stats[0].float(), stats[1].long()
        mean_rew = rew_sum / torch.clamp(n_reset, min=1) / self.max_episode_length
        delta = cfg.vel_increment
        if cfg.max_reverse_vel < 0.0:
            lo = torch.clamp(cr[0, 0] - delta, cfg.max_reverse_vel, 0.0)
        else:
            lo = torch.clamp(cr[0, 0] - delta, min=cfg.max_reverse_vel)
        hi = torch.clamp(cr[0, 1] + delta, 0.0, cfg.max_forward_vel)
        apply = (mean_rew > 0.8 * term_scale) & (n_reset > 0)
        return torch.cat([torch.where(apply, torch.stack([lo, hi]), cr[0])[None], cr[1:]])

    # ------------------------------------------------------------------
    # Heights (legged_robot.py:997-1032)
    # ------------------------------------------------------------------
    def _get_heights(self, ph: PhysicsState) -> torch.Tensor:
        """Terrain heights at the yaw-rotated scandots, from a per-env
        window of the table that covers the whole grid (physics/patch.py)."""
        B = ph.base_pos.shape[0]
        if self.hf.is_plane:
            return torch.zeros((B, self.num_height_points), device=self.device)
        pts = sp.quat_apply_yaw(ph.base_quat[:, None, :], self.height_points[None, :, :]) \
            + ph.base_pos[:, None, :]
        lp = patch_lib.extract(self.hf, ph.base_pos[:, 0], ph.base_pos[:, 1],
                               self._scan_patch_K)
        return patch_lib.height_min3(lp, pts[..., 0], pts[..., 1])

    # ------------------------------------------------------------------
    # Reset-all / step
    # ------------------------------------------------------------------
    def reset_all(self, gen: torch.Generator, init_at_random_ep_len: bool = False
                  ) -> Tuple[EnvState, Obs]:
        B = self.num_envs
        cfg = self.cfg
        dev = self.device
        levels, types, origins = self._initial_origins(gen)
        dr = self._sample_dr(gen)
        cr = torch.tensor(
            [cfg.commands.ranges.lin_vel_x, cfg.commands.ranges.lin_vel_y,
             cfg.commands.ranges.ang_vel_yaw, cfg.commands.ranges.heading],
            dtype=torch.float32, device=dev,
        )
        zeros = lambda *s: torch.zeros(s, device=dev)
        A = self.num_actions
        state = EnvState(
            physics=None,  # filled below
            episode_length=torch.zeros(B, dtype=torch.long, device=dev),
            common_step=0,
            commands=zeros(B, 4),
            actions=zeros(B, A),
            last_actions=zeros(B, A),
            last_dof_vel=zeros(B, self.model.num_dof),
            last_torques=zeros(B, A),
            obs_history=zeros(B, cfg.env.history_buffer_length, cfg.env.num_proprio),
            measured_heights=zeros(B, self.num_height_points),
            feet_air_time=zeros(B, self.n_feet),
            last_contacts=torch.zeros((B, self.n_feet), dtype=torch.bool, device=dev),
            last_contact_heights=zeros(B, self.n_feet),
            jump_flags=zeros(B),
            terrain_levels=levels,
            terrain_types=types,
            env_origins=origins,
            episode_sums=zeros(B, len(self.episode_sum_names)),
            max_x=zeros(B),
            stall_time=zeros(B),
            command_ranges=cr,
            dr=dr,
            rng=gen,
            actuator_state=self._init_actuator_state(),
        )
        physics = self._sample_reset_physics(state, gen, origins)
        state = state.replace(physics=physics, max_x=physics.base_pos[:, 0])
        state = state.replace(
            commands=self._resample_commands(state, gen, torch.ones(B, dtype=torch.bool, device=dev)))
        if init_at_random_ep_len:
            state = state.replace(episode_length=torch.randint(
                0, self.max_episode_length, (B,), generator=gen, device=dev))
        state, obs, _, _, _ = self.step(state, zeros(B, A))
        return state, obs

    def step(self, state: EnvState, actions: torch.Tensor
             ) -> Tuple[EnvState, Obs, torch.Tensor, torch.Tensor, Dict[str, Any]]:
        cfg = self.cfg
        B = self.num_envs
        gen = state.rng
        clip_a = cfg.normalization.clip_actions
        with span("lgc.env.step"):
            # ---- physics (decimated PD torque loop) ----
            with span("lgc.env.physics"):
                actions = torch.clamp(actions, -clip_a, clip_a)
                ph, info, actuator_state = self._vstep(state.physics, actions, state.dr,
                                                       state.actuator_state)

            with span("lgc.env.post_physics"):
                episode_length = state.episode_length + 1
                common_step = state.common_step + 1

                # ---- derived quantities (go2.py:352-367) ----
                base_lin_vel = sp.quat_rotate_inverse(ph.base_quat, ph.lin_vel)
                base_ang_vel = sp.quat_rotate_inverse(ph.base_quat, ph.ang_vel)
                projected_gravity = sp.quat_rotate_inverse(ph.base_quat,
                                                           self._gravity_dir.expand(B, 3))
                roll, pitch, yaw = sp.quat_to_rpy(ph.base_quat)
                fwd = sp.quat_rotate(ph.base_quat, self._unit_x.expand(B, 3))
                heading = torch.atan2(fwd[:, 1], fwd[:, 0])

                # ---- feet states + gait phases (go2.py:266-328) ----
                state_pre = state.replace(physics=ph, episode_length=episode_length,
                                          common_step=common_step)
                phases = self._phases(state_pre)
                feet_pos = info.link_pos[:, self.feet_ids, :]
                feet_force = info.link_forces[:, self.feet_ids, :]
                cur_contact = feet_force[:, :, 2] > 1.0
                contact_filt = cur_contact | state.last_contacts
                last_contacts = cur_contact
                last_contact_heights = torch.where(contact_filt, feet_pos[:, :, 2],
                                                   state.last_contact_heights)
                first_contact = (state.feet_air_time > 0.0) & contact_filt
                feet_air_time = state.feet_air_time + self.dt

                # ---- post-physics callback (go2.py:390-410) ----
                resample_mask = (episode_length % self.resample_interval) == 0
                commands = self._resample_commands(state_pre.replace(commands=state.commands), gen,
                                                   resample_mask)
                if cfg.commands.heading_command:
                    gain = getattr(cfg.commands, "heading_error_gain", 0.5)
                    err = sp.wrap_to_pi(commands[:, 3] - heading) * gain
                    commands[:, 2] = torch.clamp(err, -1.0, 1.0)
                measured_heights = self._get_heights(ph)
                if cfg.domain_rand.push_robots:
                    push_vel = self._uniform(gen, (B, 2), -cfg.domain_rand.max_push_vel_xy,
                                             cfg.domain_rand.max_push_vel_xy)
                    if common_step % self.push_interval == 0:
                        ph = ph._replace(lin_vel=torch.cat([push_vel, ph.lin_vel[:, 2:]], dim=1))

                derived = dict(
                    base_lin_vel=base_lin_vel,
                    base_ang_vel=base_ang_vel,
                    projected_gravity=projected_gravity,
                    link_forces=info.link_forces,
                )

                # ---- course progress and stall (JAX base_env.py:796-806): the new
                # ground beyond the episode's largest x, and how long a moving
                # command has gained less than stall_min_vel of it
                base_x = ph.base_pos[:, 0]
                progress = torch.clamp(base_x - state.max_x, min=0.0) / self.dt
                max_x = torch.maximum(state.max_x, base_x)
                stalled = (torch.linalg.norm(commands[:, :3], dim=1) >= 0.2) & \
                    (progress < self.stall_min_vel)
                stall_time = torch.where(stalled, state.stall_time + self.dt, 0.0)

                # ---- termination (go2.py:186-204) ----
                state_mid = state_pre.replace(physics=ph, commands=commands,
                                              measured_heights=measured_heights, max_x=max_x,
                                              stall_time=stall_time)
                reset_buf, time_out_buf = self._check_termination(state_mid, derived)

            # ---- rewards (legged_robot.py:216-237) ----
            with span("lgc.env.rewards"):
                ctx = RewardCtx(
                    base_pos=ph.base_pos,
                    base_lin_vel=base_lin_vel,
                    base_ang_vel=base_ang_vel,
                    world_lin_vel=ph.lin_vel,
                    projected_gravity=projected_gravity,
                    roll=roll, pitch=pitch, yaw=yaw, heading=heading,
                    commands=commands,
                    dof_pos=ph.dof_pos,
                    dof_vel=ph.dof_vel,
                    last_dof_vel=state.last_dof_vel,
                    torques=info.torques,
                    last_torques=state.last_torques,
                    actions=actions,
                    last_actions=state.last_actions,
                    link_forces=info.link_forces,
                    feet_pos=feet_pos,
                    feet_vel=info.link_vel[:, self.feet_ids, :],
                    last_contact_heights=last_contact_heights,
                    contact_filt=contact_filt,
                    feet_air_time=feet_air_time,
                    first_contact=first_contact,
                    phases=phases,
                    measured_heights=measured_heights,
                    jump_flags=state.jump_flags,
                    reset_buf=reset_buf,
                    time_out_buf=time_out_buf,
                    progress=progress,
                )
                rew_buf = torch.zeros(B, device=self.device)
                terms = []
                for name, fn, scale in self.reward_terms:
                    r = fn(ctx, self.reward_statics) * scale
                    rew_buf = rew_buf + r
                    terms.append(r)
                if cfg.rewards.only_positive_rewards:
                    rew_buf = torch.clamp(rew_buf, min=0.0)
                if self.termination_scale is not None:
                    r = rew_lib.REWARD_REGISTRY["termination"](ctx, self.reward_statics) * (
                        self.termination_scale * self.dt)
                    rew_buf = rew_buf + r
                    terms.append(r)
                episode_sums = state.episode_sums + torch.stack(terms, dim=1)

                # feet air time consumed on contact (go2.py:830)
                feet_air_time = feet_air_time * ~contact_filt

            # ---- masked reset (reset_idx, go2.py:207-263) ----
            with span("lgc.env.reset"):
                levels, origins = self._update_terrain_curriculum(state_mid, gen, reset_buf)
                command_ranges = self._update_command_curriculum(
                    state_mid.replace(episode_sums=episode_sums), reset_buf)
                state_mid = state_mid.replace(command_ranges=command_ranges)
                reset_physics = self._sample_reset_physics(state_mid, gen, origins)
                ph = PhysicsState(*[_where(reset_buf, new, old)
                                    for new, old in zip(reset_physics, ph)])
                commands = self._resample_commands(state_mid.replace(physics=ph), gen, reset_buf)
                last_actions = _where(reset_buf, torch.zeros_like(actions), actions)
                last_dof_vel = _where(reset_buf, torch.zeros_like(ph.dof_vel), ph.dof_vel)
                last_torques = _where(reset_buf, torch.zeros_like(info.torques), info.torques)
                obs_history = _where(reset_buf, torch.zeros_like(state.obs_history),
                                     state.obs_history)
                episode_length = torch.where(reset_buf, 0, episode_length)
                feet_air_time = _where(reset_buf, torch.zeros_like(feet_air_time), feet_air_time)
                last_contacts = _where(reset_buf, torch.zeros_like(last_contacts), last_contacts)
                last_contact_heights = _where(reset_buf, torch.zeros_like(last_contact_heights),
                                              last_contact_heights)
                # envs that reset restart their progress tracking at the respawn x
                max_x = torch.where(reset_buf, ph.base_pos[:, 0], max_x)
                stall_time = torch.where(reset_buf, 0.0, stall_time)
                # per-env episode sums of the envs that reset this step; the runner
                # reduces them once per iteration (go2.py:245-263)
                episode_contrib = _where(reset_buf, episode_sums, torch.zeros_like(episode_sums))
                episode_sums = _where(reset_buf, torch.zeros_like(episode_sums), episode_sums)
                actuator_state = self._reset_actuator_state(actuator_state, reset_buf)
                info_out: Dict[str, Any] = {"time_outs": time_out_buf,
                                            "episode_contrib": episode_contrib}

            # ---- observations ----
            with span("lgc.env.obs"):
                new_state = state_mid.replace(
                    physics=ph,
                    episode_length=episode_length,
                    commands=commands,
                    actions=actions,
                    last_actions=last_actions,
                    last_dof_vel=last_dof_vel,
                    last_torques=last_torques,
                    obs_history=obs_history,
                    feet_air_time=feet_air_time,
                    last_contacts=last_contacts,
                    last_contact_heights=last_contact_heights,
                    terrain_levels=levels,
                    env_origins=origins,
                    episode_sums=episode_sums,
                    max_x=max_x,
                    stall_time=stall_time,
                    actuator_state=actuator_state,
                )
                new_state, obs = self._compute_observations(new_state, derived, gen)

                # clip all streams except scan (legged_robot.py:91-97)
                c = cfg.normalization.clip_observations
                obs = Obs(
                    obs=torch.clamp(obs.obs, -c, c),
                    privileged=torch.clamp(obs.privileged, -c, c),
                    critic=torch.clamp(obs.critic, -c, c),
                    estimated=torch.clamp(obs.estimated, -c, c),
                    scan=obs.scan,
                )
                return new_state, obs, rew_buf, reset_buf, info_out

    def _pre_obs_hook(self, state: EnvState) -> EnvState:
        """Task hook run before obs assembly."""
        return state

    def _compute_observations(self, state: EnvState, derived, gen):
        """Obs assembly + history FIFO (legged_robot.py:240-273)."""
        state = self._pre_obs_hook(state)
        # recompute derived for post-reset states
        ph = state.physics
        B = self.num_envs
        derived = dict(derived)
        derived["base_lin_vel"] = sp.quat_rotate_inverse(ph.base_quat, ph.lin_vel)
        derived["base_ang_vel"] = sp.quat_rotate_inverse(ph.base_quat, ph.ang_vel)
        derived["projected_gravity"] = sp.quat_rotate_inverse(
            ph.base_quat, self._gravity_dir.expand(B, 3))
        cur = self._proprio_obs(state, derived)
        if self.cfg.noise.add_noise:
            u = torch.rand(cur.shape, generator=gen, device=self.device)
            cur = cur + (2.0 * u - 1.0) * self.noise_scale_vec
        obs_full = torch.cat([state.obs_history.reshape(B, -1), cur], dim=-1)
        obs5 = self._streams(state, derived, obs_full)
        H = self.cfg.env.history_buffer_length
        new_hist = _where(
            state.episode_length <= 1,
            cur[:, None, :].expand(B, H, cur.shape[1]),
            torch.cat([state.obs_history[:, 1:], cur[:, None, :]], dim=1),
        )
        return state.replace(obs_history=new_hist), obs5
