"""Batched sampling MPC (MPPI) on the port's physics core, torch port of
legged_gym_custom_tpu/mpc/mppi.py.

Per solve, K perturbed action sequences of horizon H per robot are rolled
through the physics (all B*K rollouts batched in the (C, B*K) SoA layout),
exponentially weighted by trajectory cost (MPPI, Williams et al. 2017) and
averaged into a new nominal sequence, warm-started by shifting between
solves.  The stage costs are negated analogs of the go2 reward terms
(reference mppi.py:12-22): velocity tracking, terrain-relative base height,
orientation, action rate, torques, collisions on penalized links, the
phase-gait contact and foot-lift terms, and a gap cost for a loaded foot
over a deep hole.

Each horizon step is one `physics.control_step` on the rollout batch: on
CUDA tensors one launch of the fused kernel (K1 on the plane, K3 on a
heightfield, with each rollout's window cut by `patch.extract` inside the
step), on CPU tensors the eager step.  The solver builds its kernel spec once
from its own heightfield, so an MPPI over a course other than its env's
terrain runs the variant that course needs.

`solve` draws the noise from a `torch.Generator` and hands it to
`solve_with_noise`, which is deterministic: the tests feed it the JAX draw.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from legged_gym_custom_tpu_torch import physics as phys
from legged_gym_custom_tpu_torch.ops import fused_step
from legged_gym_custom_tpu_torch.physics import heightfield as hfield
from legged_gym_custom_tpu_torch.physics import soa
from legged_gym_custom_tpu_torch.physics.engine import DomainRandParams, PhysicsState
from legged_gym_custom_tpu_torch.utils.profiling import span


class MPPIConfig(NamedTuple):
    horizon: int = 12          # control steps (@50 Hz -> 0.24 s lookahead)
    num_samples: int = 32      # K rollouts per robot per solve
    temperature: float = 0.3   # lambda in the MPPI soft-min
    noise_sigma: float = 0.4   # action perturbation std (action units)
    smooth_beta: float = 0.6   # AR(1) smoothing of sampled noise along time
    # stage-cost weights (negated analogs of the go2 reward terms)
    w_tracking_lin: float = 3.0
    w_tracking_ang: float = 1.0
    w_height: float = 20.0     # terrain-RELATIVE base height error
    w_orientation: float = 5.0
    w_action_rate: float = 0.1
    w_torque: float = 1e-4
    w_collision: float = 5.0       # go2 collision scale -10 * rew -> cost
    w_phase_contact: float = 0.5   # go2 phase_contact_match 1.0
    w_foot_lift: float = 0.125     # go2 phase_foot_lifting 0.25
    w_gap: float = 10.0            # feet loaded over deep terrain (parkour)
    height_target: float = 0.30
    contact_force_thresh: float = 1.0   # [N] stance detection (go2.py:300)
    gap_depth: float = 0.3         # [m] terrain lower than this is a "hole"
    # gait clock (go2_config.py:18-22); phases advance along the horizon
    period: float = 0.45
    leg_offsets: tuple = (0.5, 0.0, 0.0, 0.5)   # [fl, fr, bl, br]


class MPCState(NamedTuple):
    nominal: torch.Tensor      # (B, H, A) warm-started action plan
    phase: torch.Tensor = 0.0  # () float32 global gait clock in [0, 1)


class CostStatics(NamedTuple):
    """Env-derived constants the stage costs need (SoA layouts)."""

    feet_link_ids: torch.Tensor       # (n_feet,) indices into link axes
    penalized_link_ids: torch.Tensor  # (n_pen,)
    max_foot_height: float
    percent_time_on_ground: float


def stage_cost(cfg: MPPIConfig, statics: CostStatics, hf, ph: PhysicsState, info, commands,
               actions, prev_actions, phases):
    """Negative-reward stage cost over one control step (SoA layout), in the
    reference's float32 order (mppi.py:79-140).

    ph leaves component-major (..., BK); commands (4, BK); actions (A, BK);
    info: physics StepInfo (link_forces/link_pos (n_links, 3, BK));
    phases (4, BK) per-leg gait phases in [0, 1).
    """
    R = soa.quat_to_matrix(ph.base_quat)
    base_lin = soa.mtv(R, ph.lin_vel)
    base_ang = soa.mtv(R, ph.ang_vel)
    g_b = -R[2]  # world -z in body coords: row 2 of R^T applied to -e_z
    c_track = cfg.w_tracking_lin * (
        torch.square(commands[0] - base_lin[0]) + torch.square(commands[1] - base_lin[1])
    )
    c_ang = cfg.w_tracking_ang * torch.square(commands[2] - base_ang[2])
    c_orient = cfg.w_orientation * (torch.square(g_b[0]) + torch.square(g_b[1]))
    c_rate = cfg.w_action_rate * torch.sum(torch.square(actions - prev_actions), dim=0)
    c_tau = cfg.w_torque * torch.sum(torch.square(info.torques), dim=0)

    # terrain-relative base height (legged_robot.py `_reward_base_height`)
    h_base = hfield.height_bilinear(hf, ph.base_pos[0], ph.base_pos[1])
    c_height = cfg.w_height * torch.square(ph.base_pos[2] - h_base - cfg.height_target)

    # collision: contact force on any penalized link (legged_robot.py:1100)
    f_pen = info.link_forces[statics.penalized_link_ids]      # (n_pen, 3, BK)
    pen_mag = torch.sqrt(torch.sum(f_pen * f_pen, dim=1))
    c_coll = cfg.w_collision * torch.sum(pen_mag > 0.1, dim=0).to(f_pen.dtype)

    # phase-gait terms (go2.py:621-678): stance when sin(2 pi phase) is below
    # the duty-cycle threshold
    stance_thresh = 2.0 * statics.percent_time_on_ground - 1.0
    stance = torch.sin(2.0 * math.pi * phases) <= stance_thresh   # (4, BK)
    feet_f = info.link_forces[statics.feet_link_ids]              # (4, 3, BK)
    contact = feet_f[:, 2] > cfg.contact_force_thresh             # (4, BK)
    match = ~(contact ^ stance)
    c_phase = cfg.w_phase_contact * torch.sum(torch.where(match, -0.25, 0.25), dim=0)

    feet_pos = info.link_pos[statics.feet_link_ids]               # (4, 3, BK)
    h_feet = hfield.height_bilinear(hf, feet_pos[:, 0], feet_pos[:, 1])
    lift = torch.clamp(feet_pos[:, 2] - h_feet, 0.0, statics.max_foot_height)
    lift = lift / statics.max_foot_height
    c_lift = cfg.w_foot_lift * torch.sum(torch.where(stance, lift, -lift), dim=0) / 2.0

    # scandot-style gap cost: a foot bearing load over a deep hole means the
    # plan steps into the gap (parkour go2.py:186-204 analog)
    in_hole = h_feet < -cfg.gap_depth
    c_gap = cfg.w_gap * torch.sum((contact & in_hole).to(h_feet.dtype), dim=0)

    return (
        c_track + c_ang + c_height + c_orient + c_rate + c_tau
        + c_coll + c_phase + c_lift + c_gap
    )


class MPPI:
    """Binds an env's physics statics, its heightfield and the kernel spec
    for that heightfield into a batched solver."""

    def __init__(self, env, cfg: MPPIConfig = MPPIConfig()):
        self.env = env
        self.cfg = cfg
        self.num_actions = env.num_actions
        self.device = env.device
        ids = lambda x: torch.as_tensor(x, dtype=torch.long, device=env.device)
        self.statics = CostStatics(
            feet_link_ids=ids(env.feet_ids),
            penalized_link_ids=ids(env.penalized_ids),
            max_foot_height=float(env.cfg.rewards.max_foot_height),
            percent_time_on_ground=float(env.cfg.rewards.percent_time_on_ground),
        )
        # The kernel's spec for this solver's own terrain, built once: K1 on
        # the plane, K3 with the contact window's size on a heightfield.  The
        # env's `fused_spec` is for the env's terrain, which a caller may
        # have swapped (an MPPI over a course on a flat env's statics).  None
        # where the env has the kernel off: the rollouts call the eager engine.
        self.hf = env.hf
        self.spec = fused_step.build_spec(
            env.ma, env.sim_params, env.pd, env.dof_limits,
            hf_K=phys.patch_K(self.hf, env.sim_params),
            hf_hs=0.0 if self.hf.is_plane else self.hf.horizontal_scale,
        ) if env.fused_kernel else None

    def init_state(self, batch: int) -> MPCState:
        return MPCState(
            nominal=torch.zeros((batch, self.cfg.horizon, self.num_actions), device=self.device),
            phase=torch.zeros((), dtype=torch.float32, device=self.device),
        )

    def _phase_schedule(self, phase0, BK):
        """Per-leg gait phases along the horizon, (H, 4, BK)."""
        cfg = self.cfg
        t = torch.arange(1, cfg.horizon + 1, dtype=torch.float32, device=self.device)
        base = torch.remainder(phase0 + t * self.env.dt / cfg.period, 1.0)           # (H,)
        offs = torch.tensor(cfg.leg_offsets, dtype=torch.float32, device=self.device)  # (4,)
        ph = torch.remainder(base[:, None] + offs[None, :], 1.0)                      # (H, 4)
        return ph[..., None].expand(cfg.horizon, 4, BK)

    def _rollout_costs(self, ph0, dr, commands, samples_soa, phase0):
        """Total costs of all B*K rollouts, (BK,).

        ph0/dr: component-major leaves with trailing batch BK, contiguous;
        commands (4, BK); samples_soa (H, A, BK) contiguous.  One control step
        per horizon step, carrying (state, previous actions) with zero
        previous actions at t = 0.
        """
        env, cfg = self.env, self.cfg
        phases_seq = self._phase_schedule(phase0, commands.shape[-1])
        ph, prev_a = ph0, torch.zeros_like(samples_soa[0])
        costs = []
        for t in range(cfg.horizon):
            actions = samples_soa[t]
            step = (env.ma, self.hf, env.sim_params, env.pd, dr, env.dof_limits, ph, actions)
            ph, info = (phys.control_step(*step, spec=self.spec) if self.spec is not None
                        else phys.eager_control_step(*step))
            with span("lgc.mppi.stage_cost"):
                costs.append(stage_cost(cfg, self.statics, self.hf, ph, info, commands, actions,
                                        prev_a, phases_seq[t]))
            prev_a = actions
        return torch.stack(costs).sum(dim=0)

    def draw_noise(self, gen: torch.Generator, batch: int) -> torch.Tensor:
        """The solve's action noise, (B, K, H, A) normals times sigma."""
        cfg = self.cfg
        shape = (batch, cfg.num_samples, cfg.horizon, self.num_actions)
        return torch.randn(shape, generator=gen, device=self.device) * cfg.noise_sigma

    def _samples(self, nominal, eps):
        """The nominal plan plus the noise AR(1)-smoothed along the horizon
        for coherent exploration, clipped to the action range; (B, K, H, A)."""
        cfg = self.cfg
        s = torch.zeros_like(eps[:, :, 0])
        smoothed = []
        for t in range(cfg.horizon):
            s = cfg.smooth_beta * s + (1 - cfg.smooth_beta) * eps[:, :, t]
            smoothed.append(s)
        samples = nominal[:, None] + torch.stack(smoothed, dim=2)
        clip_a = self.env.cfg.normalization.clip_actions
        return torch.clamp(samples, -clip_a, clip_a)

    def _rollout_batch(self, physics, dr, commands, samples):
        """A solve's SoA rollout batch, robots tiled K times (rollout b*K + k
        is robot b's sample k): (PhysicsState, DomainRandParams, commands
        (4, BK), samples (H, A, BK)), each leaf contiguous."""
        B, K, H, A = samples.shape
        to_soa = lambda x: torch.repeat_interleave(x, K, dim=0).movedim(0, -1).contiguous()
        return (PhysicsState(*[to_soa(x) for x in physics]),
                DomainRandParams(*[to_soa(x) for x in dr]), to_soa(commands),
                samples.reshape(B * K, H, A).movedim(0, -1).contiguous())

    def _update(self, mpc_state: MPCState, samples, costs):
        """Soft-min weights of the costs, the weighted plan, its first action,
        the one-step shift and the advanced gait clock."""
        cfg = self.cfg
        costs = torch.where(torch.isfinite(costs), costs, 1e9)
        beta = torch.min(costs, dim=1, keepdim=True).values
        w = torch.exp(-(costs - beta) / cfg.temperature)
        w = w / torch.sum(w, dim=1, keepdim=True)        # (B, K)
        nominal = torch.einsum("bk,bkha->bha", w, samples)
        shifted = torch.cat([nominal[:, 1:], nominal[:, -1:]], dim=1)
        next_phase = torch.remainder(mpc_state.phase + self.env.dt / cfg.period, 1.0)
        return nominal[:, 0], MPCState(nominal=shifted, phase=next_phase), torch.sum(w * costs, 1)

    def solve_with_noise(self, mpc_state: MPCState, physics, dr, commands, eps):
        """One MPPI solve for a batch of robots from the given noise.

        Args (batch-leading, as stored by the env): physics (B, ...)
        PhysicsState; dr (B, ...) DomainRandParams; commands (B, 4); eps
        (B, K, H, A) as `draw_noise` gives it.
        Returns (actions (B, A), new MPCState, expected cost (B,)).
        """
        phase = torch.as_tensor(mpc_state.phase, dtype=torch.float32, device=self.device)
        mpc_state = mpc_state._replace(phase=phase)
        samples = self._samples(mpc_state.nominal, eps)
        costs = self._rollout_costs(*self._rollout_batch(physics, dr, commands, samples), phase)
        return self._update(mpc_state, samples, costs.reshape(samples.shape[:2]))

    def solve(self, mpc_state: MPCState, physics, dr, commands, gen: torch.Generator):
        """`draw_noise` from `gen`, then `solve_with_noise`."""
        with span("lgc.mppi.solve"):
            eps = self.draw_noise(gen, commands.shape[0])
            return self.solve_with_noise(mpc_state, physics, dr, commands, eps)
