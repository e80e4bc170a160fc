"""The fused control step's second model: a small tree of unequal, forking
branches (tests/torch_test_tree.urdf), with the go2 plant.  No task runs it;
the CPU tests, the card tests and `chip_smoke.py` check the kernel and its
lane plan on it, because it has what a quadruped lacks: padded slots, an empty
lane, parents that differ between lanes and a dense joint rotation.

Also the batches of the other robots' builds (`robot_batch`): each robot at
its own standing height, on its env's plane or terrain.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from legged_gym_custom_tpu_torch import physics as phys
from legged_gym_custom_tpu_torch.envs import task_registry
from legged_gym_custom_tpu_torch.ops import fused_step

TEST_TREE_URDF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_test_tree.urdf")

DEFAULT_ANGLES = np.array([0.2, 0.5, -0.3, 0.1, 0.8, -1.5, -0.2])


def robot_urdf_and_angles(task: str):
    """(URDF path, default joint angles in the URDF's dof order, base heights
    for `model_batch`: up to 5 cm below the config's spawn height, where the
    feet touch) of a task's robot, from its config."""
    cfg, _ = task_registry.get_cfgs(task)
    model = phys.load_urdf(cfg.asset.file, task)
    z0 = cfg.init_state.pos[2]
    return cfg.asset.file, np.array([cfg.init_state.default_joint_angles[d]
                                     for d in model.dof_names]), (z0 - 0.05, z0)


def plant_spec(urdf: str, default_angles, hf_K: int = 0, hf_hs: float = 0.0,
               control_type: str = "P", implicit_stiction: bool = False) -> fused_step.FusedSpec:
    """A URDF's FusedSpec on the go2 plant: stiff contact, 4 x 4 substeps,
    joint damping 0.1, armature 0.01, frictionloss 0.2 (a tanh torque, or
    resolved implicitly); PD gains 40 / 1, action scale 0.25 ('T': 5)."""
    model = phys.load_urdf(urdf, "model")
    ma = phys.model_arrays(model)
    ndof = model.num_dof
    default_angles = np.asarray(default_angles, np.float64)
    full = lambda v: torch.full((ndof,), v)
    params = phys.SimParams(
        substeps=4,
        contact=phys.ContactParams(stiffness=40000.0, damping=250.0, friction_vel=250.0,
                                   terrain_friction=1.0),
        dof_damping=full(0.1), dof_armature=full(0.01), dof_frictionloss=full(0.2),
        frictionloss_implicit=implicit_stiction,
    )
    if implicit_stiction:
        params = params._replace(dof_meff=phys.effective_joint_inertia(
            ma, default_angles.astype(np.float32), armature=params.dof_armature))
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    pd = phys.PDParams(full(40.0), full(1.0), f32(default_angles), f32(model.dof_effort_limits),
                       5.0 if control_type == "T" else 0.25, control_type=control_type)
    limits = (f32(model.dof_pos_limits[:, 0]), f32(model.dof_pos_limits[:, 1]),
              f32(model.dof_vel_limits))
    return fused_step.build_spec(ma, params, pd, limits, hf_K=hf_K, hf_hs=hf_hs)


def tree_spec(hf_K: int = 0, hf_hs: float = 0.0, control_type: str = "P",
              implicit_stiction: bool = False) -> fused_step.FusedSpec:
    """The test tree's FusedSpec on the go2 plant."""
    return plant_spec(TEST_TREE_URDF, DEFAULT_ANGLES, hf_K, hf_hs, control_type,
                      implicit_stiction)


def tree_batch(seed: int, B: int, device="cpu", dtype=torch.float32):
    return model_batch(seed, B, DEFAULT_ANGLES, device, dtype)


def model_batch(seed: int, B: int, default_angles, device="cpu", dtype=torch.float32,
                base_z=(0.15, 0.35)):
    """A seeded (C, B) batch around `default_angles`, the base at a height
    drawn from `base_z`, low enough over z = 0 that some spheres touch:
    (state, actions, dr)."""
    rng = np.random.default_rng(seed)
    default_angles = np.asarray(default_angles, np.float64)
    ndof = len(default_angles)
    quat = rng.normal(size=(4, B)) * 0.1 + np.array([1.0, 0, 0, 0])[:, None]
    quat /= np.linalg.norm(quat, axis=0, keepdims=True)
    state = [
        np.concatenate([rng.uniform(-1, 1, (2, B)), rng.uniform(*base_z, (1, B))]),
        quat, rng.normal(size=(3, B)) * 0.5, rng.normal(size=(3, B)) * 0.5,
        default_angles[:, None] + rng.normal(size=(ndof, B)) * 0.2,
        rng.normal(size=(ndof, B)) * 2.0,
    ]
    dr = [rng.uniform(0.5, 1.25, B), rng.uniform(-0.5, 0.5, B), rng.normal(size=(3, B)) * 0.01,
          np.full((ndof, B), 1.05), np.full((ndof, B), 0.95)]
    actions = np.clip(rng.normal(size=(ndof, B)), -3.14, 3.14)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return tuple(map(t, state)), t(actions), tuple(map(t, dr))


def tree_terrain(seed: int, state, K: int, hs: float):
    """A bumpy (B, K, K) window under each base, centred on it:
    (patch, xoff, yoff) as `fused_step.patch_inputs` lays them out."""
    pos = state[0]
    B = pos.shape[-1]
    rng = np.random.default_rng(seed)
    patch = torch.as_tensor(rng.normal(size=(B, K, K)) * 0.03 + 0.05, dtype=pos.dtype,
                            device=pos.device)
    half = 0.5 * (K - 1) * hs
    return patch.contiguous(), (pos[0] - half).contiguous(), (pos[1] - half).contiguous()


def feature_cells(env, min_step: float = 0.05) -> np.ndarray:
    """World (x, y) of the terrain cells whose height differs from a
    neighbour's by at least `min_step` metres: stair and box edges, slope
    breaks (the rough courses' features)."""
    t = env.cfg.terrain
    h = env.terrain.height_field_raw.astype(np.float64) * t.vertical_scale
    step = np.zeros_like(h)
    step[:-1] = np.maximum(step[:-1], np.abs(np.diff(h, axis=0)))
    step[:, :-1] = np.maximum(step[:, :-1], np.abs(np.diff(h, axis=1)))
    border = int(t.border_size / t.horizontal_scale)
    step[:border] = step[-border:] = 0.0
    step[:, :border] = step[:, -border:] = 0.0
    i, j = np.nonzero(step >= min_step)
    return np.stack([i, j], axis=1) * t.horizontal_scale - t.border_size


def robot_batch(env, seed: int, B: int = None, device="cpu"):
    """A seeded (C, B) batch of a task env's robot around its default angles,
    each base 0-5 cm below the config's spawn height over the ground under
    it (where the feet touch): on the plane over x, y in [-1, 1]; on a
    heightfield over the courses, a quarter of them within 0.3 m of a
    terrain feature (`feature_cells`), with each env's contact window as
    the engine cuts it.  Returns (state, actions, dr[, terrain])."""
    B = env.num_envs if B is None else B
    z0 = env.cfg.init_state.pos[2]
    state, actions, dr = model_batch(seed, B, env.default_dof_pos.cpu().numpy(), device,
                                     base_z=(z0 - 0.05, z0))
    if env.hf.is_plane:
        return state, actions, dr
    from legged_gym_custom_tpu_torch.physics import patch

    rng = np.random.default_rng(seed + 1)
    t = env.cfg.terrain
    x = rng.uniform(0.5, t.num_rows * t.terrain_length - 0.5, B)
    y = rng.uniform(0.5, t.num_cols * t.terrain_width - 0.5, B)
    cells = feature_cells(env)
    near = cells[rng.integers(0, len(cells), B // 4)] + rng.uniform(-0.3, 0.3, (B // 4, 2))
    x[: B // 4], y[: B // 4] = near[:, 0], near[:, 1]
    xy = torch.as_tensor(np.stack([x, y]), dtype=torch.float32, device=device)
    ground = phys.height_bilinear(env.hf, xy[0], xy[1])
    pos = torch.cat([xy, (ground + state[0][2])[None]]).contiguous()
    window = fused_step.patch_inputs(patch.extract(env.hf, pos[0], pos[1], env.fused_spec.hf_K))
    return (pos, *state[1:]), actions, dr, window
