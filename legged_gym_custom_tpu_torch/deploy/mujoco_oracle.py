"""MuJoCo as the independent oracle of the control step: the drops of
tests/test_sim_parity.py on the go2 and go2_stiction tasks' own plants.

A PD-held robot at the default joint angles is dropped from 0.36 m onto the
plane under zero actions.  MuJoCo steps `RobotModel.to_mjcf(contact=True, ...)`
with the plant's joint damping, armature and frictionloss (resolved in its
constraint solver) at 200 Hz, the PD law applied as `qfrc_applied`, four
steps a control step; the engine runs `physics.control_step` with the task's
SimParams, PDParams and kernel spec, so that on the card the drop goes through
the same kernel build as the task (K1 for go2, K2 stiction for go2_stiction),
or through the eager engine where the task's env has the kernel off.

Two drops, with the gates of tests/test_sim_parity.py:
  * full plant (go2, :100): FULL_PLANT_STEPS control steps; settled base
    height within 1 cm (mean of the last 25 steps), final joints within
    0.05 rad, height transient within 2 cm, xy drift under 5 cm in both;
  * rest stiction (go2_stiction against go2's tanh surrogate, :232):
    REST_STEPS control steps; implicit joints within 0.02 rad of MuJoCo,
    strictly closer than tanh, and at rest (|qd| < 0.05 rad/s).
Both start from the same state, so one MuJoCo run of REST_STEPS control steps
holds both: the full plant's is its first FULL_PLANT_STEPS.

The MuJoCo side is stored in ORACLE_PATH so that a machine without MuJoCo
holds the card's kernels to it; `mujoco` is imported inside the functions
that step it.  `mj_step` is deterministic at one MuJoCo version: the stored
file records its version, and tests/test_torch_sim_parity.py holds it to a
fresh run.  Regenerate it with

    python -m legged_gym_custom_tpu_torch.deploy.mujoco_oracle
"""
from __future__ import annotations

import os

import numpy as np
import torch

ORACLE_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "resources", "oracle", "mujoco_drops_synthetic_go2.npz")
Z0 = 0.36
FULL_PLANT_STEPS = 100
REST_STEPS = 150
SETTLE_STEPS = 25
FULL_PLANT_GATES = dict(settle_z=0.01, joints=0.05, transient_z=0.02, xy_drift=0.05)
REST_GATES = dict(joints=0.02, rest_qd=0.05)


def task_env(task: str, num_envs: int, device):
    """The task's env (its plant: model, SimParams, PDParams, kernel spec)."""
    from ..envs import task_registry

    env_cfg, _ = task_registry.get_cfgs(task)
    env_cfg.env.num_envs = num_envs
    return task_registry.make_env(task, env_cfg=env_cfg, device=device)[0]


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, np.float64)


def mujoco_drop(env, steps: int = REST_STEPS, z0: float = Z0):
    """MuJoCo's drop on `env`'s plant: (qpos (steps, 7 + ndof), qvel (steps,
    6 + ndof)) after each control step."""
    import mujoco

    sp, pd = env.sim_params, env.pd
    per_dof = lambda x: 0.0 if x is None else _np(x)
    mjm = mujoco.MjModel.from_xml_string(env.model.to_mjcf(
        contact=True, friction=sp.contact.terrain_friction, timestep=sp.dt,
        joint_damping=per_dof(sp.dof_damping), joint_armature=per_dof(sp.dof_armature),
        joint_frictionloss=per_dof(sp.dof_frictionloss)))
    mjd = mujoco.MjData(mjm)
    kp, kd = _np(pd.p_gains), _np(pd.d_gains)
    default, limit = _np(pd.default_dof_pos), _np(pd.torque_limits)
    mjd.qpos[:3] = [0.0, 0.0, z0]
    mjd.qpos[3:7] = [1.0, 0.0, 0.0, 0.0]
    mjd.qpos[7:] = default
    qpos, qvel = [], []
    for _ in range(steps):
        for _ in range(sp.decimation):
            tau = kp * (default - mjd.qpos[7:]) - kd * mjd.qvel[6:]
            mjd.qfrc_applied[:] = 0.0
            mjd.qfrc_applied[6:] = np.clip(tau, -limit, limit)
            mujoco.mj_step(mjm, mjd)
        qpos.append(mjd.qpos.copy())
        qvel.append(mjd.qvel.copy())
    return np.asarray(qpos), np.asarray(qvel)


def engine_drop(env, num_envs: int, steps: int = REST_STEPS, z0: float = Z0):
    """The same drop through `physics.control_step` on `num_envs` identical
    copies, on the env's device with its spec: (base_pos (steps, 3, B),
    dof_pos (steps, ndof, B), final dof_vel (ndof, B)) as numpy float64."""
    from .. import physics as phys

    dev, B = env.device, num_envs
    full = lambda rows: torch.tensor(rows, dtype=torch.float32, device=dev)[:, None] \
        .repeat(1, B).contiguous()
    n = env.model.num_dof
    st = phys.PhysicsState(
        base_pos=full([0.0, 0.0, z0]), base_quat=full([1.0, 0.0, 0.0, 0.0]),
        lin_vel=full([0.0] * 3), ang_vel=full([0.0] * 3),
        dof_pos=env.pd.default_dof_pos[:, None].repeat(1, B).contiguous(),
        dof_vel=full([0.0] * n))
    dr = phys.DomainRandParams(
        friction=torch.ones(B, device=dev), added_mass=torch.zeros(B, device=dev),
        com_offset=full([0.0] * 3), kp_mult=full([1.0] * n), kd_mult=full([1.0] * n))
    actions = full([0.0] * n)
    pos, q = [], []
    for _ in range(steps):
        st, _ = phys.control_step(env.ma, env.hf, env.sim_params, env.pd, dr, env.dof_limits,
                                  st, actions, spec=env.fused_spec)
        st = phys.PhysicsState(*[x.contiguous() for x in st])
        pos.append(st.base_pos)
        q.append(st.dof_pos)
    return _np(torch.stack(pos)), _np(torch.stack(q)), _np(st.dof_vel)


def full_plant_gaps(base_pos, dof_pos, mj_qpos) -> dict:
    """tests/test_sim_parity.py:174-180 on env 0 of an `engine_drop` against
    MuJoCo's qpos: each gap beside its gate, and `ok`."""
    n = FULL_PLANT_STEPS
    z, z_mj = base_pos[:n, 2, 0], mj_qpos[:n, 2]
    gaps = dict(
        settle_z=abs(z[-SETTLE_STEPS:].mean() - z_mj[-SETTLE_STEPS:].mean()),
        joints=float(np.abs(dof_pos[n - 1, :, 0] - mj_qpos[n - 1, 7:]).max()),
        transient_z=float(np.abs(z - z_mj).max()),
        xy_drift=float(max(np.linalg.norm(base_pos[n - 1, :2, 0]),
                           np.linalg.norm(mj_qpos[n - 1, :2]))))
    gaps["ok"] = all(gaps[k] < FULL_PLANT_GATES[k] for k in FULL_PLANT_GATES)
    return gaps


def rest_stiction_gaps(q_implicit, qd_implicit, q_tanh, mj_qpos) -> dict:
    """tests/test_sim_parity.py:291-301 on final joint angles (ndof,) after
    REST_STEPS: implicit against MuJoCo, tanh against MuJoCo, implicit rest
    velocity; each beside its gate, and `ok`."""
    q_mj = mj_qpos[REST_STEPS - 1, 7:]
    gaps = dict(joints=float(np.abs(q_implicit - q_mj).max()),
                joints_tanh=float(np.abs(q_tanh - q_mj).max()),
                rest_qd=float(np.abs(qd_implicit).max()))
    gaps["ok"] = (gaps["joints"] < REST_GATES["joints"] and gaps["joints"] < gaps["joints_tanh"]
                  and gaps["rest_qd"] < REST_GATES["rest_qd"])
    return gaps


def write_oracle() -> str:
    """Run MuJoCo's drop on go2's plant (the same MJCF as go2_stiction's: the
    tasks differ only in how the engine resolves frictionloss) on the CPU and
    store it in ORACLE_PATH with the MuJoCo version."""
    import mujoco

    qpos, qvel = mujoco_drop(task_env("go2", 1, "cpu"))
    os.makedirs(os.path.dirname(ORACLE_PATH), exist_ok=True)
    np.savez(ORACLE_PATH, qpos=qpos, qvel=qvel, z0=Z0, mujoco_version=mujoco.__version__)
    return ORACLE_PATH


def load_oracle() -> dict:
    with np.load(ORACLE_PATH) as data:
        return {k: data[k] for k in data.files}


if __name__ == "__main__":
    print(write_oracle())
