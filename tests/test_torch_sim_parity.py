"""Sim-to-sim parity of the port's control step against MuJoCo, on the CPU.

The plants of tests/test_sim_parity.py through the port's plain
`physics.control_step` on the synthetic Go2, against MuJoCo on
`RobotModel.to_mjcf(contact=True, ...)`, at that file's gates:
  * the standing PD drop (:23) on the default SimParams: settled height
    within 2 cm, joints within 0.1 rad, transient within 4 cm, xy drift
    under 5 cm;
  * the full plant (:100) on the go2 task's own plant (stiff contact, 4
    substeps, joint damping 0.1, armature 0.01, tanh frictionloss 0.2):
    settle within 1 cm, joints within 0.05 rad, transient within 2 cm;
  * rest stiction (:232) on the go2_stiction task's plant against go2's tanh
    surrogate: joints within 0.02 rad of MuJoCo, strictly closer than tanh,
    at rest.
The gates and both drops live in deploy/mujoco_oracle.py, which chip_smoke.py
runs on the card's kernels against the committed MuJoCo trajectory; the last
test holds that file to a fresh MuJoCo run to 1e-9 (it is tied to MuJoCo
3.10.0, where `mj_step` is deterministic).
"""
import types

import mujoco
import numpy as np
import pytest
import torch

from legged_gym_custom_tpu_torch import physics as tphys
from legged_gym_custom_tpu_torch.deploy import mujoco_oracle as oracle


@pytest.fixture(scope="module")
def drops():
    """Both tasks' engine drops on one env each, and MuJoCo's, REST_STEPS long."""
    torch.set_num_threads(1)
    envs = {task: oracle.task_env(task, 1, "cpu") for task in ("go2", "go2_stiction")}
    engine = {task: oracle.engine_drop(env, 1) for task, env in envs.items()}
    mj_qpos, mj_qvel = oracle.mujoco_drop(envs["go2"])
    return envs, engine, mj_qpos, mj_qvel


def test_standing_parity_vs_mujoco(drops):
    """The standing PD drop on the default SimParams (no joint dynamics, the
    default contact, 2 substeps) from 0.33 m, 75 control steps."""
    envs = drops[0]
    plant = types.SimpleNamespace(**vars(envs["go2"]))
    plant.sim_params, plant.fused_spec = tphys.SimParams(), None
    pos, q, _ = oracle.engine_drop(plant, 1, steps=75, z0=0.33)
    mj_qpos, _ = oracle.mujoco_drop(plant, steps=75, z0=0.33)
    z, z_mj = pos[:, 2, 0], mj_qpos[:, 2]
    assert abs(z[-25:].mean() - z_mj[-25:].mean()) < 0.02, (z[-25:].mean(), z_mj[-25:].mean())
    np.testing.assert_allclose(q[-1, :, 0], mj_qpos[-1, 7:], atol=0.1)
    assert np.max(np.abs(z - z_mj)) < 0.04
    assert np.linalg.norm(pos[-1, :2, 0]) < 0.05
    assert np.linalg.norm(mj_qpos[-1, :2]) < 0.05


def test_full_plant_parity(drops):
    _, engine, mj_qpos, _ = drops
    pos, q, _ = engine["go2"]
    gaps = oracle.full_plant_gaps(pos, q, mj_qpos)
    for key, gate in oracle.FULL_PLANT_GATES.items():
        assert gaps[key] < gate, (key, gaps)
    assert gaps["ok"]


def test_rest_stiction_vs_mujoco(drops):
    """Implicit Coulomb stiction settles to MuJoCo's pose (constraint-based
    frictionloss carries part of the load at rest), strictly closer than the
    tanh surrogate, and truly at rest."""
    _, engine, mj_qpos, _ = drops
    _, q_imp, qd_imp = engine["go2_stiction"]
    _, q_tanh, _ = engine["go2"]
    gaps = oracle.rest_stiction_gaps(q_imp[-1, :, 0], qd_imp[:, 0], q_tanh[-1, :, 0], mj_qpos)
    assert gaps["joints"] < oracle.REST_GATES["joints"], gaps
    assert gaps["joints"] < gaps["joints_tanh"], gaps
    assert gaps["rest_qd"] < oracle.REST_GATES["rest_qd"], gaps
    assert gaps["ok"]


def test_stored_oracle_matches_fresh_mujoco(drops):
    """The committed MuJoCo trajectory that chip_smoke.py holds the card's
    kernels to equals a fresh run to 1e-9, and gives the same gaps as the
    fresh run.  It was written by MuJoCo 3.10.0 (`python -m
    legged_gym_custom_tpu_torch.deploy.mujoco_oracle` rewrites it)."""
    _, engine, mj_qpos, mj_qvel = drops
    stored = oracle.load_oracle()
    assert str(stored["mujoco_version"]) == mujoco.__version__ == "3.10.0"
    assert float(stored["z0"]) == oracle.Z0
    assert stored["qpos"].shape == (oracle.REST_STEPS, 19)
    np.testing.assert_allclose(stored["qpos"], mj_qpos, rtol=0, atol=1e-9)
    np.testing.assert_allclose(stored["qvel"], mj_qvel, rtol=0, atol=1e-9)
    pos, q, _ = engine["go2"]
    assert oracle.full_plant_gaps(pos, q, stored["qpos"]) == pytest.approx(
        oracle.full_plant_gaps(pos, q, mj_qpos), abs=1e-8)
