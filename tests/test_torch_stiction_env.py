"""Parity of the PyTorch port's `go2_stiction` env with the JAX reference on
the CPU: `reset_all` and 3 steps with the same injected random draws, as
tests/test_torch_env.py does for `go2` (same tolerances: float32 physics over
4 control steps propagated through the obs scales and reward terms).  The
plant resolves joint frictionloss implicitly, with the effective joint
inertias each env computes at the default angles.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from legged_gym_custom_tpu.envs.go2_config import Go2StictionCfg as JGo2StictionCfg
from legged_gym_custom_tpu.envs.go2_env import Go2Env as JGo2Env
from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch.envs import Go2Env, Go2StictionCfg, Go2StictionCfgPPO, task_registry
from legged_gym_custom_tpu_torch.physics.engine import PhysicsState
from test_torch_env import (OBS_TOL, REW_TOL, STREAMS, _cfg, _close, _draws, _inject_jax,
                            _inject_torch)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny, so one thread is faster than many, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_go2_stiction_is_registered_with_the_reference_config():
    assert task_registry.task_classes["go2_stiction"] is Go2Env
    cfg, train_cfg = task_registry.get_cfgs("go2_stiction")
    assert isinstance(cfg, Go2StictionCfg) and isinstance(train_cfg, Go2StictionCfgPPO)
    ref = JGo2StictionCfg()
    assert cfg.sim.joint_frictionloss_implicit is True is ref.sim.joint_frictionloss_implicit
    for key in ("substeps", "joint_damping", "joint_armature", "joint_frictionloss",
                "contact_stiffness", "contact_damping", "contact_friction_vel"):
        assert getattr(cfg.sim, key) == getattr(ref.sim, key), key
    assert (cfg.env.num_envs, cfg.env.num_observations, cfg.env.num_privileged_obs,
            cfg.env.num_critic_obs, cfg.env.num_estimated_obs, cfg.env.num_scan_obs) == \
        (4096, 572, 29, 736, 3, 132)
    assert train_cfg.runner.run_name == "go2_stiction"


def test_go2_stiction_reset_and_steps_match_reference():
    dr, phys, cmds, actions = _draws()
    env_j = JGo2Env(_cfg(JGo2StictionCfg), SYNTHETIC_GO2_URDF, name="go2_stiction")
    env_t = Go2Env(_cfg(Go2StictionCfg), SYNTHETIC_GO2_URDF, name="go2_stiction", device="cpu")
    _inject_jax(env_j, dr, phys, cmds)
    _inject_torch(env_t, dr, phys, cmds)

    # the plant: implicit stiction with the effective inertias at the default angles
    assert env_t.sim_params.frictionloss_implicit and env_j.sim_params.frictionloss_implicit
    np.testing.assert_allclose(env_t.sim_params.dof_meff.numpy(),
                               np.asarray(env_j.sim_params.dof_meff), rtol=1e-4)
    spec = env_t.fused_spec
    assert spec.control_type == "P" and spec.hf_K == 0 and len(spec.fl_dqd) == 12
    fl_dqd = 0.2 * (0.005 / 4) / np.asarray(env_j.sim_params.dof_meff)
    np.testing.assert_allclose(spec.fl_dqd, fl_dqd, rtol=1e-4)

    st_j, obs_j = env_j.reset_all(jax.random.PRNGKey(0))
    st_t, obs_t = env_t.reset_all(torch.Generator().manual_seed(0))
    for name in STREAMS:
        _close(getattr(obs_t, name), getattr(obs_j, name), OBS_TOL, f"reset {name}")

    step_j = jax.jit(env_j.step)
    for i, a in enumerate(actions):
        st_j, obs_j, rew_j, done_j, info_j = step_j(st_j, jnp.asarray(a))
        st_t, obs_t, rew_t, done_t, info_t = env_t.step(st_t, torch.as_tensor(a))
        for name in STREAMS:
            _close(getattr(obs_t, name), getattr(obs_j, name), OBS_TOL, f"step {i} {name}")
        _close(rew_t, rew_j, REW_TOL, f"step {i} rewards")
        _close(st_t.episode_sums, st_j.episode_sums, REW_TOL, f"step {i} episode sums")
        np.testing.assert_array_equal(done_t.numpy(), np.asarray(done_j))
        for name, a_t, a_j in zip(PhysicsState._fields, st_t.physics, st_j.physics):
            _close(a_t, a_j, OBS_TOL, f"step {i} {name}")
