"""Parity of the PyTorch port's go2 env with the JAX reference on the CPU.

Both envs run the flat `go2` task on the synthetic Go2-shaped URDF at a few
envs, with observation noise and pushes off.  JAX keys and torch
generators give different numbers, so the random draws (domain
randomization, reset states, commands) are injected: both envs' sampling
hooks are replaced, on the instances, by the same seeded numpy values.  One
env starts upside down, so it terminates and takes the masked reset path on
every step.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from legged_gym_custom_tpu.envs.go2_config import Go2Cfg as JGo2Cfg
from legged_gym_custom_tpu.envs.go2_env import Go2Env as JGo2Env
from legged_gym_custom_tpu.physics.engine import DomainRandParams as JDR
from legged_gym_custom_tpu.physics.engine import PhysicsState as JPS
from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch.envs import Go2Cfg, Go2Env, task_registry
from legged_gym_custom_tpu_torch.physics.engine import DomainRandParams, PhysicsState

B = 6
STREAMS = ("obs", "privileged", "critic", "estimated", "scan")
# obs, rewards and episode sums: float32 physics over 4 control steps
# (the engine parity of tests/test_torch_physics.py) propagated through the
# obs scales and reward terms
OBS_TOL = dict(atol=2e-3, rtol=1e-3)
REW_TOL = dict(atol=1e-4, rtol=1e-3)


def _cfg(cfg_cls):
    cfg = cfg_cls()
    cfg.env.num_envs = B
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.rewards.only_positive_rewards = False   # compare the raw sums
    return cfg


def _draws():
    rng = np.random.default_rng(0)
    f = lambda a: np.asarray(a, np.float32)
    dr = dict(friction=f(rng.uniform(0.3, 1.2, B)), added_mass=f(rng.uniform(0, 3, B)),
              com_offset=f(rng.uniform(-0.15, 0.15, (B, 3))),
              kp_mult=f(rng.uniform(0.8, 1.2, (B, 12))), kd_mult=f(rng.uniform(0.8, 1.2, (B, 12))))
    quat = np.tile([1.0, 0.0, 0.0, 0.0], (B, 1))
    quat[0] = [0.0, 1.0, 0.0, 0.0]  # upside down: terminates every step
    phys = dict(quat=f(quat), dof_off=f(rng.uniform(0, 0.9, (B, 12))),
                lin=f(rng.uniform(-0.5, 0.5, (B, 3))), ang=f(rng.uniform(-0.5, 0.5, (B, 3))))
    cmds = f(np.concatenate([rng.uniform(-1, 1, (B, 1)), rng.uniform(-0.75, 0.75, (B, 1)),
                             rng.uniform(-1, 1, (B, 1)), np.zeros((B, 1))], axis=1))
    actions = [f(rng.normal(size=(B, 12)) * 0.5) for _ in range(3)]
    return dr, phys, cmds, actions


def _inject_jax(env, dr, phys, cmds):
    env._sample_dr = lambda key: JDR(**{k: jnp.asarray(v) for k, v in dr.items()})
    env._sample_reset_physics = lambda state, key, origins: JPS(
        base_pos=env.base_init["pos"] + origins, base_quat=jnp.asarray(phys["quat"]),
        lin_vel=jnp.asarray(phys["lin"]), ang_vel=jnp.asarray(phys["ang"]),
        dof_pos=env.default_dof_pos + phys["dof_off"], dof_vel=jnp.zeros((B, 12)))
    env._resample_commands = lambda state, key, mask: jnp.where(
        mask[:, None], jnp.asarray(cmds), state.commands)


def _inject_torch(env, dr, phys, cmds):
    T = torch.as_tensor
    env._sample_dr = lambda gen: DomainRandParams(**{k: T(v) for k, v in dr.items()})
    env._sample_reset_physics = lambda state, gen, origins: PhysicsState(
        base_pos=env.base_init["pos"] + origins, base_quat=T(phys["quat"]),
        lin_vel=T(phys["lin"]), ang_vel=T(phys["ang"]),
        dof_pos=env.default_dof_pos + T(phys["dof_off"]), dof_vel=torch.zeros((B, 12)))
    env._resample_commands = lambda state, gen, mask: torch.where(
        mask[:, None], T(cmds), state.commands)


def _close(got, ref, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               err_msg=what, **tol)


def test_go2_reset_and_steps_match_reference():
    dr, phys, cmds, actions = _draws()
    env_j = JGo2Env(_cfg(JGo2Cfg), SYNTHETIC_GO2_URDF, name="go2")
    env_t = Go2Env(_cfg(Go2Cfg), SYNTHETIC_GO2_URDF, name="go2", device="cpu")
    _inject_jax(env_j, dr, phys, cmds)
    _inject_torch(env_t, dr, phys, cmds)
    assert env_t.reward_names == env_j.reward_names
    np.testing.assert_array_equal(env_t.noise_scale_vec.numpy(), np.asarray(env_j.noise_scale_vec))

    st_j, obs_j = env_j.reset_all(jax.random.PRNGKey(0))
    st_t, obs_t = env_t.reset_all(torch.Generator().manual_seed(0))
    for name in STREAMS:
        _close(getattr(obs_t, name), getattr(obs_j, name), OBS_TOL, f"reset {name}")

    step_j = jax.jit(env_j.step)
    resets = 0
    for i, a in enumerate(actions):
        st_j, obs_j, rew_j, done_j, info_j = step_j(st_j, jnp.asarray(a))
        st_t, obs_t, rew_t, done_t, info_t = env_t.step(st_t, torch.as_tensor(a))
        for name in STREAMS:
            _close(getattr(obs_t, name), getattr(obs_j, name), OBS_TOL, f"step {i} {name}")
        _close(rew_t, rew_j, REW_TOL, f"step {i} rewards")
        _close(st_t.episode_sums, st_j.episode_sums, REW_TOL, f"step {i} episode sums")
        _close(info_t["episode_contrib"], info_j["episode_contrib"], REW_TOL, f"step {i} contrib")
        np.testing.assert_array_equal(done_t.numpy(), np.asarray(done_j))
        np.testing.assert_array_equal(info_t["time_outs"].numpy(), np.asarray(info_j["time_outs"]))
        for name, a_t, a_j in zip(PhysicsState._fields, st_t.physics, st_j.physics):
            _close(a_t, a_j, OBS_TOL, f"step {i} {name}")
        resets += int(done_t.sum())
    assert resets >= 3  # the upside-down env took the reset path every step


def test_go2_env_raises_for_what_is_not_ported():
    """Nothing of the go2 configs raises any more: the command curriculum and
    the progress-stall termination build, and `use_actuator_network` on a
    Go2Env is ignored as in the JAX package (only AnymalEnv builds a torque
    function; the base hook keeps the PD law)."""
    cfg = _cfg(Go2Cfg)
    cfg.commands.curriculum = True

    class termination:
        stall_time_s = 2.0

    cfg.termination = termination()
    env = Go2Env(cfg, SYNTHETIC_GO2_URDF, device="cpu")
    assert env.stall_time_s == 2.0 and env.cfg.commands.curriculum
    cfg = _cfg(Go2Cfg)
    cfg.control.use_actuator_network = True
    env = Go2Env(cfg, SYNTHETIC_GO2_URDF, device="cpu")
    assert env._torque_fn is None
    cfg_j = _cfg(JGo2Cfg)
    cfg_j.control.use_actuator_network = True
    assert JGo2Env(cfg_j, SYNTHETIC_GO2_URDF, name="go2")._torque_fn is None


def test_env_entry_point_defaults_to_cuda(monkeypatch):
    """make_env runs on the card unless asked for the CPU, and raises rather
    than drifting to the CPU when no card is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = task_registry.get_cfgs("go2")
    cfg.env.num_envs = 2
    with pytest.raises(RuntimeError, match="CUDA"):
        task_registry.make_env("go2", env_cfg=cfg)
    env, _ = task_registry.make_env("go2", env_cfg=cfg, device="cpu")
    assert env.device.type == "cpu"
