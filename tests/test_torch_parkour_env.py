"""Parity of the PyTorch port's go2_parkour env with the JAX reference on
the CPU: a reset and 3 steps on heightfield terrain.

Both envs build go2_parkour's gap-course curriculum from the same terrain
seed, cut to 3 x 2 courses (the full config has 12 x 20), on the synthetic
Go2-shaped URDF, with observation noise and pushes off.  The random draws
(initial terrain levels, domain randomization, reset states, commands) are
injected as in tests/test_torch_env.py.  The envs are placed so that every
terrain path fires:
  0  on level 1 just before a 0.2 m gap: the scandots see it (jump flag);
  1  on level 1 with its feet over a gap edge (wall contact);
  2  in the 2 m deep trench between two courses, below z = -1 with no
     command: the parkour hole termination fires on every step and the
     curriculum keeps its level;
  3  on level 0 (its 0.1 m gaps round to zero cells);
  4  on level 1 straddling a gap;
  5  upside down on level 1 with a command: resets every step and the
     curriculum moves it down to level 0;
  6  2.5 m from its origin at the episode's last step: times out once and
     the curriculum moves it up to level 2 (it covered > 0.6 of a course);
  7  on level 1.
"""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from legged_gym_custom_tpu.envs.go2_parkour_config import Go2ParkourCfg as JParkourCfg
from legged_gym_custom_tpu.envs.go2_env import Go2Env as JGo2Env
from legged_gym_custom_tpu.physics.engine import DomainRandParams as JDR
from legged_gym_custom_tpu.physics.engine import PhysicsState as JPS
from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch.envs import Go2Env, Go2ParkourCfg
from legged_gym_custom_tpu_torch.envs.base_env import terrain_types
from legged_gym_custom_tpu_torch.physics.engine import DomainRandParams, PhysicsState

B = 8
STREAMS = ("obs", "privileged", "critic", "estimated", "scan")
# float32 physics over 4 control steps on the heightfield, through the obs
# scales and reward terms (as tests/test_torch_env.py)
OBS_TOL = dict(atol=2e-3, rtol=1e-3)
REW_TOL = dict(atol=1e-4, rtol=1e-3)
LEVELS = np.array([1, 1, 1, 0, 1, 1, 1, 1])
# spawn offsets from base_init pos (2, 0, 0.5) + origin (28 * level, 5 + 10 * type, 0)
OFFSETS = np.array([
    [2.0, 0.3, 0.0],     # x = 32.0: the gap at [32.9, 33.1) is in the scandots
    [2.85, -0.2, 0.0],   # front feet over the gap edge
    [1.0, 5.0, -1.7],    # y = 10: the trench between courses; z = -1.2
    [0.5, 0.0, 0.0],
    [6.5, 0.1, 0.0],     # straddles the gap at [36.4, 36.6)
    [0.2, 0.0, 0.0],
    [17.5, 0.0, 0.0],    # 17.5 m > 0.6 x 28 m from the origin
    [1.0, -0.3, 0.0],
], np.float32)


def _cfg(cfg_cls):
    cfg = cfg_cls()
    cfg.env.num_envs = B
    cfg.terrain.num_rows, cfg.terrain.num_cols = 3, 2
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.rewards.only_positive_rewards = False   # compare the raw sums
    return cfg


def _draws():
    rng = np.random.default_rng(0)
    f = lambda a: np.asarray(a, np.float32)
    dr = dict(friction=f(rng.uniform(0.1, 1.0, B)), added_mass=f(rng.uniform(0, 3, B)),
              com_offset=f(rng.uniform(-0.15, 0.15, (B, 3))),
              kp_mult=f(rng.uniform(0.8, 1.2, (B, 12))), kd_mult=f(rng.uniform(0.8, 1.2, (B, 12))))
    quat = np.tile([1.0, 0.0, 0.0, 0.0], (B, 1))
    quat[5] = [0.0, 1.0, 0.0, 0.0]  # upside down: terminates every step
    phys = dict(quat=f(quat), dof_off=f(rng.uniform(0, 0.9, (B, 12))),
                lin=f(rng.uniform(-0.5, 0.5, (B, 3))), ang=f(rng.uniform(-0.5, 0.5, (B, 3))))
    cmds = f(np.concatenate([rng.uniform(0.75, 1.5, (B, 1)), np.zeros((B, 2)),
                             rng.uniform(-0.2, 0.2, (B, 1))], axis=1))
    cmds[2] = 0.0
    actions = [f(rng.normal(size=(B, 12)) * 0.5) for _ in range(3)]
    return dr, phys, cmds, actions


def _inject_jax(env, dr, phys, cmds):
    levels = jnp.asarray(LEVELS, jnp.int32)
    types = (jnp.arange(B) // (B / env.cfg.terrain.num_cols)).astype(jnp.int32)  # base_env.py:463
    env._initial_origins = lambda key: (levels, types, env.terrain_origins[levels, types])
    env._sample_dr = lambda key: JDR(**{k: jnp.asarray(v) for k, v in dr.items()})
    env._sample_reset_physics = lambda state, key, origins: JPS(
        base_pos=env.base_init["pos"] + origins + OFFSETS, base_quat=jnp.asarray(phys["quat"]),
        lin_vel=jnp.asarray(phys["lin"]), ang_vel=jnp.asarray(phys["ang"]),
        dof_pos=env.default_dof_pos + phys["dof_off"], dof_vel=jnp.zeros((B, 12)))
    env._resample_commands = lambda state, key, mask: jnp.where(
        mask[:, None], jnp.asarray(cmds), state.commands)


def _inject_torch(env, dr, phys, cmds):
    T = torch.as_tensor
    levels = T(LEVELS, dtype=torch.long)
    env._initial_origins = lambda gen: (
        levels, env.terrain_types, env.terrain_origins[levels, env.terrain_types])
    env._sample_dr = lambda gen: DomainRandParams(**{k: T(v) for k, v in dr.items()})
    env._sample_reset_physics = lambda state, gen, origins: PhysicsState(
        base_pos=env.base_init["pos"] + origins + T(OFFSETS), base_quat=T(phys["quat"]),
        lin_vel=T(phys["lin"]), ang_vel=T(phys["ang"]),
        dof_pos=env.default_dof_pos + T(phys["dof_off"]), dof_vel=torch.zeros((B, 12)))
    env._resample_commands = lambda state, gen, mask: torch.where(
        mask[:, None], T(cmds), state.commands)


def _close(got, ref, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               err_msg=what, **tol)


def test_terrain_types_match_reference_at_full_width():
    for b, cols in ((4096, 20), (B, 2), (1000, 20), (6, 4)):
        ref = np.asarray((jnp.arange(b) // (b / cols)).astype(jnp.int32))
        np.testing.assert_array_equal(terrain_types(b, cols), ref)


def test_go2_parkour_reset_and_steps_match_reference():
    dr, phys, cmds, actions = _draws()
    env_j = JGo2Env(_cfg(JParkourCfg), SYNTHETIC_GO2_URDF, name="go2", terrain_seed=3)
    env_t = Go2Env(_cfg(Go2ParkourCfg), SYNTHETIC_GO2_URDF, name="go2", device="cpu",
                   terrain_seed=3)
    np.testing.assert_array_equal(env_t.hf.data.numpy(), np.asarray(env_j.hf.data))
    np.testing.assert_array_equal(env_t.terrain_origins.numpy(), np.asarray(env_j.terrain_origins))
    assert env_t.reward_names == env_j.reward_names
    assert env_t._scan_patch_K == env_j._scan_patch_K == 40
    assert env_t.fused_spec.hf_K == 24
    np.testing.assert_array_equal(env_t.noise_scale_vec.numpy(), np.asarray(env_j.noise_scale_vec))
    _inject_jax(env_j, dr, phys, cmds)
    _inject_torch(env_t, dr, phys, cmds)

    st_j, obs_j = env_j.reset_all(jax.random.PRNGKey(0))
    st_t, obs_t = env_t.reset_all(torch.Generator().manual_seed(0))
    for name in STREAMS:
        _close(getattr(obs_t, name), getattr(obs_j, name), OBS_TOL, f"reset {name}")
    # env 6 starts at the episode's last step
    last = np.zeros(B, np.int64)
    last[6] = env_t.max_episode_length
    st_j = st_j.replace(episode_length=jnp.asarray(last, jnp.int32))
    st_t = st_t.replace(episode_length=torch.as_tensor(last))

    step_j = jax.jit(env_j.step)
    seen = dict(hole=0, jump=0, down=0, up=0, time_out=0)
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
        np.testing.assert_array_equal(st_t.terrain_levels.numpy(), np.asarray(st_j.terrain_levels))
        np.testing.assert_array_equal(st_t.terrain_types.numpy(), np.asarray(st_j.terrain_types))
        np.testing.assert_array_equal(st_t.env_origins.numpy(), np.asarray(st_j.env_origins))
        np.testing.assert_array_equal(st_t.jump_flags.numpy(), np.asarray(st_j.jump_flags))
        _close(st_t.measured_heights, st_j.measured_heights, OBS_TOL, f"step {i} heights")
        for name, a_t, a_j in zip(PhysicsState._fields, st_t.physics, st_j.physics):
            _close(a_t, a_j, OBS_TOL, f"step {i} {name}")
        seen["hole"] += int(done_t[2])
        seen["jump"] += int(st_t.jump_flags[0] > 0)
        seen["down"] += int(st_t.terrain_levels[5] == 0)
        seen["up"] += int(st_t.terrain_levels[6] == 2)
        seen["time_out"] += int(info_t["time_outs"][6])
    assert seen["hole"] == 3 and int(st_t.terrain_levels[2]) == 1
    assert seen["jump"] >= 1 and seen["down"] == 3 and seen["up"] == 3 and seen["time_out"] == 1
    assert float(obs_t.scan.abs().sum()) > 0.0
