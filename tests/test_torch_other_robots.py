"""Parity of the port's other robots with the JAX reference on the CPU:
`anymal_c_flat` and `anymal_c_rough` (the SEA actuator network), `cassie` and
`g1`, a reset and 3 steps each, on the synthetic URDFs the port ships.

Both envs run one task at a few envs with observation noise and pushes off;
the random draws (initial terrain levels, domain randomization, reset states,
commands) are injected as in tests/test_torch_env.py, and one env starts
upside down, so it takes the masked reset path (and, on ANYmal, the zeroing
of its LSTM state) on every step.  The ANYmal tasks load the anydrive-shaped
TorchScript of tests/torch_actuator_net.py on both sides, and the JAX configs
take the port's `sim.joint_armature` (the bipeds' drives' armature, the one
value the port's configs add).  All five streams,
the rewards, the episode sums, the done flags, the physics state and the
actuator state are held at the tolerances of tests/test_torch_env.py.

The proprio streams of anymal_c_rough and cassie end in the height samples
(48 + 187 and 48 + 121 wide); `test_height_samples_in_the_base_proprio_stream`
holds that part of the base env alone, on a Go2 config that asks for it.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from legged_gym_custom_tpu.envs.anymal_config import AnymalCFlatCfg as JAnymalFlatCfg
from legged_gym_custom_tpu.envs.anymal_config import AnymalCRoughCfg as JAnymalRoughCfg
from legged_gym_custom_tpu.envs.anymal_env import AnymalEnv as JAnymalEnv
from legged_gym_custom_tpu.envs.base_env import LeggedEnv as JLeggedEnv
from legged_gym_custom_tpu.envs.cassie_config import CassieCfg as JCassieCfg
from legged_gym_custom_tpu.envs.cassie_env import CassieEnv as JCassieEnv
from legged_gym_custom_tpu.envs.g1_config import G1Cfg as JG1Cfg
from legged_gym_custom_tpu.envs.g1_env import G1Env as JG1Env
from legged_gym_custom_tpu.envs.go2_config import Go2Cfg as JGo2Cfg
from legged_gym_custom_tpu.physics.engine import DomainRandParams as JDR
from legged_gym_custom_tpu.physics.engine import PhysicsState as JPS
from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch.envs import (AnymalCFlatCfg, AnymalCRoughCfg, AnymalEnv,
                                              CassieCfg, CassieEnv, G1Cfg, G1Env, Go2Cfg,
                                              LeggedEnv, task_registry)
from legged_gym_custom_tpu_torch.physics.engine import DomainRandParams, PhysicsState
import torch_actuator_net

B = 6
STREAMS = ("obs", "privileged", "critic", "estimated", "scan")
OBS_TOL = dict(atol=2e-3, rtol=1e-3)     # tests/test_torch_env.py
REW_TOL = dict(atol=1e-4, rtol=1e-3)
LEVELS = np.array([1, 0, 1, 1, 0, 1])
TASKS = {
    "anymal_c_flat": (JAnymalEnv, JAnymalFlatCfg, AnymalEnv, AnymalCFlatCfg),
    "anymal_c_rough": (JAnymalEnv, JAnymalRoughCfg, AnymalEnv, AnymalCRoughCfg),
    "cassie": (JCassieEnv, JCassieCfg, CassieEnv, CassieCfg),
    "g1": (JG1Env, JG1Cfg, G1Env, G1Cfg),
}
# proprio widths: 48 + 187 and 48 + 121 height samples, G1's 47
PROPRIO = {"anymal_c_flat": 48, "anymal_c_rough": 235, "cassie": 169, "g1": 47}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net_path(tmp_path_factory):
    return torch_actuator_net.write_sea_net(str(tmp_path_factory.mktemp("sea") / "sea.pt"))


def _cfg(cfg_cls, net_path):
    cfg = cfg_cls()
    cfg.env.num_envs = B
    cfg.terrain.num_rows, cfg.terrain.num_cols = 3, 2
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    cfg.rewards.only_positive_rewards = False   # compare the raw sums
    if hasattr(cfg.control, "actuator_net_file"):
        cfg.control.actuator_net_file = net_path
    return cfg


def _draws():
    rng = np.random.default_rng(0)
    f = lambda a: np.asarray(a, np.float32)
    dr = dict(friction=f(rng.uniform(0.3, 1.2, B)), added_mass=f(rng.uniform(-2, 3, B)),
              com_offset=f(rng.uniform(-0.05, 0.05, (B, 3))),
              kp_mult=f(rng.uniform(0.8, 1.2, (B, 12))), kd_mult=f(rng.uniform(0.8, 1.2, (B, 12))))
    quat = np.tile([1.0, 0.0, 0.0, 0.0], (B, 1))
    quat[0] = [0.0, 1.0, 0.0, 0.0]  # upside down: terminates every step
    phys = dict(quat=f(quat), dof_off=f(rng.uniform(-0.2, 0.2, (B, 12))),
                lin=f(rng.uniform(-0.5, 0.5, (B, 3))), ang=f(rng.uniform(-0.5, 0.5, (B, 3))))
    cmds = f(np.concatenate([rng.uniform(-1, 1, (B, 1)), rng.uniform(-0.75, 0.75, (B, 1)),
                             rng.uniform(-1, 1, (B, 1)), rng.uniform(-3, 3, (B, 1))], axis=1))
    actions = [f(rng.normal(size=(B, 12)) * 0.5) for _ in range(3)]
    return dr, phys, cmds, actions


def _inject_jax(env, dr, phys, cmds):
    if env.custom_origins:
        levels = jnp.asarray(LEVELS, jnp.int32)
        types = (jnp.arange(B) // (B / env.cfg.terrain.num_cols)).astype(jnp.int32)
        env._initial_origins = lambda key: (levels, types, env.terrain_origins[levels, types])
    env._sample_dr = lambda key: JDR(**{k: jnp.asarray(v) for k, v in dr.items()})
    env._sample_reset_physics = lambda state, key, origins: JPS(
        base_pos=env.base_init["pos"] + origins, base_quat=jnp.asarray(phys["quat"]),
        lin_vel=jnp.asarray(phys["lin"]), ang_vel=jnp.asarray(phys["ang"]),
        dof_pos=env.default_dof_pos + phys["dof_off"], dof_vel=jnp.zeros((B, 12)))
    env._resample_commands = lambda state, key, mask: jnp.where(
        mask[:, None], jnp.asarray(cmds), state.commands)


def _inject_torch(env, dr, phys, cmds):
    T = torch.as_tensor
    if env.custom_origins:
        levels = T(LEVELS, dtype=torch.long)
        env._initial_origins = lambda gen: (
            levels, env.terrain_types, env.terrain_origins[levels, env.terrain_types])
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


def _envs(task, net_path):
    j_env, j_cfg, t_env, t_cfg = TASKS[task]
    cfg_t = _cfg(t_cfg, net_path)
    cfg_j = _cfg(j_cfg, net_path)
    # the one value the port's biped configs add (their drives' armature)
    cfg_j.sim.joint_armature = cfg_t.sim.joint_armature
    env_t = t_env(cfg_t, cfg_t.asset.file, name=task, device="cpu", terrain_seed=5)
    env_j = j_env(cfg_j, cfg_t.asset.file, name=task, terrain_seed=5)
    return env_j, env_t


def _run(env_j, env_t, draws):
    """Reset and 3 steps of both envs, every output held against JAX;
    returns the port's states and done flags."""
    dr, phys, cmds, actions = draws
    _inject_jax(env_j, dr, phys, cmds)
    _inject_torch(env_t, dr, phys, cmds)
    st_j, obs_j = env_j.reset_all(jax.random.PRNGKey(0))
    st_t, obs_t = env_t.reset_all(torch.Generator().manual_seed(0))
    for name in STREAMS:
        _close(getattr(obs_t, name), getattr(obs_j, name), OBS_TOL, f"reset {name}")
    step_j = jax.jit(env_j.step)
    states, dones = [st_t], []
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
        act_t = st_t.actuator_state if isinstance(st_t.actuator_state, tuple) else (
            st_t.actuator_state,)
        for k, (a_t, a_j) in enumerate(zip(act_t, jax.tree.leaves(st_j.actuator_state))):
            _close(a_t, a_j, OBS_TOL, f"step {i} actuator state {k}")
        np.testing.assert_array_equal(st_t.terrain_levels.numpy(), np.asarray(st_j.terrain_levels))
        states.append(st_t)
        dones.append(done_t)
    return states, dones


@pytest.mark.parametrize("task", list(TASKS))
def test_reset_and_steps_match_reference(task, net_path):
    env_j, env_t = _envs(task, net_path)
    assert env_t.reward_names == env_j.reward_names
    np.testing.assert_array_equal(env_t.noise_scale_vec.numpy(), np.asarray(env_j.noise_scale_vec))
    np.testing.assert_array_equal(env_t.reward_statics.hip_joint_ids,
                                  env_j.reward_statics.hip_joint_ids)
    assert env_t.fused_spec.hf_K == (24 if env_t.custom_origins else 0)
    states, dones = _run(env_j, env_t, _draws())
    assert states[-1].obs_history.shape[-1] == PROPRIO[task]
    assert all(bool(d[0]) for d in dones)   # the upside-down env resets every step
    if task.startswith("anymal"):
        h0 = states[0].actuator_state[0]
        assert tuple(h0.shape) == (B, 2, 12, 8)
        for st in states[1:]:
            hidden = st.actuator_state[0]
            assert float(hidden[0].abs().max()) == 0.0      # reset zeroes its LSTM state
            assert float(hidden[1:].abs().max()) > 0.0      # the others ran the LSTM
    if task in ("anymal_c_rough", "cassie"):    # heights reach the proprio stream
        tail = states[-1].obs_history[:, -1, 48:]
        assert float(tail.abs().max()) > 0.0 and tail.shape[-1] == PROPRIO[task] - 48


def test_height_samples_in_the_base_proprio_stream(net_path):
    """The base env's proprio stream ends in clip(base_z - 0.5 - heights, -1,
    1) * obs_scales.height_measurements when terrain.measure_heights is set,
    and the noise vector covers that span (JAX base_env.py:351-352,
    367-371): the base LeggedEnv on a Go2 config with 132 scandots."""

    def cfg_of(cls):
        cfg = _cfg(cls, net_path)
        cfg.terrain.measure_heights = True
        cfg.env.num_proprio = 48 + 132
        cfg.noise.add_noise = True
        return cfg

    env_j = JLeggedEnv(cfg_of(JGo2Cfg), SYNTHETIC_GO2_URDF, name="go2")
    env_t = LeggedEnv(cfg_of(Go2Cfg), SYNTHETIC_GO2_URDF, name="go2", device="cpu")
    noise = env_t.noise_scale_vec.numpy()
    np.testing.assert_array_equal(noise, np.asarray(env_j.noise_scale_vec))
    cfg = env_t.cfg
    scale = cfg.normalization.obs_scales.height_measurements
    span = cfg.noise.noise_scales.height_measurements * cfg.noise.noise_level * scale
    assert noise.shape == (180,) and (noise[48:] == np.float32(span)).all() and span > 0
    draws = _draws()
    _inject_jax(env_j, *draws[:3])
    _inject_torch(env_t, *draws[:3])
    cfg_off = lambda env: setattr(env.cfg.noise, "add_noise", False)
    cfg_off(env_j)
    cfg_off(env_t)
    st_j, obs_j = env_j.reset_all(jax.random.PRNGKey(0))
    st_t, obs_t = env_t.reset_all(torch.Generator().manual_seed(0))
    heights = obs_t.obs[:, -132:]
    z = st_t.physics.base_pos[:, 2:3]
    torch.testing.assert_close(heights, torch.clamp(z - 0.5, -1.0, 1.0).expand(B, 132) * scale)
    _close(obs_t.obs, obs_j.obs, OBS_TOL, "obs")


@pytest.mark.parametrize("task", list(TASKS))
def test_new_tasks_default_to_cuda(task, monkeypatch):
    """make_env runs on the card unless asked for the CPU, and raises rather
    than drifting to the CPU when no card is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = task_registry.get_cfgs(task)
    cfg.env.num_envs = 2
    with pytest.raises(RuntimeError, match="CUDA"):
        task_registry.make_env(task, env_cfg=cfg)


def test_missing_actuator_network_raises(tmp_path):
    """ANYmal never falls back to PD control (JAX tests/test_tasks.py:47-65)."""
    for task in ("anymal_c_flat", "anymal_c_rough"):
        cfg, _ = task_registry.get_cfgs(task)
        cfg.env.num_envs = 2
        cfg.terrain.num_rows, cfg.terrain.num_cols = 2, 2
        cfg.control.actuator_net_file = str(tmp_path / "absent.pt")
        with pytest.raises(FileNotFoundError, match="control.actuator_net_file"):
            task_registry.make_env(task, env_cfg=cfg, device="cpu")
