"""The port's public names that scripts written against the JAX API call,
and its `LGC_FUSED_KERNEL` opt-out, against the JAX package on the CPU:

  * `utils.class_to_dict`, `update_class_from_dict`, `deep_copy_cfg` and
    `TaskRegistry.get_task_class` of each package applied to one config
    instance: equal dicts, and the round trip back onto a fresh config;
  * `LeggedEnv.num_proprio` for every registered task;
  * the flag reader against JAX `_env_flag` (ops/fused_step.py:859-860) and
    the opt-out's decision on each value; an env reads it once, when built,
    into its spec (None with the kernel off), says so, and then never reaches
    the kernel's wrapper;
  * the eager control step of the opt-out in the heightfield modes the
    kernel does not cover (`terrain_tick_sample=False`, `patch_halfwidth=0`,
    both) against JAX `control_step` with the kernel off, on the gap table
    of tests/test_torch_hf_step.py, seeds 8 and 21 in one batch, at that
    file's tolerances (dof_vel atol 2e-2, link forces atol 0.05);
  * an env and an MPPI solver built under the opt-out carry no kernel spec
    and never reach the wrapper; a spec of the per-substep mode builds, and
    the wrapper refuses it.
"""
import numpy as np
import pytest

import jax
import torch

from legged_gym_custom_tpu import physics as jphys
from legged_gym_custom_tpu import utils as jutils
from legged_gym_custom_tpu.envs import task_registry as jtask_registry
from legged_gym_custom_tpu.ops import fused_step as jfused
from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch import physics as tphys
from legged_gym_custom_tpu_torch import utils as tutils
from legged_gym_custom_tpu_torch.envs import task_registry
from legged_gym_custom_tpu_torch.ops import fused_step as tfused
from test_torch_hf_step import K, _batch, _close, _terrain
from test_torch_physics import GO2_DEFAULT, STATE, _both, _plant

TASKS = sorted(task_registry.task_classes)
MODES = {"per_substep": dict(terrain_tick_sample=False),
         "no_patch": dict(patch_halfwidth=0.0),
         "both": dict(terrain_tick_sample=False, patch_halfwidth=0.0)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- config helpers

def test_utils_export_what_the_jax_utils_export():
    names = ("BaseConfig", "class_to_dict", "set_seed", "update_class_from_dict",
             "TaskRegistry", "get_load_path", "task_registry", "update_cfg_from_args")
    for name in names:
        assert hasattr(jutils, name) and hasattr(tutils, name), name
    assert callable(tutils.config.deep_copy_cfg)


@pytest.mark.parametrize("task", TASKS)
def test_class_to_dict_matches_jax(task):
    """Both packages' `class_to_dict` of one config instance (the port's,
    then JAX's, env and train) give one dict; the port's mesh block is
    JAX's."""
    for reg in (task_registry, jtask_registry):
        for cfg in reg.get_cfgs(task):
            assert tutils.class_to_dict(cfg) == jutils.class_to_dict(cfg)
    env_t, env_j = task_registry.get_cfgs(task)[0], jtask_registry.get_cfgs(task)[0]
    assert tutils.class_to_dict(env_t)["parallel"] == jutils.class_to_dict(env_j)["parallel"] \
        == {"data_axis": "data", "mesh_shape": None}


@pytest.mark.parametrize("task", ["go2", "go2_parkour_cliff", "anymal_c_rough"])
def test_update_class_from_dict_round_trip_matches_jax(task):
    """A changed dict of the port's config applied by each package's
    `update_class_from_dict` onto a fresh port config: the same config, and
    `class_to_dict` of it gives the dict back."""
    base = tutils.class_to_dict(task_registry.get_cfgs(task)[0])
    base["env"]["num_envs"] = 7
    base["terrain"]["curriculum"] = not base["terrain"]["curriculum"]
    base["parallel"]["mesh_shape"] = 2
    base["rewards"]["scales"]["tracking_lin_vel"] = 0.125
    out = []
    for utils in (tutils, jutils):
        cfg = task_registry.get_cfgs(task)[0]
        utils.update_class_from_dict(cfg, base)
        assert cfg.parallel.mesh_shape == 2 and cfg.env.num_envs == 7
        out.append(tutils.class_to_dict(cfg))
    assert out[0] == out[1] == base


def test_deep_copy_cfg_matches_jax():
    """Both packages' copies of one config are deep: a change to a copy
    leaves the original, and the copies are equal."""
    cfg = task_registry.get_cfgs("go2")[0]
    copies = [tutils.config.deep_copy_cfg(cfg), jutils.config.deep_copy_cfg(cfg)]
    for c in copies:
        c.env.num_envs += 1
        c.rewards.scales.tracking_lin_vel = 0.5
    assert cfg.env.num_envs == copies[0].env.num_envs - 1
    assert cfg.rewards.scales.tracking_lin_vel != 0.5
    assert tutils.class_to_dict(copies[0]) == jutils.class_to_dict(copies[1])


@pytest.mark.parametrize("task", TASKS)
def test_get_task_class_matches_jax(task):
    """The same class name from `get_task_class`, and the registry's own
    entry, as JAX's (utils/task_registry.py:24)."""
    cls_t, cls_j = task_registry.get_task_class(task), jtask_registry.get_task_class(task)
    assert cls_t is task_registry.task_classes[task]
    assert cls_t.__name__ == cls_j.__name__
    with pytest.raises(KeyError):
        task_registry.get_task_class("no_such_task")


@pytest.mark.parametrize("task", TASKS)
def test_num_proprio_matches_jax(task):
    """`LeggedEnv.num_proprio` (JAX envs/base_env.py:331-333) of each task's
    env, read without building an env (the property reads the config)."""
    cfg_t = task_registry.get_cfgs(task)[0]
    cfg_j = jtask_registry.get_cfgs(task)[0]
    env_t = task_registry.get_task_class(task).__new__(task_registry.get_task_class(task))
    env_t.cfg = cfg_t
    env_j = jtask_registry.get_task_class(task).__new__(jtask_registry.get_task_class(task))
    env_j.cfg = cfg_j
    assert env_t.num_proprio == env_j.num_proprio == cfg_t.env.num_proprio


def test_num_proprio_of_a_built_env():
    cfg, _ = task_registry.get_cfgs("go2")
    cfg.env.num_envs = 2
    env, _ = task_registry.make_env("go2", env_cfg=cfg, device="cpu")
    state, obs = env.reset_all(torch.Generator().manual_seed(0))
    assert env.num_proprio == 52 == state.obs_history.shape[-1]


# ---------------------------------------------------------------- the flag

@pytest.mark.parametrize("value", [None, "auto", "1", "on", "0", "off", "false", "OFF",
                                   "False", "no"])
def test_flag_reader_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("LGC_FUSED_KERNEL", raising=False)
    else:
        monkeypatch.setenv("LGC_FUSED_KERNEL", value)
    assert tfused.env_flag() == jfused._env_flag()
    # JAX's opt-out test (ops/fused_step.py:910-912)
    assert tfused.kernel_enabled() == (jfused._env_flag() not in ("0", "off", "false"))


def _fail(*args, **kwargs):
    raise AssertionError("an env with the kernel off reached the kernel's wrapper")


def test_env_reads_the_flag_once_when_built(monkeypatch, capsys):
    """An env built under `LGC_FUSED_KERNEL=0`, or with `sim.fused_kernel`
    False, turns the kernel off and says so; the choice stays after the flag
    is gone, and its step never reaches the kernel's wrapper
    (`fused_step.fused_control_step`).  Built with neither, it keeps the
    kernel and prints nothing."""
    def build(fused_kernel=True):
        cfg, _ = task_registry.get_cfgs("go2")
        cfg.env.num_envs = 2
        cfg.sim.fused_kernel = fused_kernel
        return task_registry.make_env("go2", env_cfg=cfg, device="cpu")[0]

    monkeypatch.setenv("LGC_FUSED_KERNEL", "Off")
    flagged = build()
    monkeypatch.delenv("LGC_FUSED_KERNEL")
    assert "the fused kernel is off (sim.fused_kernel=True, LGC_FUSED_KERNEL=off)" in \
        capsys.readouterr().out
    configured = build(fused_kernel=False)
    assert "the fused kernel is off (sim.fused_kernel=False, LGC_FUSED_KERNEL=auto)" in \
        capsys.readouterr().out
    on = build()
    assert "fused kernel" not in capsys.readouterr().out
    assert on.fused_spec is not None
    monkeypatch.setattr(tfused, "fused_control_step", _fail)
    for env in (flagged, configured):
        assert env.fused_spec is None
        state, _ = env.reset_all(torch.Generator().manual_seed(0))
        state, obs, rew, _, _ = env.step(state, torch.zeros(2, env.num_actions))
        assert torch.isfinite(obs.obs).all() and torch.isfinite(rew).all()


# ---------------------------------------------------------------- the opt-out

@pytest.mark.parametrize("mode", sorted(MODES))
def test_eager_step_in_uncovered_modes_matches_jax(mode, monkeypatch):
    """The port's `physics.control_step` on the CPU (the eager engine, which
    an env with the kernel off calls on the card too) against JAX
    `control_step` under `LGC_FUSED_KERNEL=0`, in a heightfield mode no
    kernel variant covers; seeds 8 and 21, one batch."""
    monkeypatch.setenv("LGC_FUSED_KERNEL", "0")
    (ma_j, pd_j, dl_j), (ma_t, pd_t, dl_t) = _both(SYNTHETIC_GO2_URDF, GO2_DEFAULT)
    hf_j, hf_t = _terrain()
    parts = [_batch(seed, GO2_DEFAULT) for seed in (8, 21)]
    cat = lambda i: [np.ascontiguousarray(np.concatenate([p[i][k] for p in parts], axis=-1))
                     for k in range(len(parts[0][i]))]
    state, dr = cat(0), cat(1)
    actions = np.ascontiguousarray(np.concatenate([p[2] for p in parts], axis=-1))
    params_j = _plant(12, True)._replace(**MODES[mode])
    params_t = _plant(12, False)._replace(**MODES[mode])
    ref_state, ref_info, _ = jax.jit(
        lambda s, a, d: jphys.control_step(ma_j, hf_j, params_j, pd_j, d, dl_j, s, a)
    )(jphys.PhysicsState(*state), actions, jphys.DomainRandParams(*dr))
    T = torch.as_tensor
    assert tphys.patch_K(hf_t, params_t) == (0 if "patch_halfwidth" in MODES[mode] else K)
    st, info = tphys.control_step(ma_t, hf_t, params_t, pd_t, tphys.DomainRandParams(*map(T, dr)),
                                  dl_t, tphys.PhysicsState(*map(T, state)), T(actions))
    for name, a, b in zip(STATE, ref_state, st):
        _close(name, b, a)
    _close("link_forces", info.link_forces, ref_info.link_forces)
    _close("torques", info.torques, ref_info.torques)
    assert float(np.abs(np.asarray(ref_info.link_forces)).max()) > 1.0   # terrain touched


def test_spec_of_an_uncovered_mode_builds():
    """`build_spec` takes `terrain_tick_sample=False` with a window, so an
    env of that mode builds; the spec names the mode, and the wrapper itself
    refuses it (here on the CPU, as on the card), while the tick-sampled
    spec runs on the same window."""
    _, (ma_t, pd_t, dl_t) = _both(SYNTHETIC_GO2_URDF, GO2_DEFAULT)
    params = _plant(12, False)._replace(terrain_tick_sample=False)
    spec = tfused.build_spec(ma_t, params, pd_t, dl_t, hf_K=K, hf_hs=0.1)
    assert spec.hf_K == K and not spec.terrain_tick_sample
    ticked = tfused.build_spec(ma_t, _plant(12, False), pd_t, dl_t, hf_K=K, hf_hs=0.1)
    assert ticked == spec._replace(terrain_tick_sample=True)
    B = 4
    state, dr, actions = _batch(8, GO2_DEFAULT)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a[..., :B]))
    state, dr, actions = tuple(map(T, state)), tuple(map(T, dr)), T(actions)
    terrain = (torch.zeros(B, K, K), torch.zeros(B), torch.zeros(B))
    with pytest.raises(NotImplementedError, match="terrain_tick_sample"):
        tfused.fused_control_step(spec, state, actions, dr, terrain)
    out = tfused.fused_control_step(ticked, state, actions, dr, terrain)
    assert all(bool(torch.isfinite(t).all()) for t in (*out[0], out[1], out[2]))


def test_env_and_mppi_under_the_opt_out_carry_no_spec(monkeypatch):
    """Under the opt-out an env of an uncovered mode builds with no spec on
    the CPU and steps; MPPI's solver has none either, and neither reaches
    the kernel's wrapper.  Without it, the env's spec is back."""
    from legged_gym_custom_tpu_torch.mpc import MPPI, MPPIConfig

    cfg, _ = task_registry.get_cfgs("go2_parkour")
    cfg.env.num_envs = 2
    monkeypatch.setenv("LGC_FUSED_KERNEL", "off")
    env, _ = task_registry.make_env("go2_parkour", env_cfg=cfg, device="cpu")
    assert env.fused_spec is None
    env.sim_params = env.sim_params._replace(terrain_tick_sample=False)
    mpc = MPPI(env, MPPIConfig(horizon=2, num_samples=2))
    assert mpc.spec is None
    monkeypatch.setattr(tfused, "fused_control_step", _fail)
    gen = torch.Generator().manual_seed(0)
    state, _ = env.reset_all(gen)
    state, obs, rew, dones, _ = env.step(state, torch.zeros(2, env.num_actions))
    assert torch.isfinite(obs.obs).all() and torch.isfinite(rew).all()
    actions, _, _ = mpc.solve(mpc.init_state(2), state.physics, state.dr, state.commands, gen)
    assert torch.isfinite(actions).all()
    monkeypatch.undo()
    monkeypatch.delenv("LGC_FUSED_KERNEL", raising=False)
    cfg2, _ = task_registry.get_cfgs("go2")
    cfg2.env.num_envs = 2
    assert task_registry.make_env("go2", env_cfg=cfg2, device="cpu")[0].fused_spec.hf_K == 0


class _SaysCuda(torch.Tensor):
    """A CPU tensor whose `is_cuda` reads True, so that the engine's rule can
    be driven down its card branch here; its ops give plain tensors."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True


class _Reached(Exception):
    pass


def _reached(*args, **kwargs):
    raise _Reached


@pytest.mark.parametrize("task", ["go2", "go2_parkour"])
def test_kernel_spec_is_the_one_choice(task, monkeypatch):
    """`physics.kernel_spec` builds the env's `fused_spec` and an MPPI's spec
    over that env: the three are equal, and all None under
    `LGC_FUSED_KERNEL=0` and under `sim.fused_kernel = False`.  On tensors
    that say they are on CUDA, `control_step` given no spec never reaches
    the kernel's wrapper, and given the env's spec reaches it."""
    from legged_gym_custom_tpu_torch.mpc import MPPI, MPPIConfig

    def build(fused_kernel=True):
        cfg, _ = task_registry.get_cfgs(task)
        cfg.env.num_envs = 2
        cfg.sim.fused_kernel = fused_kernel
        env = task_registry.make_env(task, env_cfg=cfg, device="cpu")[0]
        mpc = MPPI(env, MPPIConfig(horizon=2, num_samples=2))
        built = tphys.kernel_spec(env.ma, env.hf, env.sim_params, env.pd, env.dof_limits,
                                  enabled=fused_kernel)
        return env, (env.fused_spec, mpc.spec, built)

    monkeypatch.delenv("LGC_FUSED_KERNEL", raising=False)
    env, (spec, *others) = build()
    assert spec is not None and others == [spec, spec]
    assert (spec.hf_K > 0) == (task == "go2_parkour")
    assert build(fused_kernel=False)[1] == (None, None, None)
    monkeypatch.setenv("LGC_FUSED_KERNEL", "0")
    assert build()[1] == (None, None, None)

    st = env.reset_all(torch.Generator().manual_seed(3))[0]
    cb = lambda x: x.movedim(0, -1).contiguous()
    physics = tphys.PhysicsState(*map(cb, st.physics))
    physics = physics._replace(dof_pos=physics.dof_pos.as_subclass(_SaysCuda))
    assert physics.dof_pos.is_cuda
    args = (env.ma, env.hf, env.sim_params, env.pd, tphys.DomainRandParams(*map(cb, st.dr)),
            env.dof_limits, physics, torch.zeros(env.num_actions, env.num_envs))
    monkeypatch.setattr(tfused, "fused_control_step", _fail)
    out, info = tphys.control_step(*args, spec=None)
    assert all(bool(torch.isfinite(x).all()) for x in (*out, *info))
    monkeypatch.setattr(tfused, "fused_control_step", _reached)
    with pytest.raises(_Reached):
        tphys.control_step(*args, spec=spec)


def test_receipt_eager_step_is_the_opt_out_step(monkeypatch):
    """`check_fused_gpu.eager_step`, the receipt's eager side: the eager
    engine's step on the receipt's plant, as an env with the kernel off
    steps it, never reaching the kernel's wrapper."""
    from legged_gym_custom_tpu_torch.scripts import check_fused_gpu

    p = check_fused_gpu.build(8, terrain=True, full_plant=True, device="cpu")
    monkeypatch.setattr(tfused, "fused_control_step", _fail)
    st, out = check_fused_gpu.eager_step(p, p.state, p.actions)
    st_e, info_e = tphys.control_step(p.ma, p.hf, p.params, p.pd, p.dr, p.dof_limits,
                                      p.state, p.actions, spec=None)
    for a, b in zip((*st, out.link_forces, out.torques),
                    (*st_e, info_e.link_forces, info_e.torques)):
        assert torch.equal(a, b)
