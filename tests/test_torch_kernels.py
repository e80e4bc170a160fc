"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one; the file imports
neither JAX nor the JAX package, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from legged_gym_custom_tpu_torch import physics as tphys
from legged_gym_custom_tpu_torch.envs import task_registry
from legged_gym_custom_tpu_torch.ops import fused_step
from legged_gym_custom_tpu_torch.physics import patch

B = 4096
# (atol, rtol) per output as in tests/test_fused_step.py:126-135, gated at the
# 99th percentile: grazing contacts seed a one-ULP tail (docs/architecture.md:74-79)
TOL = dict(base_pos=(1e-4, 1e-4), base_quat=(1e-4, 1e-4), lin_vel=(1e-3, 1e-3),
           ang_vel=(1e-3, 1e-3), dof_pos=(1e-4, 1e-4), dof_vel=(1e-2, 1e-3),
           link_forces=(0.05, 1e-3), torques=(1e-2, 1e-3))
# the heightfield variant: dof_vel atol 2e-2 (tests/test_fused_step.py:185-193)
HF_TOL = dict(TOL, dof_vel=(2e-2, 1e-3))
DEFAULT = np.array([0.1, 0.8, -1.5, -0.1, 0.8, -1.5, 0.1, 1.0, -1.5, -0.1, 1.0, -1.5])


@pytest.fixture(scope="module")
def go2_env():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernel has no CPU mode")
    cfg, _ = task_registry.get_cfgs("go2")
    cfg.env.num_envs = B
    env, _ = task_registry.make_env("go2", env_cfg=cfg, device="cuda")
    return env


def _batch(seed=0, B=B):
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(4, B)) * 0.1 + np.array([1.0, 0, 0, 0])[:, None]
    quat /= np.linalg.norm(quat, axis=0, keepdims=True)
    state = [np.concatenate([rng.uniform(-1, 1, (2, B)), rng.uniform(0.25, 0.45, (1, B))]),
             quat, rng.normal(size=(3, B)) * 0.5, rng.normal(size=(3, B)) * 0.5,
             DEFAULT[:, None] + rng.normal(size=(12, B)) * 0.2, rng.normal(size=(12, B)) * 2.0]
    dr = [rng.uniform(0.5, 1.25, B), rng.uniform(-1.0, 1.0, B), rng.normal(size=(3, B)) * 0.01,
          np.full((12, B), 1.05), np.full((12, B), 0.95)]
    actions = np.clip(rng.normal(size=(12, B)), -3.14, 3.14)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device="cuda")
    return tuple(map(t, state)), t(actions), tuple(map(t, dr))


def _assert_close_p99(names, got, ref, tol=TOL):
    for name, a, b in zip(names, got, ref):
        atol, rtol = tol[name]
        assert torch.isfinite(a).all(), name
        ratio = ((a - b).abs() / (atol + rtol * b.abs())).flatten().double()
        assert float(torch.quantile(ratio, 0.99)) <= 1.0, name


NAMES = ("base_pos", "base_quat", "lin_vel", "ang_vel", "dof_pos", "dof_vel",
         "link_forces", "torques")
# the link states the kernel writes, against the eager `link_states` of its own
# output state: only the rounding differs, so every entry is held, with the
# tolerances of the base's position and linear velocity
LINK_TOL = dict(link_pos=TOL["base_pos"], link_vel=TOL["lin_vel"])
# a go2 rank's counters after one iteration: K1 once an env step and in `reset_all`
K1_ITERATION = {"fused_control_step": 1 + 24}


def _assert_link_states(ma, state, link_pos, link_vel):
    lpos, lvel = tphys.link_states(ma, tphys.PhysicsState(*state))
    for name, got, ref in (("link_pos", link_pos, lpos), ("link_vel", link_vel, lvel)):
        assert got.shape == ref.shape, name
        atol, rtol = LINK_TOL[name]
        torch.testing.assert_close(got, ref, atol=atol, rtol=rtol, msg=lambda m: f"{name}: {m}")


def _others_unchanged(before, after, name):
    """No counter but `name`'s moved."""
    return all(after[k] == before[k] for k in before if k != name)


@pytest.mark.cuda
def test_fused_kernel_matches_plain_version(go2_env):
    spec = go2_env.fused_spec
    state, actions, dr = _batch()
    before = fused_step.fused_control_step.launches
    out = fused_step.fused_control_step(spec, state, actions, dr)
    torch.cuda.synchronize()
    assert fused_step.fused_control_step.launches == before + 1
    ref = fused_step.plain_control_step(spec, state, actions, dr)
    _assert_close_p99(NAMES, (*out[0], out[1], out[2]), (*ref[0], ref[1], ref[2]))
    _assert_link_states(go2_env.ma, out[0], *out[3:])


@pytest.mark.cuda
def test_engine_on_card_runs_the_kernel_and_matches_eager(go2_env):
    """`physics.control_step` on CUDA tensors launches the kernel once and
    agrees with the eager engine on the same tensors."""
    env = go2_env
    state, actions, dr = _batch(1)
    args = (env.ma, env.hf, env.sim_params, env.pd, tphys.DomainRandParams(*dr),
            env.dof_limits, tphys.PhysicsState(*state), actions)
    before = fused_step.launch_counts()
    st, info = tphys.control_step(*args, spec=env.fused_spec)
    torch.cuda.synchronize()
    after = fused_step.launch_counts()
    name = "fused_control_step"
    assert after[name] == before[name] + 1          # the kernel writes the link states too
    st_e, info_e = tphys.control_step(*args, spec=None)
    _assert_close_p99(NAMES, (*st, info.link_forces, info.torques),
                      (*st_e, info_e.link_forces, info_e.torques))
    _assert_link_states(env.ma, st, info.link_pos, info.link_vel)


@pytest.mark.cuda
def test_control_step_on_the_plane_issues_few_device_events(go2_env):
    """One `physics.control_step` on CUDA tensors on the plane, under
    torch.profiler: the kernel writes the link states itself, so the
    `lgc.physics` span issues at most 20 device events (the eager
    `link_states` after the kernel issued some 655), the kernel among
    them."""
    from torch.profiler import ProfilerActivity, profile

    env = go2_env
    state, actions, dr = _batch(41)
    args = (env.ma, env.hf, env.sim_params, env.pd, tphys.DomainRandParams(*dr),
            env.dof_limits, tphys.PhysicsState(*state), actions)
    tphys.control_step(*args, spec=env.fused_spec)      # warm: the library, the allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tphys.control_step(*args, spec=env.fused_spec)
        torch.cuda.synchronize()
    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans = [e for e in events if e.name == "lgc.physics" and e.device_type == cpu]
    # the span's own annotation on the device's timeline is no device event
    device = [e for e in events if e.device_type == cuda and not e.name.startswith("lgc.")]
    assert len(spans) == 1
    assert any(e.name.startswith("fused_control_step_kernel") for e in device)
    assert 1 <= len(device) <= 20, [e.name for e in device]


@pytest.mark.cuda
def test_wrapper_raises_on_the_card_for_what_the_kernel_does_not_take(go2_env):
    spec = go2_env.fused_spec
    state, actions, dr = _batch(2)
    with pytest.raises(NotImplementedError, match="'V'"):
        fused_step.fused_control_step(spec._replace(control_type="V"), state, actions, dr)
    with pytest.raises(ValueError):
        fused_step.fused_control_step(spec, state, actions.t().contiguous().t(), dr)
    with pytest.raises(ValueError):
        fused_step.fused_control_step(spec, state, actions.cpu(), dr)


@pytest.fixture(scope="module")
def parkour_env():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernel has no CPU mode")
    cfg, _ = task_registry.get_cfgs("go2_parkour")
    cfg.env.num_envs = B
    env, _ = task_registry.make_env("go2_parkour", env_cfg=cfg, device="cuda")
    return env


def _parkour_batch(env, seed, B=B):
    """`_batch` with the bases over the go2_parkour gap courses, a quarter
    of them within 0.3 m of a gap edge, and their contact windows."""
    state, actions, dr = _batch(seed, B)
    rng = np.random.default_rng(seed + 1)
    t = env.cfg.terrain
    col = int(t.border_size / t.horizontal_scale) + int(t.terrain_width / t.horizontal_scale) // 2
    edges = (np.nonzero(np.diff(env.terrain.height_field_raw[:, col]))[0] + 1) \
        * t.horizontal_scale - t.border_size
    x = rng.uniform(0.0, t.num_rows * t.terrain_length, B)
    x[: B // 4] = rng.choice(edges, B // 4) + rng.uniform(-0.3, 0.3, B // 4)
    y = (rng.integers(0, t.num_cols, B) + 0.5) * t.terrain_width + rng.uniform(-4.0, 4.0, B)
    pos = torch.as_tensor(np.stack([x, y, rng.uniform(0.25, 0.45, B)]), dtype=torch.float32,
                          device="cuda").contiguous()
    return (pos, *state[1:]), actions, dr


@pytest.mark.cuda
def test_heightfield_kernel_matches_plain_version(parkour_env):
    spec = parkour_env.fused_spec
    assert spec.hf_K == 24
    state, actions, dr = _parkour_batch(parkour_env, 3)
    lp = patch.extract(parkour_env.hf, state[0][0], state[0][1], spec.hf_K)
    terrain = fused_step.patch_inputs(lp)
    before = fused_step.fused_control_step.hf_launches
    out = fused_step.fused_control_step(spec, state, actions, dr, terrain)
    torch.cuda.synchronize()
    assert fused_step.fused_control_step.hf_launches == before + 1
    ref = fused_step.plain_control_step(spec, state, actions, dr, terrain)
    _assert_close_p99(NAMES, (*out[0], out[1], out[2]), (*ref[0], ref[1], ref[2]), HF_TOL)
    _assert_link_states(parkour_env.ma, out[0], *out[3:])


@pytest.mark.cuda
def test_heightfield_kernel_on_the_finetune_composite_course(parkour_env):
    """K3 on the finetune stages' course (0.10-0.35 m platforms between
    gaps), a quarter of the bases within 0.3 m of a platform face or a gap
    edge: the stage's spec builds the go2_parkour library, no other."""
    cfg, _ = task_registry.get_cfgs("go2_parkour_finetune")
    cfg.env.num_envs = B
    env, _ = task_registry.make_env("go2_parkour_finetune", env_cfg=cfg, device="cuda")
    spec = env.fused_spec
    assert spec == parkour_env.fused_spec
    lanes = fused_step.lanes_per_branch_for(spec)
    assert fused_step.library_key(spec, lanes) == fused_step.library_key(parkour_env.fused_spec,
                                                                         lanes)
    assert env.terrain.height_field_raw.max() == 70    # +0.35 m
    state, actions, dr = _parkour_batch(env, 13)
    terrain = fused_step.patch_inputs(patch.extract(env.hf, state[0][0], state[0][1], spec.hf_K))
    before = fused_step.fused_control_step.hf_launches
    out = fused_step.fused_control_step(spec, state, actions, dr, terrain)
    torch.cuda.synchronize()
    assert fused_step.fused_control_step.hf_launches == before + 1
    ref = fused_step.plain_control_step(spec, state, actions, dr, terrain)
    _assert_close_p99(NAMES, (*out[0], out[1], out[2]), (*ref[0], ref[1], ref[2]), HF_TOL)
    _assert_link_states(parkour_env.ma, out[0], *out[3:])


@pytest.mark.cuda
def test_engine_on_card_runs_the_heightfield_kernel_and_matches_eager(parkour_env):
    """`physics.control_step` on a heightfield cuts the windows and launches
    K3 once, and agrees with the eager engine (whose windows are sampled by
    physics/patch.py) on the same tensors."""
    env = parkour_env
    state, actions, dr = _parkour_batch(env, 4)
    args = (env.ma, env.hf, env.sim_params, env.pd, tphys.DomainRandParams(*dr),
            env.dof_limits, tphys.PhysicsState(*state), actions)
    before = (fused_step.fused_control_step.launches, fused_step.fused_control_step.hf_launches)
    st, info = tphys.control_step(*args, spec=env.fused_spec)
    torch.cuda.synchronize()
    assert (fused_step.fused_control_step.launches,
            fused_step.fused_control_step.hf_launches) == (before[0], before[1] + 1)
    st_e, info_e = tphys.control_step(*args, spec=None)
    _assert_close_p99(NAMES, (*st, info.link_forces, info.torques),
                      (*st_e, info_e.link_forces, info_e.torques), HF_TOL)
    _assert_link_states(env.ma, st, info.link_pos, info.link_vel)


@pytest.mark.cuda
def test_engine_on_card_raises_for_uncovered_heightfield_variants(parkour_env):
    env = parkour_env
    state, actions, dr = _parkour_batch(env, 5)
    base = (env.ma, env.hf, env.sim_params, env.pd, tphys.DomainRandParams(*dr),
            env.dof_limits, tphys.PhysicsState(*state), actions)
    for params in (env.sim_params._replace(patch_halfwidth=0.0),
                   env.sim_params._replace(terrain_tick_sample=False)):
        with pytest.raises(NotImplementedError, match="LGC_FUSED_KERNEL=0"):
            tphys.control_step(*base[:2], params, *base[3:], spec=env.fused_spec)
    with pytest.raises(NotImplementedError, match="'V'"):
        tphys.control_step(*base, spec=env.fused_spec._replace(control_type="V"))
    with pytest.raises(NotImplementedError):   # no window for a heightfield spec
        fused_step.fused_control_step(env.fused_spec, state, actions, dr)
    # the wrapper itself refuses a per-substep spec, windows and all
    per_substep = fused_step.build_spec(
        env.ma, env.sim_params._replace(terrain_tick_sample=False), env.pd, env.dof_limits,
        hf_K=env.fused_spec.hf_K, hf_hs=env.fused_spec.hf_hs)
    assert per_substep == env.fused_spec._replace(terrain_tick_sample=False)
    terrain = fused_step.patch_inputs(patch.extract(env.hf, state[0][0], state[0][1],
                                                    env.fused_spec.hf_K))
    fused_step.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="terrain_tick_sample"):
        fused_step.fused_control_step(per_substep, state, actions, dr, terrain)
    assert not any(fused_step.launch_counts().values())


@pytest.mark.cuda
def test_opt_out_runs_the_eager_engine_on_the_card(go2_env, parkour_env, monkeypatch):
    """The eager engine that an env with the kernel off steps
    (`physics.control_step` with no spec) launches no kernel on CUDA tensors
    and agrees with the kernel's step on the same inputs (the go2 batch, and
    the gap-course batch); the heightfield modes no kernel covers run in it.
    `LGC_FUSED_KERNEL=0` in the environment does not reach
    `physics.control_step`: given a spec, it still launches the kernel."""
    monkeypatch.setenv("LGC_FUSED_KERNEL", "0")
    for env, (state, actions, dr), tol in ((go2_env, _batch(30), TOL),
                                           (parkour_env, _parkour_batch(parkour_env, 31), HF_TOL)):
        args = (env.ma, env.hf, env.sim_params, env.pd, tphys.DomainRandParams(*dr),
                env.dof_limits, tphys.PhysicsState(*state), actions)
        fused_step.reset_launch_counts()
        st_k, info_k = tphys.control_step(*args, spec=env.fused_spec)
        torch.cuda.synchronize()
        counts = {k: n for k, n in fused_step.launch_counts().items() if n}
        name = fused_step.variant_name(env.fused_spec)
        assert counts == {name: 1}
        fused_step.reset_launch_counts()
        st, info = tphys.control_step(*args, spec=None)
        modes = [tphys.control_step(*args[:2], env.sim_params._replace(**mode), *args[3:],
                                    spec=None)
                 for mode in (dict(patch_halfwidth=0.0), dict(terrain_tick_sample=False))]
        torch.cuda.synchronize()
        assert not any(fused_step.launch_counts().values())
        _assert_close_p99(NAMES, (*st, info.link_forces, info.torques),
                          (*st_k, info_k.link_forces, info_k.torques), tol)
        for st_m, _ in modes:
            assert all(bool(torch.isfinite(x).all()) for x in st_m)


@pytest.mark.cuda
def test_opt_out_env_mppi_and_actuated_step_launch_nothing(card, tmp_path_factory, monkeypatch):
    """Envs built under `LGC_FUSED_KERNEL=0` (go2_parkour in a per-substep
    terrain mode, ANYmal's actuated plant) keep the kernel off after the
    flag is gone: they carry no spec, and their steps and an MPPI solve on
    the card launch no kernel; a go2 env with `sim.fused_kernel = False`
    likewise."""
    from legged_gym_custom_tpu_torch.mpc import MPPI, MPPIConfig

    monkeypatch.setenv("LGC_FUSED_KERNEL", "0")
    cfg, _ = task_registry.get_cfgs("go2_parkour")
    cfg.env.num_envs = 64
    env, _ = task_registry.make_env("go2_parkour", env_cfg=cfg, device="cuda")
    anymal = _robot_env("anymal_c_flat", tmp_path_factory)
    monkeypatch.delenv("LGC_FUSED_KERNEL")
    go2_cfg, _ = task_registry.get_cfgs("go2")
    go2_cfg.env.num_envs = 64
    go2_cfg.sim.fused_kernel = False
    go2 = task_registry.make_env("go2", env_cfg=go2_cfg, device="cuda")[0]
    env.sim_params = env.sim_params._replace(terrain_tick_sample=False)
    fused_step.reset_launch_counts()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for e in (env, anymal, go2):
        assert e.fused_spec is None
        state, _ = e.reset_all(gen)
        state, obs, rew, _, _ = e.step(state, torch.zeros((e.num_envs, e.num_actions),
                                                          device="cuda"))
        assert bool(torch.isfinite(obs.obs).all()) and bool(torch.isfinite(rew).all())
        if e is env:
            mpc = MPPI(env, MPPIConfig(horizon=2, num_samples=4))
            actions, _, _ = mpc.solve(mpc.init_state(64), state.physics, state.dr,
                                      state.commands, gen)
    torch.cuda.synchronize()
    assert mpc.spec is None and bool(torch.isfinite(actions).all())
    assert not any(fused_step.launch_counts().values())


@pytest.mark.cuda
def test_oracle_drop_of_an_env_with_the_kernel_off_launches_nothing(card, monkeypatch):
    """The MuJoCo oracle's drop follows its env: go2 built under
    `LGC_FUSED_KERNEL=0` has no spec, so `engine_drop` runs the eager engine
    on the card, launches no kernel and keeps the full-plant drop's gates
    against the stored MuJoCo run."""
    from legged_gym_custom_tpu_torch.deploy import mujoco_oracle as oracle

    monkeypatch.setenv("LGC_FUSED_KERNEL", "0")
    env = oracle.task_env("go2", 4, "cuda")
    monkeypatch.delenv("LGC_FUSED_KERNEL")
    assert env.fused_spec is None
    fused_step.reset_launch_counts()
    base_pos, dof_pos, _ = oracle.engine_drop(env, 4, steps=oracle.FULL_PLANT_STEPS)
    torch.cuda.synchronize()
    assert not any(fused_step.launch_counts().values())
    gaps = oracle.full_plant_gaps(base_pos, dof_pos, oracle.load_oracle()["qpos"])
    assert gaps["ok"], gaps


@pytest.mark.cuda
def test_fused_kernel_on_a_ragged_batch(go2_env):
    """B = 100 fills no block: the lanes beyond the last env compute and store
    nothing, and every env below B is written."""
    spec = go2_env.fused_spec
    state, actions, dr = _batch(10, 100)
    out = fused_step.fused_control_step(spec, state, actions, dr)
    torch.cuda.synchronize()
    ref = fused_step.plain_control_step(spec, state, actions, dr)
    assert out[1].shape == out[3].shape == out[4].shape == (spec.n_links, 3, 100)
    _assert_close_p99(NAMES, (*out[0], out[1], out[2]), (*ref[0], ref[1], ref[2]))
    _assert_link_states(go2_env.ma, out[0], *out[3:])


@pytest.mark.cuda
def test_heightfield_kernel_on_a_ragged_batch(parkour_env):
    spec = parkour_env.fused_spec
    state, actions, dr = _parkour_batch(parkour_env, 11, 100)
    lp = patch.extract(parkour_env.hf, state[0][0], state[0][1], spec.hf_K)
    terrain = fused_step.patch_inputs(lp)
    out = fused_step.fused_control_step(spec, state, actions, dr, terrain)
    torch.cuda.synchronize()
    ref = fused_step.plain_control_step(spec, state, actions, dr, terrain)
    _assert_close_p99(NAMES, (*out[0], out[1], out[2]), (*ref[0], ref[1], ref[2]), HF_TOL)
    _assert_link_states(parkour_env.ma, out[0], *out[3:])


def _rest_quarter(spec, state, actions, seed):
    """A random quarter of the (joint, env) entries at rest: zero velocity
    and, under 'P' control, the action whose target is the current angle."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rest = torch.rand(actions.shape, generator=gen, device="cuda") < 0.25
    default = torch.tensor(spec.default_dof_pos, dtype=torch.float32, device="cuda")
    qd = torch.where(rest, torch.zeros_like(state[5]), state[5]).contiguous()
    if spec.control_type == "P":
        hold = (state[4] - default[:, None]) / spec.action_scale
        actions = torch.where(rest, hold, actions).contiguous()
    return (*state[:5], qd), actions


def _assert_same_joints_held(qd_kernel, qd_plain):
    """The entries at exactly zero velocity: some, and the same set in the
    kernel and the plain version up to 1 % of all entries."""
    zk, zp = qd_kernel == 0.0, qd_plain == 0.0
    assert int(zk.sum()) > 0 and int(zp.sum()) > 0
    assert int((zk != zp).sum()) <= 0.01 * zk.numel()


@pytest.fixture(scope="module")
def stiction_env():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernel has no CPU mode")
    cfg, _ = task_registry.get_cfgs("go2_stiction")
    cfg.env.num_envs = B
    env, _ = task_registry.make_env("go2_stiction", env_cfg=cfg, device="cuda")
    return env


@pytest.mark.cuda
def test_stiction_kernel_matches_plain_version(stiction_env):
    """go2_stiction's own spec (plane, 'P', implicit stiction): the kernel
    against the plain version, its own launch counter, the joints it holds,
    and `physics.control_step` against the eager engine."""
    env = stiction_env
    spec = env.fused_spec
    assert spec.fl_dqd and spec.control_type == "P" and spec.hf_K == 0
    name = fused_step.variant_name(spec)
    assert name == "fused_control_step_stiction"
    state, actions, dr = _batch(6)
    state, actions = _rest_quarter(spec, state, actions, 7)
    before = fused_step.launch_counts()
    out = fused_step.fused_control_step(spec, state, actions, dr)
    torch.cuda.synchronize()
    after = fused_step.launch_counts()
    assert after[name] == before.get(name, 0) + 1
    assert _others_unchanged(before, after, name)
    ref = fused_step.plain_control_step(spec, state, actions, dr)
    _assert_close_p99(NAMES, (*out[0], out[1], out[2]), (*ref[0], ref[1], ref[2]))
    _assert_same_joints_held(out[0][5], ref[0][5])
    _assert_link_states(env.ma, out[0], *out[3:])

    args = (env.ma, env.hf, env.sim_params, env.pd, tphys.DomainRandParams(*dr),
            env.dof_limits, tphys.PhysicsState(*state), actions)
    st, info = tphys.control_step(*args, spec=spec)
    torch.cuda.synchronize()
    assert fused_step.launch_counts()[name] == after[name] + 1
    st_e, info_e = tphys.control_step(*args, spec=None)
    _assert_close_p99(NAMES, (*st, info.link_forces, info.torques),
                      (*st_e, info_e.link_forces, info_e.torques))
    _assert_link_states(env.ma, st, info.link_pos, info.link_vel)


@pytest.mark.cuda
def test_torque_control_stiction_heightfield_kernel_matches_plain_version():
    """'T' control with implicit stiction on the go2_parkour heightfield, the
    K2 combination farthest from K1, from an env made through the registry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernel has no CPU mode")
    cfg, _ = task_registry.get_cfgs("go2_parkour")
    cfg.env.num_envs = B
    cfg.control.control_type = "T"
    cfg.control.action_scale = 5.0
    cfg.sim.joint_frictionloss_implicit = True
    env, _ = task_registry.make_env("go2_parkour", env_cfg=cfg, device="cuda")
    spec = env.fused_spec
    assert spec.control_type == "T" and spec.fl_dqd and spec.hf_K == 24
    name = fused_step.variant_name(spec)
    assert name == "fused_control_step_T_stiction_hf"
    state, actions, dr = _parkour_batch(env, 8)
    state, actions = _rest_quarter(spec, state, actions, 9)
    lp = patch.extract(env.hf, state[0][0], state[0][1], spec.hf_K)
    terrain = fused_step.patch_inputs(lp)
    before = fused_step.launch_counts()
    out = fused_step.fused_control_step(spec, state, actions, dr, terrain)
    torch.cuda.synchronize()
    after = fused_step.launch_counts()
    assert after[name] == before.get(name, 0) + 1
    assert _others_unchanged(before, after, name)
    ref = fused_step.plain_control_step(spec, state, actions, dr, terrain)
    _assert_close_p99(NAMES, (*out[0], out[1], out[2]), (*ref[0], ref[1], ref[2]), HF_TOL)
    _assert_same_joints_held(out[0][5], ref[0][5])
    _assert_link_states(env.ma, out[0], *out[3:])
    # the torque is the scaled action, clipped to the effort limits: exact
    tlim = torch.tensor(spec.torque_limits, dtype=torch.float32, device="cuda")[:, None]
    torch.testing.assert_close(out[2], torch.maximum(torch.minimum(actions * 5.0, tlim), -tlim),
                               rtol=0, atol=0)


# ---------------------------------------------------------------- the other robots
# The builds of the other robots' tasks at 4096 envs: ANYmal's one-tick 'T'
# spec on the plane and on the rough terrain (its SEA network gives the
# torques between launches), Cassie's heightfield spec and G1's plane spec,
# the bipeds at a pair of lanes a leg (G = 4).
OTHER_BUILDS = {"anymal_c_flat": "fused_control_step_T", "anymal_c_rough": "fused_control_step_T_hf",
                "cassie": "fused_control_step_hf", "g1": "fused_control_step"}
# the layout each build launches at 4096 envs, (lanes per env, lanes per
# branch): ANYmal's legs of 3 a pair of lanes each, the bipeds' chains of 6
# four lanes each, the inward pass split by block (the layout for deep chains)
OTHER_LAYOUTS = {"anymal_c_flat": (8, 2), "anymal_c_rough": (8, 2), "cassie": (8, 4),
                 "g1": (8, 4)}


def _robot_env(task, tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused kernel has no CPU mode")
    import torch_actuator_net

    cfg, _ = task_registry.get_cfgs(task)
    cfg.env.num_envs = B
    if task.startswith("anymal"):
        cfg.control.actuator_net_file = torch_actuator_net.write_sea_net(
            str(tmp_path_factory.mktemp("sea") / "sea.pt"))
    return task_registry.make_env(task, env_cfg=cfg, device="cuda")[0]


@pytest.mark.cuda
@pytest.mark.parametrize("task", list(OTHER_BUILDS))
def test_other_robot_build_matches_plain_version(task, tmp_path_factory):
    import torch_tree_model

    env = _robot_env(task, tmp_path_factory)
    spec = env.fused_spec
    if env._torque_fn is not None:
        spec = fused_step.tick_spec(spec)
    name = fused_step.variant_name(spec)
    assert name == OTHER_BUILDS[task]
    args = torch_tree_model.robot_batch(env, 21, B, "cuda")
    if spec.control_type == "T":      # torques of the SEA network's size
        args = (args[0], (args[1] * 40.0).contiguous(), *args[2:])
    before = fused_step.launch_counts()
    out = fused_step.fused_control_step(spec, *args)
    torch.cuda.synchronize()
    after = fused_step.launch_counts()
    assert after[name] == before.get(name, 0) + 1
    assert _others_unchanged(before, after, name)
    ref = fused_step.plain_control_step(spec, *args)
    _assert_close_p99(NAMES, (*out[0], out[1], out[2]), (*ref[0], ref[1], ref[2]),
                      HF_TOL if spec.hf_K else TOL)
    _assert_link_states(env.ma, out[0], *out[3:])
    # and on a ragged batch, whose last block computes envs beyond B
    ragged = torch_tree_model.robot_batch(env, 24, 1001, "cuda")
    if spec.control_type == "T":
        ragged = (ragged[0], (ragged[1] * 40.0).contiguous(), *ragged[2:])
    ragged_out = fused_step.fused_control_step(spec, *ragged)
    torch.cuda.synchronize()
    _assert_link_states(env.ma, ragged_out[0], *ragged_out[3:])
    assert float(ref[1].abs().max()) > 10.0          # the feet are in contact
    # the build the wrapper launched: its layout, and no spill to local memory
    kernel = fused_step.load_kernel(spec, B)
    info = fused_step.launch_info(kernel, B)
    G, lanes = OTHER_LAYOUTS[task]
    assert (info["lanes_per_env"], info["lanes_per_branch"]) == (G, lanes)
    assert info["grid"] == -(-B * G // info["block"]) and info["resident_blocks_per_sm"] >= 2
    summary = fused_step.ptxas_summary(kernel.ptxas)
    assert summary["spill_store_bytes"] == summary["spill_load_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["anymal_c_flat", "anymal_c_rough"])
def test_actuated_step_on_card_runs_the_one_tick_kernel(task, tmp_path_factory):
    """`physics.actuated_control_step` on CUDA tensors launches the one-tick
    'T' build once per decimation tick and agrees with the eager loop on the
    same tensors, the LSTM state included."""
    import torch_tree_model

    env = _robot_env(task, tmp_path_factory)
    state, actions, dr = torch_tree_model.robot_batch(env, 22, B, "cuda")[:3]
    gen = torch.Generator(device="cuda").manual_seed(23)
    act = tuple(torch.randn((2, 12, 8, B), generator=gen, device="cuda") * 0.3 for _ in range(2))
    args = (env.ma, env.hf, env.sim_params, env.pd, tphys.DomainRandParams(*dr),
            env.dof_limits, tphys.PhysicsState(*state), actions)
    name = OTHER_BUILDS[task]
    before = fused_step.launch_counts()
    st, info, act_k = tphys.actuated_control_step(*args, act, env._torque_fn, spec=env.fused_spec)
    torch.cuda.synchronize()
    after = fused_step.launch_counts()
    assert after[name] == before.get(name, 0) + env.fused_spec.decimation
    assert env.fused_spec.decimation == 4
    assert _others_unchanged(before, after, name)
    st_e, info_e, act_e = tphys.engine._eager_loop(*args, env._torque_fn, act)
    tol = HF_TOL if env.fused_spec.hf_K else TOL
    _assert_close_p99(NAMES, (*st, info.link_forces, info.torques),
                      (*st_e, info_e.link_forces, info_e.torques), tol)
    _assert_link_states(env.ma, st, info.link_pos, info.link_vel)
    for a, b in zip(act_k, act_e):
        _assert_close_p99(("dof_vel",), (a,), (b,), tol)


# ---------------------------------------------------------------- the roofline

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the measurement kernels measure the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fma_chain", "tanh_chain", "stream_add"])
def test_measurement_kernel_returns_its_closed_form(name, card):
    """Each kernel of ops/csrc/peaks.cu on the card, launched once and
    counted at the shapes the peaks are measured at, against the closed
    form of its chain, which depends on the number of steps run."""
    from legged_gym_custom_tpu_torch.ops import roofline

    n = roofline.CHAIN_ELEMENTS
    roofline.reset_launch_counts()
    if name == "fma_chain":   # c <- c * 1 + 0.5 on halves: exact in float32
        iters = roofline.FMA_ITERS
        x = torch.arange(n, device=card, dtype=torch.float32) * 0.5 - 4096.0
        got = roofline.fma_chain(x, 1.0, 0.5, iters)
        assert torch.equal(got, x + 0.5 * iters * roofline.FMA_INNER)
    elif name == "tanh_chain":   # c <- tanh(c) from (0, 1]: ~sqrt(3 / (2 steps))
        iters = roofline.TANH_ITERS
        x = torch.arange(1, n + 1, device=card, dtype=torch.float32) / n
        got = roofline.tanh_chain(x, 0.0, iters)
        ref = x.double()
        for _ in range(iters * roofline.TANH_INNER):
            ref = torch.tanh(ref)
        assert float((got.double() - ref).abs().max()) <= 1e-6
        assert float((got - roofline.plain_tanh_chain(x, 0.0, iters)).abs().max()) <= 1e-6
    else:
        x = (torch.arange(n, device=card) % 1000).float() * 0.25
        assert torch.equal(roofline.stream_add(x), x + 1.0)
    torch.cuda.synchronize()
    assert roofline.launch_counts()[name] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fma_gflops", "trans_gops", "hbm_gbps"])
def test_measured_peak_lies_within_the_data_sheet(name, card):
    """A measured rate between 20 % and 105 % of the published one (above
    it, the measurement is at fault)."""
    from legged_gym_custom_tpu_torch.ops import roofline

    measure = {"fma_gflops": roofline.measure_fma_peak_gflops,
               "trans_gops": roofline.measure_trans_rate_gops,
               "hbm_gbps": roofline.measure_hbm_bw_gbps}[name]
    share = measure(device=card) / roofline.DATASHEET_PEAKS[name]
    assert 0.20 <= share <= 1.05, share


@pytest.mark.cuda
@pytest.mark.parametrize("terrain", [True, False])
def test_fused_kernel_receipt_passes_its_ks_gate(terrain, card, tmp_path):
    """`check_fused_gpu [--terrain] --full_plant --rollout 10 --batch 1024`:
    the kernel (K3, or K1 on the plane) against its plain version one step
    and ten closed-loop steps."""
    from legged_gym_custom_tpu_torch.scripts import check_fused_gpu

    fused_step.reset_launch_counts()
    out = check_fused_gpu.main(["--terrain"] * terrain + [
        "--full_plant", "--rollout", "10", "--batch", "1024", "--iters", "5", "--out",
        str(tmp_path / "r.json")])
    assert out["rollout_pass"] and max(out["rollout_ks"].values()) < 0.05
    variant = "fused_control_step_hf" if terrain else "fused_control_step"
    counts = {k: n for k, n in fused_step.launch_counts().items() if n}
    assert counts == {variant: 1 + 6 + 10}
    assert out["kernel_ms"] > 0.0 and out["speedup"] > 1.0
    assert out["parity_outlier_env_frac"]["dof_pos"] <= 0.01


# ---------------------------------------------------------------- data parallel

@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_train_through_k1(card, tmp_path):
    """Two ranks of `scripts.multihost_worker` share cuda:0 (so gloo, by the
    backend rule) for one go2 iteration at 256 global envs: each launches K1
    once per env step and in `reset_all`, and nothing else; the parameters
    come out bit-equal across ranks; the checkpoint round trip restores."""
    from legged_gym_custom_tpu_torch.scripts import multihost_worker

    result, _ = multihost_worker.launch(
        2, ["--task", "go2", "--num_envs", "256", "--iterations", "1", "--device", "cuda:0",
            "--ckpt_dir", str(tmp_path)], timeout=600)
    assert (result["backend"], result["device"]) == ("gloo", "cuda:0")
    assert [r["launches"] for r in result["ranks"]] == [K1_ITERATION] * 2
    assert [r["local_envs"] for r in result["ranks"]] == [128, 128]
    assert result["params_bit_equal"] and result["restored_iteration"] == 1
    assert all(r["losses_finite"] for r in result["ranks"])


@pytest.mark.cuda
def test_two_nccl_ranks_on_two_cards_train_through_k1(card, tmp_path):
    """Two ranks of `scripts.multihost_worker`, one a card (so nccl, by the
    backend rule: the all-reduces run on the device buffers, the barrier
    names each rank's card), one go2 iteration at 256 global envs: each rank
    launches K1 once per env step and in `reset_all`, and nothing else; the
    parameters come out bit-equal across ranks; the checkpoint round trip
    restores."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: nccl takes one rank a card")
    from legged_gym_custom_tpu_torch.scripts import multihost_worker

    result, _ = multihost_worker.launch(
        2, ["--task", "go2", "--num_envs", "256", "--iterations", "1", "--device", "cuda",
            "--ckpt_dir", str(tmp_path)], timeout=600)
    assert (result["backend"], result["device"]) == ("nccl", "cuda:0")
    assert [r["device"] for r in result["ranks"]] == ["cuda:0", "cuda:1"]
    assert [r["launches"] for r in result["ranks"]] == [K1_ITERATION] * 2
    assert [r["local_envs"] for r in result["ranks"]] == [128, 128]
    assert result["params_bit_equal"] and result["restored_iteration"] == 1
    assert all(r["losses_finite"] for r in result["ranks"])


@pytest.mark.cuda
def test_train_script_on_two_gloo_ranks_of_one_card(card):
    """`scripts.train` as two ranks sharing cuda:0 (gloo) under torch's
    variables, go2 at 256 global envs for one iteration: one run directory,
    the primary's checkpoints and event file; each rank launches K1 once
    per env step and in `reset_all`, and nothing else; the parameters come
    out bit-equal across ranks."""
    import json
    import os
    import shutil

    from legged_gym_custom_tpu_torch import LEGGED_GYM_TORCH_ROOT_DIR
    from legged_gym_custom_tpu_torch.parallel import multihost
    from legged_gym_custom_tpu_torch.scripts import train as train_script

    experiment = "test_train_script_ranks"
    root = os.path.join(LEGGED_GYM_TORCH_ROOT_DIR, "logs", experiment)
    shutil.rmtree(root, ignore_errors=True)
    try:
        outputs = multihost.launch_module(
            train_script.MODULE, 2, ["--task", "go2", "--num_envs", "256", "--max_iterations",
                                     "1", "--device", "cuda:0", "--experiment_name", experiment],
            timeout=600, torch_env=True)
        line = next(l for l in outputs[0].splitlines() if l.startswith("[train] ranks: "))
        report = json.loads(line[len("[train] ranks: "):])
        assert (report["world_size"], report["backend"], report["iteration"]) == (2, "gloo", 1)
        assert [r["launches"] for r in report["ranks"]] == [K1_ITERATION] * 2
        assert [r["local_envs"] for r in report["ranks"]] == [128, 128]
        assert report["params_bit_equal"]
        runs = os.listdir(root)
        assert len(runs) == 1 and os.path.join(root, runs[0]) == report["log_dir"]
        files = os.listdir(report["log_dir"])
        assert sorted(f for f in files if f.startswith("model_")) == ["model_0.pt", "model_1.pt"]
        assert len([f for f in files if "tfevents" in f]) == 1
        assert "Learning iteration 0/1" in outputs[0] and "Learning iteration" not in outputs[1]
    finally:
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.cuda
def test_train_script_started_plainly_runs_a_rank_a_card(card):
    """`python -m ...scripts.train --task go2 --device cuda`, started with no
    torch variables on a machine with several cards, runs one nccl rank a
    card (cards_to_use: every visible card), go2 at 1024 global envs for
    one iteration: ranks on cuda:0, cuda:1, ...; each launches K1 once per
    env step and in `reset_all`, and nothing else; one run directory; the
    console block once; the parameters bit-equal across ranks."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices: a plain start on one card stays one process")
    import json
    import os
    import shutil
    import subprocess
    import sys

    from legged_gym_custom_tpu_torch import LEGGED_GYM_TORCH_ROOT_DIR
    from legged_gym_custom_tpu_torch.scripts import train as train_script

    experiment = "test_train_script_plain_start"
    root = os.path.join(LEGGED_GYM_TORCH_ROOT_DIR, "logs", experiment)
    shutil.rmtree(root, ignore_errors=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    try:
        proc = subprocess.run(
            [sys.executable, "-m", train_script.MODULE, "--task", "go2", "--num_envs", "1024",
             "--max_iterations", "1", "--device", "cuda", "--experiment_name", experiment],
            cwd=LEGGED_GYM_TORCH_ROOT_DIR, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        assert f"[train] {n} ranks, one per card" in proc.stdout
        line = next(l for l in proc.stdout.splitlines() if l.startswith("[train] ranks: "))
        report = json.loads(line[len("[train] ranks: "):])
        assert (report["world_size"], report["backend"], report["iteration"]) == (n, "nccl", 1)
        assert [r["device"] for r in report["ranks"]] == [f"cuda:{i}" for i in range(n)]
        assert [r["launches"] for r in report["ranks"]] == [K1_ITERATION] * n
        assert sum(r["local_envs"] for r in report["ranks"]) == 1024
        assert report["params_bit_equal"] and all(r["losses_finite"] for r in report["ranks"])
        runs = os.listdir(root)
        assert len(runs) == 1 and os.path.join(root, runs[0]) == report["log_dir"]
        assert proc.stdout.count("Learning iteration 0/1") == 1
    finally:
        shutil.rmtree(root, ignore_errors=True)
