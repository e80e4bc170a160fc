"""The program's spans (`utils/profiling.py::span`) on the CPU: where each
`lgc.*` span sits under a torch.profiler, that the env step's five phases
tile it, that a control step records one physics span whichever entry point
runs it, and that with no profiler running nothing enters a
`record_function`."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from legged_gym_custom_tpu_torch import physics as phys
from legged_gym_custom_tpu_torch.envs import task_registry
from legged_gym_custom_tpu_torch.mpc import MPPI, MPPIConfig
from legged_gym_custom_tpu_torch.rl import ppo as ppo_lib
from legged_gym_custom_tpu_torch.utils import profiling

PHASES = ["lgc.env." + p for p in ("physics", "post_physics", "rewards", "reset", "obs")]
H = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def go2():
    """go2 at 4 envs on the CPU, one tick of one substep a control step (the
    eager engine's ops, each recorded by the profiler, are the tests' cost),
    its runner (4 steps an iteration), one collection to update from, and a
    small MPPI on the same env."""
    env_cfg, train_cfg = task_registry.get_cfgs("go2")
    env_cfg.env.num_envs = 4
    env_cfg.control.decimation = env_cfg.sim.substeps = 1
    train_cfg.runner.num_steps_per_env = 4
    env, _ = task_registry.make_env("go2", env_cfg=env_cfg, device="cpu")
    runner, _ = task_registry.make_alg_runner(env, train_cfg=train_cfg, log_root=None)
    runner.env_state, runner.obs = env.reset_all(runner.generator, init_at_random_ep_len=True)
    traj, returns, advantages, _ = runner._collect(False)
    mpc = MPPI(env, MPPIConfig(horizon=H, num_samples=2))
    return dict(env=env, runner=runner, update=(traj, returns, advantages), mpc=mpc)


def _step(go2):
    env, runner = go2["env"], go2["runner"]
    actions = torch.zeros(env.num_envs, env.num_actions)
    return env.step(runner.env_state, actions)


def _update(go2, kind):
    runner = go2["runner"]
    traj, returns, advantages = go2["update"]
    if kind == "ppo":
        return ppo_lib.ppo_update(runner.ppo_cfg, runner.train_state, traj, returns, advantages,
                                  runner.generator)
    return ppo_lib.dagger_update(runner.ppo_cfg, runner.train_state, traj, runner.generator)


def _solve(go2):
    env, mpc = go2["env"], go2["mpc"]
    st = go2["runner"].env_state
    return mpc.solve(mpc.init_state(env.num_envs), st.physics, st.dr, st.commands,
                     torch.Generator().manual_seed(0))


def _events(fn):
    """(name, start_ns, end_ns) of every host event of `fn()` under a CPU
    torch.profiler, sorted by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()), key=lambda e: e[1])


def _spans(events, name):
    return [(b, e) for n, b, e in events if n == name]


def _inside(x, window):
    return window[0] <= x[1] and x[2] <= window[1]


def test_span_is_one_shared_null_context_without_a_profiler():
    assert profiling.span("lgc.a") is profiling.span("lgc.b")
    with profile(activities=[ProfilerActivity.CPU]):
        on = profiling.span("lgc.a")
    assert on is not profiling.span("lgc.a")


def test_env_step_phases_tile_the_step(go2):
    """One `lgc.env.step`; the five phases inside it in order, without
    overlap; every aten op of the step in exactly one phase."""
    events = _events(lambda: _step(go2))
    (step,) = _spans(events, "lgc.env.step")
    phases = []
    for name in PHASES:
        (window,) = _spans(events, name)
        assert step[0] <= window[0] and window[1] <= step[1], name
        phases.append(window)
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:])), phases
    ops = [e for e in events if e[0].startswith("aten::") and _inside(e, step)]
    assert len(ops) > 100
    for op in ops:
        assert sum(_inside(op, w) for w in phases) == 1, op


def test_env_step_records_one_physics_span_a_step(go2):
    def two_steps():
        env, runner = go2["env"], go2["runner"]
        state = runner.env_state
        for _ in range(2):
            state = env.step(state, torch.zeros(env.num_envs, env.num_actions))[0]

    events = _events(two_steps)
    physics = _spans(events, "lgc.physics")
    env_physics = _spans(events, "lgc.env.physics")
    assert len(physics) == 2 and len(env_physics) == 2
    for p, w in zip(physics, env_physics):
        assert w[0] <= p[0] and p[1] <= w[1]
    assert all(a[1] <= b[0] for a, b in zip(physics, physics[1:]))


def _engine_args(env):
    """A control step's arguments from the env's reset state, component-major
    as `LeggedEnv._vstep` hands them to the engine."""
    st = env.reset_all(torch.Generator().manual_seed(1))[0]
    cb = lambda x: x.movedim(0, -1).contiguous()
    return (env.ma, env.hf, env.sim_params, env.pd, phys.DomainRandParams(*map(cb, st.dr)),
            env.dof_limits, phys.PhysicsState(*map(cb, st.physics)),
            torch.zeros(env.num_actions, env.num_envs))


def _pd_torques(actions, q, qd, state):
    return -2.0 * qd, state


@pytest.mark.parametrize("entry", ["control_step", "eager_control_step",
                                   "actuated_control_step", "eager_actuated_control_step"])
def test_each_engine_entry_point_records_one_physics_span(go2, entry):
    args = _engine_args(go2["env"])
    fn = getattr(phys, entry)
    call = lambda: fn(*args)
    if "actuated" in entry:
        call = lambda: fn(*args, torch.zeros(args[-1].shape[-1]), _pd_torques)
    assert len(_spans(_events(call), "lgc.physics")) == 1


@pytest.mark.parametrize("kind", ["ppo", "dagger"])
def test_update_records_one_span_of_its_kind(go2, kind):
    events = _events(lambda: _update(go2, kind))
    other = "dagger" if kind == "ppo" else "ppo"
    assert len(_spans(events, "lgc.update." + kind)) == 1
    assert _spans(events, "lgc.update." + other) == []


def test_mppi_solve_holds_a_physics_and_a_stage_cost_span_a_horizon_step(go2):
    events = _events(lambda: _solve(go2))
    (solve,) = _spans(events, "lgc.mppi.solve")
    for name in ("lgc.physics", "lgc.mppi.stage_cost"):
        windows = _spans(events, name)
        assert len(windows) == H, name
        assert all(solve[0] <= b and e <= solve[1] for b, e in windows), name
    assert _spans(events, "lgc.env.step") == []


def test_no_span_is_entered_without_a_profiler(go2, monkeypatch):
    """A step, both updates and a solve enter no `record_function` while no
    profiler records; the same patch raises as soon as one does."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    _step(go2)
    _update(go2, "ppo")
    _update(go2, "dagger")
    _solve(go2)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="lgc.env.step"):
            _step(go2)
