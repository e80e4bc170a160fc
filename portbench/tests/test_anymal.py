"""The ANYmal-C rough cell (`anymal_c_rough_train`): the SEA LSTM's state is
part of what `correct` compares, so a run whose LSTM state is not carried
from tick to tick, or whose actuator state is not zeroed on reset, comes out
not correct at the cell's limits (a tiny size on the CPU, the look for a
chip skipped); the actuator's readers count the `lgc.actuator` spans and
read None on a Go2 run, which has none; on the card the program passes the
cell's limits and the TF32 control fails them."""
import pytest
import torch

from portbench import harness, trace
from portbench.run import Run
from portbench.tests import tiny
from portbench.tests.test_spans import US, train_trace

CELL = "anymal_c_rough_train"
# Episodes of five steps, so that the tiny cell's sampled steps hold resets.
SHORT_EPISODES = {"env.episode_length_s": 0.1}


@pytest.fixture
def broken(monkeypatch):
    from legged_gym_custom_tpu_torch import physics
    from legged_gym_custom_tpu_torch.envs import base_env

    orig = physics.actuated_control_step

    def lstm_not_carried(*a, spec=None):
        """Every tick's LSTM starts from the control step's first state."""
        first, torque_fn = a[8], a[9]
        return orig(*a[:9], lambda x, q, qd, _: torque_fn(x, q, qd, first), spec=spec)

    def not_zeroed_on_reset(self, act_state, reset_mask):
        return act_state

    patch = lambda mod, name, fn: lambda: monkeypatch.setattr(mod, name, fn)
    return {"lstm_not_carried": patch(physics, "actuated_control_step", lstm_not_carried),
            "not_zeroed_on_reset": patch(base_env.LeggedEnv, "_reset_actuator_state",
                                         not_zeroed_on_reset)}


def test_the_sound_tiny_cell_is_correct():
    torch.set_num_threads(2)
    _, readings, _ = tiny.run(CELL, extra=SHORT_EPISODES)
    assert tiny.judged(CELL, readings["program"]), readings["program"]
    assert readings["program"]["env_reset_median"] == 0.0


@pytest.mark.parametrize("fault", ["lstm_not_carried", "not_zeroed_on_reset"])
def test_a_broken_actuator_state_is_not_correct(broken, fault):
    torch.set_num_threads(2)
    broken[fault]()
    _, readings, _ = tiny.run(CELL, extra=SHORT_EPISODES)
    p = readings["program"]
    assert not tiny.judged(CELL, p), p
    limits = harness.load_workload(CELL)["limits"]
    if fault == "not_zeroed_on_reset":     # seen by the envs that reset
        assert p["env_reset_median"] > limits["env_reset_median"], p


def anymal_trace():
    """go2's synthetic training trace (`test_spans.train_trace`) with an
    actuator span a tick: four inside each env step's physics call, the
    first of each issuing two device events of 10 us, the others none."""
    t = train_trace()
    host = list(t.host)
    for s in (100, 300):
        host += [("lgc.actuator", (s + b) * US, (s + b + 2) * US) for b in (6, 12, 16, 22)]
    issued = [(s + 7) * US for s in (100, 300) for _ in range(2)]
    device = t.device + [("k", h + 50 * US, h + 60 * US) for h in issued]
    launched = t.launched + issued
    order = sorted(range(len(device)), key=lambda i: device[i][1])
    return trace.Trace([device[i] for i in order], sorted(host, key=lambda h: h[1]), t.window,
                       {}, [launched[i] for i in order])


def read(name, t):
    return harness.load_module("metrics", name).read(Run(None, t, {}))


def test_the_actuator_readers():
    t = anymal_trace()
    assert read("env_launches.actuator", t) == 2
    assert read("actuator_device_ms", t) == pytest.approx(2 * 0.010)
    # the physics phase still counts everything inside it, the actuator's too
    assert read("env_launches.physics", t) == read("env_launches.physics", train_trace()) + 2


@pytest.mark.parametrize("name", ["env_launches.actuator", "actuator_device_ms"])
def test_the_actuator_readers_read_none_on_a_go2_run(name):
    """go2's env steps mark no `lgc.actuator` span; a run without a trace,
    or with the spans outside the window, reads None as well."""
    assert read(name, train_trace()) is None
    assert harness.load_module("metrics", name).read(Run(None, None, {})) is None
    late = anymal_trace()
    late.window = (late.window[1], late.window[1] + 10)
    assert read(name, late) is None


def _full_size(card, seed, control=False):
    workload = harness.load_workload(CELL)
    config = harness.load_json("configs", workload["config"])
    driver = harness.load_module("drivers", workload["driver"]).Driver(config, workload, seed,
                                                                       card)
    driver.window(0.0)
    driver.release()
    return driver.check(control=control)


@pytest.fixture
def float32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


@pytest.mark.cuda
def test_the_control_fails_on_the_card(card, float32):
    """At the cell's own size the program passes the cell's limits and the
    reference in TF32 in the program's place fails them."""
    readings = _full_size(card, 11, control=True)
    assert tiny.judged(CELL, readings["program"]), readings["program"]
    assert not tiny.judged(CELL, readings["control"]), readings["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["lstm_not_carried", "not_zeroed_on_reset"])
def test_a_broken_actuator_state_fails_on_the_card(card, float32, broken, fault):
    """The same faults at the cell's own size, on the tick-wise path."""
    broken[fault]()
    readings = _full_size(card, 12)
    assert not tiny.judged(CELL, readings["program"]), readings["program"]
