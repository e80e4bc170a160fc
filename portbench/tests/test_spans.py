"""The readers of the program's own spans (`portbench/spans.py`) on
synthetic traces: nested spans, a DAgger update beside the PPO one, events
and spans outside the traced window, and None where the program marked no
such span."""
import pytest

from portbench import harness, spans, trace
from portbench.run import Run

US = 1_000
PHASES = ("physics", "post_physics", "rewards", "reset", "obs")


def read(name, t):
    return harness.load_module("metrics", name).read(Run(None, t, {}))


def train_trace():
    """Window 100-1000 us.  Two env steps (100-300, 300-500), each cut into
    the five phases of 40 us, with the physics call nested in the first
    phase; a PPO update (500-700) and a DAgger update (700-900).  One env
    step before the window (0-50) is not counted."""
    host = [("pb.window", 100 * US, 1000 * US), ("lgc.env.step", 0, 50 * US),
            ("lgc.env.physics", 0, 10 * US), ("cudaLaunchKernel", 5 * US, 6 * US)]
    launched = [5 * US]
    for s in (100, 300):
        host.append(("lgc.env.step", s * US, (s + 200) * US))
        for k, ph in enumerate(PHASES):
            b = s + 40 * k
            host.append(("lgc.env." + ph, b * US, (b + 40) * US))
        host.append(("lgc.physics", (s + 5) * US, (s + 30) * US))
        # the physics phase issues 3 events (2 of them in the physics call),
        # the rewards phase 1, the obs phase 2; nothing in the others
        launched += [(s + t) * US for t in (2, 10, 20, 90, 170, 171)]
    host += [("lgc.update.ppo", 500 * US, 700 * US), ("lgc.update.dagger", 700 * US, 900 * US),
             ("cudaMemcpyAsync", 510 * US, 511 * US), ("cudaStreamSynchronize", 511 * US, 530 * US),
             ("cudaStreamSynchronize", 710 * US, 720 * US)]
    launched += [510 * US, 520 * US, 710 * US, 720 * US, 730 * US, None]
    device = [("k", (t or 0) + 50 * US, (t or 0) + 60 * US) for t in launched]
    return trace.Trace(device, sorted(host, key=lambda h: h[1]), (100 * US, 1000 * US), {},
                       launched)


def test_env_phases_count_what_each_issued_over_the_steps():
    t = train_trace()
    got = {ph: read("env_launches." + ph, t) for ph in PHASES}
    assert got == {"physics": 3, "post_physics": 0, "rewards": 1, "reset": 0, "obs": 2}
    # the phases add up to the env step's own count (no act in this trace)
    assert sum(got.values()) == read("env_step_launches", _with_pb_steps(t))
    assert read("env_step_syncs", t) == 0


def _with_pb_steps(t):
    """The trace with the harness's spans around the same env steps."""
    t.spans = [("pb.env_step", b, e) for n, b, e in t.host
               if n == "lgc.env.step" and b >= t.window[0]]
    return t


def test_the_ppo_readers_leave_the_dagger_update_out():
    t = train_trace()
    assert read("ppo_update_launches", t) == 2
    assert read("ppo_update_syncs", t) == 1


def test_a_span_recorded_with_nothing_in_it_reads_zero():
    t = train_trace()
    t.launched = [None] * len(t.launched)
    assert read("env_launches.physics", t) == 0
    assert read("ppo_update_launches", t) == 0


def mpc_trace():
    """Two solves in the window, each with two physics calls and two stage
    costs; a physics call outside any solve (an env step's) is left out."""
    host = [("pb.window", 0, 1000 * US), ("lgc.physics", 900 * US, 950 * US)]
    launched = [910 * US]
    for s in (0, 400):
        host.append(("lgc.mppi.solve", s * US, (s + 300) * US))
        for h in (0, 100):
            host += [("lgc.physics", (s + h + 10) * US, (s + h + 50) * US),
                     ("lgc.mppi.stage_cost", (s + h + 50) * US, (s + h + 90) * US)]
            launched += [(s + h + 20) * US, (s + h + 30) * US, (s + h + 60) * US]
        launched.append((s + 250) * US)      # the plan update, in neither
    device = [("k", t, t + 5 * US) for t in launched]
    return trace.Trace(device, sorted(host, key=lambda h: h[1]), (0, 1000 * US), {}, launched)


def test_mpc_readers_split_a_solve():
    t = mpc_trace()
    assert read("mpc_launches.physics", t) == 4
    assert read("mpc_launches.stage_cost", t) == 2


@pytest.mark.parametrize("name", ["env_launches." + p for p in PHASES] + [
    "env_step_syncs", "ppo_update_launches", "ppo_update_syncs", "mpc_launches.physics",
    "mpc_launches.stage_cost"])
def test_none_without_the_span(name):
    """A program that marks no span (or a trace with none in the window)
    reads None, never 0; so does a run without a trace."""
    t = trace.Trace([("k", 10, 20)], [("pb.window", 0, 100), ("pb.env_step", 0, 50),
                                      ("cudaStreamSynchronize", 5, 6)], (0, 100), {}, [5])
    assert read(name, t) is None
    assert harness.load_module("metrics", name).read(Run(None, None, {})) is None
    late = train_trace() if not name.startswith("mpc") else mpc_trace()
    late.window = (late.window[1], late.window[1] + 10)
    assert read(name, late) is None


def test_sync_names():
    assert {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy"} <= spans.SYNCS
    assert "cudaMemcpyAsync" not in spans.SYNCS and "cudaLaunchKernel" not in spans.SYNCS
