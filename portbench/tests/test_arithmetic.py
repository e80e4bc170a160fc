"""The rate, percentile, busy and idle arithmetic on synthetic timings."""
import math

import numpy as np
import pytest

from portbench import harness, trace
from portbench.run import Run

MS = 1_000_000


def synthetic():
    # window 0..100 ms; device busy 10-20, 15-30 (overlap), 50-60, 95-110 (clipped)
    device = [("k", 10 * MS, 20 * MS), ("fused_control_step_kernel", 15 * MS, 30 * MS),
              ("k", 50 * MS, 60 * MS), ("k", 95 * MS, 110 * MS)]
    host = [("pb.window", 0, 100 * MS), ("pb.solve", 0, 40 * MS), ("pb.solve", 40 * MS, 100 * MS),
            ("pb.env_step", 0, 40 * MS), ("cudaLaunchKernel", 1 * MS, 2 * MS),
            ("cudaLaunchKernel", 3 * MS, 4 * MS), ("cudaMemcpyAsync", 41 * MS, 42 * MS),
            ("pb.policy_act", 40 * MS, 45 * MS), ("aten::item", 70 * MS, 90 * MS)]
    # the host's runtime call that issued each device event (the last: none in the trace)
    launched = [1 * MS, 3 * MS, 41 * MS, None]
    return trace.Trace(device, host, (0, 100 * MS), {}, launched)


def test_busy_is_the_union_clipped_to_the_window():
    t = synthetic()
    assert t.busy_s() == pytest.approx((20 + 10 + 5) / 1e3)
    assert t.window_s == pytest.approx(0.1)
    idle = harness.load_module("metrics", "device_idle_pct.train").read(Run(None, t, {}))
    assert idle == pytest.approx(65.0)


def test_per_span_and_the_mpc_readers():
    t = synthetic()
    spans = t.per_span("pb.solve")
    assert [len(s) for s in spans] == [2, 2]
    busy = harness.load_module("metrics", "mpc_device_busy_ms").read(Run(None, t, {}))
    assert busy == pytest.approx(((10 + 15) + (10 + 15)) / 2)
    assert harness.load_module("metrics", "mpc_launches_per_solve").read(Run(None, t, {})) == 2


def test_device_events_issued_inside_env_step_and_act_spans_count():
    """Each device event counts once, by the host call that issued it: two
    inside the env step, one inside the act, one with no call in the trace;
    over the one env step."""
    t = synthetic()
    reader = harness.load_module("metrics", "env_step_launches")
    assert reader.read(Run(None, t, {})) == 3
    t.spans = [s for s in t.spans if s[0] != "pb.policy_act"]
    assert reader.read(Run(None, t, {})) == 2


def test_breakdown_names_the_longest_gap_by_the_host():
    b = trace.breakdown(synthetic())
    assert b["device_ops"][0] == ["k", pytest.approx(0.025)]
    label, length = b["idle_gaps"][0]
    assert length == pytest.approx(0.035) and label == "pb.solve > aten::item"


def test_window_readers():
    its = [(1.0, 0.8, 0.2, True, True), (0.5, 0.4, 0.1, False, True)]
    run = Run({"iterations": its, "elapsed_s": 1.5, "envs": 4096, "steps_per_env": 24}, None, {})
    share = harness.load_module("metrics", "train_collect_share_pct").read(run)
    assert share == pytest.approx(100 * 1.2 / 1.5)
    assert harness.load_module("metrics", "ppo_update_ms").read(run) == pytest.approx(150.0)
    assert harness.load_module("metrics", "train_collect_share_pct").read(
        Run({"iterations": []}, None, {})) is None


def test_readers_find_nothing_and_return_nothing():
    empty = trace.Trace([], [("pb.window", 0, MS)], (0, MS), {})
    for name in ("device_idle_pct.train", "mpc_device_busy_ms", "mpc_launches_per_solve",
                 "env_step_launches"):
        assert harness.load_module("metrics", name).read(Run(None, empty, {})) is None
    assert harness.load_module("metrics", "fused_kernel_roofline_pct").read(
        Run(None, empty, {"launch_spec": None})) is None


def test_p95_has_samples_beyond_it_and_rate_counts_the_whole_window():
    wall = np.linspace(0.1, 0.3, 200)
    q = np.percentile(wall * 1e3, 95)
    assert (wall * 1e3 > q).sum() == 10
    assert 8 * len(wall) / wall.sum() == pytest.approx(8 / wall.mean())


def test_judge_fails_missing_nonfinite_and_high():
    ok, out = harness.judge({"a": 1.0, "b": float("nan")}, {"a": 2.0, "b": 1.0, "c": 1.0})
    assert not ok and out["a"] == {"value": 1.0, "limit": 2.0}
    assert harness.judge({"a": 1.0}, {"a": 2.0})[0]
    assert not harness.judge({"a": 3.0}, {"a": 2.0})[0]


def test_seeds_take_more_than_32_bits():
    s = harness.seeds(2**31 + 12345)
    assert all(0 <= x < 2**31 for x in s) and len(set(s)) == 4
    assert harness.seeds(2**31 + 12345) == s != harness.seeds(2**31 + 12346)
    assert not math.isnan(float(s.terrain))
