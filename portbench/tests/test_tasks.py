"""A configuration of any task of the port's registry can be run and checked
with new files only: the frozen task table knows every task, a network the
task loads from a file is made from the seed, and the counts follow the
kernel launch that the roofline times."""
import gc

import pytest
import torch

from portbench import harness, trace
from portbench.reference import kernel_ops, net_flops, peaks, train_ref
from portbench.reference.frozen.envs import TASKS
from portbench.reference.frozen.ops.fused_step import tick_spec
from portbench.run import Run
from portbench.tests import tiny

ENV_NUMBERS = ("env_median", "env_p99", "env_reset_median", "env_done_mismatch")


def test_the_frozen_table_knows_every_registered_task():
    from legged_gym_custom_tpu_torch.envs import task_registry

    assert set(TASKS) == set(task_registry.task_classes)
    for name, (env_cls, env_cfg, train_cfg) in TASKS.items():
        assert env_cls.__module__.startswith("portbench.reference.frozen.")
        assert env_cls.__name__ == task_registry.get_task_class(name).__name__
        assert env_cfg.__name__ == task_registry.env_cfgs[name].__name__
        assert train_cfg.__name__ == task_registry.train_cfgs[name].__name__
    assert train_ref.TASKS is TASKS


def _driver(task):
    """The training driver's set-up of `task` at the tiny size, from a
    configuration made here (no committed cell)."""
    config = {"name": task, "task": task, "set": dict(tiny.TINY["train"]["set"])}
    return harness.load_module("drivers", "train").Driver(
        config, harness.load_workload("go2_train"), 2**31 + 11, torch.device("cpu"))


@pytest.mark.parametrize("task", ["anymal_c_rough", "anymal_c_flat", "cassie", "g1",
                                  "go2_stiction", "go2"])
def test_env_steps_agree_with_the_reference(task):
    """The frozen env's step from the program's recorded state stays within
    go2_train's limits; ANYmal's LSTM state is among the outputs compared,
    and the facts name the launch the kernel events time (go2's as before
    the tick-wise path was counted: its spec, once a step)."""
    torch.set_num_threads(2)
    d = _driver(task)
    env = train_ref.make_env(d.task, d.overrides, d.seeds.terrain, "cpu")
    gaps = [train_ref.env_step_gaps(env, r) for r in d.record.env_steps]
    numbers = train_ref.env_numbers(gaps)
    limits = {k: v for k, v in harness.load_workload("go2_train")["limits"].items()
              if k in ENV_NUMBERS}
    assert harness.judge(numbers, limits)[0], numbers
    out = train_ref.program_outputs(d.record.env_steps[0]["out"])
    sea = task.startswith("anymal")
    assert ("actuator.0" in out and "actuator.1" in out) == sea
    facts = d.facts()
    spec = d.env.fused_spec
    assert facts["launch_spec"] == tick_spec(spec) if sea else facts["launch_spec"] is spec
    assert facts["launches"] == (spec.decimation if sea else 1)
    del d, env
    gc.collect()


def test_the_sea_network_is_made_from_the_seed():
    """The same weights seed gives the same `LSTMWeights` in the program and
    the reference, through their own loaders; another seed, other weights."""
    from legged_gym_custom_tpu_torch.models.actuator_net import load_actuator_net as program
    from portbench.reference.frozen.models.actuator_net import load_actuator_net as reference

    def weights(seed, loader):
        cfgs = train_ref.configs("anymal_c_rough", {})
        over = harness.seeded_networks(cfgs, seed, "cpu")
        assert over == {"control.actuator_net_file": cfgs[0].control.actuator_net_file}
        assert str(seed) in over["control.actuator_net_file"]
        w = loader(over["control.actuator_net_file"])
        return [t for leaf in w for t in (leaf if isinstance(leaf, tuple) else (leaf,))]

    a, b = weights(2**31 + 5, program), weights(2**31 + 5, reference)
    assert len(a) == len(b) == 2 * 4 + 4 and all(torch.equal(x, y) for x, y in zip(a, b))
    assert [tuple(x.shape) for x in a[:8]] == [(32, 2), (32, 8), (32, 8), (32, 8),
                                               (32,), (32,), (32,), (32,)]
    assert [tuple(x.shape) for x in a[8:]] == [(1, 8), (1,), (2,), ()]
    assert torch.equal(a[-2], torch.ones(2)) and float(a[-1]) == 1.0
    c = weights(2**31 + 6, program)
    assert not any(torch.equal(x, y) for x, y in zip(a[:10], c[:10]))
    assert harness.seeded_networks(train_ref.configs("go2", {}), 5, "cpu") == {}


# The parent's counts: the frozen kernel count of go2's K1 and go2_parkour's
# K3 specs, their bytes, the networks' forward FLOPs a sample, and one
# iteration's FLOPs at 4096 envs x 24 steps x 5 epochs (PPO, DAgger).
PARENT = {
    "go2": ({"flops": 143586, "transcendentals": 1280, "other_prims": 1062}, 736,
            [3937787379712.0, 349554540544.0]),
    "go2_parkour": ({"flops": 165914, "transcendentals": 1440, "other_prims": 94982}, 3048,
                    [3939982311424.0, 351749472256.0]),
}
GO2_MODULES = {"estimator": 359168, "priv_encoder": 7072, "adapt_encoder": 54000,
               "scan_encoder": 54272, "actor": 972800, "critic": 1081600, "actuator": 0}


def _spec(task):
    import argparse

    from legged_gym_custom_tpu_torch.envs import task_registry

    env_cfg, _ = task_registry.get_cfgs(task)
    env_cfg.env.num_envs = 8
    if env_cfg.control.use_actuator_network:
        harness.seeded_networks((env_cfg,), 3, "cpu")
    env, _ = task_registry.make_env(task, args=argparse.Namespace(seed=3), env_cfg=env_cfg,
                                    device="cpu")
    return env.fused_spec


WINDOW = {"iterations": [(1.0, 0.5, 0.5, False, True), (1.0, 0.5, 0.5, True, True)],
          "elapsed_s": 1.0, "envs": 4096, "steps_per_env": 24}


def _mfu(facts, cfgs):
    """`train_mfu_pct` over a window of a PPO and a DAgger iteration."""
    run = Run(WINDOW, None, dict(facts, epochs=5, configs=cfgs))
    return harness.load_module("metrics", "train_mfu_pct").read(run)


@pytest.mark.parametrize("task", ["go2", "go2_parkour"])
def test_go2_counts_are_the_parents(task):
    ops, nbytes, iters = PARENT[task]
    spec = _spec(task)
    assert kernel_ops.count_kernel_ops(spec) == ops
    assert kernel_ops.kernel_bytes_per_env(spec) == nbytes
    mods = net_flops.module_flops(*train_ref.configs(task, {}))
    assert mods == GO2_MODULES
    assert [net_flops.iteration_flops(mods, ops["flops"], 4096, 24, 5, d)
            for d in (False, True)] == iters
    assert _mfu({"launch_spec": spec, "launches": 1}, train_ref.configs(task, {})) == \
        100.0 * sum(iters) / (WINDOW["elapsed_s"] * peaks.FP32_FLOPS)


def test_tickwise_launches_count_the_one_tick_spec():
    """ANYmal rough: the roofline holds a kernel event against the one-tick
    spec's count (the port's own count of that build: 18457 flops and 152
    transcendentals an env), and the MFU counts four such launches and the
    SEA network's products at every tick, counted here by hand."""
    spec = _spec("anymal_c_rough")
    one = tick_spec(spec)
    ops = kernel_ops.count_kernel_ops(one)
    assert (ops["flops"], ops["transcendentals"]) == (18457, 152)
    from legged_gym_custom_tpu_torch.ops import roofline

    assert ops == roofline.count_kernel_ops(one)
    assert kernel_ops.count_kernel_ops(spec)["flops"] > 3 * ops["flops"]
    # per dof and tick: two LSTM layers of 4 gates x 8 units over (input + hidden)
    # inputs, [2 + 8] then [8 + 8], and the 8-wide head; 2 FLOPs a multiply-add
    by_hand = 2 * (4 * 8 * (2 + 8) + 4 * 8 * (8 + 8) + 8)
    assert by_hand == 1680
    cfgs = train_ref.configs("anymal_c_rough", {})
    harness.seeded_networks(cfgs, 3, "cpu")
    assert net_flops.module_flops(*cfgs)["actuator"] == by_hand
    assert net_flops.module_flops(*train_ref.configs("cassie", {}))["actuator"] == 0

    B = 4096
    ev = trace.Trace([("fused_control_step_kernel_x", 0, 20_000)], [], (0, 10**6), {})
    got = harness.load_module("metrics", "fused_kernel_roofline_pct").read(
        Run(None, ev, {"launch_spec": one, "launches": 4, "batch": B}))
    least = max(ops["flops"] * B / peaks.FP32_FLOPS,
                ops["transcendentals"] * B / peaks.SFU_OPS_PER_S,
                kernel_ops.kernel_bytes_per_env(one) * B / peaks.HBM_BYTES_PER_S)
    assert got == pytest.approx(100.0 * least / 20e-6, rel=1e-12)

    mods = net_flops.module_flops(*cfgs)
    step = 4 * ops["flops"] + by_hand * 12 * 4
    want = sum(net_flops.iteration_flops(mods, step, 4096, 24, 5, d) for d in (False, True))
    assert _mfu({"launch_spec": one, "launches": 4}, cfgs) == pytest.approx(
        100.0 * want / peaks.FP32_FLOPS, rel=1e-12)
