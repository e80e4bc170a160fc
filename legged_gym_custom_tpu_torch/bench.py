"""Benchmarks of the port: one JSON line per metric, the counterpart of the
root bench.py's lines 1-3b (that file imports JAX and stays as it is).

1. go2 flat training throughput: env steps/s through whole PPO iterations
   (rollout + update, the reference's `Perf/total_fps`,
   on_policy_runner.py:219,230) at 4096 envs x 24 steps;
2. the same for go2_parkour (heightfield, 132 scandots, parkour rewards);
3. MPPI solves/s at the throughput point B 4096 / K 16 / H 10, and at the
   single-robot point B 8 / K 16 / H 10 the p99 wall latency and the device
   time per solve against the 50 Hz budget (mpc/bench.py);
3b. the closed loop: one synchronized solve per tick, device p99 per solve;
3c. `fused_kernel_roofline_pct`: the K3 kernel (terrain, full plant) at
   4096 envs against its speed of light from the peaks measured on this card
   (scripts/check_fused_gpu.py::roofline_bench, ops/roofline.py); null on
   the CPU, which has no kernel to time.
The weak-scaling and multiprocess lines of bench.py need modules the port
does not have yet and are not emitted.  A failed line fails the
run.  Every line names the card (`nvidia-smi` name and power limit); the last
line repeats the first with every metric's value under "all".

On the CPU (`--device cpu`) the sizes shrink to a smoke run and the device
metrics are null: a CPU run measures no device.

Run: python -m legged_gym_custom_tpu_torch.bench [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from legged_gym_custom_tpu_torch import resolve_device

BASELINE_FPS = 100_000.0  # estimate; the reference publishes no numbers
MPC_TARGET_SOLVES = 4096.0
# Training: envs, steps per env an iteration, timed iterations after a first;
# MPPI: the throughput batch, samples, horizon and timed solves, the
# single-robot batch and its timed solves, warm-up solves, closed-loop ticks.
SIZES = {"cuda": dict(num_envs=4096, steps=24, iters=5, mpc_batch=4096, samples=16, horizon=10,
                      mpc_iters=10, robot_batch=8, robot_iters=20, warmup=3, ticks=1000),
         "cpu": dict(num_envs=2, steps=2, iters=1, mpc_batch=2, samples=2, horizon=2,
                     mpc_iters=1, robot_batch=2, robot_iters=1, warmup=1, ticks=1)}


def device_info(device: torch.device) -> dict:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them, or the CPU's stand-in."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    name, power = lines[device.index or 0].rsplit(", ", 1)
    return {"name": name, "power_limit": power}


def bench_train(task: str, num_envs: int, steps: int, iters: int, device) -> float:
    """Env steps/s of `iters` PPO iterations of `steps` steps per env after
    a first one."""
    from legged_gym_custom_tpu_torch.envs import task_registry

    env_cfg, train_cfg = task_registry.get_cfgs(task)
    env_cfg.env.num_envs = num_envs
    train_cfg.runner.num_steps_per_env = steps
    env, _ = task_registry.make_env(task, env_cfg=env_cfg, device=device)
    runner, _ = task_registry.make_alg_runner(env, train_cfg=train_cfg, log_root=None)
    runner.env_state, runner.obs = env.reset_all(runner.generator)
    t0 = time.time()
    runner.run_iteration(False)   # synchronizes at its end
    print(f"# {task} first iteration: {time.time() - t0:.1f}s", file=sys.stderr)
    t0 = time.time()
    for _ in range(iters):
        runner.run_iteration(False)
    return iters * runner.num_steps_per_env * num_envs / (time.time() - t0)


def main(argv=None):
    from legged_gym_custom_tpu_torch.mpc.bench import BUDGET_MS, run_bench, run_closed_loop

    p = argparse.ArgumentParser("legged_gym_custom_tpu_torch.bench")
    p.add_argument("--device", default="cuda")
    device = resolve_device(p.parse_args(argv).device)
    size = SIZES[device.type]
    card = device_info(device)
    emitted = []

    def emit(obj):
        obj["device"] = card
        emitted.append(obj)
        print(json.dumps(obj), flush=True)

    def ratio(value, target, invert=False):
        if value is None:
            return None
        return round(target / max(value, 1e-6) if invert else value / target, 4)

    n, steps = size["num_envs"], size["steps"]
    for task, metric, what in (
            ("go2", "go2_train_total_fps", "rollout+PPO update"),
            ("go2_parkour", "go2_parkour_train_total_fps",
             "heightfield + 132 scandots, rollout+PPO update")):
        fps = bench_train(task, n, steps, size["iters"], device)
        emit({"metric": metric, "value": round(fps, 1),
              "unit": f"env_steps/s ({n} envs x {steps} steps, {what})",
              "vs_baseline": ratio(fps, BASELINE_FPS),
              "baseline_note": "100k steps/s is an estimate (typical 1-GPU Isaac Gym "
                               "figure); the reference publishes no benchmarks"})

    K, H, warmup = size["samples"], size["horizon"], size["warmup"]
    thr = run_bench(batch=size["mpc_batch"], samples=K, horizon=H, iters=size["mpc_iters"],
                    warmup=warmup, device=device)
    thr["vs_baseline"] = ratio(thr["value"], MPC_TARGET_SOLVES)
    thr["baseline_note"] = "target >=4096 solves/s per host"
    emit(thr)
    B = size["robot_batch"]
    lat = run_bench(batch=B, samples=K, horizon=H, iters=size["robot_iters"], warmup=warmup,
                    device=device)
    emit({"metric": "go2_mpc_single_robot_p99_ms", "value": lat["p99_latency_ms"],
          "unit": f"ms p99 WALL solve latency (B={B}, K={K}, H={H}), synchronized solves",
          "vs_baseline": ratio(lat["p99_latency_ms"], BUDGET_MS, invert=True),
          "baseline_note": "budget 20 ms (50 Hz); trivial dispatch round trip "
                           f"{lat['trivial_dispatch_rtt_ms']} ms"})
    emit({"metric": "go2_mpc_single_robot_device_solve_ms", "value": lat["device_solve_ms"],
          "unit": "ms per solve of DEVICE busy time (sum of kernel and copy durations, "
                  f"torch.profiler); first-to-last kernel span {lat['device_span_ms']} ms",
          "vs_baseline": ratio(lat["device_solve_ms"], BUDGET_MS, invert=True),
          "baseline_note": "budget 20 ms (50 Hz)"})
    cl = run_closed_loop(batch=B, samples=K, horizon=H, ticks=size["ticks"], warmup=warmup,
                         device=device)
    cl["vs_baseline"] = ratio(cl["value"], BUDGET_MS, invert=True)
    cl["baseline_note"] = "budget 20 ms (50 Hz); wall includes the host's launches"
    emit(cl)

    rl = None
    if device.type == "cuda":
        from legged_gym_custom_tpu_torch.scripts.check_fused_gpu import roofline_bench

        rl = roofline_bench(batch=4096, terrain=True, full_plant=True, device=device)
    emit({"metric": "fused_kernel_roofline_pct", "value": rl and rl["roofline_pct"],
          "unit": "% of measured speed-of-light (max of the fp32-FMA / tanhf compute "
                  "and the device-memory bounds) achieved by the terrain full-plant "
                  "kernel (K3) at B=4096",
          "vs_baseline": None, "detail": rl})

    headline = dict(emitted[0])
    headline["all"] = {m["metric"]: m["value"] for m in emitted}
    print(json.dumps(headline), flush=True)


if __name__ == "__main__":
    main()
