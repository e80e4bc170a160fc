"""Data-parallel overhead on the CPU, torch port of
legged_gym_custom_tpu/scripts/bench_scaling.py.

The JAX tool runs the same total env batch on 1 device and sharded over 8
virtual CPU devices.  Here the devices are ranks: the same total batch
(`--total_envs`, 512 by default) trained by one gloo process and by
`--devices` gloo processes of `scripts/multihost_worker.py` on this host's
CPU, each with an equal share of its cores (OMP_NUM_THREADS).  fps(N) /
fps(1) is the throughput that survives the data-parallel path (per-rank
rollouts, per-minibatch gradient all-reduces, the statistics' reductions)
on shared silicon.  It measures CPU ranks over gloo, not the card.

    python -m legged_gym_custom_tpu_torch.scripts.bench_scaling --devices 8 \\
        --total_envs 512

The port's `bench.py` runs the 1-vs-8 pair and emits the efficiency line.
"""
from __future__ import annotations

import argparse
import json
import os


def run(devices: int, total_envs: int, iters: int, warmup: int = 1,
        timeout: float = 3600.0) -> dict:
    from legged_gym_custom_tpu_torch.scripts.multihost_worker import launch

    threads = max(1, (os.cpu_count() or 1) // devices)
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    result, _ = launch(devices, ["--task", "go2", "--num_envs", str(total_envs),
                                 "--iterations", str(iters), "--warmup", str(warmup),
                                 "--device", "cpu"], timeout=timeout, env=env)
    return {"devices": devices, "num_envs": total_envs, "iters": iters, "fps": result["fps"],
            "backend": result["backend"], "threads_per_rank": threads,
            "host_cores": os.cpu_count()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--total_envs", type=int, default=512)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    args = ap.parse_args(argv)
    out = run(args.devices, args.total_envs, args.iters, args.warmup)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
