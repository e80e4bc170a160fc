"""Multi-process scaling efficiency with each rank pinned to its own core,
torch port of legged_gym_custom_tpu/scripts/bench_multiprocess.py.

`bench_scaling` shares every core between the ranks.  Here each gloo rank
of `scripts/multihost_worker.py` runs on its own core (taskset, one thread),
so the 1-process baseline and the N-process run get 1 and N cores:

  baseline: 1 process on core 0,            E envs         -> fps_1
  scaled:   N processes on cores 0..N-1,    E envs         -> fps_N
  half:     1 process on core 0,            E / N envs     -> fps_half
  efficiency           = fps_N / (N * fps_1)     (1.0 = perfect strong scaling)
  sync_only_efficiency = fps_N / (N * fps_half)  (the same work a rank does,
                         without the collectives: their cost alone)

CPU ranks over gloo on this host, not the card.

Run: python -m legged_gym_custom_tpu_torch.scripts.bench_multiprocess
         [--procs 2] [--total_envs 64] [--iters 3] [--warmup 1]
Emits one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil


def _run(n_procs: int, total_envs: int, iters: int, warmup: int, timeout: float = 3600.0):
    from legged_gym_custom_tpu_torch.scripts.multihost_worker import launch

    env = dict(os.environ, OMP_NUM_THREADS="1")
    result, _ = launch(n_procs, ["--task", "go2", "--num_envs", str(total_envs),
                                 "--iterations", str(iters), "--warmup", str(warmup),
                                 "--device", "cpu"], timeout=timeout, env=env,
                       pin_cores=shutil.which("taskset") is not None)
    return result


def run_bench(procs: int = 2, total_envs: int = 64, iters: int = 3, warmup: int = 1):
    r1 = _run(1, total_envs, iters, warmup)
    rn = _run(procs, total_envs, iters, warmup)
    r_half = _run(1, max(total_envs // procs, 1), iters, warmup)
    return {
        "procs": procs,
        "total_envs": total_envs,
        "fps_1proc_1core": r1["fps"],
        f"fps_{procs}proc_{procs}core": rn["fps"],
        "efficiency": round(rn["fps"] / (procs * r1["fps"]), 4),
        "fps_1proc_half_batch": r_half["fps"],
        "sync_only_efficiency": round(rn["fps"] / (procs * r_half["fps"]), 4),
        # the last iteration's phase split: where the scaling loss lives
        "collection_s_1proc": r1.get("collection_s"),
        "learning_s_1proc": r1.get("learning_s"),
        "collection_s_1proc_half": r_half.get("collection_s"),
        "learning_s_1proc_half": r_half.get("learning_s"),
        f"collection_s_{procs}proc": rn.get("collection_s"),
        f"learning_s_{procs}proc": rn.get("learning_s"),
        "taskset": shutil.which("taskset") is not None,
        "backend": rn["backend"],
        "host_cores": os.cpu_count(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--total_envs", type=int, default=64)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    args = ap.parse_args(argv)
    out = run_bench(args.procs, args.total_envs, args.iters, args.warmup)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
