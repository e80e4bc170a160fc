"""The readings that the limits of `correct` are set from, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds <s> [--out <file.jsonl>]

For each seed: the cell's set-up, a window of `--seconds` (the MPPI check
samples its solves from the window; a training cell's check needs none),
then the check.  On `--control-seeds` the check also reads the control (the
reference in TF32 in the program's place) and the planted faults.  One JSON
line a seed.  The benchmark's own runs never run this."""
from __future__ import annotations

import argparse
import gc
import json
import sys

from portbench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.set_environment()
    workload = harness.load_workload(args.workload)
    config = harness.load_json("configs", workload["config"])
    driver_mod = harness.load_module("drivers", workload["driver"])
    harness.require_cards(workload["chips"])
    import torch

    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    control = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in [int(s) for s in args.seeds.split(",")]:
            driver = driver_mod.Driver(config, workload, seed, device)
            driver.window(args.seconds)
            driver.release()
            gc.collect()
            torch.cuda.empty_cache()
            line = json.dumps({"workload": args.workload, "seed": seed,
                               **driver.check(control=seed in control, faults=seed in control)})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            del driver
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
