"""Run one cell of the benchmark once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the cell's driver: build, weights and state from the seed, warm-up
of every shape the window uses), then `--seconds` of the cell's traffic,
then with `--trace 1` a short traced stretch, then the check against the
plain reference, once the device's peak memory has been read and the
program's state freed.  The last line of standard output is the result; the
numbers compared, each with its limit, are the last lines of standard
error.  With `--trace 0` the metrics are the cell's end-to-end ones, with
`--trace 1` its per-layer ones (BENCHMARK.json)."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench import harness


class Run:
    """What a metric reader is handed: the window's result, the trace of
    `--trace 1` and the driver's facts about the cell."""

    def __init__(self, window, trace, facts):
        self.window = window
        self.trace = trace
        self.facts = facts


def main(argv=None) -> int:
    t_start = harness.process_start_time()
    host_setup = harness.HostSample()
    p = argparse.ArgumentParser("portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.set_environment()

    workload = harness.load_workload(args.workload)
    config = harness.load_json("configs", workload["config"])
    driver_mod = harness.load_module("drivers", workload["driver"])
    section = "per_layer" if args.trace else "end_to_end"
    wanted = harness.metrics_for(args.workload, section)
    readers = {m["name"]: harness.load_module("metrics", m["name"]) for m in wanted} \
        if args.trace else {}
    harness.require_cards(workload["chips"])
    import torch

    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    driver = driver_mod.Driver(config, workload, args.seed, device)
    setup_s = time.time() - t_start
    print("host setup " + json.dumps(host_setup.since()), file=sys.stderr)
    host = harness.HostSample()
    win = driver.window(args.seconds)
    print("host window " + json.dumps(host.since()), file=sys.stderr)
    tr = driver.trace() if args.trace else None
    facts = driver.facts()
    device_info = harness.device_info(workload["chips"])
    driver.release()
    gc.collect()
    torch.cuda.empty_cache()
    t_check = time.time()
    numbers = driver.check()["program"]
    print(f"setup_s {setup_s:.3f} check_s {time.time() - t_check:.3f} numbers "
          + json.dumps(numbers), file=sys.stderr)
    correct, compared = harness.judge(numbers, workload["limits"])

    if args.trace:
        run = Run(getattr(driver, "window_result", None), tr, facts)
        values = {name: r.read(run) for name, r in readers.items()}
        units = {m["name"]: m["unit"] for m in wanted}
        metrics = {n: {"value": v, "unit": units[n]} for n, v in values.items() if v is not None}
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        print(f"trace: {len(tr.in_window())} device events, "
              f"{sum(h is not None for h in tr.launched)} of all {len(tr.device)} matched to "
              f"a host runtime call, {len(tr.host)} host events, "
              f"counts {tr.counts}", file=sys.stderr)
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in wanted}

    banned = harness.banned_modules()
    if banned:
        print(f"portbench: modules of the JAX stack were loaded: {banned}", file=sys.stderr)
        return 3
    result = {"correct": bool(correct and win["failed"] == 0), "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": device_info}
    if args.trace:
        from portbench import trace

        result["breakdown"] = trace.breakdown(tr)
    result["check"] = {k: [v["value"], v["limit"]] for k, v in compared.items()}
    for k, v in compared.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
