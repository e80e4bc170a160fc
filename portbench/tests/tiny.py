"""A cell at a size the CPU runs in seconds, through the real driver, its
check and the cell's limits: what the tests drive in place of a run."""
from __future__ import annotations

import gc

import torch

from portbench import harness

TINY = {"train": {"set": {"env.num_envs": 16, "runner.num_steps_per_env": 4}},
        "mpc": {"set": {"env.num_envs": 2}, "mppi": {"horizon": 2, "num_samples": 2},
                "check_span": 3, "checks": 2}}


def cell(name: str, extra=None):
    """(config, workload) of the cell, cut to the tiny size; `extra` sets
    more of the training config."""
    workload = harness.load_workload(name)
    config = harness.load_json("configs", workload["config"])
    tiny = TINY[workload["driver"]]
    if workload["driver"] == "train":
        config = dict(config, set=dict(tiny["set"], **(extra or {})))
    else:
        workload = dict(workload, set=dict(workload["set"], **tiny["set"]),
                        mppi=tiny["mppi"], check_span=tiny["check_span"], checks=tiny["checks"])
    return config, workload


def run(name: str, seed: int = 2**31 + 7, seconds: float = 0.5, control=False, faults=False,
        extra=None):
    """Set-up, window, release and check of the tiny cell on the CPU (the
    look for a chip skipped); returns (window result, check readings, the
    driver)."""
    config, workload = cell(name, extra)
    driver = harness.load_module("drivers", workload["driver"]).Driver(
        config, workload, seed, torch.device("cpu"))
    win = driver.window(seconds)
    driver.release()
    gc.collect()
    return win, driver.check(control=control, faults=faults), driver


def judged(name: str, readings: dict) -> bool:
    return harness.judge(readings, harness.load_workload(name)["limits"])[0]
