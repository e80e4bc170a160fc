"""MPPI traffic: one controller solving for a batch of robots, solve after
solve (closed loop: each solve starts when the last has ended and been
synchronised, as a controller that skips missed ticks).  The robots' state
is the env's reset state from the seed and stays fixed; the plan is warm
started from solve to solve, and each solve draws its noise from the
solver's generator, seeded from the seed.

The check records the inputs and the answer (the new plan and the expected
costs) of solves drawn from the seed among the first `check_span` solves of
the window, and the reference solves them again once the window has closed."""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from portbench import harness, trace

WARMUP_SOLVES = 3
TRACE_SOLVES = 10


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int, device: torch.device):
        from legged_gym_custom_tpu_torch.envs import task_registry
        from legged_gym_custom_tpu_torch.mpc import MPPI, MPPIConfig

        self.device = device
        self.seeds = harness.seeds(seed)
        self.task = config["task"]
        self.overrides = {**config.get("set", {}), **workload.get("set", {})}
        self.mppi_cfg = workload["mppi"]
        env_cfg, train_cfg = task_registry.get_cfgs(self.task)
        for k, v in self.overrides.items():
            harness.set_path((env_cfg, train_cfg), k, v)
        self.overrides.update(harness.seeded_networks((env_cfg, train_cfg), self.seeds.weights,
                                                      device))
        self.env, _ = task_registry.make_env(self.task, args=argparse.Namespace(
            seed=self.seeds.terrain), env_cfg=env_cfg, device=device)
        state, _ = self.env.reset_all(torch.Generator(device=device).manual_seed(self.seeds.runner))
        self.args = (state.physics, state.dr, state.commands)
        self.mpc = MPPI(self.env, MPPIConfig(**self.mppi_cfg))
        self.batch = env_cfg.env.num_envs
        self.ms = self.mpc.init_state(self.batch)
        self.gen = torch.Generator(device=device).manual_seed(self.seeds.weights)
        rng = np.random.default_rng(self.seeds.sample)
        self.want = {0, *rng.choice(np.arange(1, workload["check_span"]), size=workload["checks"] - 1,
                                    replace=False).tolist()}
        self.recs = []
        self.bad = torch.zeros((), dtype=torch.bool, device=device)
        for _ in range(WARMUP_SOLVES):
            self.solve()

    def solve(self, record: bool = False):
        rec = None
        if record:
            rec = {"in": harness.snapshot(self.ms._asdict()),
                   "generator": harness.snapshot(self.gen)}
        actions, self.ms, cost = self.mpc.solve(self.ms, *self.args, self.gen)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if rec is not None:
            rec["out"] = {"nominal": self.ms.nominal.clone(), "cost": cost.clone()}
            self.recs.append(rec)
        self.bad |= ~torch.isfinite(actions).all()

    def window(self, seconds: float) -> dict:
        wall = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            s = time.perf_counter()
            self.solve(record=len(wall) in self.want)
            wall.append(time.perf_counter() - s)
        elapsed = time.perf_counter() - t0
        q = np.percentile(np.asarray(wall) * 1e3, 95)
        return {"metrics": {"mpc_solve_p95_ms": float(q),
                            "mpc_robot_solves_per_s": self.batch * len(wall) / elapsed},
                "attempted": len(wall), "failed": len(wall) if bool(self.bad) else 0}

    def trace(self) -> trace.Trace:
        from torch.profiler import record_function

        with trace.profiler() as prof:
            with record_function(trace.WINDOW):
                for _ in range(TRACE_SOLVES):
                    with record_function("pb.solve"):
                        self.solve()
        return trace.read(prof, {"solves": TRACE_SOLVES})

    def facts(self) -> dict:
        return {"batch": self.batch}

    def release(self):
        self.state_snapshot = {
            "physics": harness.snapshot(self.args[0]), "dr": harness.snapshot(self.args[1]),
            "commands": self.args[2].clone()}
        del self.mpc, self.env, self.args, self.ms
        torch.cuda.empty_cache()

    def check(self, control: bool = False, faults: bool = False) -> dict:
        """The widest gaps of the sampled solves' plans and costs against the
        reference.  `control`: the reference in TF32 in the program's place;
        `faults`: the program's answer altered where it is produced (its
        plan's first action moved by 0.01)."""
        from portbench.reference import mpc_ref, train_ref

        env = train_ref.make_env(self.task, self.overrides, self.seeds.terrain, self.device)
        recs = [dict(r, **self.state_snapshot) for r in self.recs]
        if not recs:
            return {"program": {"plan": float("inf"), "cost": float("inf")}}
        out = {"program": mpc_ref.numbers(env, self.mppi_cfg, recs)}
        if control:
            out["control"] = mpc_ref.numbers(env, self.mppi_cfg, recs, prog_override=lambda m, r:
                                             mpc_ref.solve(m, r, tf32=True))

        def altered(m, r):
            plan = r["out"]["nominal"].clone()
            plan[:, 0] += 0.01
            return plan, r["out"]["cost"]

        if faults:
            out["fault_altered"] = mpc_ref.numbers(env, self.mppi_cfg, recs, prog_override=altered)
        return out
