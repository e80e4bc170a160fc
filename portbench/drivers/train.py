"""Training traffic: whole PPO / DAgger iterations of `OnPolicyRunner`,
back to back, as `scripts/train.py` runs them (closed loop: each iteration
starts when the last has ended, synchronised).

Set-up builds the env and the runner through the task registry, makes the
weights from the seed on the card (and any network the task loads from a
file, `harness.seeded_networks`), resets the envs at random episode lengths
and runs the first two iterations (iteration 0 is a DAgger update, 1 a PPO
update) through `run_iteration`, the window's own call.  They warm up every
shape the window uses, and the check records what they did: the env steps
it samples (state, generator and actions in, every output), each update's
inputs, its first three optimizer steps, the number of steps it took and
the parameters' change over all of them.  The window then goes on with
iteration 2 on the same runner."""
from __future__ import annotations

import argparse
import contextlib
import copy
import math
import time

import numpy as np
import torch

from portbench import harness, trace

ENV_CHECKS = 3            # env steps of the first two iterations that the check follows
TRACE_ITERATIONS = 2      # iterations in the traced window


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int, device: torch.device):
        from legged_gym_custom_tpu_torch.envs import task_registry

        self.device = device
        self.seeds = harness.seeds(seed)
        self.task = config["task"]
        self.overrides = {**config.get("set", {}), **workload.get("set", {})}
        env_cfg, train_cfg = task_registry.get_cfgs(self.task)
        for k, v in self.overrides.items():
            harness.set_path((env_cfg, train_cfg), k, v)
        wrong = {k: (harness.get_path((env_cfg, train_cfg), k), v)
                 for k, v in config.get("expect", {}).items()
                 if harness.get_path((env_cfg, train_cfg), k) != v}
        if wrong:
            raise SystemExit(f"portbench: the program's config differs from {self.task}.json: "
                             f"{wrong}")
        self.overrides.update(harness.seeded_networks((env_cfg, train_cfg), self.seeds.weights,
                                                      device))
        train_cfg.seed = self.seeds.runner
        self.env, _ = task_registry.make_env(self.task, args=argparse.Namespace(
            seed=self.seeds.terrain), env_cfg=env_cfg, device=device)
        self.runner, _ = task_registry.make_alg_runner(self.env, train_cfg=train_cfg,
                                                       log_root=None)
        harness.make_weights(self.runner.nets, self.seeds.weights, device)
        self.runner.env_state, self.runner.obs = self.env.reset_all(
            self.runner.generator, init_at_random_ep_len=True)
        self.steps_per_iteration = self.runner.num_steps_per_env * self.env.num_envs_global
        self.it = 0
        T = self.runner.num_steps_per_env
        rng = np.random.default_rng(self.seeds.sample)
        want = set(rng.choice(2 * T, size=ENV_CHECKS, replace=False).tolist())
        self.record = Recorder(self, want)
        with self.record:
            self.iterate()
            self.iterate()

    def iterate(self):
        """One iteration; (wall s, collection s, update s, DAgger, finite)."""
        r = self.runner
        dagger = self.it % r.dagger_update_freq == 0
        t0 = time.perf_counter()
        metrics, _ = r.run_iteration(dagger)    # ends synchronised
        wall = time.perf_counter() - t0
        self.it += 1
        return wall, r.collection_time, r.learn_time, dagger, \
            all(math.isfinite(v) for v in metrics.values())

    # ------------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        its = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            its.append(self.iterate())
        elapsed = time.perf_counter() - t0
        self.window_result = {"iterations": its, "elapsed_s": elapsed,
                              "envs": self.env.num_envs_global,
                              "steps_per_env": self.runner.num_steps_per_env}
        return {"metrics": {"train_env_steps_per_s": len(its) * self.steps_per_iteration / elapsed},
                "attempted": len(its), "failed": sum(1 for i in its if not i[4])}

    def trace(self) -> trace.Trace:
        """TRACE_ITERATIONS iterations under the profiler, with the harness's
        spans around the env step, the policy's act and the update."""
        from torch.profiler import record_function

        from legged_gym_custom_tpu_torch.rl import ppo as ppo_lib

        def spanned(name, fn):
            def call(*a, **k):
                with record_function(name):
                    return fn(*a, **k)
            return call

        patches = [(ppo_lib, n, getattr(ppo_lib, n)) for n in
                   ("policy_act", "ppo_update", "dagger_update")]
        for mod, n, fn in patches:
            setattr(mod, n, spanned({"policy_act": "pb.policy_act"}.get(n, "pb.update"), fn))
        self.env.step = spanned("pb.env_step", type(self.env).step.__get__(self.env))
        dagger = 0
        try:
            with trace.profiler() as prof:
                with record_function(trace.WINDOW):
                    for _ in range(TRACE_ITERATIONS):
                        with record_function("pb.iteration"):
                            dagger += self.iterate()[3]
        finally:
            for mod, n, fn in patches:
                setattr(mod, n, fn)
            del self.env.step
        return trace.read(prof, {"iterations": TRACE_ITERATIONS, "dagger_iterations": dagger,
                                 "env_steps": TRACE_ITERATIONS * self.runner.num_steps_per_env})

    def facts(self) -> dict:
        """What the metric readers need to know of the cell: the spec each
        kernel launch runs and the launches in a control step (an env with an
        actuator network steps tick by tick, one launch of the one-tick spec
        a decimation tick; any other env launches its spec once), the batch,
        the configs' sizes."""
        from portbench.reference import train_ref
        from portbench.reference.frozen.ops.fused_step import tick_spec

        cfgs = train_ref.configs(self.task, self.overrides)
        spec = self.env.fused_spec
        tickwise = spec is not None and getattr(cfgs[0].control, "use_actuator_network", False)
        return {"launch_spec": tick_spec(spec) if tickwise else spec,
                "launches": spec.decimation if tickwise else 1,
                "batch": self.env.num_envs, "configs": cfgs,
                "epochs": self.runner.ppo_cfg.num_learning_epochs}

    def release(self):
        self.window_result = getattr(self, "window_result", None)
        del self.runner, self.env
        torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def check(self, control: bool = False, faults: bool = False) -> dict:
        """The numbers compared: the reference run on what the check
        recorded.  `control` and `faults` (calibration) give the same numbers
        for the TF32 control and for the planted faults, each in the
        program's place and held against the float32 reference."""
        from portbench.reference import compare, train_ref

        rec = self.record
        env = train_ref.make_env(self.task, self.overrides, self.seeds.terrain, self.device)
        readings = {"program": [train_ref.env_step_gaps(env, r) for r in rec.env_steps]}
        if control:
            readings["control"] = [train_ref.env_step_gaps(env, _as_program(env, r))
                                   for r in rec.env_steps]
        if faults:
            for fault in ("unchanged", "reset_skipped"):
                readings["fault_" + fault] = [train_ref.env_step_gaps(env, r, fault=fault)
                                              for r in rec.env_steps]
        out = {k: train_ref.env_numbers(v) for k, v in readings.items()}
        del env
        for u in rec.updates:
            run = lambda **kw: train_ref.run_update(u, self.task, self.overrides, self.device,
                                                    **kw)
            ref, ref_fwd = run()
            fwd = lambda f: max(compare.rel(f[0], ref_fwd[0]), compare.rel(f[1], ref_fwd[1]))
            answers = {"program": (u["prog"], fwd((u["traj"]["mu"], u["traj"]["values"])))}
            if control:
                c, c_fwd = run(tf32=True)
                answers["control"] = (c, fwd(c_fwd))
            if faults:
                answers["fault_half_batch"] = (run(half=True)[0], None)
                answers["fault_last_minibatch_dropped"] = (run(drop_last=True)[0], None)
            for name, (prog, f) in answers.items():
                o = out.setdefault(name, {})
                for k, v in train_ref.update_numbers(prog, ref).items():
                    o[k] = max(o.get(k, 0.0), v)
                if f is not None:
                    o["forward"] = max(o.get("forward", 0.0), f)
        return out


def _as_program(env, rec):
    """The record with the reference's step in TF32 as the program's answer."""
    from portbench.reference import train_ref

    with train_ref.precision(True), torch.no_grad():
        s, o, r, d, _ = env.step(train_ref.to_state(rec["state"]), rec["actions"].clone())
    return dict(rec, out=(harness.snapshot(s), harness.snapshot(o), r, d))


class Recorder:
    """What the check needs of the first two iterations, recorded around
    the program's calls (the env's step, the update, the optimizers' steps
    and the loss's backward) and removed again before the window."""

    def __init__(self, driver: Driver, env_steps: set):
        self.d = driver
        self.want = env_steps
        self.n_env = 0
        self.env_steps, self.updates = [], []

    def __enter__(self):
        from legged_gym_custom_tpu_torch.rl import ppo as ppo_lib

        self.ppo_lib = ppo_lib
        self.orig = {n: getattr(ppo_lib, n) for n in ("ppo_update", "dagger_update")}
        ppo_lib.ppo_update = self._update("ppo", self.orig["ppo_update"])
        ppo_lib.dagger_update = self._update("dagger", self.orig["dagger_update"])
        env = self.d.env
        step = type(env).step.__get__(env)

        def env_step(state, actions):
            k = self.n_env
            self.n_env += 1
            if k not in self.want:
                return step(state, actions)
            rec = {"step": k, "state": harness.snapshot(state), "actions": actions.detach().clone()}
            out = step(state, actions)
            rec["out"] = (harness.snapshot(out[0]), harness.snapshot(out[1]), out[2].clone(),
                          out[3].clone())
            self.env_steps.append(rec)
            return out

        env.step = env_step
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.ppo_lib, n, fn)
        del self.d.env.step
        return False

    def _update(self, kind, fn):
        def update(cfg, ts, traj, *args, **kw):
            nets = ts.nets
            rec = {
                "kind": kind,
                "params": {k: v.detach().clone() for k, v in nets.state_dict().items()},
                "opt": {"policy": copy.deepcopy(ts.opt_policy.state_dict()),
                        "adapt": copy.deepcopy(ts.opt_adapt.state_dict()),
                        "est": copy.deepcopy(ts.opt_est.state_dict())},
                "learning_rate": ts.learning_rate, "total_updates": ts.total_updates,
                "traj": harness.snapshot(traj),
                "final_critic_obs": self.d.runner.obs.critic.detach().clone(),
                "generator": harness.snapshot(self.d.runner.generator),
            }
            opts = (ts.opt_adapt,) if kind == "dagger" else (ts.opt_policy, ts.opt_est)
            with _watch(nets, opts) as seen:
                out = fn(cfg, ts, traj, *args, **kw)
            rec["prog"] = seen["update"]
            self.updates.append(rec)
            return out
        return update


@contextlib.contextmanager
def _watch(nets, opts):
    """What an update did (`train_ref.Update`): the loss each of the first
    CHECK_STEPS backward passes starts from, the first gradient as the
    optimizers got it (Adam's state after one step), the parameters' change
    after CHECK_STEPS steps, the optimizer steps taken, and the change over
    the whole update."""
    from portbench.reference.train_ref import CHECK_STEPS, Update, first_gradients

    names = {p: n for n, p in nets.named_parameters()}
    before = {n: p.detach().clone() for n, p in nets.named_parameters()}
    seen = {"losses": [], "first": {}, "change": {}}
    moved = lambda: {n: nets.get_parameter(n).detach() - before[n] for n in seen["first"]}
    backward = torch.Tensor.backward
    steps = {"n": 0}

    def watched_backward(self, *a, **k):
        if len(seen["losses"]) < CHECK_STEPS:
            seen["losses"].append(float(self.detach()))
        return backward(self, *a, **k)

    last = opts[-1]
    originals = [(o, o.step) for o in opts]

    def stepped(opt, step):
        def call(*a, **k):
            out = step(*a, **k)
            if opt is last:
                steps["n"] += 1
                if steps["n"] == 1:
                    seen["first"] = first_gradients(opts, names)
                if steps["n"] == CHECK_STEPS:
                    seen["change"] = moved()
            return out
        return call

    torch.Tensor.backward = watched_backward
    for o, s in originals:
        o.step = stepped(o, s)
    try:
        yield seen
        seen["update"] = Update(seen["losses"], seen["first"], seen["change"], steps["n"],
                                moved())
    finally:
        torch.Tensor.backward = backward
        for o, _ in originals:
            del o.step
