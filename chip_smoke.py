"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last line is printed only on success):
  1. card    - device name and `nvidia-smi` name / power limit;
  2. build   - nvcc-builds every kernel of the main paths from the sources in
               this checkout, one build per kernel, all started together: K1
               (the fused control step on the plane, go2) and K3 (its
               heightfield variant, go2_parkour); prints build seconds and
               each ptxas register / spill report;
  3. check   - each kernel against its plain PyTorch version on the card, at
               the main path's shapes, B = 4096 envs on the synthetic
               Go2-shaped URDF: K1 on a seeded random batch, K3 on the
               go2_parkour env's own gap-course terrain with a quarter of
               the bases within 0.3 m of a gap edge and the windows cut by
               `physics.patch.extract`; each output gated at its 99th
               percentile;
  4. timing  - CUDA-event medians of each kernel and of its plain version;
               the bound from the bytes and operations of this run's inputs;
  5. train   - `scripts.train --task go2_parkour --num_envs 4096
               --max_iterations 3`, then the same for `--task go2` (iteration
               0 DAgger, 1-2 PPO), each with every launch counter set to 0 just
               before and read just after: the path's kernel must have
               launched 1 + 24 per iteration times and the other kernel not at
               all, every loss must be finite, and on go2_parkour the scan
               stream must see the terrain;
  6. profile - wall and device time of a policy + env step of each task, top
               kernels.
Then it prints the kernels' JSON line, the card's line and, last,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): fp32 outside
# the tensor cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
NUM_ENVS = 4096
TRAIN_ITERATIONS = 3
STEPS_PER_ITERATION = 24
# Per-output tolerances (atol, rtol) of tests/test_fused_step.py:126-135 (K1)
# and :185-193 (K3: dof_vel atol 2e-2 on a heightfield).  The gate is on the
# 99th percentile of err / (atol + rtol |ref|): grazing contacts give a
# one-ULP-seeded tail that max-abs gates flake on (docs/architecture.md:74-79),
# and on the gap course a one-ULP difference in a sphere's grid coordinate at
# a cell edge picks the other cell.
TOLERANCES = {
    "base_pos": (1e-4, 1e-4), "base_quat": (1e-4, 1e-4), "lin_vel": (1e-3, 1e-3),
    "ang_vel": (1e-3, 1e-3), "dof_pos": (1e-4, 1e-4), "dof_vel": (1e-2, 1e-3),
    "link_forces": (0.05, 1e-3), "torques": (1e-2, 1e-3),
}
HF_TOLERANCES = dict(TOLERANCES, dof_vel=(2e-2, 1e-3))
NAMES = ["base_pos", "base_quat", "lin_vel", "ang_vel", "dof_pos", "dof_vel", "link_forces",
         "torques"]
DEFAULT_ANGLES = np.array([0.1, 0.8, -1.5, -0.1, 0.8, -1.5, 0.1, 1.0, -1.5, -0.1, 1.0, -1.5])


def log(msg: str):
    print(msg, flush=True)


def rand_batch(seed: int, B: int, device):
    """A seeded random (C, B) batch like tests/test_fused_step.py:_rand_batch."""
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(4, B)) * 0.1 + np.array([1.0, 0, 0, 0])[:, None]
    quat /= np.linalg.norm(quat, axis=0, keepdims=True)
    state = [
        np.concatenate([rng.uniform(-1, 1, (2, B)), rng.uniform(0.25, 0.45, (1, B))]),
        quat,
        rng.normal(size=(3, B)) * 0.5,
        rng.normal(size=(3, B)) * 0.5,
        DEFAULT_ANGLES[:, None] + rng.normal(size=(12, B)) * 0.2,
        rng.normal(size=(12, B)) * 2.0,
    ]
    dr = [
        rng.uniform(0.5, 1.25, B), rng.uniform(-1.0, 1.0, B), rng.normal(size=(3, B)) * 0.01,
        np.ones((12, B)) * 1.05, np.ones((12, B)) * 0.95,
    ]
    actions = np.clip(rng.normal(size=(12, B)), -3.14, 3.14)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)
    return tuple(map(t, state)), t(actions), tuple(map(t, dr))


def gap_edges(env) -> np.ndarray:
    """World x of every height step along a course's centre line: the
    parkour gaps' edges (the courses of one terrain row share them)."""
    t = env.cfg.terrain
    border = int(t.border_size / t.horizontal_scale)
    col = border + int(t.terrain_width / t.horizontal_scale) // 2
    idx = np.nonzero(np.diff(env.terrain.height_field_raw[:, col]))[0]
    return (idx + 1) * t.horizontal_scale - t.border_size


def parkour_batch(env, seed: int, device):
    """`rand_batch` with the bases placed over the env's own gap-course
    terrain: x over the courses' length, a quarter within 0.3 m of a gap
    edge, y inside a random course's valid width; plus each env's contact
    window cut from the terrain table as the engine cuts it."""
    from legged_gym_custom_tpu_torch.ops import fused_step
    from legged_gym_custom_tpu_torch.physics import patch

    B = env.num_envs
    state, actions, dr = rand_batch(seed, B, device)
    rng = np.random.default_rng(seed + 1)
    t = env.cfg.terrain
    x = rng.uniform(0.0, t.num_rows * t.terrain_length, B)
    edges = gap_edges(env)
    x[: B // 4] = rng.choice(edges, B // 4) + rng.uniform(-0.3, 0.3, B // 4)
    y = (rng.integers(0, t.num_cols, B) + 0.5) * t.terrain_width + rng.uniform(-4.0, 4.0, B)
    z = rng.uniform(0.25, 0.45, B)
    pos = torch.as_tensor(np.stack([x, y, z]), dtype=torch.float32, device=device)
    state = (pos.contiguous(), *state[1:])
    lp = patch.extract(env.hf, pos[0], pos[1], env.fused_spec.hf_K)
    return state, actions, dr, fused_step.patch_inputs(lp), len(edges)


def count_operations(fn, *args) -> int:
    """Arithmetic operations `fn` performs on its tensors, from an aten-level
    trace: each elementwise or reduction op counts its output elements (an
    FMA written as mul + add counts 2, as the fp32 peak does)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {
        "add", "sub", "mul", "div", "neg", "rsub", "reciprocal", "sqrt", "rsqrt", "cos", "sin",
        "tanh", "exp", "log", "pow", "clamp", "clamp_min", "clamp_max", "minimum", "maximum",
        "where", "lt", "le", "gt", "ge", "eq", "ne", "bitwise_or", "bitwise_and", "logical_or",
        "abs", "square", "sum", "mean", "floor",
    }

    class Counter(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in arith and isinstance(out, torch.Tensor):
                Counter.total += out.numel()
            return out

    with Counter():
        fn(*args)
    return Counter.total


def cuda_time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of `fn()`, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare(names, got, ref, tolerances):
    """Per-output max / p99 abs error and the p99 tolerance gate."""
    rows, ok = {}, True
    for name, g, r in zip(names, got, ref):
        atol, rtol = tolerances[name]
        err = (g - r).abs().flatten().double()
        viol = err / (atol + rtol * r.abs().flatten().double())
        finite = bool(torch.isfinite(g).all())
        row = dict(max_abs=float(err.max()), p99_abs=float(torch.quantile(err, 0.99)),
                   p99_tol_ratio=float(torch.quantile(viol, 0.99)), finite=finite)
        row["pass"] = finite and row["p99_tol_ratio"] <= 1.0
        ok &= row["pass"]
        rows[name] = row
    return rows, ok


def profile_env_steps(runner, task: str, steps: int = 5):
    """Wall time of `steps` policy + env steps of the trained runner, and the
    device time by kernel over the same steps under torch.profiler; the
    device's busy share is device time over unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from legged_gym_custom_tpu_torch.rl import ppo as ppo_lib

    env, nets, gen = runner.env, runner.nets, runner.generator

    def run():
        state, obs = runner.env_state, runner.obs
        with torch.no_grad():
            for _ in range(steps):
                actions = ppo_lib.policy_act(nets, obs, gen, False)[0]
                state, obs, _, _, _ = env.step(state, actions)
        torch.cuda.synchronize()
        runner.env_state, runner.obs = state, obs

    run()  # warm
    t0 = time.time()
    run()
    wall_ms = (time.time() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    # kernel events only: an aten op's self device time repeats its kernels'
    kernels = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    dev = lambda e: e.self_device_time_total
    device_ms = sum(dev(e) for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=dev, reverse=True)[:10]
    log(f"[profile] {task} policy + env step at {env.num_envs} envs: {wall_ms:.2f} ms wall per "
        f"step (unprofiled), {device_ms:.2f} ms device time per step -> device busy "
        f"{device_ms / wall_ms:.1%}")
    for e in top:
        log(f"[profile]   {dev(e) / 1e3 / steps:8.3f} ms/step  {e.count // steps:5d} calls/step  "
            f"{e.key[:90]}")


def card_lines():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return name, smi


def check_kernel(label, names, tolerances, out_k, out_p):
    """Log the kernel-vs-plain comparison; returns (ok, max abs error)."""
    flat = lambda o: (*o[0], o[1], o[2])
    rows, ok = compare(names, flat(out_k), flat(out_p), tolerances)
    for name, row in rows.items():
        log(f"[check] {label} {name:12s} max_abs {row['max_abs']:.3e}  "
            f"p99_abs {row['p99_abs']:.3e}  p99 err/tol {row['p99_tol_ratio']:.3f}  "
            f"finite {row['finite']}  {'ok' if row['pass'] else 'FAIL'}")
    return ok, max(r["max_abs"] for r in rows.values())


def time_kernel(label, spec, args, out_k, extra_bytes=()):
    """CUDA-event medians of the kernel and its plain version, bytes and
    operations of this run's inputs, and the bound they give."""
    from legged_gym_custom_tpu_torch.ops import fused_step

    ms = cuda_time_ms(lambda: fused_step.fused_control_step(spec, *args), reps=50)
    plain_reps = 5
    plain_ms = cuda_time_ms(lambda: fused_step.plain_control_step(spec, *args),
                            reps=plain_reps, warmup=1)
    state, actions, dr = args[:3]
    terrain = args[3] if len(args) > 3 else None
    outs = (*out_k[0], out_k[1], out_k[2])
    tensors = (*state, actions, *dr, *(terrain or ()), *outs)
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    one = lambda ts: tuple(t[..., :1].contiguous().cpu() for t in ts)
    one_env = [one(state), actions[:, :1].contiguous().cpu(), one(dr)]
    if terrain is not None:
        one_env.append(tuple(t[:1].contiguous().cpu() for t in terrain))
    B = actions.shape[-1]
    ops = count_operations(fused_step.plain_control_step, spec, *one_env) * B
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"[timing] {label} B={B}: {ms:.4f} ms (median of 50); plain {plain_ms:.2f} ms "
        f"(median of {plain_reps}); {n_bytes} bytes, {ops} fp32 ops -> bound {bound_ms:.5f} ms "
        f"by {bound_by} ({bytes_ms:.5f} ms bytes, {ops_ms:.5f} ms ops)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def train_task(task: str, counter: str, other: str, device):
    """The main path of `task`: the train CLI's `train` at 4096 envs, with
    the launch counters set to 0 just before and read just after.  Returns
    (runner, launches of the path's kernel) or None on a failed gate."""
    from legged_gym_custom_tpu_torch.ops import fused_step
    from legged_gym_custom_tpu_torch.scripts import train as train_script

    args = train_script.get_args(["--task", task, "--num_envs", str(NUM_ENVS),
                                  "--max_iterations", str(TRAIN_ITERATIONS), "--seed", "1",
                                  "--device", "cuda", "--run_name", "chip_smoke"])
    fused_step.fused_control_step.launches = 0
    fused_step.fused_control_step.hf_launches = 0
    t0 = time.time()
    runner, history = train_script.train(args)
    torch.cuda.synchronize()
    launches = getattr(fused_step.fused_control_step, counter)
    other_launches = getattr(fused_step.fused_control_step, other)
    train_s = time.time() - t0
    expected = 1 + STEPS_PER_ITERATION * TRAIN_ITERATIONS  # reset_all steps once
    for h in history:
        level = f", mean terrain level {h['terrain_level']:.3f}" if "terrain_level" in h else ""
        log(f"[train] {task} it {h['iteration']} {h['update']:6s} {h['env_steps_per_s']:.0f} "
            f"env-steps/s (collection {h['collection_s']:.3f}s, learning "
            f"{h['learning_s']:.3f}s){level}")
    log(f"[train] {task}: {len(history)} iterations in {train_s:.1f}s; {counter} {launches} "
        f"(expected {expected}), {other} {other_launches} (expected 0)")
    losses = [v for h in history for k, v in h.items() if k.endswith("loss")]
    if launches != expected or other_launches != 0:
        log(f"[train] FAIL: {task} did not launch its kernel once per env step, and only it")
        return None
    if len(history) != TRAIN_ITERATIONS or not all(np.isfinite(losses)) or not losses:
        log(f"[train] FAIL: {task}: missing iterations or a non-finite loss")
        return None
    if [h["update"] for h in history] != ["dagger", "ppo", "ppo"]:
        log(f"[train] FAIL: {task}: expected DAgger then PPO updates")
        return None
    return runner, launches


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
        return 2
    from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
    from legged_gym_custom_tpu_torch.envs import task_registry
    from legged_gym_custom_tpu_torch.ops import fused_step

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card
    kind, smi = card_lines()
    log(f"[card] {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build (one nvcc per kernel, all started together)
    envs = {}
    for task in ("go2", "go2_parkour"):
        env_cfg, _ = task_registry.get_cfgs(task)
        env_cfg.env.num_envs = NUM_ENVS
        envs[task], _ = task_registry.make_env(task, env_cfg=env_cfg, device=device)
    log(f"[urdf] {env_cfg.asset.file} (synthetic Go2-shaped model: "
        f"{env_cfg.asset.file == SYNTHETIC_GO2_URDF})")
    hf = envs["go2_parkour"].hf
    log(f"[terrain] go2_parkour: {tuple(hf.data.shape)} float32 table, "
        f"{hf.data.numel() * 4 / 1e6:.1f} MB on the card; contact window "
        f"K={envs['go2_parkour'].fused_spec.hf_K}, scan window K={envs['go2_parkour']._scan_patch_K}")
    specs = {"fused_control_step": envs["go2"].fused_spec,
             "fused_control_step_hf": envs["go2_parkour"].fused_spec}
    t0 = time.time()
    builds = {name: fused_step.KernelBuild(spec) for name, spec in specs.items()}
    kernels = {name: b.finish() for name, b in builds.items()}
    log(f"[build] {len(builds)} kernels in {time.time() - t0:.2f}s wall")
    for name, kernel in kernels.items():
        log(f"[build] {name}: nvcc {kernel.build_seconds:.2f}s; ptxas "
            f"{json.dumps(fused_step.ptxas_summary(kernel.ptxas))}")
        for line in kernel.ptxas.splitlines():
            log(f"[build] {name} ptxas: {line}")

    # ---- 3. each kernel against its plain version on the card
    spec1, spec3 = specs["fused_control_step"], specs["fused_control_step_hf"]
    args1 = rand_batch(0, NUM_ENVS, device)
    out1 = fused_step.fused_control_step(spec1, *args1)
    torch.cuda.synchronize()
    ok1, err1 = check_kernel("K1", NAMES, TOLERANCES, out1,
                             fused_step.plain_control_step(spec1, *args1))
    *args3, n_edges = parkour_batch(envs["go2_parkour"], 2, device)
    near = int((torch.as_tensor(gap_edges(envs["go2_parkour"]), device=device)[:, None]
                - args3[0][0][0][None]).abs().min(dim=0).values.le(0.3).sum())
    log(f"[check] K3 on the go2_parkour terrain: {n_edges} gap edges along a course line, "
        f"{near} of {NUM_ENVS} bases within 0.3 m of one")
    out3 = fused_step.fused_control_step(spec3, *args3)
    torch.cuda.synchronize()
    ok3, err3 = check_kernel("K3", NAMES, HF_TOLERANCES, out3,
                             fused_step.plain_control_step(spec3, *args3))
    torch.cuda.synchronize()
    if not (ok1 and ok3) or near < NUM_ENVS // 4:
        log("[check] FAIL: a kernel disagrees with its plain version (or too few bases at "
            "gap edges)")
        return 1

    # ---- 4. timing and bound
    t1 = time_kernel("fused_control_step (K1)", spec1, args1, out1)
    t3 = time_kernel("fused_control_step_hf (K3)", spec3, args3, out3)
    del envs, args1, args3, out1, out3

    # ---- 5. the main paths: counters 0 just before each, read just after
    trained = {}
    for task, counter, other in (("go2_parkour", "hf_launches", "launches"),
                                 ("go2", "launches", "hf_launches")):
        result = train_task(task, counter, other, device)
        if result is None:
            return 1
        trained[task] = result
    runner3, launches3 = trained["go2_parkour"]
    scan = runner3.obs.scan
    if not bool(torch.isfinite(scan).all()) or float(scan.abs().sum()) == 0.0:
        log("[train] FAIL: the go2_parkour scan stream is all zero or not finite")
        return 1
    gen0 = torch.Generator(device=device).manual_seed(1)
    levels0 = runner3.env._initial_origins(gen0)[0]   # reset_all's first draw, seed 1
    moved = int((runner3.env_state.terrain_levels != levels0).sum())
    log(f"[train] go2_parkour: scan stream |sum| {float(scan.abs().sum()):.1f}, "
        f"{float((scan.abs() > 0).float().mean()):.1%} of scandot entries nonzero; "
        f"terrain_levels moved for {moved} of {NUM_ENVS} envs")

    # ---- 6. where a training env step's time goes (after the main paths' counts)
    for task, (runner, _) in trained.items():
        profile_env_steps(runner, task)

    entry = lambda name, replaces, launches, err, t: dict(
        name=name, route="cuda", source="legged_gym_custom_tpu_torch/ops/csrc/fused_step.cu",
        replaces=replaces, launches=launches, max_abs_err=err, ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None)
    line = {"kernels": [
        entry("fused_control_step", "legged_gym_custom_tpu/ops/fused_step.py:824",
              trained["go2"][1], err1, t1),
        entry("fused_control_step_hf", "legged_gym_custom_tpu/ops/fused_step.py:352",
              launches3, err3, t3),
    ]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
