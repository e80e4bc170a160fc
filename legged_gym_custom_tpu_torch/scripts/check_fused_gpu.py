"""Parity receipt and micro-benchmark of the fused control-step kernel on the
card, the port's counterpart of legged_gym_custom_tpu/scripts/check_fused_tpu.py.

The CPU tests hold the kernel's plain version against the JAX package; this
tool is the hardware half: it builds the 13-body Go2 kernel (the synthetic
Go2-shaped URDF: the reference's go2.urdf is not in the repository) with
nvcc, checks one step of it against its plain version
(`fused_step.plain_control_step`, where the reference compares with XLA),
and times both.

Run on the card (it checks the kernel, so it refuses the CPU):

    python -m legged_gym_custom_tpu_torch.scripts.check_fused_gpu \
        [--batch 4096] [--iters 50] [--terrain] [--full_plant] \
        [--rollout 25] [--roofline] [--out receipt.json]

Prints one JSON line with the parity deltas and the env-steps/s of both
paths, and of the eager engine (`physics.control_step` with no spec, what
an env with the kernel off steps, the counterpart of the reference's
`xla_ms`), with the card's `nvidia-smi` name and power limit.  `--rollout N`
adds the closed-loop distributional gate (KS statistic of trajectory
statistics, plain version against kernel, gate 0.05); `--roofline` prints
the kernel-only speed-of-light accounting of ops/roofline.py instead.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch import physics as phys
from legged_gym_custom_tpu_torch.ops import fused_step
from legged_gym_custom_tpu_torch.utils.profiling import cuda_time_ms

GO2_URDF = SYNTHETIC_GO2_URDF
DEFAULT_ANGLES = np.array(
    [0.1, 0.8, -1.5, -0.1, 0.8, -1.5, 0.1, 1.0, -1.5, -0.1, 1.0, -1.5]
)
KS_GATE = 0.05
PLAIN_REPS = 3   # timed calls of the plain version (about 2 s each at 4096 envs)
EAGER_REPS = 5   # timed calls of the eager engine
PARITY_GATES = {"dof_pos": 0.01, "dof_vel": 1.0}


class Plant(NamedTuple):
    ma: object
    hf: object
    params: object
    pd: object
    dr: object
    dof_limits: tuple
    state: object      # PhysicsState of (C, B) tensors
    actions: object    # (12, B)
    spec: object       # the kernel's FusedSpec


class StepOut(NamedTuple):
    link_forces: torch.Tensor   # (n_links, 3, B)
    torques: torch.Tensor       # (12, B)


def build(batch: int, terrain: bool = False, full_plant: bool = False, device="cuda") -> Plant:
    """A seeded random batch of the Go2 model (draws from a torch.Generator
    seeded 0, shaped as the reference's jax.random draws), on the plane or
    on the reference's bumpy 128 x 128 table (np.random.default_rng(7),
    +-4 cm: bit-equal to the reference's), with the default or the full
    go2 plant."""
    model = phys.load_urdf(GO2_URDF, "go2")
    ma = phys.model_arrays(model, device=device)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
    pd = phys.PDParams(
        p_gains=torch.full((12,), 40.0, device=device),
        d_gains=torch.full((12,), 1.0, device=device),
        default_dof_pos=f32(DEFAULT_ANGLES),
        torque_limits=f32(model.dof_effort_limits),
        action_scale=0.25,
    )
    dof_limits = (f32(model.dof_pos_limits[:, 0]), f32(model.dof_pos_limits[:, 1]),
                  f32(model.dof_vel_limits))
    g = torch.Generator(device=device).manual_seed(0)
    normal = lambda *shape: torch.randn(shape, generator=g, device=device)
    uniform = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(shape, generator=g,
                                                                 device=device)
    quat = normal(4, batch) * 0.1 + torch.tensor([1.0, 0, 0, 0], device=device)[:, None]
    quat = quat / torch.linalg.norm(quat, dim=0, keepdim=True)
    xy_lo, xy_hi = (4.0, 8.0) if terrain else (-1.0, 1.0)
    state = phys.PhysicsState(
        base_pos=torch.cat([uniform(xy_lo, xy_hi, 2, batch), uniform(0.25, 0.45, 1, batch)]),
        base_quat=quat.contiguous(),
        lin_vel=normal(3, batch) * 0.5,
        ang_vel=normal(3, batch) * 0.5,
        dof_pos=(f32(DEFAULT_ANGLES)[:, None] + normal(12, batch) * 0.2).contiguous(),
        dof_vel=normal(12, batch) * 2.0,
    )
    dr = phys.DomainRandParams(
        friction=uniform(0.5, 1.25, batch),
        added_mass=uniform(-1.0, 1.0, batch),
        com_offset=normal(3, batch) * 0.01,
        kp_mult=torch.ones((12, batch), device=device),
        kd_mult=torch.ones((12, batch), device=device),
    )
    actions = normal(12, batch).clip(-3.14, 3.14)
    if terrain:
        rng = np.random.default_rng(7)
        raw = (rng.normal(size=(128, 128)) * 8).astype(np.int16)  # +-4 cm
        hf = phys.from_raw(raw, 0.1, 0.005, 1.0, device=device)
    else:
        hf = phys.plane()
    if full_plant:
        # the go2_config.sim plant (stiff contact + joint dynamics)
        full = lambda v: torch.full((12,), v, device=device)
        params = phys.SimParams(
            substeps=4,
            contact=phys.ContactParams(
                stiffness=40000.0, damping=250.0, friction_vel=250.0,
                terrain_friction=1.0,
            ),
            dof_damping=full(0.1),
            dof_armature=full(0.01),
            dof_frictionloss=full(0.2),
        )
    else:
        params = phys.SimParams()
    K = phys.patch_K(hf, params)
    spec = fused_step.build_spec(ma, params, pd, dof_limits, hf_K=K,
                                 hf_hs=hf.horizontal_scale if K else 0.0)
    return Plant(ma, hf, params, pd, dr, dof_limits, state, actions, spec)


def _terrain(p: Plant, state):
    if not p.spec.hf_K:
        return None
    lp = phys.extract_patch(p.hf, state.base_pos[0], state.base_pos[1], p.spec.hf_K)
    return fused_step.patch_inputs(lp)


def kernel_step(p: Plant, state, actions):
    """One control step through the kernel (`physics.control_step` on CUDA
    tensors: the windows cut, one launch)."""
    st, info = phys.control_step(p.ma, p.hf, p.params, p.pd, p.dr, p.dof_limits, state,
                                 actions, spec=p.spec)
    return st, StepOut(info.link_forces, info.torques)


def eager_step(p: Plant, state, actions):
    """One control step of the eager engine (`physics.control_step` with no
    spec, the windows cut, no launch), as an env with the kernel off steps."""
    st, info = phys.control_step(p.ma, p.hf, p.params, p.pd, p.dr, p.dof_limits, state,
                                 actions, spec=None)
    return st, StepOut(info.link_forces, info.torques)


def plain_step(p: Plant, state, actions):
    """One control step of the kernel's plain version on the same inputs."""
    st, lf, tau = fused_step.plain_control_step(p.spec, tuple(state), actions, tuple(p.dr),
                                                _terrain(p, state))[:3]
    return phys.PhysicsState(*(x.contiguous() for x in st)), StepOut(lf, tau)


def _action_noise(gen, shape):
    """One step's standard normals of the smoothed random actions."""
    return torch.randn(shape, generator=gen, device=gen.device)


def closed_loop_stats(step_fn, state, n_steps: int, batch: int, gen):
    """Roll the plant closed-loop for n_steps with a smoothed random action
    sequence; return trajectory statistic samples for the distributional
    parity gate: per-(env, step) dof_vel RMS, base height, and vertical
    foot-contact impulse."""
    stats = {"dof_vel_rms": [], "base_z": [], "contact_fz": []}
    a = torch.zeros((12, batch), device=state.dof_pos.device)
    for _ in range(n_steps):
        a = 0.8 * a + 0.2 * _action_noise(gen, (12, batch)) * 1.5
        state, info = step_fn(state, a.clip(-3.14, 3.14).contiguous())
        stats["dof_vel_rms"].append(
            torch.sqrt(torch.mean(state.dof_vel ** 2, dim=0)).cpu().numpy()
        )
        stats["base_z"].append(state.base_pos[2].cpu().numpy())
        stats["contact_fz"].append(
            torch.sum(torch.clamp_min(info.link_forces[:, 2], 0.0), dim=0).cpu().numpy()
        )
    return {k: np.concatenate(v) for k, v in stats.items()}


def ks_stat(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample Kolmogorov-Smirnov statistic (no scipy dependency)."""
    a = np.sort(a)
    b = np.sort(b)
    allv = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, allv, side="right") / len(a)
    cdf_b = np.searchsorted(b, allv, side="right") / len(b)
    return float(np.abs(cdf_a - cdf_b).max())


def _require_card(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit(
            f"check_fused_gpu checks the CUDA kernel against its plain version; it needs a "
            f"GPU and runs only with a CUDA device (got {device!r}, CUDA available: "
            f"{torch.cuda.is_available()})")
    return dev


# the spin that lets the host queue a run of launches of the kernel (about
# 0.2 ms of host time each) before the card reaches them
AHEAD_MS = 60.0


def roofline_bench(batch: int = 4096, terrain: bool = True, full_plant: bool = True,
                   iters: int = 30, device="cuda"):
    """Kernel-only timing + speed-of-light accounting (ops/roofline.py),
    with the peaks measured on this card.  Skips the plain version, which
    is irrelevant to the roofline question."""
    from legged_gym_custom_tpu_torch.bench import device_info
    from legged_gym_custom_tpu_torch.ops import roofline

    dev = _require_card(device)
    p = build(batch, terrain=terrain, full_plant=full_plant, device=dev)
    args = (p.spec, tuple(p.state), p.actions, tuple(p.dr), _terrain(p, p.state))
    achieved_ms = cuda_time_ms(lambda: fused_step.fused_control_step(*args), reps=iters,
                               warmup=1, ahead_ms=AHEAD_MS)
    report = roofline.roofline_report(p.spec, achieved_ms, batch, device=dev)
    report.update(batch=batch, terrain=terrain, full_plant=full_plant,
                  device=device_info(dev))
    return report


def get_args(argv=None):
    ap = argparse.ArgumentParser("check_fused_gpu")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--terrain", action="store_true",
                    help="bumpy heightfield + per-env patch (terrain kernel)")
    ap.add_argument("--full_plant", action="store_true",
                    help="the go2 plant (stiff contact, joint dynamics)")
    ap.add_argument("--rollout", type=int, default=0,
                    help="N>0: closed-loop N-step distributional parity gate "
                         "(KS statistic over trajectory stats, plain vs kernel)")
    ap.add_argument("--roofline", action="store_true",
                    help="kernel-only speed-of-light accounting (skips the "
                         "plain version)")
    ap.add_argument("--out", default=None, help="write the JSON receipt here")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Print (and with --out write) the receipt; returns it.  Raises
    SystemExit when the distributional gate fails."""
    from legged_gym_custom_tpu_torch.bench import device_info

    args = get_args(argv)
    dev = _require_card(args.device)

    if args.roofline:
        report = roofline_bench(args.batch, terrain=args.terrain,
                                full_plant=args.full_plant, iters=args.iters, device=dev)
        print(json.dumps(report))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
        return report

    t0 = time.time()
    p = build(args.batch, terrain=args.terrain, full_plant=args.full_plant, device=dev)
    fused_step.load_kernel(p.spec, args.batch)
    print(f"device={torch.cuda.get_device_name(dev)} batch={args.batch} "
          f"terrain={args.terrain} full_plant={args.full_plant} "
          f"(build {time.time() - t0:.1f}s)", flush=True)

    ref_state, ref_info = plain_step(p, p.state, p.actions)
    out_state, out_info = kernel_step(p, p.state, p.actions)
    torch.cuda.synchronize()

    # Parity stats.  max-abs alone is misleading under stiff contact: a
    # float-associativity difference in penetration depth at a contact on/off
    # boundary is amplified by the spring stiffness, so a handful of
    # grazing-contact envs dominate the max while the batch median is tiny.
    # Report per-env-reduced percentiles + the fraction of envs past a
    # loose gate alongside the max.
    pairs = {
        "pos": (out_state.base_pos, ref_state.base_pos),
        "quat": (out_state.base_quat, ref_state.base_quat),
        "dof_pos": (out_state.dof_pos, ref_state.dof_pos),
        "dof_vel": (out_state.dof_vel, ref_state.dof_vel),
        "torques": (out_info.torques, ref_info.torques),
        "link_forces": (out_info.link_forces, ref_info.link_forces),
    }
    deltas, delta_p50, delta_p99, outlier_frac = {}, {}, {}, {}
    for name, (a, b) in pairs.items():
        err = (a - b).abs().cpu().numpy()
        per_env = err.reshape(-1, err.shape[-1]).max(axis=0)  # (B,)
        deltas[name] = float(per_env.max())
        delta_p50[name] = float(np.percentile(per_env, 50))
        delta_p99[name] = float(np.percentile(per_env, 99))
        if name in PARITY_GATES:
            outlier_frac[name] = float((per_env > PARITY_GATES[name]).mean())

    # the kernel alone (its windows cut before) against its plain version on
    # the same inputs, as the reference times the Pallas call
    step_args = (p.spec, tuple(p.state), p.actions, tuple(p.dr), _terrain(p, p.state))
    t_plain = cuda_time_ms(lambda: fused_step.plain_control_step(*step_args),
                           reps=PLAIN_REPS, warmup=1)
    t_kernel = cuda_time_ms(lambda: fused_step.fused_control_step(*step_args), reps=args.iters,
                            warmup=1, ahead_ms=AHEAD_MS)
    # the whole step of the eager engine, as the reference times its XLA step
    t_eager = cuda_time_ms(lambda: eager_step(p, p.state, p.actions), reps=EAGER_REPS, warmup=1)
    result = {
        "metric": "fused_control_step",
        "batch": args.batch,
        "terrain": bool(args.terrain),
        "full_plant": bool(args.full_plant),
        "parity_max_abs": deltas,
        "parity_p50_abs": delta_p50,
        "parity_p99_abs": delta_p99,
        "parity_outlier_env_frac": outlier_frac,
        "plain_ms": round(t_plain, 3),
        "kernel_ms": round(t_kernel, 3),
        "plain_env_steps_per_s": round(args.batch / (t_plain * 1e-3)),
        "kernel_env_steps_per_s": round(args.batch / (t_kernel * 1e-3)),
        "speedup": round(t_plain / t_kernel, 3),
        "eager_ms": round(t_eager, 3),
        "eager_env_steps_per_s": round(args.batch / (t_eager * 1e-3)),
        "eager_speedup": round(t_eager / t_kernel, 3),
        "device": device_info(dev),
    }

    if args.rollout:
        # Closed-loop distributional gate: the kernel and its plain version
        # must be statistically the same physics, not just single-step
        # close.  Rolled out independently under one action sequence
        # (chaotic contact lets single envs part; the distributions must not).
        stats_plain = closed_loop_stats(
            lambda s, a: plain_step(p, s, a), p.state, args.rollout, args.batch,
            torch.Generator(device=dev).manual_seed(123))
        stats_kern = closed_loop_stats(
            lambda s, a: kernel_step(p, s, a), p.state, args.rollout, args.batch,
            torch.Generator(device=dev).manual_seed(123))
        ks = {k: round(ks_stat(stats_plain[k], stats_kern[k]), 4) for k in stats_plain}
        means = {
            k: [round(float(stats_plain[k].mean()), 4),
                round(float(stats_kern[k].mean()), 4)]
            for k in stats_plain
        }
        result["rollout_steps"] = args.rollout
        result["rollout_ks"] = ks
        result["rollout_means_plain_vs_kernel"] = means
        result["rollout_ks_gate"] = KS_GATE
        result["rollout_pass"] = bool(max(ks.values()) < KS_GATE)

    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if args.rollout and not result["rollout_pass"]:
        raise SystemExit(
            f"distributional parity FAILED: KS {result['rollout_ks']} exceeds gate {KS_GATE}"
        )
    return result


if __name__ == "__main__":
    main()
