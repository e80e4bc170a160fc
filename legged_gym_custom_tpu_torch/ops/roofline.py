"""Speed-of-light accounting for the fused control-step kernel, torch port of
legged_gym_custom_tpu/ops/roofline.py.

Three parts:

* a per-env operation count of the kernel's algorithm, from an aten-level
  trace of the step that walks the kernel's lane plan at one lane per
  branch (`plan_step.plan_control_step`) on one env.  The reference counts
  the jaxpr of its kernel's own body (`control_step_components`); the
  port's kernel is CUDA C++, which no tracer reads, so the port counts the
  plain step that does the kernel's arithmetic and no more (a butterfly sum
  formed once, the base's 6x6 system solved once, articulated inertias as
  3x3 blocks).  The reference's weights: comparisons, selects, min / max
  one operation each, clamp two, a division four; sqrt, rsqrt, tanh, sin,
  cos, exp, log, sigmoid, atan2, asin, acos and a non-integer pow are
  transcendentals; layout and bookkeeping ops are `other_prims`.  The same
  count gives chip_smoke.py's bound of every build;
* measured machine peaks of this card: fp32 FMA throughput, tanhf
  throughput and device-memory stream bandwidth, from three measurement
  kernels written by hand (ops/csrc/peaks.cu, nvcc for sm_90a, medians of
  CUDA-event timings of a launch).  They measure the card and compute no function of the
  system; each wrapper's plain version (used for CPU tensors, and on the
  card to check the kernel) is the same chain in eager PyTorch;
* the roofline ratio: achieved kernel time against
  max(compute_time, memory_time), where compute_time charges the flops and
  transcendentals at their measured rates (summed, as the reference does:
  the two pipes run at once, so for a kernel with many transcendentals this
  overstates the speed of light and understates the ratio) and memory_time
  the kernel's device-memory traffic at the measured stream bandwidth.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
from typing import Dict

import torch

from ..utils.profiling import cuda_time_ms
from . import fused_step, lane_plan, plan_step

PEAKS_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "peaks.cu")
FMA_INNER, TANH_INNER = 32, 8   # LGC_FMA_INNER, LGC_TANH_INNER of peaks.cu
# The published rates of one H100 SXM at its 700 W limit, in the units of
# the measured peaks: fp32 outside the tensor cores and HBM3 bandwidth from
# NVIDIA's data sheet; the special-function rate from the Hopper white paper
# (16 SFU results per SM a clock, 132 SMs, 1.98 GHz boost).  A measured rate
# above one of them is a fault of the measurement.
DATASHEET_PEAKS = {"fma_gflops": 67000.0, "trans_gops": 16 * 132 * 1.98, "hbm_gbps": 3350.0}

# aten op -> elementwise flop weight (the reference's _FLOP_WEIGHTS, :38-47,
# by aten name).  Undercounting work understates the speed-of-light bound,
# so the reported roofline % is a floor, never flattery.
_FLOP_WEIGHTS = {
    "add": 1, "sub": 1, "rsub": 1, "mul": 1, "neg": 1, "abs": 1,
    "maximum": 1, "minimum": 1, "max": 1, "min": 1, "clamp_min": 1, "clamp_max": 1,
    "where": 1, "clamp": 2,
    "ge": 1, "gt": 1, "le": 1, "lt": 1, "eq": 1, "ne": 1,
    "logical_and": 1, "logical_or": 1, "logical_not": 1, "logical_xor": 1,
    "bitwise_and": 1, "bitwise_or": 1, "bitwise_not": 1, "bitwise_xor": 1,
    "sign": 1, "floor": 1, "ceil": 1, "round": 1,
    "square": 1,   # the reference's integer_pow
    "div": 4, "reciprocal": 4,
}
_TRANS_OPS = {
    "sqrt", "rsqrt", "tanh", "sin", "cos", "exp", "log", "sigmoid",
    "atan2", "asin", "acos", "pow",
}
_SUM_OPS = {"sum"}   # adds scale with the INPUT element count (reduce_sum)


def _numel(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    if isinstance(x, (tuple, list)):
        return max((_numel(v) for v in x), default=1)
    return 1


def count_ops(fn, *args) -> Dict[str, int]:
    """Run `fn(*args)` under an aten-level trace and count its operations
    with the reference's weights (see the module docstring)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = {"flops": 0, "transcendentals": 0, "other_prims": 0}

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            size = _numel(out)
            if name == "pow" and len(args) > 1 and isinstance(args[1], (int, float)) \
                    and float(args[1]).is_integer():
                counts["flops"] += size            # x ** 2: the reference's integer_pow
            elif name in _FLOP_WEIGHTS:
                counts["flops"] += _FLOP_WEIGHTS[name] * size
            elif name in _SUM_OPS:
                counts["flops"] += _numel(args[0])
            elif name in _TRANS_OPS:
                counts["transcendentals"] += size
            else:
                counts["other_prims"] += size
            return out

    with Counter():
        fn(*args)
    return {k: int(v) for k, v in counts.items()}


def count_kernel_ops(spec) -> Dict[str, int]:
    """Per-ENV counts of the kernel's algorithm for one full control step
    (decimation x substeps, as the kernel runs it): the lane-plan step at
    one lane per branch, traced on one env ((C, 1) zeros; the trace holds no
    branch on a value, so the count does not depend on the data)."""
    ndof = len(spec.parent) - 1
    one = lambda c: torch.zeros((c, 1), dtype=torch.float32)
    state = (one(3), one(4), one(3), one(3), one(ndof), one(ndof))
    dr = (torch.zeros(1), torch.zeros(1), one(3), one(ndof), one(ndof))
    terrain = None
    if spec.hf_K:
        terrain = (torch.zeros((1, spec.hf_K, spec.hf_K)), torch.zeros(1), torch.zeros(1))
    return count_ops(plan_step.plan_control_step, spec, lane_plan.lane_plan(spec, 1), state,
                     one(ndof), dr, terrain)


def kernel_bytes_per_env(spec) -> int:
    """Device-memory traffic per env per control step: every input read
    once, every output written once (the point of the fusion: no
    intermediate round trips)."""
    ndof = len(spec.parent) - 1
    nl = spec.n_links
    state_io = 3 + 4 + 3 + 3 + ndof + ndof          # in AND out
    dr_in = 1 + 1 + 3 + ndof + ndof
    act_in = ndof
    out_extra = nl * 3 + ndof                        # link forces + torques
    n_f32 = 2 * state_io + dr_in + act_in + out_extra
    if spec.hf_K:
        n_f32 += spec.hf_K * spec.hf_K + 2           # patch + x/y offsets
    return 4 * n_f32


# --------------------------------------------------------------------------
# The measurement kernels: build, wrappers, plain versions
# --------------------------------------------------------------------------


class PeaksBuild:
    """An nvcc build of peaks.cu, started in the background on
    construction (so that it can run beside the fused kernel's builds);
    `finish` waits for it and loads the library.  A library already in
    fused_step.BUILD_DIR for the same source and flags is reused."""

    def __init__(self):
        with open(PEAKS_SOURCE, "rb") as f:
            key = hashlib.sha256(f.read() + " ".join(fused_step.NVCC_FLAGS).encode())
        os.makedirs(fused_step.BUILD_DIR, exist_ok=True)
        self.build = fused_step.NvccBuild(
            os.path.join(fused_step.BUILD_DIR, f"peaks_{key.hexdigest()[:16]}.so"), PEAKS_SOURCE)
        self.ptxas, self.build_seconds = "", 0.0

    def finish(self) -> ctypes.CDLL:
        global _LIB
        self.ptxas, self.build_seconds = self.build.wait()
        lib = ctypes.CDLL(self.build.lib_path)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lgc_fma_chain.argtypes = [p, i, i, f, f, p]
        lib.lgc_tanh_chain.argtypes = [p, i, i, f, p]
        lib.lgc_stream_add.argtypes = [p, p, ctypes.c_long, p]
        for fn in (lib.lgc_fma_chain, lib.lgc_tanh_chain, lib.lgc_stream_add,
                   lib.lgc_fma_inner, lib.lgc_tanh_inner):
            fn.restype = i
        lib.lgc_peaks_error_string.argtypes = [i]
        lib.lgc_peaks_error_string.restype = ctypes.c_char_p
        if (lib.lgc_fma_inner(), lib.lgc_tanh_inner()) != (FMA_INNER, TANH_INNER):
            raise RuntimeError("peaks.cu's chain lengths differ from ops/roofline.py's")
        _LIB = lib
        return lib


_LIB = None


def _lib() -> ctypes.CDLL:
    return _LIB if _LIB is not None else PeaksBuild().finish()


def _check(x: torch.Tensor, what: str):
    """The measurement kernels read four floats a thread."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 or x.dim() != 1 \
            or not x.is_contiguous() or x.numel() == 0 or x.numel() % 4:
        raise ValueError(f"{what}: expected a contiguous 1-D float32 tensor of 4k > 0 elements")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: unsupported device {x.device}")


def _launch(fn, *args, device):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError("measurement kernel launch failed: "
                           + _lib().lgc_peaks_error_string(err).decode())


def plain_fma_chain(x, a: float, b: float, iters: int):
    c = x.clone()
    for _ in range(iters * FMA_INNER):
        c = c * a + b
    return c


def plain_tanh_chain(x, b: float, iters: int):
    c = x.clone()
    for _ in range(iters * TANH_INNER):
        c = torch.tanh(c) + b
    return c


def plain_stream_add(x):
    return x + 1.0


def fma_chain(x: torch.Tensor, a: float, b: float, iters: int) -> torch.Tensor:
    """iters x FMA_INNER dependent c = c * a + b on each element of a copy
    of x.  CPU tensors run the plain version; CUDA tensors launch
    `lgc_fma_chain` (one FMA, one rounding, a step)."""
    _check(x, "fma_chain")
    if x.device.type == "cpu":
        return plain_fma_chain(x, a, b, iters)
    out = x.clone()
    _launch(_lib().lgc_fma_chain, out.data_ptr(), out.numel(), iters, a, b, device=x.device)
    fma_chain.launches += 1
    return out


def tanh_chain(x: torch.Tensor, b: float, iters: int) -> torch.Tensor:
    """iters x TANH_INNER dependent c = tanh(c) + b on a copy of x."""
    _check(x, "tanh_chain")
    if x.device.type == "cpu":
        return plain_tanh_chain(x, b, iters)
    out = x.clone()
    _launch(_lib().lgc_tanh_chain, out.data_ptr(), out.numel(), iters, b, device=x.device)
    tanh_chain.launches += 1
    return out


def stream_add(x: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """out = x + 1 (out allocated when not given)."""
    _check(x, "stream_add")
    if x.device.type == "cpu":
        return plain_stream_add(x)
    if out is None:
        out = torch.empty_like(x)
    _check(out, "stream_add out")
    if out.shape != x.shape or out.device != x.device:
        raise ValueError("stream_add: out must match x")
    _launch(_lib().lgc_stream_add, x.data_ptr(), out.data_ptr(), x.numel(), device=x.device)
    stream_add.launches += 1
    return out


fma_chain.launches = tanh_chain.launches = stream_add.launches = 0
KERNELS = {"fma_chain": fma_chain, "tanh_chain": tanh_chain, "stream_add": stream_add}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


# --------------------------------------------------------------------------
# Measured peaks
# --------------------------------------------------------------------------


def _cuda(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the measured peaks are the card's: they need a CUDA device")
    return dev


def _elements(size_mb: float) -> int:
    return int(size_mb * 1e6 / 4) // 1024 * 1024


# The measurement shapes: the chains run over 4 MB (it stays in the 50 MB L2,
# and iters x inner steps an element amortize its traffic), the stream over
# 256 MB, far larger than the L2, STREAM_ITERS launches a timing.
CHAIN_ELEMENTS, STREAM_ELEMENTS = _elements(4.0), _elements(256.0)
FMA_ITERS, TANH_ITERS, STREAM_ITERS = 512, 64, 32


def measure_fma_peak_gflops(device="cuda") -> float:
    """Sustained fp32 FMA rate: each thread chains FMA_INNER dependent FMAs
    an iteration in a register, so memory traffic is amortized FMA_ITERS x
    FMA_INNER fold and the kernel measures the FMA pipes' issue rate."""
    x = torch.ones(CHAIN_ELEMENTS, device=_cuda(device))
    ms = cuda_time_ms(lambda: fma_chain(x, 1.0000001, 1e-7, FMA_ITERS), reps=5, warmup=1)
    return 2.0 * x.numel() * FMA_ITERS * FMA_INNER / (ms * 1e-3) / 1e9


def measure_trans_rate_gops(device="cuda") -> float:
    """Sustained tanhf rate (the kernel's transcendental, its frictionloss
    torque), inner-chained like the FMA measurement."""
    x = torch.full((CHAIN_ELEMENTS,), 0.5, device=_cuda(device))
    ms = cuda_time_ms(lambda: tanh_chain(x, 1.0000001, TANH_ITERS), reps=5, warmup=1)
    return x.numel() * TANH_ITERS * TANH_INNER / (ms * 1e-3) / 1e9


def measure_hbm_bw_gbps(device="cuda") -> float:
    """Sustained device-memory stream bandwidth: out = x + 1 (read + write
    each launch), STREAM_ITERS launches."""
    x = torch.ones(STREAM_ELEMENTS, device=_cuda(device))
    out = torch.empty_like(x)

    def run():
        for _ in range(STREAM_ITERS):
            stream_add(x, out)

    ms = cuda_time_ms(run, reps=3, warmup=1)
    return 2.0 * 4.0 * x.numel() * STREAM_ITERS / (ms * 1e-3) / 1e9


def measure_peaks(device="cuda") -> Dict[str, float]:
    return {"fma_gflops": measure_fma_peak_gflops(device=device),
            "trans_gops": measure_trans_rate_gops(device=device),
            "hbm_gbps": measure_hbm_bw_gbps(device=device)}


def roofline_report(spec, achieved_ms: float, batch: int,
                    peaks: Dict[str, float] | None = None, device="cuda") -> Dict:
    """Achieved vs speed-of-light for one fused control step at `batch`."""
    ops = count_kernel_ops(spec)
    bpe = kernel_bytes_per_env(spec)
    if peaks is None:
        peaks = measure_peaks(device)
    compute_ms = (
        ops["flops"] / (peaks["fma_gflops"] * 1e9)
        + ops["transcendentals"] / (peaks["trans_gops"] * 1e9)
    ) * batch * 1e3
    memory_ms = bpe * batch / (peaks["hbm_gbps"] * 1e9) * 1e3
    sol_ms = max(compute_ms, memory_ms)
    return {
        "per_env_flops": ops["flops"],
        "per_env_transcendentals": ops["transcendentals"],
        "per_env_hbm_bytes": bpe,
        "measured_peaks": {k: round(v, 1) for k, v in peaks.items()},
        "compute_bound_ms": round(compute_ms, 3),
        "memory_bound_ms": round(memory_ms, 3),
        "speed_of_light_ms": round(sol_ms, 3),
        "achieved_ms": round(achieved_ms, 3),
        "bound": "compute" if compute_ms >= memory_ms else "memory",
        "roofline_pct": round(100.0 * sol_ms / max(achieved_ms, 1e-9), 1),
    }
