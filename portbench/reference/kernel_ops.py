"""The fused kernel's operations and bytes, frozen from the port's
`ops/roofline.py` (`count_ops`, `count_kernel_ops`, `kernel_bytes_per_env`):
the kernel's algorithm counted per env and control step from an aten-level
trace of the lane-plan step at one lane a branch (the frozen
`ops/plan_step.py`), with the reference's weights (comparisons, selects,
min / max one operation each, clamp two, a division four; sqrt, tanh, exp and
the like are transcendentals).  `spec` is the kernel's spec as the program
built it for the cell (its `fused_spec`): the constants of the model, not a
count."""
from __future__ import annotations

import functools
from typing import Dict

import torch

from .frozen.ops import lane_plan, plan_step

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


@functools.lru_cache(maxsize=8)
def cached_counts(spec) -> Dict[str, int]:
    """`count_kernel_ops`, once per spec in a process (the trace takes
    seconds)."""
    return count_kernel_ops(spec)
