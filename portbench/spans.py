"""The program's own spans in a traced window: `lgc.<layer>[.<phase>]`, which
`legged_gym_custom_tpu_torch/utils/profiling.py::span` records as
`record_function`s on the profiler's clock while a profiler runs.  They are
host events of `Trace.host`; the readers count, per span, the device events
issued inside it and the host's blocking runtime calls started inside it.

A device event is issued in a span when the host's runtime call that issued
it (`Trace.launched`) starts inside one of the span's windows.  A sync is a
host runtime call that waits for the device (SYNCS); it counts where it
starts.  Only spans that start inside the traced window count.  A program
that marks no such span (one older than its spans) gives None, never 0."""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

# The CUDA runtime's calls that block the host on the device, and their
# driver-API twins: a synchronize of a stream, the device or an event, and a
# synchronous copy (`cudaMemcpy`, not `cudaMemcpyAsync`).
SYNCS = frozenset((
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize", "cuMemcpy",
    "cuMemcpyDtoH", "cuMemcpyDtoH_v2", "cuMemcpyHtoD", "cuMemcpyHtoD_v2",
))


def windows(trace, name: str, within: Optional[str] = None) -> List[Tuple[int, int]]:
    """The (start, end) of every `name` span that starts inside the traced
    window, sorted; with `within`, only those inside a `within` span."""
    lo, hi = trace.window
    out = sorted((b, e) for n, b, e in trace.host if n == name and lo <= b < hi)
    if within is not None:
        outer = windows(trace, within)
        out = [(b, e) for b, e in out if (i := _find(outer, b)) is not None and e <= outer[i][1]]
    return out


def _find(wins: List[Tuple[int, int]], t: int) -> Optional[int]:
    """The index of the last window that starts at or before `t`, where `t`
    lies inside it; else None."""
    i = bisect.bisect_right(wins, (t, float("inf"))) - 1
    return i if i >= 0 and t <= wins[i][1] else None


def count_in(wins: List[Tuple[int, int]], times) -> int:
    """How many of `times` lie inside one of the disjoint, sorted `wins`."""
    return sum(1 for t in times if t is not None and _find(wins, t) is not None)


def launches(trace, name: str, per: str, within: Optional[str] = None) -> Optional[float]:
    """Device events issued inside the `name` spans (inside `within` spans,
    if given), over the number of `per` spans; None where either is absent."""
    if trace is None:
        return None
    wins, n = windows(trace, name, within), len(windows(trace, per))
    if not wins or not n:
        return None
    return count_in(wins, trace.launched) / n


def syncs(trace, name: str) -> Optional[float]:
    """Host runtime calls that wait on the device, started inside the
    `name` spans, over their number; None where the span is absent."""
    if trace is None:
        return None
    wins = windows(trace, name)
    if not wins:
        return None
    return count_in(wins, (b for n, b, _ in trace.host if n in SYNCS)) / len(wins)
