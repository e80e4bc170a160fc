"""The traced window (`--trace 1`): `torch.profiler` over a short stretch of
the cell's own traffic, read into plain lists that the metric readers take
apart.  The harness's spans (`record_function`, names starting `pb.`) are
recorded from the benchmark's own files around its calls into the program's
layers; the program records none yet."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "pb.window"
# The host's CUDA runtime and driver calls: the only host events whose
# correlation id is CUPTI's, shared with the device events they issue.
RUNTIME = ("cuda", "cu")


class Trace:
    """Device events `(name, start_ns, end_ns)`, sorted by start, the host
    events (every CPU op and span) and the harness's spans, and the traced
    window; `counts` holds what the driver counted inside it.  `launched`
    holds, for each device event, the start of the host's CUDA runtime call
    that issued it (by CUPTI's correlation id; None where the trace holds no
    such call)."""

    def __init__(self, device: List[Tuple[str, int, int]], host: List[Tuple[str, int, int]],
                 window: Tuple[int, int], counts: Dict[str, float],
                 launched: Optional[List[Optional[int]]] = None):
        self.device = device
        self.host = host
        self.spans = [h for h in host if h[0].startswith("pb.")]
        self.window = window
        self.counts = counts
        self.launched = launched if launched is not None else [None] * len(device)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def in_window(self):
        """The device events that overlap the window, clipped to it."""
        lo, hi = self.window
        return [(n, max(b, lo), min(e, hi)) for n, b, e in self.device if e > lo and b < hi]

    def busy_s(self, events=None) -> float:
        """Seconds in which some device operation ran: the union of the
        events' intervals, clipped to the window."""
        lo, hi = self.window
        total, end = 0, lo
        for _, b, e in sorted(events if events is not None else self.device, key=lambda d: d[1]):
            b, e = max(b, end), min(e, hi)
            if e > b:
                total += e - b
                end = e
        return total / 1e9

    def span_windows(self, name: str) -> List[Tuple[int, int]]:
        return sorted((b, e) for n, b, e in self.spans if n == name)

    def per_span(self, name: str):
        """The device events that start between each `name` span's start and
        the next one's (the copy of `mpc/bench.py::solve_device_times`: each
        span ends in a synchronize, so its work has ended before the next)."""
        starts = [b for b, _ in self.span_windows(name)]
        first = [d[1] for d in self.device]
        out = []
        for i, s in enumerate(starts):
            lo = bisect.bisect_left(first, s)
            hi = bisect.bisect_left(first, starts[i + 1]) if i + 1 < len(starts) else len(first)
            out.append(self.device[lo:hi])
        return out


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def read(prof, counts: Dict[str, float]) -> Trace:
    """The profiler's raw events (not `prof.events()`, which builds a Python
    object for every event first) as a Trace; the window is the
    harness's `pb.window` span."""
    from torch.autograd import DeviceType

    device, host, runtime = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.name(), e.start_ns(), e.end_ns()))
            if e.name().startswith(RUNTIME) and e.correlation_id() > 0:
                runtime[e.correlation_id()] = e.start_ns()
    device.sort(key=lambda d: d[1])
    window = [(b, e) for n, b, e in host if n == WINDOW]
    if not window:
        raise RuntimeError("the profile holds no pb.window span")
    return Trace([d[:3] for d in device], host, window[0], counts,
                 [runtime.get(d[3]) for d in device])


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the window, and its
    longest idle gaps, each named by what the host was doing at the gap's
    middle: the innermost harness span and the innermost host op."""
    lo, hi = trace.window
    by_name = defaultdict(int)
    for n, b, e in trace.in_window():
        by_name[n] += e - b
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], lo
    for _, b, e in trace.in_window():
        if b > end:
            gaps.append((b - end, end, b))
        end = max(end, e)
    if hi > end:
        gaps.append((hi - end, end, hi))
    gaps.sort(reverse=True)
    named = []
    for length, b, e in gaps[:top]:
        mid = (b + e) // 2
        inner = lambda evs: min((x for x in evs if x[1] <= mid <= x[2]),
                                key=lambda x: x[2] - x[1], default=None)
        span = inner(trace.spans)
        op = inner([h for h in trace.host if not h[0].startswith("pb.")])
        label = " > ".join(x[0] for x in (span, op) if x is not None) or "host idle"
        named.append([label, length / 1e9])
    return {"device_ops": [[n, t / 1e9] for n, t in ops], "idle_gaps": named}
