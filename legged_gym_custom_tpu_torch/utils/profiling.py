"""Profiling / tracing utilities, torch port of
legged_gym_custom_tpu/utils/profiling.py: a torch.profiler trace around a
block, the program's spans, CUDA-event timing of a call on the card, and the
card's memory statistics."""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

SM_CLOCK_HZ = 1.98e9   # H100 SXM boost clock: sizes the spin that lets the host run ahead
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A span `name` around a block of the program: a `record_function` on
    the profiler's own clock (the one its device events are on) while a
    torch.profiler records, else one shared null context.  Spans are named
    `lgc.<layer>[.<phase>]`; with no profiler on, a span costs one check."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host + device trace around a code block into `log_dir`
    (`<worker>.<time>.pt.trace.json`, read by TensorBoard's profiler plugin
    and by Perfetto).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def cuda_time_ms(fn, reps: int, warmup: int = 3, ahead_ms: float = 0.0) -> float:
    """Median of `reps` CUDA-event timings of `fn()`, after `warmup` calls.
    A kernel that takes less than its Python wrapper takes to enqueue it would
    be timed at the host's pace; `ahead_ms` first keeps the card spinning that
    long, so that every launch and its two events are already queued when the
    card reaches them and each pair of events brackets device time only."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if ahead_ms:
        torch.cuda._sleep(int(ahead_ms * 1e-3 * SM_CLOCK_HZ))
    events = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in events]))


def device_memory_stats() -> Dict[str, int]:
    """The byte counters of `torch.cuda.memory_stats()` on the current card,
    or {} without one."""
    if not torch.cuda.is_available():
        return {}
    return {k: v for k, v in torch.cuda.memory_stats().items() if "bytes" in k}
