"""Env-step layer (`envs/base_env.py`, `go2_env.py`, `rewards.py`, the
physics call, the policy's act): the device's kernel, copy and set events
per env step.  An event counts where the host's CUDA runtime call that
issued it (matched by correlation id, one call to each event) lies inside a
harness span `pb.env_step` or `pb.policy_act`; the count is over the number
of `pb.env_step` spans."""
import bisect


def read(run):
    t = run.trace
    spans = sorted(t.span_windows("pb.env_step") + t.span_windows("pb.policy_act")) \
        if t is not None else []
    steps = len(t.span_windows("pb.env_step")) if spans else 0
    lo, hi = t.window if spans else (0, 0)
    issued = [h for (_, b, _), h in zip(t.device, t.launched)
              if h is not None and lo <= h <= hi] if steps else []
    if not issued:
        return None
    starts = [b for b, _ in spans]
    n = 0
    for h in issued:
        i = bisect.bisect_right(starts, h) - 1
        n += i >= 0 and h <= spans[i][1]
    return n / steps
