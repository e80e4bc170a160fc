"""Extract TensorBoard scalar curves from a training run into JSON, a copy of
legged_gym_custom_tpu/scripts/extract_curve.py (numpy-free, no JAX).

Produces the `reward_curve.json` artifact format (dict: tag -> [[iteration,
value], ...], subsampled), the receipt that a training run actually learned
(reference analog: the TB logs of on_policy_runner.py:221-239).  The port's
runner writes event files only where `tensorboard` is installed
(rl/runner.py), so this is a host tool.

Usage: python -m legged_gym_custom_tpu_torch.scripts.extract_curve \
           logs/go2_parkour/<run> out.json [--every 25] [--tags t1,t2,...]
"""
from __future__ import annotations

import argparse
import json
import os

DEFAULT_TAGS = [
    "Train/mean_reward",
    "Train/mean_episode_length",
    "Episode/rew_tracking_lin_vel",
    "Episode/rew_tracking_ang_vel",
    "Episode/rew_phase_contact_match",
    "Episode/rew_jump_zone_forward_vel",
    "Episode/rew_jump_zone_upward_vel",
    "Episode/terrain_level",
    "Perf/total_fps",
    "Loss/estimator",
    "Loss/regularization",
    "Loss/value_function",
]


def extract(run_dir: str, tags=None, every: int = 25) -> dict:
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(run_dir, size_guidance={"scalars": 0})
    acc.Reload()
    available = set(acc.Tags().get("scalars", []))
    out = {}
    for tag in tags or DEFAULT_TAGS:
        if tag not in available:
            continue
        events = acc.Scalars(tag)
        series = [
            [int(e.step), round(float(e.value), 4)]
            for e in events
            if e.step % every == 0 or e is events[-1]
        ]
        out[tag] = series
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("out_json")
    ap.add_argument("--every", type=int, default=25)
    ap.add_argument("--tags", default=None)
    args = ap.parse_args(argv)
    tags = args.tags.split(",") if args.tags else None
    curves = extract(args.run_dir, tags=tags, every=args.every)
    os.makedirs(os.path.dirname(os.path.abspath(args.out_json)), exist_ok=True)
    with open(args.out_json, "w") as f:
        json.dump(curves, f)
    print(f"wrote {len(curves)} curves to {args.out_json}")


if __name__ == "__main__":
    main()
