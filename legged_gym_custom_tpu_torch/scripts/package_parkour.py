"""Package the parkour training runs into a trained-policy artifact, the
port's counterpart of legged_gym_custom_tpu/scripts/package_parkour.py.

Writes, into --out:
  reward_curve.json   TB scalars merged across the base run(s) and the jump
                      finetune run on a single global-iteration axis
  model_final.pt      the blessed checkpoint (a port checkpoint is one
                      `.pt` file, copied with its metadata)

Two differences from the reference, both deliberate: the checkpoint is a
file, not an orbax directory; and the default --out lies under the port's
own logs root, not the repository's `trained/go2_parkour_tpu_r3`, which
holds the JAX package's artifacts.

The remaining artifact pieces (policy_bundle.npz via scripts/play.py export,
scenes via deploy/scene_gen.py) are produced by their own tools.

Usage: python -m legged_gym_custom_tpu_torch.scripts.package_parkour \
           --runs run1:0 run2:1350 ft:3550 --ckpt <model_N.pt>
where each --runs entry is <logdir>:<global iteration offset>.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil

from legged_gym_custom_tpu_torch import LEGGED_GYM_TORCH_ROOT_DIR as ROOT
from legged_gym_custom_tpu_torch.scripts.extract_curve import extract


def merge_curves(runs, every=25):
    merged: dict = {}
    for run_dir, offset in runs:
        cur = extract(run_dir, every=every)
        for tag, series in cur.items():
            out = merged.setdefault(tag, [])
            base_max = out[-1][0] if out else -1
            for it, v in series:
                g = it + offset
                if g > base_max:
                    out.append([g, v])
    return merged


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="+", required=True,
                    help="<logdir>:<global offset> in training order")
    ap.add_argument("--ckpt", required=True, help="checkpoint file to bless")
    ap.add_argument("--out", default=os.path.join(ROOT, "logs", "trained", "go2_parkour"))
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    runs = []
    for spec in args.runs:
        d, off = spec.rsplit(":", 1)
        runs.append((d, int(off)))

    curves = merge_curves(runs)
    mean_rew = curves.get("Train/mean_reward")
    if not mean_rew:
        # the reference's message as it is: the conditional binds looser
        # than `+`, so with no tag extracted the whole message is "none"
        raise SystemExit(
            "Train/mean_reward not found in the given runs; extracted tags: "
            + ", ".join(sorted(curves)) if curves else "none"
        )
    with open(os.path.join(args.out, "reward_curve.json"), "w") as f:
        json.dump(curves, f)
    print(f"reward_curve.json: {len(curves)} tags, "
          f"final mean_reward={mean_rew[-1]}")

    dst = os.path.join(args.out, "model_final.pt")
    shutil.copy2(args.ckpt, dst)
    print(f"checkpoint: {args.ckpt} -> {dst}")


if __name__ == "__main__":
    main()
