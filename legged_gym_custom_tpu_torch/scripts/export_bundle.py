"""Export a deploy bundle from a checkpoint without rolling the env, torch
port of legged_gym_custom_tpu/scripts/export_bundle.py.

Packaging needs only the network parameters, so this tool builds the env
object (for the network dimensions, on a 1 x 1 course), restores the
checkpoint and writes the .npz bundle through deploy/export.py.

Run: python -m legged_gym_custom_tpu_torch.scripts.export_bundle \
        --task go2_parkour_cliff --load_run <run> [--checkpoint N] \
        --out path/to/policy_bundle.npz [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os

from legged_gym_custom_tpu_torch import DEFAULT_DEVICE, LEGGED_GYM_TORCH_ROOT_DIR


def get_args(argv=None):
    ap = argparse.ArgumentParser("export_bundle")
    ap.add_argument("--task", required=True)
    ap.add_argument("--load_run", default=None)
    ap.add_argument("--checkpoint", type=int, default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def main(args, log_root="default") -> str:
    """Write the bundle of the checkpoint to `args.out`; returns the checkpoint path."""
    from legged_gym_custom_tpu_torch.deploy.export import export_policy_bundle
    from legged_gym_custom_tpu_torch.envs import task_registry
    from legged_gym_custom_tpu_torch.rl.runner import OnPolicyRunner
    from legged_gym_custom_tpu_torch.utils.task_registry import get_load_path

    env_cfg, train_cfg = task_registry.get_cfgs(args.task)
    env_cfg.env.num_envs = 1
    env_cfg.terrain.num_rows = 1
    env_cfg.terrain.num_cols = 1
    env_cfg.terrain.curriculum = False
    env = task_registry.task_classes[args.task](env_cfg, env_cfg.asset.file, name=args.task,
                                                device=args.device)
    runner = OnPolicyRunner(env, train_cfg, log_dir=None)
    if log_root == "default":
        log_root = os.path.join(LEGGED_GYM_TORCH_ROOT_DIR, "logs",
                                train_cfg.runner.experiment_name)
    path = get_load_path(log_root, load_run=args.load_run or -1,
                         checkpoint=args.checkpoint if args.checkpoint is not None else -1)
    runner.load(path)
    out = os.path.abspath(args.out)
    export_policy_bundle(runner.nets, os.path.dirname(out), filename=os.path.basename(out))
    print(f"exported {path} -> {args.out}")
    return path


if __name__ == "__main__":
    main(get_args())
