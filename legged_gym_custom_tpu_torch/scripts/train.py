"""Training entry point, torch port of legged_gym_custom_tpu/scripts/train.py.

Usage: python -m legged_gym_custom_tpu_torch.scripts.train --task go2
       [--num_envs N] [--max_iterations M] [--seed S] [--device cuda|cpu]
       [--resume] [--load_run R] [--checkpoint C]

`--resume` loads the newest checkpoint of the newest run of the experiment
(or the one `--load_run` / `--checkpoint` name) and goes on from its iteration.
A task whose config sets `runner.resume` (the go2_parkour stages after the
first: `--task go2_parkour_finetune`, ...) resumes so without the flag.

Runs on the GPU unless `--device cpu` is given; with no GPU it raises
rather than falling back to the CPU.
"""
from __future__ import annotations

import argparse

from legged_gym_custom_tpu_torch import DEFAULT_DEVICE
from legged_gym_custom_tpu_torch.envs import task_registry


def get_args(argv=None):
    """CLI args (reference helpers.py:152-178); --device picks the card or
    the CPU."""
    p = argparse.ArgumentParser("legged_gym_custom_tpu_torch train")
    p.add_argument("--task", default="go2")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--experiment_name", default=None)
    p.add_argument("--run_name", default=None)
    p.add_argument("--load_run", default=None)
    p.add_argument("--checkpoint", type=int, default=None)
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max_iterations", type=int, default=None)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    p.add_argument("--headless", action="store_true")  # accepted for parity
    return p.parse_args(argv)


def train(args, log_root="default", env_cfg=None):
    """Build the env (from `env_cfg` if given, else the task's config) and
    the runner, and train; returns (runner, per-iteration history)."""
    env, _ = task_registry.make_env(name=args.task, args=args, env_cfg=env_cfg,
                                    device=args.device)
    runner, train_cfg = task_registry.make_alg_runner(env=env, name=args.task, args=args,
                                                      log_root=log_root)
    history = runner.learn(num_learning_iterations=train_cfg.runner.max_iterations,
                           init_at_random_ep_len=True)
    return runner, history


if __name__ == "__main__":
    train(get_args())
