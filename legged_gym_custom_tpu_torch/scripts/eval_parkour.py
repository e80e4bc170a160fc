"""Deterministic parkour capability evaluation, torch port of
legged_gym_custom_tpu/scripts/eval_parkour.py.

Rolls the deterministic inference policy over a parkour course and reports,
per env: course-x reached (the env's `max_x` progress tracker), gaps/
composites crossed, flight-phase statistics and termination causes, as the
same JSON object the JAX tool prints (its keys and how each value is
computed).

Modes:
  --course finetune   the jump-finetune composite course (default)
  --course gaps --gap_width 0.3   a plain-gap course: 6 gaps of the given
                      width at x = 5, 8.5, ... (the generator's gap layout)

Run: python -m legged_gym_custom_tpu_torch.scripts.eval_parkour \
        --task go2_parkour_commit --load_run <run> --checkpoint N \
        [--num_envs 128] [--steps 600] [--course gaps --gap_width 0.3] \
        [--device cuda|cpu]

Runs on the GPU unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from legged_gym_custom_tpu_torch import DEFAULT_DEVICE, LEGGED_GYM_TORCH_ROOT_DIR


def get_args(argv=None):
    p = argparse.ArgumentParser("eval_parkour")
    p.add_argument("--task", default="go2_parkour_commit")
    p.add_argument("--load_run", default=None)
    p.add_argument("--checkpoint", type=int, default=None)
    p.add_argument("--num_envs", type=int, default=128)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--course", choices=["finetune", "gaps"], default="finetune")
    p.add_argument("--gap_width", type=float, default=0.3)
    p.add_argument("--n_gaps", type=int, default=6)
    p.add_argument("--command_vx", type=float, default=1.2)
    p.add_argument("--stochastic", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--ckpt_path", default=None,
                   help="load this checkpoint path directly (bypasses the "
                        "logs-dir run/checkpoint resolution)")
    p.add_argument("--device", default=DEFAULT_DEVICE)
    return p.parse_args(argv)


def course_edges(parkour_kwargs):
    """(the far edge's course x of each obstacle, which obstacles are gaps)
    as the reference counts them (eval_parkour.py:82-83): x + length.  Kept
    so on purpose, although the generator centres each obstacle on its x and
    the true far edge is x + length / 2 (ROADMAP Queue C)."""
    far_edges = np.asarray(parkour_kwargs["x_positions"]) + np.asarray(
        parkour_kwargs["obstacle_lengths"])
    return far_edges, np.asarray(parkour_kwargs["obstacle_heights"]) < 0.0


class EvalRun(NamedTuple):
    result: dict       # the JSON object the tool prints
    steps: int         # env steps run: fewer than --steps when every env ended before
    seconds: float     # wall time of the rollout, from the reset to the last step


def evaluate(args, log_root="default") -> EvalRun:
    """Build the eval env, load the checkpoint and roll the policy out."""
    from legged_gym_custom_tpu_torch.envs import task_registry
    from legged_gym_custom_tpu_torch.rl.runner import OnPolicyRunner
    from legged_gym_custom_tpu_torch.utils.task_registry import get_load_path

    env_cfg, train_cfg = task_registry.get_cfgs(args.task)
    env_cfg.env.num_envs = args.num_envs
    env_cfg.terrain.num_rows = 1
    env_cfg.terrain.num_cols = 1
    env_cfg.terrain.curriculum = False
    env_cfg.noise.add_noise = False
    for k in ["randomize_friction", "push_robots", "randomize_base_mass",
              "randomize_center_of_mass", "randomize_kp_kd"]:
        setattr(env_cfg.domain_rand, k, False)
    # spawn at the course start, not in the bootcamp slots
    env_cfg.init_state.rand_x_offsets = None
    env_cfg.init_state.rand_vx_range = None
    # no stall termination at eval: balking is measured, not hidden
    if hasattr(env_cfg, "termination"):
        env_cfg.termination.stall_time_s = 0.0

    if args.course == "gaps":
        xs = [5.0 + 3.5 * k for k in range(args.n_gaps)]
        env_cfg.terrain.parkour_kwargs = dict(
            env_cfg.terrain.parkour_kwargs,
            x_positions=xs,
            y_positions=[0.0] * args.n_gaps,
            obstacle_heights=[-2.0] * args.n_gaps,
            obstacle_lengths=[args.gap_width] * args.n_gaps,
        )

    far_edges, is_gap = course_edges(env_cfg.terrain.parkour_kwargs)

    env, _ = task_registry.make_env(name=args.task, args=None, env_cfg=env_cfg,
                                    device=args.device)
    train_cfg.runner.resume = True
    if args.load_run:
        train_cfg.runner.load_run = args.load_run
    if args.checkpoint is not None:
        train_cfg.runner.checkpoint = args.checkpoint
    if args.ckpt_path:
        path = args.ckpt_path
    else:
        if log_root == "default":
            log_root = os.path.join(LEGGED_GYM_TORCH_ROOT_DIR, "logs",
                                    train_cfg.runner.experiment_name)
        path = get_load_path(log_root, load_run=train_cfg.runner.load_run or -1,
                             checkpoint=train_cfg.runner.checkpoint
                             if train_cfg.runner.checkpoint is not None else -1)
    runner = OnPolicyRunner(env, train_cfg, log_dir=None)
    runner.load(path)
    print(f"loaded {path}")
    policy = runner.get_inference_policy(stochastic=args.stochastic)

    dev = env.device
    state, obs = env.reset_all(torch.Generator(device=dev).manual_seed(0))
    B = args.num_envs
    cmd = torch.tensor([args.command_vx, 0.0, 0.0, 0.0], device=dev).expand(B, 4)

    alive = torch.ones(B, dtype=torch.bool, device=dev)
    best_x = torch.full((B,), -float("inf"), device=dev)
    air_run = torch.zeros(B, dtype=torch.long, device=dev)
    max_air = torch.zeros(B, dtype=torch.long, device=dev)
    flight_count = torch.zeros(B, dtype=torch.long, device=dev)  # airborne runs >= 3 steps
    sample_gen = torch.Generator(device=dev).manual_seed(7)
    steps_run, t0 = 0, time.time()
    for _ in range(args.steps):
        state = state.replace(commands=cmd)
        if args.stochastic:
            actions = policy(obs, sample_gen, adaptation_mode=True)
        else:
            actions = policy(obs, adaptation_mode=True)
        state, obs, rew, done, info = env.step(state, actions)
        steps_run += 1
        rel = state.max_x - state.env_origins[:, 0]
        best_x = torch.where(alive, torch.maximum(best_x, rel), best_x)
        airborne = ~state.last_contacts.any(dim=1) & alive
        flight_count += ((air_run >= 3) & ~airborne).long()
        air_run = torch.where(airborne, air_run + 1, 0)
        max_air = torch.maximum(max_air, air_run)
        alive &= ~done
        if not bool(alive.any()):
            break
    seconds = time.time() - t0

    alive, max_air = alive.cpu().numpy(), max_air.cpu().numpy()
    best_x = best_x.cpu().numpy().astype(np.float64)
    flight_count = flight_count.cpu().numpy()
    gaps_crossed = (best_x[:, None] > far_edges[None, is_gap] + 0.05).sum(axis=1)
    n_obstacle_groups = None
    if args.course == "finetune":
        comp_far = far_edges[2::3]  # last gap of each composite
        n_obstacle_groups = (best_x[:, None] > comp_far[None, :] + 0.05).sum(axis=1)

    result = {
        "task": args.task,
        "checkpoint": path,
        "course": args.course,
        "gap_width": args.gap_width if args.course == "gaps" else None,
        "num_envs": B,
        "steps": args.steps,
        "stochastic": bool(args.stochastic),
        "survived_frac": round(float(alive.mean()), 3),
        "best_x_p50": round(float(np.percentile(best_x, 50)), 2),
        "best_x_p90": round(float(np.percentile(best_x, 90)), 2),
        "best_x_max": round(float(best_x.max()), 2),
        "gaps_crossed_p50": float(np.percentile(gaps_crossed, 50)),
        "gaps_crossed_p90": float(np.percentile(gaps_crossed, 90)),
        "gaps_crossed_max": int(gaps_crossed.max()),
        "frac_crossed_3plus": round(float((gaps_crossed >= 3).mean()), 3),
        "flight_runs_p50": float(np.percentile(flight_count, 50)),
        "max_airborne_steps": int(max_air.max()),
    }
    if n_obstacle_groups is not None:
        result["composites_crossed_p50"] = float(np.percentile(n_obstacle_groups, 50))
        result["composites_crossed_max"] = int(n_obstacle_groups.max())
    return EvalRun(result, steps_run, seconds)


def main(args, log_root="default"):
    result = evaluate(args, log_root=log_root).result
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main(get_args())
