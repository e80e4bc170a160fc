"""Evaluation / export entry point, torch port of
legged_gym_custom_tpu/scripts/play.py.

Usage: python -m legged_gym_custom_tpu_torch.scripts.play --task go2
       [--load_run R] [--checkpoint C] [--num_envs N] [--steps S]
       [--device cuda|cpu] [--record_scan PATH] [--plot]

Loads the latest checkpoint for a task, rolls the deterministic policy out
with the play-time overrides (one small terrain, no randomization or noise,
reference play.py:14-25), exports the deploy bundle (policy + adaptation +
estimator + scan encoder, deploy/export.py) to
`logs/<experiment>/exported/policies/policy_bundle.npz`, and logs states
through utils/logger.py.  Runs on the GPU unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from legged_gym_custom_tpu_torch import DEFAULT_DEVICE, LEGGED_GYM_TORCH_ROOT_DIR


def get_args(argv=None):
    p = argparse.ArgumentParser("legged_gym_custom_tpu_torch play")
    p.add_argument("--task", default="go2")
    p.add_argument("--load_run", default=None)
    p.add_argument("--checkpoint", type=int, default=None)
    p.add_argument("--num_envs", type=int, default=1)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    p.add_argument("--export", action="store_true", default=True)
    p.add_argument("--plot", action="store_true")
    p.add_argument(
        "--record_scan",
        default=None,
        metavar="PATH",
        help="record jump-flag-synced scandot frames of env 0 to PATH in the "
        "SCAN_*.txt deploy-replay format (reference play.py:61-104)",
    )
    return p.parse_args(argv)


class ScanCapture:
    """Record jump-flag-synced scandot frames for deploy fake-scan replay.

    While env 0's jump flag is raised, write the gait-phase sync scalar once
    (`[phase]`) and then one 132-float frame per control step; when the flag
    drops after having been raised, stop.  The output is what
    `deploy.controller.parse_scan_trace` reads and the replay state machine
    feeds to the scan encoder.
    """

    def __init__(self, path: str):
        self.path = path
        self.started = False
        self.complete = False
        open(path, "w").close()

    def update(self, jump_flag: bool, phase: float, scan: np.ndarray) -> None:
        if self.complete:
            return
        if jump_flag:
            with open(self.path, "a") as f:
                if not self.started:
                    f.write(f"[{float(phase)}]\n\n")
                    self.started = True
                f.write(np.array2string(np.asarray(scan, np.float32), threshold=10_000) + "\n\n")
        elif self.started:
            self.complete = True
            print(f"SCAN LOGGING COMPLETE: trace written to {self.path}")


class PlayResult(NamedTuple):
    runner: object
    obs: object                     # the observation the last action was computed from
    actions: torch.Tensor           # the last action, (num_envs, num_actions)
    bundle_path: Optional[str]      # the exported policy bundle, if any
    actions_finite: bool            # every action of the rollout was finite


def play(args, log_root="default") -> PlayResult:
    from legged_gym_custom_tpu_torch.envs import task_registry
    from legged_gym_custom_tpu_torch.utils.logger import Logger

    env_cfg, train_cfg = task_registry.get_cfgs(args.task)
    # play-time overrides (reference play.py:13-25)
    env_cfg.env.num_envs = min(args.num_envs, 100)
    env_cfg.terrain.num_rows = 5
    env_cfg.terrain.num_cols = 5
    env_cfg.terrain.curriculum = False
    env_cfg.noise.add_noise = False
    env_cfg.domain_rand.randomize_friction = False
    env_cfg.domain_rand.push_robots = False
    env_cfg.domain_rand.randomize_base_mass = False
    env_cfg.domain_rand.randomize_center_of_mass = False
    env_cfg.domain_rand.randomize_kp_kd = False

    env, _ = task_registry.make_env(name=args.task, args=args, env_cfg=env_cfg,
                                    device=args.device)
    train_cfg.runner.resume = True
    if args.load_run:
        train_cfg.runner.load_run = args.load_run
    if args.checkpoint is not None:
        train_cfg.runner.checkpoint = args.checkpoint
    if log_root == "default":
        log_root = os.path.join(LEGGED_GYM_TORCH_ROOT_DIR, "logs",
                                train_cfg.runner.experiment_name)
    runner, train_cfg = task_registry.make_alg_runner(
        env=env, name=args.task, args=None, train_cfg=train_cfg, log_root=log_root)
    policy = runner.get_inference_policy()

    bundle_path = None
    if args.export:
        from legged_gym_custom_tpu_torch.deploy.export import export_policy_bundle

        export_dir = os.path.join(log_root, "exported", "policies")
        bundle_path = export_policy_bundle(runner.nets, export_dir)
        print(f"Exported policy bundle to: {export_dir}")

    logger = Logger(env.dt)
    capture = ScanCapture(args.record_scan) if args.record_scan else None
    period = getattr(env.cfg.env, "period", 0.45)
    gen = torch.Generator(device=env.device).manual_seed(0)
    state, obs = env.reset_all(gen)
    last_obs, actions, finite = obs, None, True
    for _ in range(args.steps):
        last_obs = obs
        actions = policy(obs, adaptation_mode=True)
        state, obs, rew, done, info = env.step(state, actions)
        finite = finite and bool(torch.isfinite(actions).all())
        if capture is not None:
            phase0 = (float(state.episode_length[0]) * env.dt % period) / period
            capture.update(bool(state.jump_flags[0] > 0.0), phase0, obs.scan[0].cpu().numpy())
        est = obs.estimated[0].tolist()
        logger.log_states(
            dict(
                dof_pos_target=float(actions[0, 2]) * env.cfg.control.action_scale,
                dof_pos=float(state.physics.dof_pos[0, 2]),
                dof_vel=float(state.physics.dof_vel[0, 2]),
                dof_torque=0.0,
                command_x=float(state.commands[0, 0]),
                command_y=float(state.commands[0, 1]),
                command_yaw=float(state.commands[0, 2]),
                base_vel_x=est[0] / 2.0,
                base_vel_y=est[1] / 2.0,
                base_vel_z=est[2] / 2.0,
                base_vel_yaw=0.0,
                contact_forces_z=np.zeros(4),
            )
        )
        if bool(done[0]):
            logger.reset()
    logger.print_rewards()
    if args.plot:
        logger.plot_states()
    return PlayResult(runner, last_obs, actions, bundle_path, finite)


if __name__ == "__main__":
    play(get_args())
