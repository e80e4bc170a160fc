"""Interactive play with live commands, torch port of
legged_gym_custom_tpu/scripts/control_and_play.py (reference
scripts/control_and_play.py).

Usage: python -m legged_gym_custom_tpu_torch.scripts.control_and_play
       --task go2 [--load_run R] [--checkpoint C] [--steps S]
       [--vx VX --vy VY --wz WZ] [--device cuda|cpu]

Drives a trained policy in one env with gamepad commands (deploy/gamepad.py)
or, when no gamepad is present, the fixed command `--vx --vy --wz`; logs
base/joint traces through utils/logger.py.  Rendering, being
Isaac-viewer-specific in the reference, is replaced by the MuJoCo deploy loop
(deploy/mujoco_runner.py) for visual playback.  Runs on the GPU unless
`--device cpu` is given.  Unlike the JAX script, `--load_run` and
`--checkpoint` select the checkpoint (the JAX one parses and ignores them).
"""
from __future__ import annotations

import argparse
from typing import NamedTuple

import torch

from legged_gym_custom_tpu_torch import DEFAULT_DEVICE


def get_args(argv=None):
    p = argparse.ArgumentParser("legged_gym_custom_tpu_torch control_and_play")
    p.add_argument("--task", default="go2")
    p.add_argument("--load_run", default=None)
    p.add_argument("--checkpoint", type=int, default=None)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--vx", type=float, default=0.8)
    p.add_argument("--vy", type=float, default=0.0)
    p.add_argument("--wz", type=float, default=0.0)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    return p.parse_args(argv)


class ControlResult(NamedTuple):
    runner: object
    state: object          # the env state after the last step
    obs: object            # the observation after the last step
    steps: int             # env steps taken (fewer than --steps after an e-stop)
    obs_finite: bool       # every observation of the run was finite


def play(args, log_root="default") -> ControlResult:
    from legged_gym_custom_tpu_torch.deploy.gamepad import Gamepad
    from legged_gym_custom_tpu_torch.envs import task_registry
    from legged_gym_custom_tpu_torch.utils.logger import Logger

    env_cfg, train_cfg = task_registry.get_cfgs(args.task)
    env_cfg.env.num_envs = 1
    env_cfg.terrain.num_rows = 2
    env_cfg.terrain.num_cols = 2
    env_cfg.terrain.curriculum = False
    env_cfg.noise.add_noise = False
    env_cfg.domain_rand.push_robots = False
    env_cfg.domain_rand.randomize_friction = False
    env_cfg.domain_rand.randomize_base_mass = False
    env_cfg.domain_rand.randomize_center_of_mass = False
    env_cfg.domain_rand.randomize_kp_kd = False
    env_cfg.commands.user_command = [args.vx, args.vy, args.wz, 0.0]

    env, _ = task_registry.make_env(name=args.task, env_cfg=env_cfg, device=args.device)
    train_cfg.runner.resume = True
    if args.load_run:
        train_cfg.runner.load_run = args.load_run
    if args.checkpoint is not None:
        train_cfg.runner.checkpoint = args.checkpoint
    runner, train_cfg = task_registry.make_alg_runner(
        env=env, name=args.task, train_cfg=train_cfg, log_root=log_root)
    policy = runner.get_inference_policy()

    pad = Gamepad(vel_scale_x=1.2, vel_scale_y=0.6, vel_scale_rot=1.0)
    logger = Logger(env.dt)
    state, obs = env.reset_all(torch.Generator(device=env.device).manual_seed(0))
    finite, steps = True, 0
    for i in range(args.steps):
        cmd = pad.get_command()
        if pad._available:
            commands = state.commands.clone()
            commands[0, :3] = torch.as_tensor(cmd, device=env.device)
            state = state.replace(commands=commands)
        if pad.estop_flagged:
            print("E-STOP")
            break
        actions = policy(obs, adaptation_mode=True)
        state, obs, rew, done, info = env.step(state, actions)
        steps += 1
        finite = finite and bool(torch.isfinite(obs.obs).all())
        logger.log_states(
            dict(
                base_vel_x=float(obs.estimated[0, 0]) / 2.0,
                command_x=float(state.commands[0, 0]),
                dof_pos=float(state.physics.dof_pos[0, 2]),
                dof_pos_target=float(actions[0, 2]) * env.cfg.control.action_scale,
            )
        )
        if i % 100 == 0:
            print(
                f"step {i}: vx={float(obs.estimated[0, 0]) / 2.0:+.2f} "
                f"cmd={float(state.commands[0, 0]):+.2f} "
                f"z={float(state.physics.base_pos[0, 2]):.2f}"
            )
    pad.stop()
    logger.print_rewards()
    return ControlResult(runner, state, obs, steps, finite)


if __name__ == "__main__":
    play(get_args())
