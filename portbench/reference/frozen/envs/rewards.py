"""Reward terms, torch port of legged_gym_custom_tpu/envs/rewards.py.

Each term is a batched function of a `RewardCtx` and the task's
`RewardStatics`; the env builds its term list from cfg.rewards.scales
(scale * dt, zero scales dropped) and sums the terms with positive clipping
and the termination-after-clip rule (reference legged_robot.py:216-237).

Every term of the JAX registry is here: the base terms
(legged_robot.py:1036-1148), the Go2 parkour and phase-gait terms
(go2.py:578-831), the G1 humanoid terms (g1_env_broken.py:106-124, with
`forward_vel` as the clipped world forward velocity) and Cassie's `no_fly`
(cassie.py:42-46).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch


class RewardStatics(NamedTuple):
    """Static (per-task) data used by reward terms."""

    dt: float
    tracking_sigma: float
    base_height_target: float
    max_contact_force: float
    pitch_deg_target: float
    roll_deg_target: float
    max_foot_height: float
    percent_time_on_ground: float
    soft_dof_pos_limits: torch.Tensor   # (ndof, 2)
    soft_dof_vel_limit: float
    soft_torque_limit: float
    dof_vel_limits: torch.Tensor        # (ndof,)
    torque_limits: torch.Tensor         # (ndof,)
    default_dof_pos: torch.Tensor       # (ndof,)
    feet_ids: np.ndarray                # link indices (static numpy)
    penalized_ids: np.ndarray
    termination_ids: np.ndarray
    calf_link_ids: np.ndarray
    hip_joint_ids: np.ndarray
    thigh_joint_ids: np.ndarray
    calf_joint_ids: np.ndarray
    heading_command: bool
    # gate the jump-zone rewards on actual forward velocity (m/s; 0 = off,
    # the reference behavior; see the JAX RewardStatics)
    jump_zone_fwd_gate: float = 0.0


class RewardCtx(NamedTuple):
    """Per-step batched quantities the reward terms read (batch-leading)."""

    base_pos: torch.Tensor          # (B,3) world
    base_lin_vel: torch.Tensor      # (B,3) body frame
    base_ang_vel: torch.Tensor      # (B,3) body frame
    world_lin_vel: torch.Tensor     # (B,3) world frame
    projected_gravity: torch.Tensor  # (B,3)
    roll: torch.Tensor              # (B,)
    pitch: torch.Tensor
    yaw: torch.Tensor
    heading: torch.Tensor
    commands: torch.Tensor          # (B,4)
    dof_pos: torch.Tensor           # (B,ndof)
    dof_vel: torch.Tensor
    last_dof_vel: torch.Tensor
    torques: torch.Tensor
    last_torques: torch.Tensor
    actions: torch.Tensor
    last_actions: torch.Tensor
    link_forces: torch.Tensor       # (B, n_links, 3)
    feet_pos: torch.Tensor          # (B, n_feet, 3) world
    feet_vel: torch.Tensor          # (B, n_feet, 3) world
    last_contact_heights: torch.Tensor  # (B, n_feet)
    contact_filt: torch.Tensor      # (B, n_feet) bool
    feet_air_time: torch.Tensor     # (B, n_feet)
    first_contact: torch.Tensor     # (B, n_feet) bool
    phases: torch.Tensor            # (B,4) per-leg [fl, fr, bl, br]
    measured_heights: torch.Tensor  # (B,P)
    jump_flags: torch.Tensor        # (B,)
    reset_buf: torch.Tensor         # (B,) bool
    time_out_buf: torch.Tensor      # (B,) bool
    # new-ground rate (m/s): clip(base_x - the episode's max x so far, 0) / dt
    progress: torch.Tensor          # (B,)


def _sq_sum(x):
    return torch.sum(torch.square(x), dim=1)


def _reward_lin_vel_z(ctx, s):
    return torch.square(ctx.base_lin_vel[:, 2])


def _reward_ang_vel_xy(ctx, s):
    return _sq_sum(ctx.base_ang_vel[:, :2])


def _reward_orientation(ctx, s):
    return _sq_sum(ctx.projected_gravity[:, :2])


def _reward_base_height(ctx, s):
    base_height = torch.mean(ctx.base_pos[:, 2:3] - ctx.measured_heights, dim=1)
    return torch.square(base_height - s.base_height_target)


def _reward_torques(ctx, s):
    return _sq_sum(ctx.torques)


def _reward_dof_vel(ctx, s):
    return _sq_sum(ctx.dof_vel)


def _reward_dof_acc(ctx, s):
    return _sq_sum((ctx.last_dof_vel - ctx.dof_vel) / s.dt)


def _reward_action_rate(ctx, s):
    return _sq_sum(ctx.last_actions - ctx.actions)


def _reward_collision(ctx, s):
    f = torch.linalg.norm(ctx.link_forces[:, s.penalized_ids, :], dim=-1)
    return torch.sum((f > 0.1).float(), dim=1)


def _reward_termination(ctx, s):
    return (ctx.reset_buf & ~ctx.time_out_buf).float()


def _reward_dof_pos_limits(ctx, s):
    out = -torch.clamp(ctx.dof_pos - s.soft_dof_pos_limits[:, 0], max=0.0)
    out = out + torch.clamp(ctx.dof_pos - s.soft_dof_pos_limits[:, 1], min=0.0)
    return torch.sum(out, dim=1)


def _reward_dof_vel_limits(ctx, s):
    return torch.sum(torch.clamp(
        torch.abs(ctx.dof_vel) - s.dof_vel_limits * s.soft_dof_vel_limit, 0.0, 1.0), dim=1)


def _reward_torque_limits(ctx, s):
    return torch.sum(torch.clamp(
        torch.abs(ctx.torques) - s.torque_limits * s.soft_torque_limit, min=0.0), dim=1)


def _reward_stand_still(ctx, s):
    small = torch.linalg.norm(ctx.commands[:, :2], dim=1) < 0.1
    return torch.sum(torch.abs(ctx.dof_pos - s.default_dof_pos), dim=1) * small


def _reward_feet_air_time(ctx, s):
    """Long-step reward on filtered first contact (go2.py:819-831)."""
    rew = torch.sum((ctx.feet_air_time - 0.5) * ctx.first_contact, dim=1)
    return rew * (torch.linalg.norm(ctx.commands[:, :2], dim=1) > 0.1)


def _reward_contact_forces(ctx, s):
    f = torch.linalg.norm(ctx.link_forces[:, s.feet_ids, :], dim=-1)
    return torch.sum(torch.clamp(f - s.max_contact_force, min=0.0), dim=1)


def _reward_tracking_lin_vel(ctx, s):
    err = _sq_sum(ctx.commands[:, :2] - ctx.base_lin_vel[:, :2])
    return torch.exp(-err / s.tracking_sigma)


def _reward_tracking_ang_vel(ctx, s):
    err = torch.square(ctx.commands[:, 2] - ctx.base_ang_vel[:, 2])
    return torch.exp(-err / s.tracking_sigma)


def _reward_delta_torques(ctx, s):
    return _sq_sum(ctx.torques - ctx.last_torques)


def _reward_dof_error(ctx, s):
    return _sq_sum(ctx.dof_pos - s.default_dof_pos)


def _reward_zero_cmd_dof_error(ctx, s):
    zero = (torch.linalg.norm(ctx.commands[:, :3], dim=1) < 0.2).float()
    return _reward_dof_error(ctx, s) * zero


def _joint_sq_err(ctx, s, joint_ids):
    ids = torch.as_tensor(joint_ids, device=ctx.dof_pos.device)
    return _sq_sum(ctx.dof_pos[:, ids] - s.default_dof_pos[ids])


def _reward_hip_pos(ctx, s):
    return _joint_sq_err(ctx, s, s.hip_joint_ids)


def _reward_thigh_pos(ctx, s):
    return _joint_sq_err(ctx, s, s.thigh_joint_ids)


def _reward_calf_pos(ctx, s):
    return _joint_sq_err(ctx, s, s.calf_joint_ids)


def _stumble(f):
    """1 where some link's horizontal force exceeds 5 times its vertical one."""
    return torch.any(torch.linalg.norm(f[:, :, :2], dim=2) > 5 * torch.abs(f[:, :, 2]),
                     dim=1).float()


def _reward_stumble_feet(ctx, s):
    return _stumble(ctx.link_forces[:, s.feet_ids, :])


def _reward_stumble_calves(ctx, s):
    return _stumble(ctx.link_forces[:, s.calf_link_ids, :])


def _reward_calf_collision(ctx, s):
    f = torch.linalg.norm(ctx.link_forces[:, s.calf_link_ids, :], dim=-1)
    return torch.sum((f > 0.1).float(), dim=1)


def _reward_tracking_pitch(ctx, s):
    pitch_deg = ctx.pitch * (180.0 / math.pi)
    return torch.exp(-torch.square(pitch_deg - s.pitch_deg_target) / s.tracking_sigma)


def _reward_tracking_roll(ctx, s):
    roll_deg = ctx.roll * (180.0 / math.pi)
    return torch.exp(-torch.square(roll_deg - s.roll_deg_target) / s.tracking_sigma)


def _stance_flags(ctx, s):
    stance_threshold = 2.0 * s.percent_time_on_ground - 1.0
    return torch.sin(2 * math.pi * ctx.phases) <= stance_threshold


def _reward_phase_contact_match(ctx, s):
    match = ~(ctx.contact_filt ^ _stance_flags(ctx, s))
    return torch.sum(torch.where(match, 0.25, -0.25), dim=1)


def _reward_phase_foot_lifting(ctx, s):
    stance = _stance_flags(ctx, s)
    heights = ctx.feet_pos[:, :, 2] - ctx.last_contact_heights
    normalized = torch.clamp(heights, 0.0, s.max_foot_height) / s.max_foot_height
    rew = torch.where(~stance, normalized, -normalized)
    return torch.sum(rew, dim=1) / 2.0


def _left_right_asymmetry(ctx, joint_ids):
    """Sum |q_left - q_right| over the front and rear leg pairs (legs in
    FL, FR, RL, RR order)."""
    ids = np.asarray(joint_ids)
    left = ctx.dof_pos[:, torch.as_tensor(ids[[0, 2]], device=ctx.dof_pos.device)]
    right = ctx.dof_pos[:, torch.as_tensor(ids[[1, 3]], device=ctx.dof_pos.device)]
    return torch.sum(torch.abs(left - right), dim=1)


def _reward_thigh_symmetry(ctx, s):
    return _left_right_asymmetry(ctx, s.thigh_joint_ids)


def _reward_calf_symmetry(ctx, s):
    return _left_right_asymmetry(ctx, s.calf_joint_ids)


def _wrap_to_pi(x):
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def _moving(ctx):
    """1 where the command asks for motion (|cmd| >= 0.2), else 0."""
    return (torch.linalg.norm(ctx.commands[:, :3], dim=1) >= 0.2).float()


def _reward_heading_alignment(ctx, s):
    desired = (_wrap_to_pi(ctx.commands[:, 3]) if s.heading_command
               else torch.zeros_like(ctx.heading))
    err = _wrap_to_pi(desired - ctx.heading)
    return torch.square(err) * _moving(ctx)


def _reward_reverse_penalty(ctx, s):
    return -torch.clamp(ctx.world_lin_vel[:, 0], max=0.0)


def _jump_motion_gate(ctx, s):
    """The command mask (reference go2.py:778,791), and optionally the
    actual forward velocity above `jump_zone_fwd_gate`."""
    moving = _moving(ctx)
    if s.jump_zone_fwd_gate > 0.0:
        moving = moving * (ctx.world_lin_vel[:, 0] > s.jump_zone_fwd_gate).float()
    return moving


def _reward_jump_zone_forward_vel(ctx, s):
    fwd = torch.clamp(ctx.world_lin_vel[:, 0], min=0.0)
    return fwd * (ctx.jump_flags > 0.0).float() * _jump_motion_gate(ctx, s)


def _reward_jump_zone_upward_vel(ctx, s):
    up = torch.clamp(ctx.world_lin_vel[:, 2], min=0.0)
    return up * (ctx.jump_flags > 0.0).float() * _jump_motion_gate(ctx, s)


def _reward_progress(ctx, s):
    """New-ground bonus: pays only for course x not reached before in this
    episode, so pacing or bobbing at a gap edge earns nothing."""
    return ctx.progress * _moving(ctx)


def _reward_min_height(ctx, s):
    z_err = torch.clamp(s.base_height_target - ctx.base_pos[:, 2], 0.0, s.base_height_target)
    return z_err * (ctx.jump_flags > 0.0).float()


# ---------------------------------------------------------------------------
# G1 humanoid terms (g1_env_broken.py:106-124; `forward_vel`, declared in the
# reference's config but not implemented there, is the clipped world forward
# velocity, as in the JAX package)
# ---------------------------------------------------------------------------

def _feet_in_contact(ctx, s):
    return torch.linalg.norm(ctx.link_forces[:, s.feet_ids, :], dim=-1) > 1.0


def _reward_g1_contact(ctx, s):
    stance = ctx.phases < 0.55
    contact = ctx.link_forces[:, s.feet_ids, 2] > 1.0
    return torch.sum((~(contact ^ stance)).float(), dim=1)


def _reward_feet_swing_height(ctx, s):
    pos_error = torch.square(ctx.feet_pos[:, :, 2] - 0.08) * ~_feet_in_contact(ctx, s)
    return torch.sum(pos_error, dim=1)


def _reward_alive(ctx, s):
    return torch.ones_like(ctx.roll)


def _reward_contact_no_vel(ctx, s):
    v = ctx.feet_vel * _feet_in_contact(ctx, s)[..., None]
    return torch.sum(torch.square(v), dim=(1, 2))


def _reward_forward_vel(ctx, s):
    return torch.clamp(ctx.world_lin_vel[:, 0], min=0.0)


# Cassie's single-stance term (cassie.py:42-46)
def _reward_no_fly(ctx, s):
    contacts = ctx.link_forces[:, s.feet_ids, 2] > 0.1
    return (torch.sum(contacts.float(), dim=1) == 1).float()


REWARD_REGISTRY: Dict[str, Callable] = {
    "lin_vel_z": _reward_lin_vel_z,
    "ang_vel_xy": _reward_ang_vel_xy,
    "orientation": _reward_orientation,
    "base_height": _reward_base_height,
    "torques": _reward_torques,
    "dof_acc": _reward_dof_acc,
    "action_rate": _reward_action_rate,
    "collision": _reward_collision,
    "termination": _reward_termination,
    "tracking_lin_vel": _reward_tracking_lin_vel,
    "tracking_ang_vel": _reward_tracking_ang_vel,
    "delta_torques": _reward_delta_torques,
    "dof_error": _reward_dof_error,
    "zero_cmd_dof_error": _reward_zero_cmd_dof_error,
    "hip_pos": _reward_hip_pos,
    "thigh_pos": _reward_thigh_pos,
    "stumble_feet": _reward_stumble_feet,
    "phase_contact_match": _reward_phase_contact_match,
    "phase_foot_lifting": _reward_phase_foot_lifting,
    "thigh_symmetry": _reward_thigh_symmetry,
    "calf_symmetry": _reward_calf_symmetry,
    "heading_alignment": _reward_heading_alignment,
    "reverse_penalty": _reward_reverse_penalty,
    "jump_zone_forward_vel": _reward_jump_zone_forward_vel,
    "jump_zone_upward_vel": _reward_jump_zone_upward_vel,
    "contact_forces": _reward_contact_forces,
    "feet_contact_forces": _reward_contact_forces,
    "progress": _reward_progress,
    "min_height": _reward_min_height,
    "dof_vel": _reward_dof_vel,
    "dof_pos_limits": _reward_dof_pos_limits,
    "dof_vel_limits": _reward_dof_vel_limits,
    "torque_limits": _reward_torque_limits,
    "stand_still": _reward_stand_still,
    "feet_air_time": _reward_feet_air_time,
    "calf_pos": _reward_calf_pos,
    "stumble_calves": _reward_stumble_calves,
    "calf_collision": _reward_calf_collision,
    "tracking_pitch": _reward_tracking_pitch,
    "tracking_roll": _reward_tracking_roll,
    "no_fly": _reward_no_fly,
    "contact": _reward_g1_contact,
    "feet_swing_height": _reward_feet_swing_height,
    "alive": _reward_alive,
    "contact_no_vel": _reward_contact_no_vel,
    "forward_vel": _reward_forward_vel,
}
