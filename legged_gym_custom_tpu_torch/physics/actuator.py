"""PD actuation, torch port of legged_gym_custom_tpu/physics/actuator.py
(`PDParams`, `compute_torques`; the SEA LSTM comes with the other robots).

Semantics of reference legged_robot.py:440-478: position ('P') or direct
torque ('T') control, per-env kp/kd multipliers, clipping to the URDF effort
limits.  Velocity control ('V') needs `last_dof_vel` and `dt`; it runs on the
eager path only, the fused kernel has no 'V' variant.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PDParams(NamedTuple):
    p_gains: torch.Tensor         # (ndof,)
    d_gains: torch.Tensor         # (ndof,)
    default_dof_pos: torch.Tensor  # (ndof,)
    torque_limits: torch.Tensor   # (ndof,)
    action_scale: float
    control_type: str = "P"       # 'P' | 'V' | 'T'


def _bcast(x, bs):
    return x.reshape(tuple(x.shape) + (1,) * len(bs))


def compute_torques(pd: PDParams, actions, dof_pos, dof_vel, kp_mult=None, kd_mult=None,
                    last_dof_vel=None, dt=None):
    """Component-major with trailing batch: actions/dof_pos/dof_vel (ndof,)+bs."""
    bs = tuple(dof_pos.shape[1:])
    tlim = _bcast(pd.torque_limits, bs)
    actions_scaled = actions * pd.action_scale
    if pd.control_type == "P":
        kp = _bcast(pd.p_gains, bs)
        kd = _bcast(pd.d_gains, bs)
        if kp_mult is not None:
            kp = kp_mult * kp
        if kd_mult is not None:
            kd = kd_mult * kd
        torques = kp * (actions_scaled + _bcast(pd.default_dof_pos, bs) - dof_pos) - kd * dof_vel
    elif pd.control_type == "V":
        torques = _bcast(pd.p_gains, bs) * (actions_scaled - dof_vel) - _bcast(pd.d_gains, bs) * (
            (dof_vel - last_dof_vel) / dt)
    elif pd.control_type == "T":
        torques = actions_scaled
    else:
        raise NameError(f"Unknown controller type: {pd.control_type}")
    return torch.maximum(torch.minimum(torques, tlim), -tlim)
