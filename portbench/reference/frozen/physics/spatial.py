"""Quaternion helpers on batch-leading (..., 4) / (..., 3) tensors, torch
port of the parts of legged_gym_custom_tpu/physics/spatial.py the env uses.

Quaternions are (w, x, y, z), Hamilton convention, world <- body.  The
engine's component-major algebra lives in physics/soa.py; these are the
env-side helpers (base velocities in the body frame, roll/pitch/yaw).
"""
from __future__ import annotations

import math

import torch


def quat_conj(q):
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def quat_rotate(q, v):
    """Rotate v by q (body -> world when q is world<-body)."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * torch.cross(qv, v, dim=-1)
    return v + qw * t + torch.cross(qv, t, dim=-1)


def quat_rotate_inverse(q, v):
    """Rotate v by q^{-1} (world -> body)."""
    return quat_rotate(quat_conj(q), v)


def quat_to_rpy(q):
    """Roll/pitch/yaw (reference go2.py:11-31)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return roll, pitch, yaw


def wrap_to_pi(angles):
    """Wrap to [-pi, pi)."""
    return torch.remainder(angles + math.pi, 2 * math.pi) - math.pi


def quat_apply_yaw(q, v):
    """Rotate v by only the yaw component of q (reference utils/math.py:38-42)."""
    _, _, yaw = quat_to_rpy(q)
    c, s = torch.cos(yaw), torch.sin(yaw)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(torch.broadcast_tensors(c * x - s * y, s * x + c * y, z), dim=-1)
