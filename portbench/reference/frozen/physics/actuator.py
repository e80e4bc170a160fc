"""Actuation models, torch port of legged_gym_custom_tpu/physics/actuator.py:
PD control (`PDParams`, `compute_torques`) and the ANYmal SEA actuator
network (`LSTMWeights`, `lstm_cell`, `lstm_actuator`).

PD semantics of reference legged_robot.py:440-478: position ('P') or direct
torque ('T') control, per-env kp/kd multipliers, clipping to the URDF effort
limits.  Velocity control ('V') needs `last_dof_vel` and `dt`; it runs on the
eager path only, the fused kernel has no 'V' variant.

The SEA network (reference anymal.py:62-80) is a per-dof 2-layer LSTM of
hidden size 8 over [position error, velocity] with a linear torque head,
written as plain tensor ops on the component-major layout (ndof, ...)+bs with
explicit (hidden, cell) state; its weights come from the TorchScript
checkpoint through models/actuator_net.py.
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


# --------------------------------------------------------------------------
# SEA actuator network (ANYmal): 2-layer LSTM, hidden 8, per dof
# --------------------------------------------------------------------------


class LSTMWeights(NamedTuple):
    w_ih: tuple   # per layer: (4 * hidden, in)
    w_hh: tuple   # per layer: (4 * hidden, hidden)
    b_ih: tuple
    b_hh: tuple
    w_out: torch.Tensor
    b_out: torch.Tensor
    in_scale: torch.Tensor = 1.0   # input normalization (anydrive_v3_lstm)
    out_scale: torch.Tensor = 1.0  # torque output scaling


def lstm_cell(x, h_prev, c_prev, w_ih, w_hh, b_ih, b_hh, bs):
    """Torch-convention LSTM cell (gate order i, f, g, o) on the SoA layout:
    x (ndof, in)+bs, h/c (ndof, hidden)+bs; weights in plain torch shapes."""
    gates = (torch.einsum("nd...,gd->ng...", x, w_ih)
             + torch.einsum("nh...,gh->ng...", h_prev, w_hh)
             + _bcast(b_ih + b_hh, bs)[None])
    i, f, g, o = torch.chunk(gates, 4, dim=1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def lstm_actuator(weights: LSTMWeights, pos_err, dof_vel, hidden, cell):
    """One step of the per-dof SEA LSTM: pos_err / dof_vel (ndof,)+bs,
    hidden / cell (layers, ndof, hidden)+bs.  Returns (torques, hidden', cell')."""
    bs = tuple(pos_err.shape[1:])
    in_scale = torch.as_tensor(weights.in_scale, dtype=pos_err.dtype,
                               device=pos_err.device).reshape(-1)
    x = torch.stack([pos_err, dof_vel], dim=1) * _bcast(in_scale, bs)   # (ndof, 2)+bs
    new_h, new_c = [], []
    for l in range(len(weights.w_ih)):
        h, c = lstm_cell(x, hidden[l], cell[l], weights.w_ih[l], weights.w_hh[l],
                         weights.b_ih[l], weights.b_hh[l], bs)
        new_h.append(h)
        new_c.append(c)
        x = h
    b_out = torch.as_tensor(weights.b_out, dtype=x.dtype, device=x.device).reshape(())
    torques = (torch.einsum("nh...,oh->no...", x, weights.w_out)[:, 0] + b_out) \
        * weights.out_scale
    return torques, torch.stack(new_h), torch.stack(new_c)
