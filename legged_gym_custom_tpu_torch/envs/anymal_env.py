"""ANYmal-C environment with the SEA actuator network, torch port of
legged_gym_custom_tpu/envs/anymal_env.py (reference
legged_gym/envs/anymal_c/anymal.py).

The PD law is replaced by a per-dof 2-layer LSTM actuator model (hidden 8,
input [position error, velocity], anymal.py:71-80) whose hidden and cell
states live in `EnvState.actuator_state`, (B, 2, ndof, 8) each, and are
zeroed on reset (anymal.py:55-58).  On the card every decimation tick runs
the LSTM in plain PyTorch and that tick's substeps as one launch of the
kernel's one-tick 'T' variant (physics.actuated_control_step).
"""
from __future__ import annotations

import torch

from legged_gym_custom_tpu_torch.models.actuator_net import load_actuator_net
from legged_gym_custom_tpu_torch.physics.actuator import lstm_actuator
from .base_env import LeggedEnv


def sea_torque_fn(weights, action_scale: float, default):
    """The SEA network `weights` (`LSTMWeights`) as the engine's torque
    function: the position error of the scaled actions about `default`
    (ndof, 1), and the velocity, through the LSTM."""
    def torque_fn(actions, dof_pos, dof_vel, act_state):
        # (C, B) layout: dof tensors (ndof, B), the state (2, ndof, 8, B)
        hidden, cell = act_state
        pos_err = actions * action_scale + default - dof_pos
        tau, hidden, cell = lstm_actuator(weights, pos_err, dof_vel, hidden, cell)
        return tau, (hidden, cell)

    return torque_fn


class AnymalEnv(LeggedEnv):
    def _build_torque_fn(self):
        cfg = self.cfg.control
        if not getattr(cfg, "use_actuator_network", False):
            return None
        return sea_torque_fn(load_actuator_net(cfg.actuator_net_file, device=self.device),
                             cfg.action_scale, self.default_dof_pos[:, None])

    def _init_actuator_state(self):
        if self._torque_fn is None:
            return super()._init_actuator_state()
        zeros = lambda: torch.zeros((self.num_envs, 2, self.num_actions, 8), device=self.device)
        return zeros(), zeros()   # (layers, ndof, hidden) per env: hidden, cell
