"""Unitree G1 humanoid environment, torch port of
legged_gym_custom_tpu/envs/g1_env.py (reference "g1 (broken)/g1_env_broken.py",
made functional as the JAX package does).

The 47-d observation (ang_vel 3 + gravity 3 + cmd 3 + dof 12 + dof_vel 12 +
actions 12 + sin/cos phase 2, g1_env_broken.py:70-93), the biped walk phase
(period 0.8, offset 0.5, :57-62) and the G1 reward set, wired into the
5-stream machinery like every other task.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base_env import EnvState, LeggedEnv


class G1Env(LeggedEnv):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # G1's hip_pos penalizes roll and pitch only (g1_env_broken.py:124)
        ids = self.model.dof_ids_matching(["hip_roll", "hip_pitch"])
        self.hip_joint_ids = ids
        self.reward_statics = self.reward_statics._replace(hip_joint_ids=ids)

    def _phases(self, state: EnvState) -> torch.Tensor:
        """Biped leg phases [left, right] (g1_env_broken.py:57-62), with no
        zero-command masking."""
        period = getattr(self.cfg.env, "period", 0.8)
        offset = 0.5
        phase = torch.remainder(state.episode_length.float() * self.dt, period) / period
        return torch.stack([phase, torch.remainder(phase + offset, 1.0)], dim=-1)

    def _noise_scale_vec(self) -> np.ndarray:
        cfg = self.cfg
        n = np.zeros(cfg.env.num_proprio, np.float32)
        ns = cfg.noise.noise_scales
        lvl = cfg.noise.noise_level
        osc = cfg.normalization.obs_scales
        a = self.num_actions
        n[0:3] = ns.ang_vel * lvl * osc.ang_vel
        n[3:6] = ns.gravity * lvl
        n[9:9 + a] = ns.dof_pos * lvl * osc.dof_pos
        n[9 + a:9 + 2 * a] = ns.dof_vel * lvl * osc.dof_vel
        return n   # commands, actions and the phase carry no noise

    def _proprio_obs(self, state: EnvState, derived) -> torch.Tensor:
        ph = state.physics
        phase = self._phases(state)[:, 0]
        two_pi = 2.0 * math.pi
        return torch.cat([
            derived["base_ang_vel"] * self.obs_scales.ang_vel,
            derived["projected_gravity"],
            state.commands[:, :3] * self.commands_scale,
            (ph.dof_pos - self.default_dof_pos) * self.obs_scales.dof_pos,
            ph.dof_vel * self.obs_scales.dof_vel,
            state.actions,
            torch.sin(two_pi * phase)[:, None],
            torch.cos(two_pi * phase)[:, None],
        ], dim=-1)
