"""Go2 task environment, torch port of legged_gym_custom_tpu/envs/go2_env.py.

Overrides the base observation layout with the Go2's 52-d proprio scheme
(go2.py:467-574): IMU roll/pitch instead of projected gravity and linear
velocity, plus gait phase features, and the parkour jump flags.  The
5-stream outputs (privileged 29 / estimated 3 / scan 132 / critic 736) come
from the base class.  Observations are recomputed from the post-reset
state, as in the JAX env.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.frozen.physics import spatial as sp
from .base_env import EnvState, LeggedEnv


class Go2Env(LeggedEnv):
    def _noise_scale_vec(self) -> np.ndarray:
        """Go2 noise vector (go2.py:110-129), aligned to the actual layout."""
        cfg = self.cfg
        n = np.zeros(cfg.env.num_proprio, np.float32)
        ns = cfg.noise.noise_scales
        lvl = cfg.noise.noise_level
        osc = cfg.normalization.obs_scales
        a = self.num_actions
        n[0:3] = ns.ang_vel * lvl * osc.ang_vel              # angular vel (3)
        n[3:5] = ns.imu * lvl                                 # roll, pitch (2)
        n[8:8 + a] = ns.dof_pos * lvl * osc.dof_pos           # dof pos (12)
        n[8 + a:8 + 2 * a] = ns.dof_vel * lvl * osc.dof_vel   # dof vel (12)
        return n

    def _proprio_obs(self, state: EnvState, derived) -> torch.Tensor:
        """Go2 52-d proprio (go2.py:506-515 + phase features :471-481)."""
        ph = state.physics
        roll, pitch, _ = sp.quat_to_rpy(ph.base_quat)
        phases = self._phases(state)  # [fl, fr, bl, br]
        two_pi = 2.0 * math.pi
        fl, fr, bl, br = phases[:, 0], phases[:, 1], phases[:, 2], phases[:, 3]
        phase_features = torch.stack([
            torch.sin(two_pi * fr), torch.cos(two_pi * fr),
            torch.sin(two_pi * fl), torch.cos(two_pi * fl),
            torch.sin(two_pi * bl), torch.cos(two_pi * bl),
            torch.sin(two_pi * br), torch.cos(two_pi * br),
        ], dim=-1)
        return torch.cat([
            derived["base_ang_vel"] * self.obs_scales.ang_vel,
            torch.stack([roll, pitch], dim=-1),
            state.commands[:, :3] * self.commands_scale,
            (ph.dof_pos - self.default_dof_pos) * self.obs_scales.dof_pos,
            ph.dof_vel * self.obs_scales.dof_vel,
            state.actions,
            phase_features,
        ], dim=-1)

    def _pre_obs_hook(self, state: EnvState) -> EnvState:
        """Jump flags from scandot outliers (go2.py:487-494): 8 or more
        scandots more than 0.1 m off the ground level."""
        if not getattr(self.cfg.terrain, "parkour", False):
            return state
        num_outliers = torch.sum(torch.abs(state.measured_heights) > 0.1, dim=1)
        return state.replace(jump_flags=(num_outliers >= 8).float())
