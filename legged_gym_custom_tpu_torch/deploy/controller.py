"""Backend-agnostic 50 Hz deploy controller (copy of
legged_gym_custom_tpu/deploy/controller.py, reference deploy/base/deploy_base.py).

Pure numpy: no torch at deploy time.  Replicates the reference
BaseController semantics step for step:
  * obs assembly identical to the training layout (deploy_base.py:224-234)
  * history ring buffer with first-step tiling (:237-242)
  * gait phase from wall-clock time (:187-199)
  * command smoothing EMA (:160-169)
  * gravity projection + quat->rpy (:6-25, 87-106)
  * fake scan replay state machine NORMAL -> WAITING -> REPLAY synced on the
    gait phase, fed from recorded SCAN_*.txt traces (:59-84, 110-143)
  * adaptation + estimator + scan encoder + policy -> target_dof_pos
    (:244-270)

The network runtime is the tiny numpy MLP/conv evaluator below, fed from the
exported .npz bundle (deploy/export.py).
"""
from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from .export import load_policy_bundle


def _elu(x):
    return np.where(x > 0, x, np.expm1(x))


class NumpyMLP:
    def __init__(self, layers: List[dict], final_activation: bool = False):
        self.layers = layers
        self.final_activation = final_activation

    def __call__(self, x):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = x @ layer["kernel"] + layer["bias"]
            if i < n - 1 or self.final_activation:
                x = _elu(x)
        return x


class NumpyAdaptationEncoder:
    """dense(P->30) + conv(30->20,k4,s2) + conv(20->10,k2,s1) + dense(30->20),
    all ELU (support_networks.py:129-175)."""

    def __init__(self, layers: List[dict]):
        dense = [l for l in layers if "kernel" in l]
        convs = [l for l in layers if "convkernel" in l]
        assert len(dense) == 2 and len(convs) == 2, (len(dense), len(convs))
        # first dense has the larger input (num_proprio)
        dense.sort(key=lambda l: -l["kernel"].shape[0])
        self.fc_in, self.fc_out = dense
        convs.sort(key=lambda l: -l["convkernel"].shape[0])  # k4 first
        self.conv1, self.conv2 = convs

    @staticmethod
    def _conv1d(x, kernel, bias, stride):
        # x: (T, C_in); kernel: (k, C_in, C_out) flax layout, VALID padding
        k = kernel.shape[0]
        T = (x.shape[0] - k) // stride + 1
        out = np.stack(
            [
                sum(x[t * stride + j] @ kernel[j] for j in range(k)) + bias
                for t in range(T)
            ]
        )
        return out

    def __call__(self, obs_history):
        # obs_history: (H, P)
        x = _elu(obs_history @ self.fc_in["kernel"] + self.fc_in["bias"])
        x = _elu(self._conv1d(x, self.conv1["convkernel"], self.conv1["bias"], 2))
        x = _elu(self._conv1d(x, self.conv2["convkernel"], self.conv2["bias"], 1))
        x = x.T.reshape(-1)  # channel-major flatten (torch Flatten parity)
        return _elu(x @ self.fc_out["kernel"] + self.fc_out["bias"])


def quaternion_to_euler(q):
    """wxyz quaternion -> (roll, pitch, yaw) (deploy_base.py:6-25)."""
    w, x, y, z = q
    roll = np.arctan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return roll, pitch, yaw


def get_gravity_orientation(q):
    """Unit gravity [0,0,-1] in the base frame (deploy_base.py:87-106)."""
    qw, qx, qy, qz = q
    return np.array(
        [
            2 * (-qz * qx + qw * qy),
            -2 * (qz * qy + qw * qx),
            1 - 2 * (qw * qw + qz * qz),
        ]
    )


def parse_scan_trace(path: str):
    """Parse a recorded SCAN_*.txt: first block = phase sync scalar, then
    132-float frames (deploy_base.py:67-84)."""
    with open(path) as f:
        text = f.read()
    blocks = re.split(r"\n\s*\n", text.strip())
    frames = []
    for blk in blocks:
        content = blk.strip().lstrip("[").rstrip("]")
        frames.append([float(x) for x in content.split()])
    sync = frames[0][0]
    return sync, frames[1:]


class BaseController:
    def __init__(self, cfg, bundle_path: str, scan_trace_path: Optional[str] = None):
        self.cfg = cfg
        bundle = load_policy_bundle(bundle_path)
        self.policy = NumpyMLP(bundle["policy"])
        self.estimator = NumpyMLP(bundle["estimator"])
        self.scan_encoder = NumpyMLP(bundle["scan_encoder"])
        self.adaptation = NumpyAdaptationEncoder(bundle["adaptation_module"])

        na = cfg.num_actions
        self.qj = np.zeros(na, np.float32)
        self.dqj = np.zeros(na, np.float32)
        self.ang_vel = np.zeros(3, np.float32)
        self.base_quat = np.array([1.0, 0, 0, 0], np.float32)
        self.actions = np.zeros(na, np.float32)
        self.target_dof_pos = np.asarray(cfg.default_angles, np.float32).copy()
        self.obs = np.zeros(cfg.num_obs, np.float32)
        self.obs_history = np.zeros((cfg.buffer_length, cfg.num_proprio), np.float32)
        self.cmd = np.zeros(3, np.float32)
        self.first_step_ever = True
        self.projected_gravity = np.array([0.0, 0.0, -1.0], np.float32)
        self.smoothed_cmd = np.zeros(3, np.float32)
        self.phase = 0.0

        # fake scan replay state machine (deploy_base.py:59-84)
        self.jump_button_pressed = False
        self.scan_idx = 0
        self.mode = "NORMAL"
        if scan_trace_path is not None:
            self.phase_sync_point, self.fake_scan_obs = parse_scan_trace(scan_trace_path)
        else:
            self.phase_sync_point, self.fake_scan_obs = -1.0, []

    # ------------------------------------------------------------------
    def _refresh_robot_states(self):
        raise NotImplementedError

    def get_smoothed_command(self, raw_cmd, smoothing_factor):
        self.smoothed_cmd = self.smoothed_cmd + smoothing_factor * (
            raw_cmd - self.smoothed_cmd
        )
        return self.smoothed_cmd

    def _get_scan_obs(self) -> np.ndarray:
        """Zeros, or fake-scan replay when armed (deploy_base.py:110-143)."""
        scan = np.zeros(self.cfg.num_scan_obs, np.float32)
        if self.jump_button_pressed and self.mode == "NORMAL" and self.fake_scan_obs:
            self.mode = "WAITING"
        if self.mode == "WAITING" and abs(self.phase - self.phase_sync_point) < 0.005:
            self.mode = "REPLAY"
        if self.mode == "REPLAY":
            scan = np.asarray(self.fake_scan_obs[self.scan_idx], np.float32)
            self.scan_idx += 1
            if self.scan_idx == len(self.fake_scan_obs) - 1:
                self.mode = "NORMAL"
                self.scan_idx = 0
        return scan

    def step(self, elapsed_time_s: float) -> np.ndarray:
        cfg = self.cfg
        self._refresh_robot_states()
        self.projected_gravity = get_gravity_orientation(self.base_quat)
        roll, pitch, yaw = quaternion_to_euler(self.base_quat)

        self.phase = (elapsed_time_s % cfg.period) / cfg.period
        phase_fr = (self.phase + cfg.fr_offset) % 1
        phase_bl = (self.phase + cfg.bl_offset) % 1
        phase_fl = (self.phase + cfg.fl_offset) % 1
        phase_br = (self.phase + cfg.br_offset) % 1
        if np.linalg.norm(self.cmd[:3]) < 0.2:
            phase_fr = phase_bl = phase_fl = phase_br = 0.0
        two_pi = 2 * np.pi
        phase_features = np.array(
            [
                np.sin(two_pi * phase_fr), np.cos(two_pi * phase_fr),
                np.sin(two_pi * phase_fl), np.cos(two_pi * phase_fl),
                np.sin(two_pi * phase_bl), np.cos(two_pi * phase_bl),
                np.sin(two_pi * phase_br), np.cos(two_pi * phase_br),
            ],
            np.float32,
        )

        pitch = pitch + cfg.pitch_offset * (np.pi / 180)
        roll = roll + cfg.roll_offset * (np.pi / 180)
        na = cfg.num_actions
        cur_obs = np.zeros(cfg.num_proprio, np.float32)
        cur_obs[:3] = self.ang_vel * cfg.ang_vel_scale
        cur_obs[3:5] = [roll, pitch]
        cur_obs[5:8] = self.cmd * cfg.cmd_scale * cfg.rc_scale
        cur_obs[8:8 + na] = (self.qj - cfg.default_angles) * cfg.dof_pos_scale
        cur_obs[8 + na:8 + 2 * na] = self.dqj * cfg.dof_vel_scale
        cur_obs[8 + 2 * na:8 + 3 * na] = self.actions
        cur_obs[8 + 3 * na:8 + 3 * na + 8] = phase_features

        self.obs[:] = np.concatenate([self.obs_history.flatten(), cur_obs])
        if self.first_step_ever:
            self.first_step_ever = False
            self.obs_history = np.tile(cur_obs, (cfg.buffer_length, 1))
        else:
            self.obs_history = np.roll(self.obs_history, -1, axis=0)
            self.obs_history[-1] = cur_obs

        obs = np.clip(self.obs, -cfg.clip_obs, cfg.clip_obs)
        hist = obs[: cfg.buffer_length * cfg.num_proprio].reshape(
            cfg.buffer_length, cfg.num_proprio
        )
        priv_latent = self.adaptation(hist)
        estimated = self.estimator(obs)
        scan_latent = self.scan_encoder(self._get_scan_obs())
        actor_input = np.concatenate([obs, priv_latent, scan_latent, estimated])
        self.actions = np.clip(
            self.policy(actor_input), -cfg.clip_actions, cfg.clip_actions
        ).astype(np.float32)
        self.target_dof_pos = self.actions * cfg.action_scale + cfg.default_angles
        return self.target_dof_pos
