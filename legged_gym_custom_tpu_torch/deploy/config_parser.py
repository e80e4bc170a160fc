"""Deploy YAML config (copy of legged_gym_custom_tpu/deploy/config_parser.py,
reference deploy/base/config_parser.py:5-81).

Same field set + `*model` path substitution so the reference's
deploy/configs/go2.yaml works unchanged; `{LEGGED_GYM_ROOT_DIR}` expands to
`root_dir` (the entry points pass LEGGED_GYM_TORCH_ROOT_DIR, the repo root).
`yaml` is imported when a config is read, not with the module: the package
imports without it.
"""
from __future__ import annotations

import numpy as np


class ConfigParser:
    def __init__(self, path: str, root_dir: str = ""):
        import yaml

        with open(path) as f:
            cfg = yaml.safe_load(f)
        model = cfg.get("model_name", "")

        def sub(p):
            if p is None:
                return None
            return p.replace("*model", model).replace("{LEGGED_GYM_ROOT_DIR}", root_dir)

        self.model_name = model
        self.policy_path = sub(cfg.get("policy_path"))
        self.adaptation_path = sub(cfg.get("adaptation_path"))
        self.estimator_path = sub(cfg.get("estimator_path"))
        self.scan_encoder_path = sub(cfg.get("scan_encoder_path"))
        self.bundle_path = sub(cfg.get("bundle_path"))
        self.xml_path = sub(cfg.get("xml_path"))

        self.num_actions = cfg["num_actions"]
        self.num_proprio = cfg["num_proprio"]
        self.buffer_length = cfg["buffer_length"]
        self.num_scan_obs = cfg.get("num_scan_obs", 0)
        self.num_obs = self.num_proprio * (1 + self.buffer_length)

        self.period = cfg["period"]
        self.fr_offset = cfg["fr_offset"]
        self.bl_offset = cfg["bl_offset"]
        self.fl_offset = cfg["fl_offset"]
        self.br_offset = cfg["br_offset"]

        self.msg_type = cfg.get("msg_type", "go")
        self.lowcmd_topic = cfg.get("lowcmd_topic", "rt/lowcmd")
        self.lowstate_topic = cfg.get("lowstate_topic", "rt/lowstate")

        self.simulation_dt = cfg["simulation_dt"]
        self.control_decimation = cfg["control_decimation"]

        self.leg_joint2motor_idx = np.asarray(cfg["leg_joint2motor_idx"], np.int32)
        self.kps = np.asarray(cfg["kps"], np.float32)
        self.kds = np.asarray(cfg["kds"], np.float32)
        self.default_angles = np.asarray(cfg["default_angles"], np.float32)

        self.pitch_offset = cfg.get("pitch_offset", 0.0)
        self.roll_offset = cfg.get("roll_offset", 0.0)

        self.lin_vel_scale = cfg["lin_vel_scale"]
        self.ang_vel_scale = cfg["ang_vel_scale"]
        self.dof_pos_scale = cfg["dof_pos_scale"]
        self.dof_vel_scale = cfg["dof_vel_scale"]
        self.action_scale = cfg["action_scale"]
        self.cmd_scale = np.array(
            [self.lin_vel_scale, self.lin_vel_scale, self.ang_vel_scale], np.float32
        )

        self.clip_obs = cfg["clip_observations"]
        self.clip_actions = cfg["clip_actions"]
        self.rc_scale = np.asarray(cfg.get("rc_scale", [1.0, 1.0, 1.0]), np.float32)
