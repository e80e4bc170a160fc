"""Real Unitree Go2 driver (copy of legged_gym_custom_tpu/deploy/real_robot.py,
reference deploy/deploy_real/deploy_real.py:28-291).

Thin host-side client over unitree_sdk2py / CycloneDDS: DDS pub/sub on
rt/lowcmd / rt/lowstate, sport-mode release, zero-torque -> move-to-default
(2 s lerp) -> wait-for-A -> 50 Hz run loop with sleep-mode guard (upside-down
or select button -> damping command), CRC-stamped LowCmd, and the Isaac
L-R <-> Unitree R-L motor remap via cfg.leg_joint2motor_idx
(deploy/configs/go2.yaml:39-44).

Importable without the SDK; `RobotController` raises at construction if
unitree_sdk2py is unavailable.
"""
from __future__ import annotations

import struct
import time

import numpy as np

from .config_parser import ConfigParser
from .controller import BaseController


class RemoteController:
    """Wireless remote parsing (reference remote_controller.py:23-39)."""

    KEY = {
        "R1": 0, "L1": 1, "start": 2, "select": 3, "R2": 4, "L2": 5,
        "F1": 6, "F2": 7, "A": 8, "B": 9, "X": 10, "Y": 11,
        "up": 12, "right": 13, "down": 14, "left": 15,
    }

    def __init__(self):
        self.lx = self.ly = self.rx = self.ry = 0.0
        self.button = [0] * 16

    def set(self, data: bytes):
        keys = struct.unpack("H", data[2:4])[0]
        for i in range(16):
            self.button[i] = (keys & (1 << i)) >> i
        self.lx = struct.unpack("f", data[4:8])[0]
        self.rx = struct.unpack("f", data[8:12])[0]
        self.ry = struct.unpack("f", data[12:16])[0]
        self.ly = struct.unpack("f", data[20:24])[0]


def _require_sdk():
    try:
        import unitree_sdk2py  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "unitree_sdk2py is required for real-robot deployment "
            "(see reference deploy/README.md for installation)"
        ) from e


def create_damping_cmd(cmd):
    """kd=8 damping command (reference command_helper.py:10-20)."""
    size = len(cmd.motor_cmd)
    for i in range(size):
        cmd.motor_cmd[i].q = 0.0
        cmd.motor_cmd[i].qd = 0.0
        cmd.motor_cmd[i].kp = 0.0
        cmd.motor_cmd[i].kd = 8.0
        cmd.motor_cmd[i].tau = 0.0
    return cmd


def create_zero_cmd(cmd):
    """Zero-torque command (reference command_helper.py:22-30)."""
    size = len(cmd.motor_cmd)
    for i in range(size):
        cmd.motor_cmd[i].q = 0.0
        cmd.motor_cmd[i].qd = 0.0
        cmd.motor_cmd[i].kp = 0.0
        cmd.motor_cmd[i].kd = 0.0
        cmd.motor_cmd[i].tau = 0.0
    return cmd


def init_cmd_go(cmd, weak_motor=None):
    """LowCmd init for the 'go' protocol (reference command_helper.py:33-62)."""
    cmd.head[0] = 0xFE
    cmd.head[1] = 0xEF
    cmd.level_flag = 0xFF
    cmd.gpio = 0
    PosStopF = 2.146e9
    VelStopF = 16000.0
    for i in range(len(cmd.motor_cmd)):
        cmd.motor_cmd[i].mode = 0x01
        cmd.motor_cmd[i].q = PosStopF
        cmd.motor_cmd[i].qd = VelStopF
        cmd.motor_cmd[i].kp = 0.0
        cmd.motor_cmd[i].kd = 0.0
        cmd.motor_cmd[i].tau = 0.0
    return cmd


class RobotController(BaseController):
    """50 Hz real-robot loop (reference deploy_real.py:28-291)."""

    def __init__(self, cfg: ConfigParser, bundle_path: str, net_interface: str,
                 scan_trace_path=None):
        _require_sdk()
        super().__init__(cfg, bundle_path, scan_trace_path)
        from unitree_sdk2py.core.channel import (
            ChannelFactoryInitialize,
            ChannelPublisher,
            ChannelSubscriber,
        )
        from unitree_sdk2py.idl.default import unitree_go_msg_dds__LowCmd_
        from unitree_sdk2py.idl.default import unitree_go_msg_dds__LowState_
        from unitree_sdk2py.idl.unitree_go.msg.dds_ import LowCmd_ as LowCmdGo
        from unitree_sdk2py.idl.unitree_go.msg.dds_ import LowState_ as LowStateGo
        from unitree_sdk2py.utils.crc import CRC

        ChannelFactoryInitialize(0, net_interface)
        self.remote = RemoteController()
        self.crc = CRC()
        self.low_cmd = unitree_go_msg_dds__LowCmd_()
        self.low_state = unitree_go_msg_dds__LowState_()
        init_cmd_go(self.low_cmd)

        self.pub = ChannelPublisher(cfg.lowcmd_topic, LowCmdGo)
        self.pub.Init()
        self.sub = ChannelSubscriber(cfg.lowstate_topic, LowStateGo)
        self.sub.Init(self._on_low_state, 10)

        self._disable_sport_mode()
        self.control_dt = cfg.simulation_dt * cfg.control_decimation
        self.t0 = time.time()
        self.sleep_mode = False

    # ------------------------------------------------------------------
    def _on_low_state(self, msg):
        self.low_state = msg
        self.remote.set(bytes(msg.wireless_remote))

    def _disable_sport_mode(self):
        """Stand down + release sport mode (reference deploy_real.py:46-66)."""
        from unitree_sdk2py.go2.sport.sport_client import SportClient
        from unitree_sdk2py.comm.motion_switcher.motion_switcher_client import (
            MotionSwitcherClient,
        )

        sc = SportClient()
        sc.SetTimeout(5.0)
        sc.Init()
        msc = MotionSwitcherClient()
        msc.SetTimeout(5.0)
        msc.Init()
        sc.StandDown()
        status, result = msc.CheckMode()
        while result.get("name"):
            sc.StandDown()
            msc.ReleaseMode()
            status, result = msc.CheckMode()
            time.sleep(1)

    def _send_cmd(self, cmd):
        cmd.crc = self.crc.Crc(cmd)
        self.pub.Write(cmd)

    # ------------------------------------------------------------------
    def _refresh_robot_states(self):
        m = self.cfg.leg_joint2motor_idx
        ms = self.low_state.motor_state
        self.qj = np.array([ms[j].q for j in m], np.float32)
        self.dqj = np.array([ms[j].dq for j in m], np.float32)
        imu = self.low_state.imu_state
        self.base_quat = np.asarray(imu.quaternion, np.float32)  # wxyz
        self.ang_vel = np.asarray(imu.gyroscope, np.float32)
        self.cmd = self.get_smoothed_command(
            np.array([self.remote.ly, -self.remote.lx, -self.remote.rx], np.float32),
            0.1,
        )
        self.jump_button_pressed = bool(self.remote.button[RemoteController.KEY["R1"]])

    # ------------------------------------------------------------------
    def zero_torque_state(self):
        """Wait for start button under zero torque (deploy_real.py:126-133)."""
        print("Enter zero-torque state. Press start to continue...")
        while not self.remote.button[RemoteController.KEY["start"]]:
            create_zero_cmd(self.low_cmd)
            self._send_cmd(self.low_cmd)
            time.sleep(self.control_dt)

    def move_to_default_pos(self, duration_s: float = 2.0):
        """2 s lerp to default angles (deploy_real.py:134-164)."""
        m = self.cfg.leg_joint2motor_idx
        num_step = int(duration_s / self.control_dt)
        init_q = np.array(
            [self.low_state.motor_state[j].q for j in m], np.float32
        )
        for i in range(num_step):
            alpha = i / num_step
            for k, j in enumerate(m):
                mc = self.low_cmd.motor_cmd[j]
                mc.q = float(init_q[k] * (1 - alpha) + self.cfg.default_angles[k] * alpha)
                mc.qd = 0.0
                mc.kp = float(self.cfg.kps[k])
                mc.kd = float(self.cfg.kds[k])
                mc.tau = 0.0
            self._send_cmd(self.low_cmd)
            time.sleep(self.control_dt)

    def default_pos_state(self):
        """Hold default pose until A pressed (deploy_real.py:166-179)."""
        print("Holding default pose. Press A to run the policy...")
        m = self.cfg.leg_joint2motor_idx
        while not self.remote.button[RemoteController.KEY["A"]]:
            for k, j in enumerate(m):
                mc = self.low_cmd.motor_cmd[j]
                mc.q = float(self.cfg.default_angles[k])
                mc.qd = 0.0
                mc.kp = float(self.cfg.kps[k])
                mc.kd = float(self.cfg.kds[k])
                mc.tau = 0.0
            self._send_cmd(self.low_cmd)
            time.sleep(self.control_dt)

    def run_once(self):
        """One 50 Hz control tick with safety guards (deploy_real.py:236-272)."""
        upside_down = self.low_state.imu_state.rpy[0] > 1.5 or \
            self.low_state.imu_state.rpy[0] < -1.5
        if self.remote.button[RemoteController.KEY["select"]]:
            self.sleep_mode = True
        if self.sleep_mode or upside_down:
            create_damping_cmd(self.low_cmd)
            self._send_cmd(self.low_cmd)
            return
        target = self.step(time.time() - self.t0)
        m = self.cfg.leg_joint2motor_idx
        for k, j in enumerate(m):
            mc = self.low_cmd.motor_cmd[j]
            mc.q = float(target[k])
            mc.qd = 0.0
            mc.kp = float(self.cfg.kps[k])
            mc.kd = float(self.cfg.kds[k])
            mc.tau = 0.0
        self._send_cmd(self.low_cmd)

    def main_loop(self):
        self.zero_torque_state()
        self.move_to_default_pos()
        self.default_pos_state()
        self.t0 = time.time()
        while True:
            t = time.time()
            self.run_once()
            leftover = self.control_dt - (time.time() - t)
            if leftover > 0:
                time.sleep(leftover)


def main():
    import argparse

    p = argparse.ArgumentParser("deploy_real")
    p.add_argument("net_interface")
    p.add_argument("--config", required=True)
    p.add_argument("--bundle", required=True)
    p.add_argument("--scan_trace", default=None)
    args = p.parse_args()
    from legged_gym_custom_tpu_torch import LEGGED_GYM_TORCH_ROOT_DIR

    cfg = ConfigParser(args.config, root_dir=LEGGED_GYM_TORCH_ROOT_DIR)
    rc = RobotController(cfg, args.bundle, args.net_interface, args.scan_trace)
    rc.main_loop()


if __name__ == "__main__":
    main()
