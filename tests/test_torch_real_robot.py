"""Mock-DDS tests of the port's real-robot client (deploy/real_robot.py).

The cases of tests/test_real_robot.py on the port's module, over the same
fake in-process `unitree_sdk2py` (imported from that file): remote parsing,
the command helpers, the Isaac L-R <-> Unitree R-L motor remap with CRC
stamping, sleep mode and move-to-default, each against golden vectors; the
module imports without the SDK and raises at construction; and three 50 Hz
ticks of the port's controller and of the JAX package's on the same bundle
and LowState publish the same commands.
"""
import struct
import sys

import numpy as np
import pytest
import torch

from legged_gym_custom_tpu.deploy import real_robot as jreal_robot
from legged_gym_custom_tpu_torch.deploy import export_policy_bundle
from legged_gym_custom_tpu_torch.deploy import real_robot as treal_robot
from legged_gym_custom_tpu_torch.deploy.real_robot import (RemoteController, create_damping_cmd,
                                                           create_zero_cmd, init_cmd_go)
from legged_gym_custom_tpu_torch.envs.go2_config import Go2CfgPPO
from legged_gym_custom_tpu_torch.models.networks import ActorCriticNetworks
from test_real_robot import (NUM_MOTORS, REMAP, _Cfg, _FakeBus, _FakeCRC, _install_fake_sdk,
                             _LowCmd, _LowState)


@pytest.fixture
def bundle(tmp_path):
    nets = ActorCriticNetworks(
        Go2CfgPPO.policy, num_proprio=52, num_privileged_obs=29, num_critic_obs=736,
        num_estimated_obs=3, num_scan_obs=132, num_actions=12, history_buffer_length=10,
        generator=torch.Generator().manual_seed(3))
    return export_policy_bundle(nets, str(tmp_path / "bundle"))


@pytest.fixture
def controller(monkeypatch, bundle):
    """The port's RobotController over the fake SDK."""
    bus = _FakeBus()
    _install_fake_sdk(monkeypatch, bus)
    rc = treal_robot.RobotController(_Cfg(), bundle, net_interface="eth0")
    return rc, bus


def test_imports_without_sdk_and_raises_at_construction(monkeypatch, bundle):
    monkeypatch.setitem(sys.modules, "unitree_sdk2py", None)
    with pytest.raises(ImportError, match="unitree_sdk2py is required"):
        treal_robot.RobotController(_Cfg(), bundle, net_interface="eth0")


def test_remote_controller_parsing():
    """Button bits + stick floats from the wireless byte layout
    (reference remote_controller.py:23-39)."""
    r = RemoteController()
    keys = (1 << RemoteController.KEY["A"]) | (1 << RemoteController.KEY["select"])
    data = bytearray(40)
    data[2:4] = struct.pack("H", keys)
    data[4:8] = struct.pack("f", 0.25)     # lx
    data[8:12] = struct.pack("f", -0.5)    # rx
    data[12:16] = struct.pack("f", 0.75)   # ry
    data[20:24] = struct.pack("f", 1.0)    # ly
    r.set(bytes(data))
    assert r.button[RemoteController.KEY["A"]] == 1
    assert r.button[RemoteController.KEY["select"]] == 1
    assert r.button[RemoteController.KEY["start"]] == 0
    assert (r.lx, r.rx, r.ry, r.ly) == (0.25, -0.5, 0.75, 1.0)
    assert RemoteController.KEY == jreal_robot.RemoteController.KEY


def test_command_helpers():
    """Golden values for damping / zero / init commands
    (reference command_helper.py:10-62)."""
    cmd = _LowCmd()
    init_cmd_go(cmd)
    assert cmd.head == [0xFE, 0xEF] and cmd.level_flag == 0xFF
    assert all(mc.mode == 0x01 for mc in cmd.motor_cmd)
    assert cmd.motor_cmd[0].q == pytest.approx(2.146e9)
    assert cmd.motor_cmd[0].qd == pytest.approx(16000.0)

    create_damping_cmd(cmd)
    assert all(mc.kd == 8.0 and mc.kp == 0.0 and mc.q == 0.0 for mc in cmd.motor_cmd)

    create_zero_cmd(cmd)
    assert all(
        mc.kd == 0.0 and mc.kp == 0.0 and mc.q == 0.0 and mc.tau == 0.0
        for mc in cmd.motor_cmd
    )


def test_run_once_motor_remap_and_crc(controller, monkeypatch):
    """Policy targets land at the remapped Unitree motor indices with the
    config's gains, and every published command is CRC-stamped
    (reference deploy_real.py:193-204)."""
    rc, bus = controller
    target = np.arange(12, dtype=np.float32) * 0.1
    monkeypatch.setattr(type(rc), "step", lambda self, t: target, raising=False)

    ls = _LowState()
    for k, j in enumerate(REMAP):
        ls.motor_state[j].q = float(_Cfg.default_angles[k])
    bus.subscriber_cb(ls)
    assert rc.low_state is ls

    rc.run_once()
    assert len(bus.published) == 1
    cmd = bus.published[0]
    for k, j in enumerate(REMAP):
        assert cmd.motor_cmd[j].q == pytest.approx(target[k])
        assert cmd.motor_cmd[j].kp == pytest.approx(40.0)
        assert cmd.motor_cmd[j].kd == pytest.approx(1.0)
        assert cmd.motor_cmd[j].tau == 0.0
    for j in set(range(NUM_MOTORS)) - set(REMAP):
        assert cmd.motor_cmd[j].q == pytest.approx(2.146e9)
    assert cmd.crc == _FakeCRC().Crc(cmd)


def test_sleep_mode_on_flip_and_select(controller):
    """Upside-down or select button -> damping command, policy bypassed
    (reference deploy_real.py:236-259)."""
    rc, bus = controller

    ls = _LowState()
    ls.imu_state.rpy = [1.8, 0.0, 0.0]  # flipped
    bus.subscriber_cb(ls)
    rc.run_once()
    cmd = bus.published[-1]
    assert all(mc.kd == 8.0 and mc.kp == 0.0 for mc in cmd.motor_cmd)
    assert not rc.sleep_mode  # the flip guard alone does not latch

    ls2 = _LowState()
    data = bytearray(40)
    data[2:4] = struct.pack("H", 1 << RemoteController.KEY["select"])
    ls2.wireless_remote = bytes(data)
    bus.subscriber_cb(ls2)
    rc.run_once()
    assert rc.sleep_mode
    assert all(mc.kd == 8.0 and mc.kp == 0.0 for mc in bus.published[-1].motor_cmd)

    bus.subscriber_cb(_LowState())      # still latched after the buttons are released
    rc.run_once()
    assert rc.sleep_mode
    assert all(mc.kd == 8.0 for mc in bus.published[-1].motor_cmd)


def test_move_to_default_lerp(controller, monkeypatch):
    """2 s interpolation from measured to default angles
    (reference deploy_real.py:134-164)."""
    rc, bus = controller
    monkeypatch.setattr("time.sleep", lambda s: None)
    ls = _LowState()
    for j in range(NUM_MOTORS):
        ls.motor_state[j].q = 0.0
    bus.subscriber_cb(ls)
    bus.published.clear()
    rc.move_to_default_pos(duration_s=rc.control_dt * 4)  # 4 steps
    assert len(bus.published) == 4
    first, last = bus.published[0], bus.published[-1]
    for k, j in enumerate(REMAP):
        assert first.motor_cmd[j].q == pytest.approx(0.0, abs=1e-6)  # alpha = 0
        assert last.motor_cmd[j].q == pytest.approx(0.75 * _Cfg.default_angles[k], abs=1e-6)


def test_policy_tick_matches_reference(monkeypatch, bundle):
    """Three policy ticks of both controllers from one LowState (joints off
    the default pose, a tilted IMU, a stick command): the published commands
    are equal field for field."""
    published = []
    for module in (treal_robot, jreal_robot):
        bus = _FakeBus()
        _install_fake_sdk(monkeypatch, bus)
        rc = module.RobotController(_Cfg(), bundle, net_interface="eth0")
        ls = _LowState()
        for k, j in enumerate(REMAP):
            ls.motor_state[j].q = float(_Cfg.default_angles[k]) + 0.05 * (k - 6)
            ls.motor_state[j].dq = 0.1 * k
        ls.imu_state.quaternion = [0.995, 0.05, -0.08, 0.0]
        ls.imu_state.gyroscope = [0.1, -0.2, 0.3]
        data = bytearray(40)
        data[20:24] = struct.pack("f", 0.5)    # ly: forward
        ls.wireless_remote = bytes(data)
        bus.subscriber_cb(ls)
        rc.t0, clock = 0.0, [0.0]            # the gait phase's clock
        monkeypatch.setattr(module.time, "time", lambda: clock[0])
        for k in range(3):
            clock[0] = 0.02 * k
            rc.run_once()
        monkeypatch.undo()
        published.append([[(mc.q, mc.kp, mc.kd, mc.tau) for mc in c.motor_cmd] + [c.crc]
                          for c in bus.published])
    assert len(published[0]) == 3 and published[0] == published[1]
    assert published[0][0][REMAP[0]][0] != pytest.approx(_Cfg.default_angles[0])
