"""The port's deploy stack on the CPU, against the JAX package's.

  * `ConfigParser`: every field of each deploy_configs/*.yaml equals JAX's
    (arrays exactly);
  * `mujoco_runner.run`: the JAX runner and the port's, on one bundle and one
    scene (the synthetic Go2 of `scene_gen.write_robot_scene`: to_mjcf with
    contact, motors, feet named FL/FR/RL/RR), give the same qpos, ctrl and
    target trajectories over 2 s of sim to 1e-9, on the committed JAX-trained
    trained/go2_tpu_r4 bundle and on a bundle the port exported;
  * `native`: `write_flat_bundle` is byte-equal to JAX's; the C++ runtime
    built into build/native/ and the torch networks that exported the bundle
    give the numpy runtime's actions to 1e-5; a source that does not compile
    raises with the compiler's stderr;
  * `import_torchscript`: both converters give equal bundles from TorchScript
    modules of the reference's shapes, and the numpy runtime on the bundle
    gives the TorchScript forward to 1e-5;
  * `gamepad`: the stub (no `inputs` package) gives zero commands, and the
    event handler's deadzone and e-stop latch equal JAX's.
"""
import glob
import os
import shutil
import types

import numpy as np
import pytest
import torch
from torch import nn

from legged_gym_custom_tpu.deploy import config_parser as jconfig
from legged_gym_custom_tpu.deploy import gamepad as jgamepad
from legged_gym_custom_tpu.deploy import import_torchscript as jimport
from legged_gym_custom_tpu.deploy import mujoco_runner as jrunner
from legged_gym_custom_tpu.deploy import native as jnative
from legged_gym_custom_tpu_torch import LEGGED_GYM_TORCH_ROOT_DIR
from legged_gym_custom_tpu_torch.deploy import (ConfigParser, NumpyAdaptationEncoder, NumpyMLP,
                                                export_policy_bundle, load_policy_bundle)
from legged_gym_custom_tpu_torch.deploy import gamepad as tgamepad
from legged_gym_custom_tpu_torch.deploy import import_torchscript as timport
from legged_gym_custom_tpu_torch.deploy import mujoco_runner as trunner
from legged_gym_custom_tpu_torch.deploy import native as tnative
from legged_gym_custom_tpu_torch.deploy import scene_gen
from legged_gym_custom_tpu_torch.envs.go2_config import Go2CfgPPO
from legged_gym_custom_tpu_torch.models.networks import ActorCriticNetworks

ROOT = LEGGED_GYM_TORCH_ROOT_DIR
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "deploy_configs", "*.yaml")))
R4_BUNDLE = os.path.join(ROOT, "trained", "go2_tpu_r4", "policy_bundle.npz")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_nets():
    """Seeded go2-shaped networks of the port."""
    return ActorCriticNetworks(
        Go2CfgPPO.policy, num_proprio=52, num_privileged_obs=29, num_critic_obs=736,
        num_estimated_obs=3, num_scan_obs=132, num_actions=12, history_buffer_length=10,
        generator=torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def port_bundle(port_nets, tmp_path_factory):
    """The bundle the port exports from `port_nets`."""
    return export_policy_bundle(port_nets, str(tmp_path_factory.mktemp("bundle")))


def _numpy_policy(bundle_path):
    """The numpy runtime on a bundle: (obs 572, scan 132) -> actions 12."""
    b = load_policy_bundle(bundle_path)
    policy, estimator = NumpyMLP(b["policy"]), NumpyMLP(b["estimator"])
    scan_enc, adapt = NumpyMLP(b["scan_encoder"]), NumpyAdaptationEncoder(b["adaptation_module"])
    return lambda obs, scan: policy(np.concatenate(
        [obs, adapt(obs[:520].reshape(10, 52)), scan_enc(scan), estimator(obs)]))


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_config_parser_matches_reference(path):
    ref = jconfig.ConfigParser(path, root_dir=ROOT)
    got = ConfigParser(path, root_dir=ROOT)
    assert vars(got).keys() == vars(ref).keys()
    for key, want in vars(ref).items():
        have = getattr(got, key)
        if isinstance(want, np.ndarray):
            assert have.dtype == want.dtype and np.array_equal(have, want), key
        else:
            assert type(have) is type(want) and have == want, key
    assert got.bundle_path is None or got.bundle_path.startswith(ROOT + "/")


def test_runner_trajectories_match_reference(tmp_path, port_bundle):
    """One scene, one config, two bundles: the two runners step the same
    MuJoCo model with the same controller arithmetic."""
    scene = scene_gen.write_robot_scene(str(tmp_path / "go2_synthetic.xml"))
    config = os.path.join(ROOT, "deploy_configs", "go2.yaml")
    cmd = np.array([0.8, 0.0, 0.0], np.float32)
    for bundle in (R4_BUNDLE, port_bundle):
        trajs = []
        for runner, parser in ((jrunner, jconfig.ConfigParser), (trunner, ConfigParser)):
            cfg = parser(config, root_dir=ROOT)
            cfg.xml_path = scene
            trajs.append(runner.run(cfg, bundle, duration_s=2.0, command_source=lambda: cmd))
        ref, got = trajs
        assert got["qpos"].shape == (400, 19) and got["ctrl"].shape == (400, 12)
        for key in ("t", "qpos", "ctrl", "target"):
            np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-9, err_msg=key)
        np.testing.assert_array_equal(got["foot_contact"], ref["foot_contact"])
        # the feet are found by name and touch the ground; the robot stays up
        assert got["foot_contact"].shape == (400, 4) and got["foot_contact"].any()
        assert np.isfinite(got["qpos"]).all() and got["qpos"][:, 2].min() > 0.1


def test_runner_cli_headless(tmp_path, capsys):
    """The runner's entry point on a generated scene, as the README runs it."""
    scene = scene_gen.write_robot_scene(str(tmp_path / "scene.xml"))
    config = tmp_path / "go2_synthetic.yaml"
    text = open(os.path.join(ROOT, "deploy_configs", "go2.yaml")).read()
    config.write_text("\n".join(f'xml_path: "{scene}"' if line.startswith("xml_path:") else line
                                for line in text.splitlines()))
    trunner.main(["--config", str(config), "--bundle", R4_BUNDLE, "--headless",
                  "--seconds", "0.5"])
    assert capsys.readouterr().out.startswith("ran 0.5s: dx=")


def test_load_scene_rejects_a_drifted_heightfield(tmp_path):
    """The `.hfield.npy` size check raises on a mismatch, in both runners."""
    raw = np.zeros((20, 30), np.int16)
    raw[5:8] = -100
    out = scene_gen.write_heightfield_scene(raw, 0.1, 0.005, (0.0, 0.0),
                                            str(tmp_path / "s.xml"),
                                            robot_xml=scene_gen.write_robot_scene(
                                                str(tmp_path / "robot.xml"), floor=False))
    m = trunner.load_scene(out)
    assert m.nhfield == 1 and m.hfield_data.size == 600
    np.save(str(tmp_path / "s.hfield.npy"), np.zeros((3, 3), np.float32))
    for runner in (trunner, jrunner):
        with pytest.raises(ValueError, match="hfield npy size 9"):
            runner.load_scene(out)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_native_matches_numpy_and_reference_flat_bundle(tmp_path, port_nets, port_bundle, rng):
    """Three runtimes of one bundle: the torch networks that exported it, the
    numpy runtime and the native one."""
    flat = tnative.write_flat_bundle(port_bundle, str(tmp_path / "port.lgct"))
    ref = jnative.write_flat_bundle(port_bundle, str(tmp_path / "jax.lgct"))
    assert open(flat, "rb").read() == open(ref, "rb").read()
    lib = tnative.build_library()
    assert os.path.dirname(lib) == tnative.BUILD_DIR and lib == tnative.library_path()
    assert tnative.BUILD_DIR == os.path.join(ROOT, "build", "native")
    native, numpy_policy = tnative.NativePolicy(flat), _numpy_policy(port_bundle)
    for _ in range(3):
        obs = rng.normal(size=572).astype(np.float32)
        scan = rng.normal(size=132).astype(np.float32)
        ref = numpy_policy(obs, scan)
        np.testing.assert_allclose(native(obs, scan), ref, rtol=0, atol=1e-5)
        o, sc = torch.from_numpy(obs[None]), torch.from_numpy(scan[None])
        with torch.no_grad():
            act = port_nets.action_mean(o, None, port_nets.estimate(o), sc, True)
        np.testing.assert_allclose(act.numpy()[0], ref, rtol=0, atol=1e-5)
    native.close()


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_native_build_failure_raises_with_stderr(tmp_path, monkeypatch):
    """No silent fallback: a source that does not compile raises with the
    compiler's message, and nothing is written beside the sources."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("int lgc_bundle_load( { this is not C++\n")
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="error") as err:
        tnative.build_library(str(bad))
    assert "broken.cpp" in str(err.value)
    assert not os.path.exists(tnative.library_path(str(bad)))
    assert not glob.glob(os.path.join(os.path.dirname(tnative.SOURCE), "*.so"))


def _torchscript_dir(tmp_path, seed=0):
    """TorchScript modules of the reference's policy shapes
    (deploy/networks/go2/<model>/*.pt): Sequentials for the policy,
    estimator and scan encoder, and the adaptation module's fc_encoder /
    conv_layers / fc_final."""
    def mlp(dims):
        layers = []
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            layers.append(nn.Linear(a, b))
            if i < len(dims) - 2:
                layers.append(nn.ELU())
        return nn.Sequential(*layers)

    class Adaptation(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc_encoder = nn.Sequential(nn.Linear(52, 30), nn.ELU())
            self.conv_layers = nn.Sequential(nn.Conv1d(30, 20, 4, stride=2), nn.ELU(),
                                             nn.Conv1d(20, 10, 2, stride=1), nn.ELU(),
                                             nn.Flatten())
            self.fc_final = nn.Sequential(nn.Linear(30, 20), nn.ELU())

        def forward(self, hist):                       # (B, 10, 52)
            x = self.fc_encoder(hist).permute(0, 2, 1)  # (B, 30, 10)
            return self.fc_final(self.conv_layers(x))

    with torch.random.fork_rng():
        torch.manual_seed(seed)
        modules = {"policy": mlp([627, 512, 256, 128, 12]),
                   "estimator": mlp([572, 256, 128, 3]),
                   "scan_encoder": mlp([132, 128, 64, 32]), "adaptation_module": Adaptation()}
    for name, m in modules.items():
        torch.jit.script(m.eval()).save(str(tmp_path / f"{name}.pt"))
    return str(tmp_path), modules


def test_import_torchscript_matches_reference_and_forward(tmp_path, rng):
    model_dir, modules = _torchscript_dir(tmp_path)
    got = timport.import_torchscript_policy(model_dir, str(tmp_path / "port.npz"))
    ref = jimport.import_torchscript_policy(model_dir, str(tmp_path / "jax.npz"))
    got_z, ref_z = np.load(got), np.load(ref)
    assert got_z.files == ref_z.files
    for key in ref_z.files:
        assert got_z[key].dtype == ref_z[key].dtype and np.array_equal(got_z[key], ref_z[key]), key

    numpy_policy = _numpy_policy(got)
    b = load_policy_bundle(got)
    estimator, scan_enc = NumpyMLP(b["estimator"]), NumpyMLP(b["scan_encoder"])
    adapt = NumpyAdaptationEncoder(b["adaptation_module"])
    obs = rng.normal(size=572).astype(np.float32)
    scan = rng.normal(size=132).astype(np.float32)
    with torch.no_grad():
        est_t = modules["estimator"](torch.from_numpy(obs[None])).numpy()[0]
        scan_t = modules["scan_encoder"](torch.from_numpy(scan[None])).numpy()[0]
        ad_t = modules["adaptation_module"](torch.from_numpy(obs[:520].reshape(1, 10, 52)))
        ad_t = ad_t.numpy()[0]
        act_t = modules["policy"](torch.from_numpy(
            np.concatenate([obs, ad_t, scan_t, est_t])[None])).numpy()[0]
    tol = dict(rtol=0, atol=1e-5)
    np.testing.assert_allclose(estimator(obs), est_t, **tol)
    np.testing.assert_allclose(scan_enc(scan), scan_t, **tol)
    np.testing.assert_allclose(adapt(obs[:520].reshape(10, 52)), ad_t, **tol)
    np.testing.assert_allclose(numpy_policy(obs, scan), act_t, **tol)


def test_gamepad_stub_and_events_match_reference():
    pads = [tgamepad.Gamepad(1.2, 0.6, 1.0), jgamepad.Gamepad(1.2, 0.6, 1.0)]
    for pad in pads:
        assert not pad._available   # no `inputs` package here: the stub path
        assert np.array_equal(pad.get_command(), np.zeros(3, np.float32))
    ev = lambda code, state: types.SimpleNamespace(code=code, state=state)
    events = [ev("ABS_Y", -16384), ev("ABS_X", 200), ev("ABS_RX", 32767), ev("BTN_TL", 1)]
    cmds = []
    for pad in pads:
        out = []
        for e in events:
            pad._handle(e)
            out.append(pad.get_command())
        pad._handle(ev("BTN_TR", 1))          # LB + RB: the e-stop latch
        out.append(pad.get_command())
        assert pad.estop_flagged and pad.jump_pressed
        cmds.append(np.stack(out))
        pad.stop()
    np.testing.assert_array_equal(cmds[0], cmds[1])
    assert cmds[0][0, 0] == pytest.approx(0.6)   # half stick forward at vel_scale_x 1.2
    assert cmds[0][1, 1] == 0.0                   # inside the deadzone
    assert np.array_equal(cmds[0][-1], np.zeros(3))
