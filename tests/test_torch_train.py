"""The PyTorch port end to end on the CPU: a 2-iteration go2 training run
through the train CLI, its checkpoint, the port's import rules and the
entry points' default device."""
import ast
import math
import os
import subprocess
import sys

import pytest
import torch

import legged_gym_custom_tpu_torch
from legged_gym_custom_tpu_torch.scripts import train as train_script
from legged_gym_custom_tpu_torch.utils import checkpoint as checkpoint_lib

PORT_DIR = os.path.dirname(legged_gym_custom_tpu_torch.__file__)
FORBIDDEN = ("jax", "flax", "optax", "legged_gym_custom_tpu")


def test_two_iteration_cpu_training_saves_a_checkpoint(tmp_path):
    args = train_script.get_args(["--task", "go2", "--num_envs", "8", "--max_iterations", "2",
                                  "--seed", "3", "--device", "cpu", "--run_name", "smoke"])
    runner, history = train_script.train(args, log_root=str(tmp_path))
    assert [h["update"] for h in history] == ["dagger", "ppo"]
    losses = [v for h in history for k, v in h.items() if k.endswith("loss")]
    assert losses and all(math.isfinite(v) for v in losses)
    assert runner.env.num_envs == 8 and runner.env.device.type == "cpu"

    saved = sorted(os.listdir(runner.log_dir))
    assert "model_0.pt" in saved and "model_2.pt" in saved
    ckpt = checkpoint_lib.load_checkpoint(os.path.join(runner.log_dir, "model_2.pt"))
    assert set(ckpt) == set(checkpoint_lib.KEYS)
    assert ckpt["iter"] == 2 and ckpt["total_updates"] == 2.0
    for name, value in runner.nets.state_dict().items():
        torch.testing.assert_close(ckpt["model_state_dict"][name], value, rtol=0, atol=0)
    # every optimizer group has taken steps: the DAgger one at iteration 0,
    # the policy and estimator ones at iteration 1
    for key in ("optimizer_policy", "optimizer_adapt", "optimizer_est"):
        assert ckpt[key]["state"], key


def test_two_iteration_cpu_training_go2_parkour(tmp_path):
    """go2_parkour on its full 12 x 20 gap-course terrain at 8 envs: DAgger
    then PPO, finite losses, a scan stream that sees the terrain."""
    args = train_script.get_args(["--task", "go2_parkour", "--num_envs", "8",
                                  "--max_iterations", "2", "--seed", "4", "--device", "cpu"])
    runner, history = train_script.train(args, log_root=str(tmp_path))
    assert [h["update"] for h in history] == ["dagger", "ppo"]
    losses = [v for h in history for k, v in h.items() if k.endswith("loss")]
    assert losses and all(math.isfinite(v) for v in losses)
    env = runner.env
    assert env.hf.data.shape == (3860, 2500) and env.fused_spec.hf_K == 24
    assert runner.obs.scan.shape == (8, 132) and float(runner.obs.scan.abs().sum()) > 0.0
    levels = runner.env_state.terrain_levels
    assert int(levels.min()) >= 0 and int(levels.max()) < env.cfg.terrain.num_rows
    assert history[-1]["terrain_level"] == float(levels.float().mean())


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    checked = 0
    for root, _, files in os.walk(PORT_DIR):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            for mod in _imports(path):
                top = mod.split(".")[0]
                assert top not in FORBIDDEN, f"{path} imports {mod}"
            checked += 1
    chip_smoke = os.path.join(os.path.dirname(PORT_DIR), "chip_smoke.py")
    for mod in _imports(chip_smoke):
        assert mod.split(".")[0] not in FORBIDDEN, f"chip_smoke.py imports {mod}"
    assert checked >= 20


def test_port_modules_load_without_jax():
    """Importing the port's env (the other robots' too), terrain, patch,
    kernel, deploy, play, MPC, bench, profiling, recurrent-policy,
    actuator-network, jump-pipeline, curve and roofline modules pulls in
    neither JAX nor the JAX package, transitively (a fresh interpreter)."""
    code = ("import sys\n"
            "import legged_gym_custom_tpu_torch.envs, legged_gym_custom_tpu_torch.terrain\n"
            "import legged_gym_custom_tpu_torch.physics.patch, legged_gym_custom_tpu_torch.ops.fused_step\n"
            "import legged_gym_custom_tpu_torch.deploy, legged_gym_custom_tpu_torch.scripts.play\n"
            "import legged_gym_custom_tpu_torch.utils.logger\n"
            "import legged_gym_custom_tpu_torch.mpc, legged_gym_custom_tpu_torch.mpc.bench\n"
            "import legged_gym_custom_tpu_torch.bench, legged_gym_custom_tpu_torch.utils.profiling\n"
            "import legged_gym_custom_tpu_torch.deploy.config_parser\n"
            "import legged_gym_custom_tpu_torch.deploy.native\n"
            "import legged_gym_custom_tpu_torch.deploy.mujoco_runner\n"
            "import legged_gym_custom_tpu_torch.deploy.mujoco_oracle\n"
            "import legged_gym_custom_tpu_torch.deploy.scene_gen\n"
            "import legged_gym_custom_tpu_torch.deploy.real_robot\n"
            "import legged_gym_custom_tpu_torch.deploy.import_torchscript\n"
            "import legged_gym_custom_tpu_torch.deploy.gamepad\n"
            "import legged_gym_custom_tpu_torch.scripts.make_gap_scene\n"
            "import legged_gym_custom_tpu_torch.scripts.control_and_play\n"
            "import legged_gym_custom_tpu_torch.models.recurrent\n"
            "import legged_gym_custom_tpu_torch.models.actuator_net\n"
            "import legged_gym_custom_tpu_torch.rl.traj_utils\n"
            "import legged_gym_custom_tpu_torch.scripts.jump_teacher\n"
            "import legged_gym_custom_tpu_torch.scripts.jump_distill\n"
            "import legged_gym_custom_tpu_torch.scripts.extract_curve\n"
            "import legged_gym_custom_tpu_torch.scripts.package_parkour\n"
            "import legged_gym_custom_tpu_torch.scripts.check_fused_gpu\n"
            "import legged_gym_custom_tpu_torch.ops.roofline\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in %r))" % (FORBIDDEN,))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(PORT_DIR), check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_port_deploy_loads_without_yaml_and_mujoco():
    """The card's machine has neither yaml nor mujoco: the deploy package, the
    native runtime, the MuJoCo oracle's module and control_and_play import
    without them (a fresh interpreter where importing either fails)."""
    code = ("import sys\n"
            "sys.modules['yaml'] = sys.modules['mujoco'] = None\n"
            "import legged_gym_custom_tpu_torch.deploy, legged_gym_custom_tpu_torch.deploy.native\n"
            "import legged_gym_custom_tpu_torch.deploy.mujoco_oracle\n"
            "import legged_gym_custom_tpu_torch.scripts.control_and_play\n"
            "import legged_gym_custom_tpu_torch.models.recurrent\n"
            "import legged_gym_custom_tpu_torch.models.actuator_net\n"
            "import legged_gym_custom_tpu_torch.rl.traj_utils\n"
            "try:\n"
            "    import yaml\n"
            "except ImportError:\n"
            "    print('no yaml')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(PORT_DIR), check=True)
    assert out.stdout.strip() == "no yaml", out.stdout + out.stderr


def test_entry_points_default_to_cuda(monkeypatch):
    assert train_script.get_args([]).device == "cuda"
    assert legged_gym_custom_tpu_torch.DEFAULT_DEVICE == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_script.train(train_script.get_args(["--num_envs", "2", "--max_iterations", "1"]),
                           log_root=None)
    assert legged_gym_custom_tpu_torch.resolve_device("cpu").type == "cpu"
