"""The port's `scripts.control_and_play` on the CPU: 20 steps of one go2 env
from a saved checkpoint, with the stub gamepad (no `inputs` package), under
the command of `--vx --vy --wz`; every observation finite."""
import os

import numpy as np
import pytest
import torch

from legged_gym_custom_tpu_torch.envs import task_registry
from legged_gym_custom_tpu_torch.scripts import control_and_play


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_control_and_play_runs_the_command_on_cpu(tmp_path, capsys):
    env_cfg, train_cfg = task_registry.get_cfgs("go2")
    env_cfg.env.num_envs = 1
    env, _ = task_registry.make_env("go2", env_cfg=env_cfg, device="cpu")
    runner, _ = task_registry.make_alg_runner(env, train_cfg=train_cfg, log_root=None)
    ckpt = os.path.join(tmp_path, "Jan01_00-00-00_saved", "model_7.pt")
    os.makedirs(os.path.dirname(ckpt))
    runner.current_learning_iteration = 7
    runner.save(ckpt)

    args = control_and_play.get_args(["--task", "go2", "--load_run", "Jan01_00-00-00_saved",
                                      "--steps", "20", "--vx", "0.6", "--vy", "0.1",
                                      "--device", "cpu"])
    assert control_and_play.get_args([]).device == "cuda"
    out = control_and_play.play(args, log_root=str(tmp_path))
    printed = capsys.readouterr().out
    assert f"Loading model from: {ckpt}" in printed and "step 0: vx=" in printed
    assert out.steps == 20 and out.obs_finite
    assert out.runner.env.num_envs == 1 and out.runner.current_learning_iteration == 7
    for p_saved, p_loaded in zip(runner.nets.parameters(), out.runner.nets.parameters()):
        assert torch.equal(p_saved, p_loaded)
    np.testing.assert_allclose(out.state.commands[0, :2].numpy(), [0.6, 0.1], atol=1e-7)
    assert bool(torch.isfinite(out.state.physics.base_pos).all())
