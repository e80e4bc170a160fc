"""Resume, play and export of the PyTorch port end to end on the CPU, on
`go2_stiction` at 8 envs: the checkpoint round trip, `--resume` through the
train CLI, `get_load_path`, the resume ROA schedule against the JAX
package's, and `scripts.play` writing the policy bundle.
"""
import math
import os

import numpy as np
import pytest
import torch

from legged_gym_custom_tpu.rl.ppo import PPOConfig as JPPOConfig
from legged_gym_custom_tpu.utils.task_registry import get_load_path as jget_load_path
from legged_gym_custom_tpu_torch.deploy import load_policy_bundle
from legged_gym_custom_tpu_torch.envs import task_registry
from legged_gym_custom_tpu_torch.rl import ppo as ppo_lib
from legged_gym_custom_tpu_torch.scripts import play as play_script
from legged_gym_custom_tpu_torch.scripts import train as train_script
from legged_gym_custom_tpu_torch.utils.task_registry import get_load_path


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny, so one thread is faster than many, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_args(*extra):
    return train_script.get_args(["--task", "go2_stiction", "--num_envs", "8", "--seed", "3",
                                  "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(log root, runner) of a 2-iteration go2_stiction run: DAgger, then PPO."""
    root = str(tmp_path_factory.mktemp("logs"))
    runner, history = train_script.train(_train_args("--max_iterations", "2", "--run_name", "a"),
                                         log_root=root)
    assert [h["update"] for h in history] == ["dagger", "ppo"]
    assert runner.env.fused_spec.fl_dqd   # the implicit-stiction plant
    return root, runner


def _fresh_runner(resume=False):
    env_cfg, train_cfg = task_registry.get_cfgs("go2_stiction")
    env_cfg.env.num_envs = 8
    train_cfg.seed = 11   # other initial weights than the trained run's
    train_cfg.runner.resume = resume
    env, _ = task_registry.make_env("go2_stiction", env_cfg=env_cfg, device="cpu")
    return task_registry.make_alg_runner(env, train_cfg=train_cfg, log_root=None)[0] \
        if not resume else (env, train_cfg)


def _assert_optimizers_equal(a, b):
    for name in ("opt_policy", "opt_adapt", "opt_est"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert sa["param_groups"] == sb["param_groups"], name
        assert sa["state"].keys() == sb["state"].keys() and sa["state"], name
        for idx, entry in sa["state"].items():
            for key, value in entry.items():
                torch.testing.assert_close(sb["state"][idx][key], value, rtol=0, atol=0,
                                           msg=f"{name}[{idx}].{key}")


def test_checkpoint_round_trip_restores_every_tensor(trained):
    root, runner = trained
    path = get_load_path(root)
    assert path.endswith("model_2.pt")
    fresh = _fresh_runner()
    before = {k: v.clone() for k, v in fresh.nets.state_dict().items()}
    assert fresh.load(path) is None   # no infos were saved
    assert any(not torch.equal(before[k], v) for k, v in fresh.nets.state_dict().items())
    for (k, a), (_, b) in zip(runner.nets.state_dict().items(), fresh.nets.state_dict().items()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    _assert_optimizers_equal(runner.train_state, fresh.train_state)
    assert fresh.current_learning_iteration == runner.current_learning_iteration == 2
    assert fresh.train_state.learning_rate == runner.train_state.learning_rate
    assert fresh.train_state.total_updates == runner.train_state.total_updates == 2.0
    assert fresh.train_state.opt_policy.param_groups[0]["lr"] == runner.train_state.learning_rate

    # parameters only: the optimizers, learning rate and update count stay
    other = _fresh_runner()
    other.save(os.path.join(root, "infos.pt"), infos={"note": 1.5})   # not named model_*
    other.train_state.learning_rate = 0.5
    assert other.load(path, load_optimizer=False) is None
    assert other.train_state.learning_rate == 0.5 and other.train_state.total_updates == 0.0
    assert not other.train_state.opt_policy.state_dict()["state"]
    assert other.current_learning_iteration == 2
    assert other.load(os.path.join(root, "infos.pt")) == {"note": 1.5}
    os.remove(os.path.join(root, "infos.pt"))


def test_resume_continues_at_the_saved_iteration(trained, capsys):
    root, runner = trained
    resumed, history = train_script.train(
        _train_args("--max_iterations", "1", "--run_name", "b", "--resume"), log_root=root)
    out = capsys.readouterr().out
    assert f"Loading model from: {get_load_path(root, load_run=os.path.basename(runner.log_dir))}" \
        in out
    assert [h["iteration"] for h in history] == [2] and history[0]["update"] == "ppo"
    assert math.isclose(history[0]["reg_coef"], 0.1, rel_tol=1e-6)   # the resume ROA schedule
    assert resumed.current_learning_iteration == 3
    assert resumed.train_state.total_updates == 3.0
    assert resumed.log_dir != runner.log_dir
    assert sorted(os.listdir(resumed.log_dir))[-1] == "model_3.pt"
    # a named run and checkpoint
    picked = get_load_path(root, load_run=os.path.basename(runner.log_dir), checkpoint=0)
    again, _ = train_script.train(
        _train_args("--max_iterations", "1", "--run_name", "c", "--resume", "--load_run",
                    os.path.basename(runner.log_dir), "--checkpoint", "0"), log_root=root)
    assert f"Loading model from: {picked}" in capsys.readouterr().out
    # model_0.pt was written after iteration 0, so it resumes at iteration 1
    assert again.current_learning_iteration == 2


def test_resume_roa_schedule_is_the_reference(trained):
    _, train_cfg = task_registry.get_cfgs("go2_stiction")
    for resume in (False, True):
        cfg_t = ppo_lib.PPOConfig.from_cfg(train_cfg.algorithm, resume=resume)
        assert cfg_t._asdict() == JPPOConfig.from_cfg(train_cfg.algorithm, resume=resume)._asdict()
    cfg_t = ppo_lib.PPOConfig.from_cfg(train_cfg.algorithm, resume=True)
    assert [ppo_lib.roa_coefficient(cfg_t, u) for u in (0.0, 1.0, 5000.0)] == [0.0, 0.1, 0.1]
    fresh = ppo_lib.PPOConfig.from_cfg(train_cfg.algorithm)
    assert [ppo_lib.roa_coefficient(fresh, u) for u in (0.0, 5000.0, 15000.0)] == [0.0, 0.0, 0.05]
    env, cfg = _fresh_runner(resume=True)
    with pytest.raises(ValueError, match="log_root"):
        task_registry.make_alg_runner(env, train_cfg=cfg, log_root=None)


def test_get_load_path_picks_the_newest_run_and_highest_model(tmp_path):
    root = tmp_path / "exp"
    for run, models in (("Jan01_00-00-00_a", (0, 50, 100)), ("Jan02_00-00-00_b", (0, 50, 1000, 200)),
                        ("exported", ())):
        (root / run).mkdir(parents=True)
        for it in models:
            (root / run / f"model_{it}.pt").write_bytes(b"")
    (root / "Jan02_00-00-00_b" / "events.out.tfevents.1").write_bytes(b"")
    (root / "Jan02_00-00-00_b" / "model_1000.pt.tmp").write_bytes(b"")
    assert get_load_path(str(root)) == str(root / "Jan02_00-00-00_b" / "model_1000.pt")
    assert get_load_path(str(root), load_run="Jan01_00-00-00_a") == \
        str(root / "Jan01_00-00-00_a" / "model_100.pt")
    assert get_load_path(str(root), checkpoint=50) == str(root / "Jan02_00-00-00_b" / "model_50.pt")
    # the reference's choice of run and checkpoint number, its files ending in .ckpt
    ref = jget_load_path(str(root), load_run="Jan01_00-00-00_a")
    assert ref == str(root / "Jan01_00-00-00_a" / "model_100.pt")
    with pytest.raises(ValueError, match="No runs"):
        get_load_path(str(tmp_path / "nothing"))


def test_play_on_the_cpu_exports_the_bundle(trained, capsys):
    root, runner = trained
    args = play_script.get_args(["--task", "go2_stiction", "--num_envs", "2", "--steps", "8",
                                 "--device", "cpu", "--load_run", os.path.basename(runner.log_dir)])
    assert play_script.get_args([]).device == "cuda"
    result = play_script.play(args, log_root=root)
    assert "Loading model from:" in capsys.readouterr().out
    env = result.runner.env
    assert env.num_envs == 2 and env.device.type == "cpu"
    # the play-time overrides
    assert not env.cfg.noise.add_noise and not env.cfg.domain_rand.push_robots
    assert not env.cfg.domain_rand.randomize_friction and not env.cfg.domain_rand.randomize_kp_kd
    assert result.actions.shape == (2, 12) and result.actions_finite
    assert result.bundle_path == os.path.join(root, "exported", "policies", "policy_bundle.npz")
    bundle = load_policy_bundle(result.bundle_path)
    assert [len(bundle[m]) for m in ("policy", "estimator", "scan_encoder",
                                     "adaptation_module")] == [4, 3, 3, 4]
    # the trained weights, not a fresh initialisation
    np.testing.assert_array_equal(bundle["policy"][0]["kernel"],
                                  runner.nets.actor.layers[0].weight.detach().numpy().T)
    # the last action is the deterministic policy on the observation before it
    policy = result.runner.get_inference_policy()
    torch.testing.assert_close(policy(result.obs), result.actions, rtol=0, atol=0)
    # `exported` beside the runs does not count as a run
    assert os.path.basename(os.path.dirname(get_load_path(root))) != "exported"
