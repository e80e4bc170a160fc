"""`scripts/train.py` as a data-parallel run on two gloo ranks of the CPU,
through `parallel.multihost.spawn_ranks` (rank functions in
tests/torch_dist_ranks.py): `train.train` joins the ranks' group, go2 at
16 global envs.

  * a fresh run of 2 iterations: each rank's env is its slice of the
    one-process env (the plane's grid of origins, and an unseeded
    go2_parkour env's terrain and terrain columns), rank 0's unseeded seed
    reaches rank 1, one run directory with the primary's checkpoints and
    one event file, parameters bit-equal across ranks;
  * then, in one spawn, `--resume` for one iteration and a stage whose
    config sets `runner.resume`: every rank loads the primary's pick, the
    newest run before this one (not the run's own new directory, which a
    rank listing the log root could find), with parameters equal to the
    file's, and goes on from its iteration; only the primary lists the log
    root;
  * `train.cards_to_use`, the count of ranks a plain start runs, with the
    visible cards and the task's `parallel.mesh_shape` patched.
"""
import hashlib
import os

import numpy as np
import pytest
import torch

from legged_gym_custom_tpu_torch.envs import task_registry
from legged_gym_custom_tpu_torch.parallel import multihost
from legged_gym_custom_tpu_torch.utils import checkpoint
import torch_dist_ranks as ranks

WORLD, ENVS = 2, 16
# a spawn's limit: its ranks take about 40 s alone, several times that
# beside the other test files on the same cores
TIMEOUT = 480.0
ARGV = ["--task", "go2", "--num_envs", str(ENVS), "--device", "cpu"]


def _file_sha(path):
    sd = checkpoint.load_checkpoint(path)["model_state_dict"]
    flat = torch.cat([t.reshape(-1).float() for t in sd.values()])
    return hashlib.sha256(flat.numpy().tobytes()).hexdigest()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("logs"))
    fresh = multihost.spawn_ranks(ranks.train_script_on_rank, WORLD,
                                  ([ARGV + ["--max_iterations", "2"]], root, True),
                                  timeout=TIMEOUT)
    first = sorted(os.listdir(root))
    resumed = multihost.spawn_ranks(
        ranks.train_script_on_rank, WORLD,
        ([ARGV + ["--resume", "--max_iterations", "1"],
          ARGV[:1] + ["go2_stage"] + ARGV[2:] + ["--max_iterations", "1"]], root),
        timeout=TIMEOUT)
    return root, first, fresh, resumed


def test_rank_envs_are_slices_of_the_one_process_env(runs):
    _, _, fresh, _ = runs
    cfg, _ = task_registry.get_cfgs("go2")
    cfg.env.num_envs = ENVS
    full = task_registry.get_task_class("go2")(cfg, cfg.asset.file, name="go2", device="cpu")
    origins = full._initial_origins(torch.Generator().manual_seed(0))[2].numpy()
    got = [r["runs"][0] for r in fresh]
    assert [(g["num_envs"], g["env_offset"]) for g in got] == [(8, 0), (8, 8)]
    assert all(g["mesh_is_env_mesh"] for g in got)
    np.testing.assert_array_equal(np.concatenate([g["origins"] for g in got]), origins)
    # the unseeded go2_parkour env: rank 0's seed on both ranks, so one
    # terrain, each rank its columns of the one-process env of that seed
    seed = fresh[0]["seeds"][-1]
    pcfg, _ = task_registry.get_cfgs("go2_parkour")
    pcfg.env.num_envs = ENVS
    one = task_registry.get_task_class("go2_parkour")(pcfg, pcfg.asset.file, name="go2",
                                                      device="cpu", terrain_seed=seed)
    parkour = [r["parkour"] for r in fresh]
    assert parkour[0]["terrain_sha256"] == parkour[1]["terrain_sha256"] == \
        hashlib.sha256(one.hf.data.numpy().tobytes()).hexdigest()
    np.testing.assert_array_equal(np.concatenate([p["terrain_types"] for p in parkour]),
                                  one.terrain_types.numpy())


def test_rank_zeros_unseeded_seed_reaches_rank_one(runs):
    """Every `set_seed` of an unseeded env on rank 1 ends at rank 0's draw
    (rank 0 draws, rank 1 takes it before the env is built)."""
    _, _, fresh, resumed = runs
    for got in (fresh, resumed):
        s0, s1 = got[0]["seeds"], got[1]["seeds"]
        assert len(s0) == len(s1) and len(s0) % 2 == 0
        for i in range(0, len(s0), 2):   # (own draw, the broadcast) per env
            assert s0[i] == s0[i + 1] == s1[i + 1]


def test_one_run_directory_written_by_the_primary(runs):
    root, first, fresh, _ = runs
    assert len(first) == 1
    run = os.path.join(root, first[0])
    assert {r["runs"][0]["log_dir"] for r in fresh} == {run}
    files = sorted(os.listdir(run))
    assert [f for f in files if f.startswith("model_")] == ["model_0.pt", "model_2.pt"]
    assert len([f for f in files if "tfevents" in f]) == 1
    assert not [f for f in files if f.endswith(".tmp")]
    assert [r["runs"][0]["iterations"] for r in fresh] == [[0, 1]] * WORLD
    assert fresh[0]["runs"][0]["params_sha256"] == fresh[1]["runs"][0]["params_sha256"]
    # the final checkpoint is what the ranks hold
    assert _file_sha(os.path.join(run, "model_2.pt")) == fresh[0]["runs"][0]["params_sha256"]


def test_resume_on_two_ranks_continues_from_the_checkpoint(runs):
    root, first, _, resumed = runs
    ckpt = os.path.join(root, first[0], "model_2.pt")
    for r in resumed:
        path, sha, iteration = r["loads"][0]
        assert (path, iteration) == (ckpt, 2)
        assert sha == _file_sha(ckpt)
        assert r["runs"][0]["iterations"] == [2]
    assert resumed[0]["runs"][0]["params_sha256"] == resumed[1]["runs"][0]["params_sha256"]
    assert resumed[0]["runs"][0]["log_dir"] == resumed[1]["runs"][0]["log_dir"]


def test_stage_resume_finds_the_previous_run_not_its_own(runs):
    """The stage's run loads the `--resume` run's checkpoint (the newest
    run before it) on both ranks; only rank 0 listed the log root."""
    root, first, _, resumed = runs
    prev = resumed[0]["runs"][0]["log_dir"]
    own = resumed[0]["runs"][1]["log_dir"]
    assert own != prev and os.path.dirname(own) == root
    for r in resumed:
        path, sha, iteration = r["loads"][1]
        assert (path, iteration) == (os.path.join(prev, "model_3.pt"), 3)
        assert sha == _file_sha(path)
        assert r["runs"][1]["iterations"] == [3] and r["runs"][1]["log_dir"] == own
    assert len(resumed[0]["listed"]) == 2 and resumed[1]["listed"] == []
    # one directory a run: the fresh run's, the resumed run's and the stage's
    assert sorted(os.listdir(root)) == sorted([first[0], os.path.basename(prev),
                                               os.path.basename(own)])


@pytest.mark.parametrize("visible, mesh_shape, device, expected", [
    (4, None, "cuda", 4),        # every visible card
    (1, None, "cuda", 1),        # one card: one process
    (4, 2, "cuda", 2),           # an int: that many cards
    (4, (3,), "cuda", 3),        # a shape: its product
    (4, None, "cuda:1", 1),      # a named card: one process
    (4, None, "cpu", 1),
    (2, 4, "cuda", ValueError),  # more than are visible
])
def test_cards_to_use(monkeypatch, visible, mesh_shape, device, expected):
    from legged_gym_custom_tpu_torch.scripts import train as train_script

    get_cfgs = task_registry.get_cfgs

    def patched(name):
        env_cfg, train_cfg = get_cfgs(name)
        env_cfg.parallel.mesh_shape = mesh_shape
        return env_cfg, train_cfg

    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    monkeypatch.setattr(task_registry, "get_cfgs", patched)
    args = train_script.get_args(["--task", "go2", "--device", device])
    if expected is ValueError:
        with pytest.raises(ValueError, match="4 cards, 2 visible"):
            train_script.cards_to_use(args)
    else:
        assert train_script.cards_to_use(args) == expected
