"""The port's multi-process worker and its scaling benchmarks on gloo ranks of
the CPU, at small sizes: two OS processes of `scripts.multihost_worker`
training go2 over gloo with a collective checkpoint round trip, the
refusal of a global env count that does not divide, and one run each of
`bench_scaling`, `bench_multiprocess` and the bench entry's scaling lines.

Each run is bounded: the launcher kills every rank and fails when one fails
or when the run outlasts its timeout.
"""
import json
import math
import os
import subprocess
import sys

import pytest

from legged_gym_custom_tpu_torch import LEGGED_GYM_TORCH_ROOT_DIR
from legged_gym_custom_tpu_torch import bench
from legged_gym_custom_tpu_torch.scripts import bench_multiprocess, bench_scaling
from legged_gym_custom_tpu_torch.scripts import multihost_worker

TIMEOUT = 240.0
ENV = dict(os.environ, OMP_NUM_THREADS="1")
# tests/test_multiprocess.py's keys of the JAX worker's result line
JAX_KEYS = {"process_count", "global_devices", "local_devices", "num_envs", "iterations", "fps",
            "collection_s", "learning_s", "value_loss", "ckpt", "restored_iteration"}
SCALING_KEYS = {"devices", "num_envs", "iters", "fps"}
MULTIPROCESS_KEYS = {"procs", "total_envs", "fps_1proc_1core", "fps_2proc_2core", "efficiency",
                     "fps_1proc_half_batch", "sync_only_efficiency", "collection_s_1proc",
                     "learning_s_1proc", "collection_s_1proc_half", "learning_s_1proc_half",
                     "collection_s_2proc", "learning_s_2proc", "taskset"}


def test_two_process_training_and_checkpoint(tmp_path):
    """Two gloo ranks of 8 envs each: the JAX worker's keys plus the backend
    and the device, the iteration restored from the collective checkpoint,
    parameters bit-equal across ranks, each rank its own slice."""
    result, outputs = multihost_worker.launch(
        2, ["--task", "go2", "--num_envs", "16", "--iterations", "1", "--warmup", "1",
            "--ckpt_dir", str(tmp_path), "--device", "cpu"], timeout=TIMEOUT, env=ENV)
    assert JAX_KEYS | {"backend", "device"} <= set(result)
    assert (result["backend"], result["device"]) == ("gloo", "cpu")
    assert result["process_count"] == result["global_devices"] == 2
    assert result["local_devices"] == 1 and result["num_envs"] == 16
    assert math.isfinite(result["value_loss"]) and result["fps"] > 0
    assert result["restored_iteration"] == 2   # warmup + iterations
    assert os.path.exists(result["ckpt"]) and not os.path.exists(result["ckpt"] + ".tmp")
    assert result["params_bit_equal"]
    assert len({r["params_sha256"] for r in result["ranks"]}) == 1
    assert [(r["local_envs"], r["env_offset"]) for r in result["ranks"]] == [(8, 0), (8, 8)]
    assert all(r["losses_finite"] and r["launches"] == {} for r in result["ranks"])
    # one gradient all-reduce per minibatch round of the PPO iteration; two
    # after the rollout
    assert result["collectives"]["update"]["counts"] == {"all-reduce": 20}
    assert result["collectives"]["collect"]["counts"] == {"all-reduce": 2}
    # only the primary prints the console block and the result line
    assert "Learning iteration" in outputs[0] and "Learning iteration" not in outputs[1]
    assert json.loads(outputs[0].strip().splitlines()[-1]) == result


def test_worker_refuses_a_global_count_that_does_not_divide():
    with pytest.raises(RuntimeError, match=r"AssertionError: \(15, 2\)"):
        multihost_worker.launch(2, ["--task", "go2", "--num_envs", "15", "--iterations", "1",
                                    "--device", "cpu"], timeout=TIMEOUT, env=ENV)


def test_worker_runs_from_torchrun_variables(tmp_path):
    """Without --coordinator the worker reads MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK, as torchrun sets them (here a world of 1)."""
    from legged_gym_custom_tpu_torch.parallel.multihost import free_port

    env = dict(ENV, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
               RANK="0")
    out = subprocess.run(
        [sys.executable, "-m", multihost_worker.MODULE, "--task", "go2", "--num_envs", "4",
         "--iterations", "1", "--device", "cpu", "--result_json", str(tmp_path / "r.json")],
        capture_output=True, text=True, timeout=TIMEOUT, env=env, cwd=LEGGED_GYM_TORCH_ROOT_DIR,
        check=True)
    result = json.loads((tmp_path / "r.json").read_text())
    assert (result["backend"], result["process_count"], result["params_bit_equal"]) == \
        ("gloo", 1, True)
    assert "Learning iteration 0/1" in out.stdout


def test_bench_scaling_emits_its_keys(capsys):
    out = bench_scaling.main(["--devices", "2", "--total_envs", "8", "--iters", "1",
                              "--warmup", "0"])
    assert SCALING_KEYS <= set(out) and out["devices"] == 2 and out["fps"] > 0
    assert out["backend"] == "gloo"
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


def test_bench_multiprocess_emits_its_keys():
    out = bench_multiprocess.run_bench(procs=2, total_envs=8, iters=1, warmup=0)
    assert MULTIPROCESS_KEYS <= set(out)
    assert out["efficiency"] > 0 and out["sync_only_efficiency"] > 0
    assert out["efficiency"] == round(out["fps_2proc_2core"] / (2 * out["fps_1proc_1core"]), 4)


def test_bench_scaling_lines_name_the_cpu_not_the_card(monkeypatch):
    """The bench entry's three scaling lines keep the root bench.py's names
    and are tagged with the host's CPU."""
    fake = {"fps": 10.0, "backend": "gloo"}
    monkeypatch.setattr(bench_scaling, "run", lambda n, envs, iters: dict(fake, devices=n))
    monkeypatch.setattr(bench_multiprocess, "run_bench", lambda **kw: {
        "efficiency": 0.5, "sync_only_efficiency": 0.9})
    lines = bench.scaling_lines()
    assert [line["metric"] for line in lines] == [
        "mesh_sharding_overhead_efficiency_8dev", "dcn_multiprocess_scaling_efficiency_2proc",
        "dcn_sync_only_efficiency_2proc"]
    assert [line["value"] for line in lines] == [1.0, 0.5, 0.9]
    for line in lines:
        assert line["device"] == {"name": f"cpu ({os.cpu_count()} cores)", "power_limit": None}
        assert "CPU ranks, not the card" in line["unit"] and "gloo" in line["unit"]


def test_distributed_modules_load_without_jax():
    """The parallel modules, the four scripts and the rank functions of the
    tests pull in neither JAX nor the JAX package, transitively (a fresh
    interpreter): the card's machine has no JAX."""
    forbidden = ("jax", "flax", "optax", "legged_gym_custom_tpu")
    code = ("import sys\n"
            "sys.path.insert(0, 'tests')\n"
            "import legged_gym_custom_tpu_torch.parallel.mesh\n"
            "import legged_gym_custom_tpu_torch.parallel.multihost\n"
            "import legged_gym_custom_tpu_torch.scripts.multihost_worker\n"
            "import legged_gym_custom_tpu_torch.scripts.bench_scaling\n"
            "import legged_gym_custom_tpu_torch.scripts.bench_multiprocess\n"
            "import legged_gym_custom_tpu_torch.scripts.comm_budget\n"
            "import torch_dist_ranks\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in %r))" % (forbidden,))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=LEGGED_GYM_TORCH_ROOT_DIR, check=True)
    assert out.stdout.strip() == "[]", out.stdout
