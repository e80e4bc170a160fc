"""Every cell, configuration, traffic mix, driver and metric is found by its
name in files of its own; a cell is added as new files only."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.benchmark()


def test_benchmark_names_resolve_to_files():
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert harness.load_json("configs", c["name"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        cell = harness.load_workload(w["name"])
        for k in ("config", "traffic", "chips", "why"):
            assert cell[k] == w[k], (w["name"], k)
        assert os.path.exists(os.path.join(harness.HERE, "drivers", cell["driver"] + ".py"))
        assert cell["limits"], f"{w['name']} has no limits"
    for m in BENCH["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.metrics_for(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_for(w["name"], "per_layer")


def test_a_new_cell_is_only_new_files(tmp_path):
    """A copy of the benchmark with one more cell, made of a traffic file and
    a workload file and an entry in BENCHMARK.json: the harness finds it, and
    no file that was there changed."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: (root / "portbench" / p).read_bytes()
              for p in [os.path.relpath(os.path.join(d, f), root / "portbench")
                        for d, _, fs in os.walk(root / "portbench") for f in fs]}
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "go2_mppi_b4096", "config": "go2", "traffic": "mppi_b4096", "chips": 1,
         "why": "a test cell"}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((root / "portbench/traffic/mppi_b8.json").read_text())
    traffic.update(name="mppi_b4096", set={"env.num_envs": 4096, "noise.add_noise": False})
    (root / "portbench/traffic/mppi_b4096.json").write_text(json.dumps(traffic))
    (root / "portbench/workloads/go2_mppi_b4096.json").write_text(json.dumps(
        dict(bench["workloads"][-1], limits={"plan": 1.0})))
    code = ("from portbench import harness; c = harness.load_workload('go2_mppi_b4096'); "
            "print(c['driver'], c['set']['env.num_envs'], "
            "[m['name'] for m in harness.metrics_for('go2_mppi_b4096', 'end_to_end')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert out.split()[:2] == ["mpc", "4096"] and "setup_s" in out
    for p, data in before.items():
        assert (root / "portbench" / p).read_bytes() == data


def test_run_refuses_without_the_program_or_a_card(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, and on a
    machine without a card, a run exits non-zero and prints no result."""
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    for cwd in (tmp_path, harness.ROOT):
        r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "go2_train",
                            "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        if cwd == harness.ROOT and r.returncode == 0:
            pytest.skip("this machine has a card")
        assert r.returncode != 0 and '"correct"' not in r.stdout
