"""After the harness has been imported and run on the CPU, no module of the
JAX stack or of the JAX package is loaded, compared by whole top-level name
(`legged_gym_custom_tpu_torch` is the port and passes)."""
import subprocess
import sys

from portbench import harness

CODE = """
import sys
from portbench import harness, run, trace, calibrate
from portbench.tests import tiny
tiny.run("go2_train")
tiny.run("go2_mppi_b8", seconds=0.5)
for m in harness.benchmark()["per_layer"]:
    harness.load_module("metrics", m["name"])
assert "legged_gym_custom_tpu_torch" in {m.split(".")[0] for m in sys.modules}
print("BANNED", harness.banned_modules())
"""


def test_no_jax_after_a_run():
    out = subprocess.run([sys.executable, "-c", CODE], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600, env={"OMP_NUM_THREADS": "2", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "BANNED []"


def test_banned_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "legged_gym_custom_tpu_torch_x", sys)
    assert "legged_gym_custom_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "legged_gym_custom_tpu.envs", sys)
    assert "legged_gym_custom_tpu" in harness.banned_modules()
