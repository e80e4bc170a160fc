"""The port's curve tools against the JAX package's on the CPU: TensorBoard
event files written with `SummaryWriter`, then `extract_curve.extract`,
`package_parkour.merge_curves` and both `main`s in the two packages; the JSON
equal exactly.  The port packages a checkpoint file (`model_final.pt`), the
reference an orbax directory (`model_final.ckpt`)."""
import json
import os
import sys

import numpy as np
import pytest
from torch.utils.tensorboard import SummaryWriter

from legged_gym_custom_tpu.scripts import extract_curve as jextract_curve
from legged_gym_custom_tpu.scripts import package_parkour as jpackage_parkour
from legged_gym_custom_tpu_torch import LEGGED_GYM_TORCH_ROOT_DIR
from legged_gym_custom_tpu_torch.scripts import extract_curve, package_parkour

TAGS = ["Train/mean_reward", "Loss/value_function", "Perf/total_fps", "Episode/terrain_level",
        "Other/not_a_default_tag"]


def _run(path, seed, iterations, tags=TAGS):
    """A run directory with `iterations` scalars of each tag."""
    rng = np.random.default_rng(seed)
    writer = SummaryWriter(log_dir=str(path))
    for it in range(iterations):
        for tag in tags:
            writer.add_scalar(tag, float(rng.normal() * 100.0), it)
    writer.close()
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("runs")
    return [_run(d / "base", 0, 61), _run(d / "finetune", 1, 33), _run(d / "jump", 2, 27)]


@pytest.mark.parametrize("every", [1, 7, 25])
def test_extract_matches_reference(runs, every):
    got = extract_curve.extract(runs[0], every=every)
    ref = jextract_curve.extract(runs[0], every=every)
    assert json.dumps(got) == json.dumps(ref)
    assert list(got) == [t for t in extract_curve.DEFAULT_TAGS if t in TAGS]
    series = got["Train/mean_reward"]
    assert series[-1][0] == 60 and all(it % every == 0 for it, _ in series[:-1])


def test_extract_with_tags_and_main_match_reference(runs, tmp_path, monkeypatch):
    tags = ["Other/not_a_default_tag", "Missing/tag", "Train/mean_reward"]
    assert json.dumps(extract_curve.extract(runs[1], tags=tags, every=5)) == json.dumps(
        jextract_curve.extract(runs[1], tags=tags, every=5))
    argv = [runs[1], "--every", "4", "--tags", ",".join(tags)]
    monkeypatch.setattr(sys, "argv", ["extract_curve", argv[0], str(tmp_path / "j.json")]
                        + argv[1:])
    jextract_curve.main()
    extract_curve.main([argv[0], str(tmp_path / "t.json")] + argv[1:])
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


def test_merge_curves_matches_reference(runs):
    spec = [(runs[0], 0), (runs[1], 50), (runs[2], 80)]
    got = package_parkour.merge_curves(spec, every=10)
    assert json.dumps(got) == json.dumps(jpackage_parkour.merge_curves(spec, every=10))
    its = [it for it, _ in got["Train/mean_reward"]]
    assert its == sorted(set(its)) and its[-1] == 80 + 26


def test_package_parkour_writes_the_reference_curve_and_copies_the_pt(runs, tmp_path,
                                                                      monkeypatch):
    ckpt_dir = tmp_path / "orbax_ckpt"
    ckpt_dir.mkdir()
    (ckpt_dir / "params").write_bytes(b"jax")
    pt = tmp_path / "model_9.pt"
    pt.write_bytes(os.urandom(1024))
    spec = [f"{runs[0]}:0", f"{runs[2]}:61"]
    monkeypatch.setattr(sys, "argv", ["package_parkour", "--runs", *spec, "--ckpt",
                                      str(ckpt_dir), "--out", str(tmp_path / "j")])
    jpackage_parkour.main()
    package_parkour.main(["--runs", *spec, "--ckpt", str(pt), "--out", str(tmp_path / "t")])
    assert (tmp_path / "t" / "reward_curve.json").read_text() == \
        (tmp_path / "j" / "reward_curve.json").read_text()
    assert (tmp_path / "t" / "model_final.pt").read_bytes() == pt.read_bytes()
    assert (tmp_path / "j" / "model_final.ckpt" / "params").read_bytes() == b"jax"


def test_package_parkour_default_out_is_under_the_port_logs(runs, tmp_path, monkeypatch):
    """Without --out the artifact goes under the port's logs root (the
    reference writes the repository's trained/go2_parkour_tpu_r3)."""
    assert package_parkour.ROOT == LEGGED_GYM_TORCH_ROOT_DIR
    monkeypatch.setattr(package_parkour, "ROOT", str(tmp_path))
    pt = tmp_path / "model_3.pt"
    pt.write_bytes(b"pt")
    package_parkour.main(["--runs", f"{runs[0]}:0", "--ckpt", str(pt)])
    out = tmp_path / "logs" / "trained" / "go2_parkour"
    assert (out / "model_final.pt").read_bytes() == b"pt"
    assert "Train/mean_reward" in json.loads((out / "reward_curve.json").read_text())


def test_package_parkour_no_tag_message_is_none_in_both(tmp_path, monkeypatch):
    """package_parkour.py:57-61: the conditional binds looser than `+`, so
    with no tag extracted the whole SystemExit message is "none" (the
    reference's fault, kept); with other tags it names them."""
    empty = _run(tmp_path / "empty", 3, 0)
    other = _run(tmp_path / "other", 4, 3, tags=["Perf/total_fps"])
    for run, want in ((empty, "none"), (other, "Train/mean_reward not found in the given runs; "
                                              "extracted tags: Perf/total_fps")):
        monkeypatch.setattr(sys, "argv", ["package_parkour", "--runs", f"{run}:0", "--ckpt",
                                          "x", "--out", str(tmp_path / "j")])
        with pytest.raises(SystemExit) as ref:
            jpackage_parkour.main()
        with pytest.raises(SystemExit) as got:
            package_parkour.main(["--runs", f"{run}:0", "--ckpt", "x.pt", "--out",
                                  str(tmp_path / "t")])
        assert str(got.value) == str(ref.value) == want
