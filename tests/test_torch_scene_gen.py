"""The port's MuJoCo scene generation and `scripts.make_gap_scene`, on the CPU.

  * `scripts.make_gap_scene` writes the XML, `.hfield.npy` and `.meta.json`
    of the JAX tool, byte for byte, for the go2_parkour_commit gap course, and
    the committed trained/go2_parkour_tpu_r5 scene is that output;
  * the meta file keeps the JAX tool's gap edges, near x and far x + w, while
    the generator centres each gap on x (terrain/primitives.py), so the
    heightfield's gap spans x -+ w / 2: pinned here, listed in ROADMAP Queue C;
  * `scene_gen.write_heightfield_scene` equals JAX's, and MuJoCo ray heights
    over the scene equal the int16 grid within 1e-3 (tests/test_scene_gen.py:28);
  * a robot spawned by its home keyframe on the generated course comes to
    rest on the start platform (tests/test_scene_gen.py:71, whose go2.xml is
    not in this repository: here the synthetic Go2 of `write_robot_scene`).
"""
import json
import sys

import mujoco
import numpy as np
import pytest

from legged_gym_custom_tpu.deploy import scene_gen as jscene_gen
from legged_gym_custom_tpu.envs import task_registry as jregistry
from legged_gym_custom_tpu.scripts import make_gap_scene as jmake_gap_scene
from legged_gym_custom_tpu_torch import LEGGED_GYM_TORCH_ROOT_DIR
from legged_gym_custom_tpu_torch.deploy import scene_gen
from legged_gym_custom_tpu_torch.deploy.mujoco_runner import load_scene
from legged_gym_custom_tpu_torch.envs import task_registry
from legged_gym_custom_tpu_torch.scripts import make_gap_scene

TRAINED_GAP = f"{LEGGED_GYM_TORCH_ROOT_DIR}/trained/go2_parkour_tpu_r5/gap_scene"


def _files(base):
    return [open(base + ext, "rb").read() for ext in (".xml", ".hfield.npy", ".meta.json")]


@pytest.fixture(scope="module")
def gap_scenes(tmp_path_factory):
    """Both tools' default gap course (0.3 m gaps, go2_parkour_commit)."""
    out = tmp_path_factory.mktemp("gap")
    make_gap_scene.main(["--out", str(out / "port.xml")])
    argv = sys.argv
    sys.argv = ["make_gap_scene", "--out", str(out / "jax.xml")]
    try:
        jmake_gap_scene.main()
    finally:
        sys.argv = argv
    return str(out / "port"), str(out / "jax")


def test_make_gap_scene_matches_reference_and_committed_scene(gap_scenes):
    port, jax_ = gap_scenes
    assert _files(port) == _files(jax_)
    assert _files(port) == _files(TRAINED_GAP)


def test_gap_meta_edges_keep_the_reference_formula(gap_scenes, tmp_path, monkeypatch):
    """The meta's near edge is x - 2 m and its far edge x + w - 2 m (the robot
    starts 2 m onto the platform): the JAX tool's formula, kept so that both
    tools' files agree.  The generator centres each gap on x and cuts
    `round(w / hs) // 2` cells to each side, so in MuJoCo the meta's near edge
    is inside the gap and the ground resumes at x + (round(w / hs) // 2) hs,
    short of the far edge the meta names.  The scene's `{REFERENCE_DIR}`
    robot include is served by a generated robot."""
    port, _ = gap_scenes
    mjcf_dir = tmp_path / "resources" / "robots" / "go2" / "mujoco"
    mjcf_dir.mkdir(parents=True)
    scene_gen.write_robot_scene(str(mjcf_dir / "go2.xml"), floor=False)
    monkeypatch.setenv("LGC_REFERENCE_DIR", str(tmp_path))
    meta = json.load(open(port + ".meta.json"))
    w, xs = meta["gap_width"], [5.0 + 3.5 * k for k in range(meta["n_gaps"])]
    assert meta["gap_near_edges_mj"] == [round(x - 2.0, 3) for x in xs]
    assert meta["gap_far_edges_mj"] == [round(x + w - 2.0, 3) for x in xs]
    hs = task_registry.get_cfgs("go2_parkour_commit")[0].terrain.horizontal_scale
    lip = round(w / hs) // 2 * hs          # ground resumes this far past the centre
    m = load_scene(port + ".xml")
    d = mujoco.MjData(m)
    mujoco.mj_forward(m, d)
    for near, far in zip(meta["gap_near_edges_mj"], meta["gap_far_edges_mj"]):
        assert _probe_height(m, d, near, 0.0) < -1.0
        beyond = [_probe_height(m, d, x, 0.0) for x in np.linspace(near + lip + 0.01, far, 9)]
        assert np.abs(beyond).max() < 1e-3, beyond
        assert far - (near + lip) == pytest.approx(0.2)


def _probe_height(m, d, x, y):
    """Ray cast straight down from 5 m onto static geoms: the hit's z."""
    geomid = np.zeros(1, np.int32)
    dist = mujoco.mj_ray(m, d, np.array([x, y, 5.0]), np.array([0.0, 0.0, -1.0]), None, 1, -1,
                         geomid)
    assert dist >= 0, f"no terrain hit at ({x}, {y})"
    return 5.0 - dist


def test_parkour_scene_matches_reference_and_grid(tmp_path):
    env_cfg, _ = task_registry.get_cfgs("go2_parkour")
    terrain, origin = scene_gen.build_parkour_play_terrain(env_cfg, rng_seed=0)
    jenv_cfg, _ = jregistry.get_cfgs("go2_parkour")
    jterrain, jorigin = jscene_gen.build_parkour_play_terrain(jenv_cfg, rng_seed=0)
    assert np.array_equal(terrain.height_field_raw, jterrain.height_field_raw)
    assert np.array_equal(origin, jorigin)
    hf = terrain.height_field_raw
    hs, vs, border = (terrain.cfg.horizontal_scale, terrain.cfg.vertical_scale,
                      terrain.cfg.border_size)
    robot = scene_gen.write_robot_scene(str(tmp_path / "robot.xml"), floor=False)
    args = (hf, hs, vs, (origin[0], origin[1]))
    out = scene_gen.write_heightfield_scene(*args, str(tmp_path / "scene.xml"),
                                            robot_xml=robot, border_size=border)
    ref = jscene_gen.write_heightfield_scene(*args, str(tmp_path / "ref.xml"),
                                             robot_xml=robot, border_size=border)
    assert open(out).read() == open(ref).read()
    assert np.array_equal(np.load(str(tmp_path / "scene.hfield.npy")),
                          np.load(str(tmp_path / "ref.hfield.npy")))
    # the default robot include keeps the {REFERENCE_DIR} placeholder
    scene_gen.write_heightfield_scene(*args, str(tmp_path / "default.xml"), border_size=border)
    assert '<include file="{REFERENCE_DIR}/resources/robots/go2/mujoco/go2.xml"/>' in \
        open(tmp_path / "default.xml").read()

    m = load_scene(out)
    assert m.nhfield == 1
    d = mujoco.MjData(m)
    mujoco.mj_forward(m, d)
    # away from the robot at the world origin: run-up platform, the first gap
    # (x_positions[0] = 5, depth -2) and the ground after it
    for wx in [1.0, 2.0, 5.0, 6.0, 8.5]:
        ix = int(round((wx + origin[0] + border) / hs))
        iy = int(round((0.0 + origin[1] + border) / hs))
        z_grid = hf[ix, iy] * vs
        z_mj = _probe_height(m, d, wx, 0.0)
        assert abs(z_mj - z_grid) < 1e-3, f"x={wx}: mj {z_mj} vs grid {z_grid}"
    gap = hf[int(round((5.0 + origin[0] + border) / hs)), int(round((origin[1] + border) / hs))]
    assert min(gap * vs, 0.0) < -1.0


def test_scene_robot_spawns_on_platform(tmp_path):
    """The home keyframe on the generated course puts the robot on solid
    ground: unactuated for 200 steps, the legs fold but the body rests on the
    start platform, not in a gap (bottom at -2 m) or through the field."""
    env_cfg, _ = task_registry.get_cfgs("go2_parkour")
    terrain, origin = scene_gen.build_parkour_play_terrain(env_cfg, rng_seed=0)
    spawn = (origin[0] + env_cfg.init_state.pos[0], origin[1])
    out = scene_gen.write_heightfield_scene(
        terrain.height_field_raw, terrain.cfg.horizontal_scale, terrain.cfg.vertical_scale,
        spawn, str(tmp_path / "scene.xml"),
        robot_xml=scene_gen.write_robot_scene(str(tmp_path / "robot.xml"), floor=False),
        border_size=terrain.cfg.border_size)
    m = load_scene(out)
    d = mujoco.MjData(m)
    mujoco.mj_resetDataKeyframe(m, d, 0)
    for _ in range(200):
        mujoco.mj_step(m, d)
    assert d.qpos[2] > 0.03, f"robot fell through terrain: z={d.qpos[2]:.3f}"
