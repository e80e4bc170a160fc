"""Generate MuJoCo deploy scenes from this framework's terrain generator
(copy of legged_gym_custom_tpu/deploy/scene_gen.py over the port's
terrain/terrain.py).

The reference ships hand-made MuJoCo scenes (scene_flat / scene_terrain /
scene_stairs_*, resources/robots/go2/mujoco/) for its sim-to-sim oracle; it
has no way to carry a *training* terrain into the deploy loop.  Here the
terrain composer (terrain/terrain.py) is the single source of truth: any
generated course — in particular the parkour gap/hurdle courses — is exported
as a MuJoCo heightfield scene, so a trained parkour policy can be
evaluated in the oracle over the exact ground it trained (and recorded its
scan replay trace) on.

The scene XML declares an empty `<hfield nrow ncol>` asset; the exact float
elevation grid is stored in a sibling `<name>.hfield.npy` that
`mujoco_runner.load_scene` pours into `model.hfield_data` after load (no
8-bit PNG quantization of gap/hurdle edges).
"""
from __future__ import annotations

import os

import numpy as np

# Committed scenes carry this placeholder instead of an absolute checkout
# path; mujoco_runner.load_scene expands it from $LGC_REFERENCE_DIR at load
# time (default: this package's directory, mujoco_runner.DEFAULT_REFERENCE_DIR).
GO2_XML = "{REFERENCE_DIR}/resources/robots/go2/mujoco/go2.xml"

_SCENE_TEMPLATE = """<mujoco model="{name}">
  <include file="{robot_xml}"/>

  <statistic center="0 0 0.1" extent="0.8"/>

  <visual>
    <headlight diffuse="0.6 0.6 0.6" ambient="0.3 0.3 0.3" specular="0 0 0"/>
    <rgba haze="0.15 0.25 0.35 1"/>
    <global azimuth="-130" elevation="-20"/>
  </visual>

  <asset>
    <texture type="skybox" builtin="gradient" rgb1="0.3 0.5 0.7" rgb2="0 0 0" width="512" height="3072"/>
    <hfield name="terrain" nrow="{nrow}" ncol="{ncol}" size="{rx} {ry} {ztop} {zbot}"/>
  </asset>

  <worldbody>
    <light pos="0 0 1.5" dir="0 0 -1" directional="true"/>
    <geom name="terrain" type="hfield" hfield="terrain" pos="{px} {py} {pz}"
          friction="0.8 0.02 0.01"/>
  </worldbody>
</mujoco>
"""


def write_heightfield_scene(
    height_field_raw: np.ndarray,
    horizontal_scale: float,
    vertical_scale: float,
    spawn_xy: tuple,
    out_path: str,
    robot_xml: str = GO2_XML,
    name: str = "lgc_generated_scene",
    border_size: float = 0.0,
) -> str:
    """Write a MuJoCo scene whose heightfield reproduces `height_field_raw`.

    height_field_raw: (nx, ny) int16 grid, heights = raw * vertical_scale,
        world x = ix * horizontal_scale - border_size (the Terrain/Heightfield
        convention, reference legged_robot.py:1020-1021).
    spawn_xy: world-frame (x, y) (e.g. an env origin) that should land at
        MuJoCo world (0, 0) — the go2.xml home keyframe spawns the robot at
        the world origin, so the terrain is shifted under it rather than
        moving the robot.

    Returns out_path.  The elevation grid is written to
    `<out_path minus .xml>.hfield.npy` for load_scene's runtime fill.
    """
    h = np.asarray(height_field_raw, np.float64) * vertical_scale
    nx, ny = h.shape
    hmin, hmax = float(h.min()), float(h.max())
    ztop = max(hmax - hmin, 1e-3)

    # MuJoCo hfield layout: data[row, col] with col → x, row → y, normalized
    # to [0, 1]; heights span [0, ztop] above the geom frame.
    data = ((h - hmin) / ztop).T.astype(np.float32)  # (nrow=ny, ncol=nx)

    rx = (nx - 1) * horizontal_scale / 2.0
    ry = (ny - 1) * horizontal_scale / 2.0
    # world position of the grid center (pixel (nx-1)/2, (ny-1)/2)
    cx, cy = rx - border_size, ry - border_size
    sx, sy = spawn_xy
    px, py, pz = cx - sx, cy - sy, hmin

    base = out_path[:-4] if out_path.endswith(".xml") else out_path
    np.save(base + ".hfield.npy", data)
    xml = _SCENE_TEMPLATE.format(
        name=name,
        robot_xml=robot_xml
        if (os.path.isabs(robot_xml) or robot_xml.startswith("{REFERENCE_DIR}"))
        else os.path.relpath(robot_xml, os.path.dirname(os.path.abspath(out_path))),
        nrow=ny,
        ncol=nx,
        rx=rx,
        ry=ry,
        ztop=ztop,
        zbot=2.0,
        px=px,
        py=py,
        pz=pz,
    )
    with open(out_path, "w") as f:
        f.write(xml)
    return out_path


# The reference deploy plant's joint dynamics (go2.xml:9) and the deploy
# config's default angles (deploy_configs/go2.yaml), FL FR RL RR, hip thigh
# calf; the home keyframe's base height
GO2_JOINT_DYNAMICS = dict(joint_damping=0.1, joint_armature=0.01, joint_frictionloss=0.2)
GO2_DEFAULT_ANGLES = (0.1, 0.8, -1.5, -0.1, 0.8, -1.5, 0.1, 1.0, -1.5, -0.1, 1.0, -1.5)
HOME_Z = 0.36


def write_robot_scene(out_path: str, floor: bool = True) -> str:
    """Write a flat MuJoCo deploy scene of the synthetic Go2-shaped URDF,
    which has no MJCF of its own; the JAX package has no counterpart (its
    scenes include the reference's go2.xml, which is not in the repository).

    The scene is `RobotModel.to_mjcf(contact=True)` with the deploy plant's
    joint dynamics, plus what `mujoco_runner.run` reads: one `<motor>` per
    joint (it writes `ctrl`), the foot spheres named FL/FR/RL/RR (it records
    their contacts) and a home keyframe standing at HOME_Z on the default
    angles.  `floor=False` leaves out the ground plane, for a robot that a
    `write_heightfield_scene` scene includes as its `robot_xml`.  Returns
    out_path.
    """
    import xml.etree.ElementTree as ET

    from .. import SYNTHETIC_GO2_URDF
    from ..physics.urdf import load_urdf

    model = load_urdf(SYNTHETIC_GO2_URDF, "go2")
    root = ET.fromstring(model.to_mjcf(contact=True, **GO2_JOINT_DYNAMICS))
    if not floor:
        world = root.find("worldbody")
        world.remove(world.find("geom"))
    # a body's sphere elements are its geoms in index order
    bodies = {el.get("name"): el for el in root.iter("body")}
    for b, body in enumerate(model.body_names):
        spheres = [el for el in bodies[body] if el.tag == "geom"]
        links = [model.link_names[l] for l, gb in zip(model.geom_link, model.geom_body) if gb == b]
        for el, link in zip(spheres, links):
            if link.endswith("_foot"):
                el.set("name", link[: -len("_foot")])
    actuator = ET.SubElement(root, "actuator")
    for dof in model.dof_names:
        ET.SubElement(actuator, "motor", name=dof, joint=dof)
    qpos = [0.0, 0.0, HOME_Z, 1.0, 0.0, 0.0, 0.0, *GO2_DEFAULT_ANGLES]
    ET.SubElement(ET.SubElement(root, "keyframe"), "key", name="home",
                  qpos=" ".join(f"{x:.12g}" for x in qpos))
    with open(out_path, "w") as f:
        f.write(ET.tostring(root, encoding="unicode"))
    return out_path


def build_parkour_play_terrain(env_cfg, rng_seed: int = 0):
    """Build the 1x1 parkour course used for play/record/deploy.

    Shrinks the config to a single sub-terrain (the play.py override spirit,
    reference play.py:13-25) and returns (Terrain, spawn_xyz) where spawn is
    the course's env origin (start platform).
    """
    from ..terrain.terrain import Terrain

    cfg = env_cfg.terrain
    cfg.num_rows = 1
    cfg.num_cols = 1
    cfg.curriculum = False
    cfg.border_size = 5.0
    terrain = Terrain(cfg, num_robots=1, rng=np.random.default_rng(rng_seed))
    origin = terrain.env_origins[0, 0]
    return terrain, origin
