"""MuJoCo sim-to-sim deploy loop (copy of
legged_gym_custom_tpu/deploy/mujoco_runner.py, reference
deploy/deploy_mujoco/deploy_mujoco.py).

500 Hz `mj_step` + 50 Hz policy, PD torques recomputed at sim rate
(deploy_mujoco.py:56-59, 110-117), optional viewer + real-time pacing, gamepad
or scripted commands.  This is the parity oracle for the engine (SURVEY §2.4,
BASELINE.md): trained policies must control the MuJoCo Go2 the same way they
control the training sim.  `mujoco` is imported by the functions that use it.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np

from .config_parser import ConfigParser
from .controller import BaseController

# `{REFERENCE_DIR}` of generated scenes when $LGC_REFERENCE_DIR is unset
DEFAULT_REFERENCE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_scene(xml_path: str):
    """Load a MuJoCo scene, stubbing visual meshes that are missing on disk.

    The reference asset tree references a few .obj visual meshes that are not
    shipped (e.g. go2 base_4.obj); physics is unaffected, so missing files get
    a degenerate triangle stub via the assets VFS.

    Scenes generated by deploy/scene_gen.py reference the robot model through
    a `{REFERENCE_DIR}` placeholder, expanded here from $LGC_REFERENCE_DIR, so
    committed scenes are not tied to one machine's absolute checkout path.
    The default is this package's directory, whose resources/ tree holds no
    go2.xml unless one is written there (`scene_gen.write_robot_scene(
    <dir>/resources/robots/go2/mujoco/go2.xml, floor=False)`); the JAX
    package's default is its reference asset checkout.
    """
    import re
    import tempfile

    import mujoco

    raw = open(xml_path).read()
    if "{REFERENCE_DIR}" in raw:
        expanded = raw.replace(
            "{REFERENCE_DIR}",
            os.environ.get("LGC_REFERENCE_DIR", DEFAULT_REFERENCE_DIR),
        )
        # keep the temp file next to the original so any relative includes
        # still resolve (the .hfield.npy sibling is resolved from the
        # ORIGINAL path below, so it survives either temp location); on a
        # read-only checkout / installed package fall back to the system
        # temp dir — generated scenes only carry the absolute
        # {REFERENCE_DIR} include, which resolves from anywhere
        try:
            fd, tmp = tempfile.mkstemp(
                suffix=".xml", dir=os.path.dirname(os.path.abspath(xml_path))
            )
        except OSError:
            fd, tmp = tempfile.mkstemp(suffix=".xml")
        with os.fdopen(fd, "w") as f:
            f.write(expanded)
        try:
            model = load_scene(tmp)
        finally:
            os.unlink(tmp)
        npy = (xml_path[:-4] if xml_path.endswith(".xml") else xml_path) + ".hfield.npy"
        if model.nhfield > 0 and os.path.exists(npy):
            import numpy as _np

            data = _np.load(npy).astype(_np.float32).ravel()
            if data.size != model.hfield_data.size:
                raise ValueError(
                    f"hfield npy size {data.size} != model "
                    f"{model.hfield_data.size} ({npy} drifted from {xml_path})"
                )
            model.hfield_data[:] = data
        return model

    root = os.path.dirname(xml_path)
    assets = {}
    stub = b"v 0 0 0\nv 0 0.001 0\nv 0.001 0 0\nv 0 0 0.001\nf 1 2 3\nf 1 2 4\n"
    # collect mesh file references from the xml and any includes
    todo = [xml_path]
    seen = set()
    meshdir = "assets"
    while todo:
        p = todo.pop()
        if p in seen or not os.path.exists(p):
            continue
        seen.add(p)
        text = open(p).read()
        m = re.search(r'meshdir="([^"]+)"', text)
        if m:
            meshdir = m.group(1)
        for inc in re.findall(r'<include\s+file="([^"]+)"', text):
            todo.append(os.path.join(root, inc))
        for fname in re.findall(r'file="([^"]+\.(?:obj|stl|png))"', text):
            full = os.path.join(root, meshdir, fname)
            if not os.path.exists(full):
                full = os.path.join(root, fname)
            if os.path.exists(full):
                assets[fname] = open(full, "rb").read()
            elif fname.endswith((".obj", ".stl")):
                assets[fname] = stub
    model = mujoco.MjModel.from_xml_path(xml_path, assets=assets or None)
    # Scenes generated by deploy/scene_gen.py declare an empty hfield and ship
    # the exact float elevation grid in a sibling .hfield.npy (no PNG
    # quantization); pour it into the model after load.
    npy = (xml_path[:-4] if xml_path.endswith(".xml") else xml_path) + ".hfield.npy"
    if model.nhfield > 0 and os.path.exists(npy):
        import numpy as _np

        data = _np.load(npy).astype(_np.float32).ravel()
        if data.size != model.hfield_data.size:
            # Never fall through silently: a flat (all-zero) heightfield would
            # make terrain acceptance tests pass trivially.
            raise ValueError(
                f"hfield npy size {data.size} != model {model.hfield_data.size} "
                f"({npy} drifted from {xml_path})"
            )
        model.hfield_data[:] = data
    return model


class MujocoController(BaseController):
    """Sim-to-sim controller reading state from MuJoCo (deploy_mujoco.py:13-59)."""

    def __init__(self, cfg: ConfigParser, bundle_path: str, mj_model, mj_data,
                 command_source: Optional[Callable[[], np.ndarray]] = None,
                 scan_trace_path: Optional[str] = None):
        super().__init__(cfg, bundle_path, scan_trace_path)
        self.mj_model = mj_model
        self.mj_data = mj_data
        self.command_source = command_source or (lambda: np.zeros(3, np.float32))

    def _refresh_robot_states(self):
        d = self.mj_data
        self.qj = d.qpos[7:].astype(np.float32).copy()
        self.dqj = d.qvel[6:].astype(np.float32).copy()
        self.base_quat = d.qpos[3:7].astype(np.float32).copy()  # wxyz
        # gyro: world angular velocity rotated into the base frame
        w, x, y, z = self.base_quat
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        omega_world = R @ d.qvel[3:6]  # free joint ang vel is body-frame
        self.ang_vel = (R.T @ omega_world).astype(np.float32)  # = qvel[3:6]
        self.cmd = self.get_smoothed_command(
            np.asarray(self.command_source(), np.float32), 0.1
        )

    def compute_torques(self) -> np.ndarray:
        """PD at sim rate toward target_dof_pos (deploy_mujoco.py:56-59)."""
        q = self.mj_data.qpos[7:]
        dq = self.mj_data.qvel[6:]
        return self.cfg.kps * (self.target_dof_pos - q) - self.cfg.kds * dq


def run(cfg: ConfigParser, bundle_path: str, duration_s: float = 10.0,
        viewer: bool = False, realtime: bool = False,
        command_source=None, scan_trace_path=None, keyframe: int = 0,
        on_control_step=None):
    """Headless-able main loop (deploy_mujoco.py:62-127).

    `on_control_step(controller, mj_data)`, if given, runs before every 50 Hz
    controller tick — a scripted stand-in for the human operator (e.g. press
    the jump button that arms the fake-scan replay when the robot nears an
    obstacle, the role the gamepad plays in the reference deploy loop).

    Returns the recorded (time, qpos, ctrl, target_dof_pos) trajectory for
    parity checks.
    """
    import mujoco

    mj_model = load_scene(cfg.xml_path)
    mj_data = mujoco.MjData(mj_model)
    mj_model.opt.timestep = cfg.simulation_dt
    if mj_model.nkey > keyframe:
        mujoco.mj_resetDataKeyframe(mj_model, mj_data, keyframe)

    controller = MujocoController(
        cfg, bundle_path, mj_model, mj_data, command_source, scan_trace_path
    )
    v = None
    if viewer:
        import mujoco.viewer as mj_viewer

        v = mj_viewer.launch_passive(mj_model, mj_data)

    # foot geoms (go2.xml names its collision feet FL/FR/RL/RR) for
    # flight-phase detection in the oracle acceptance tests
    foot_geoms = []
    for nm in ("FL", "FR", "RL", "RR"):
        gid = mujoco.mj_name2id(mj_model, mujoco.mjtObj.mjOBJ_GEOM, nm)
        if gid >= 0:
            foot_geoms.append(gid)
    traj = {"t": [], "qpos": [], "ctrl": [], "target": [], "foot_contact": []}
    n_steps = int(duration_s / cfg.simulation_dt)
    counter = 0
    t_start = time.time()
    for i in range(n_steps):
        step_start = time.time()
        if counter % cfg.control_decimation == 0:
            if on_control_step is not None:
                on_control_step(controller, mj_data)
            controller.step(mj_data.time)
        mj_data.ctrl[:] = controller.compute_torques()
        mujoco.mj_step(mj_model, mj_data)
        counter += 1
        traj["t"].append(mj_data.time)
        traj["qpos"].append(mj_data.qpos.copy())
        traj["ctrl"].append(mj_data.ctrl.copy())
        traj["target"].append(controller.target_dof_pos.copy())
        contact = np.zeros(max(len(foot_geoms), 1), bool)
        for ci in range(mj_data.ncon):
            c = mj_data.contact[ci]
            for fi, gid in enumerate(foot_geoms):
                if c.geom1 == gid or c.geom2 == gid:
                    contact[fi] = True
        traj["foot_contact"].append(contact)
        if v is not None:
            v.sync()
        if realtime:
            leftover = cfg.simulation_dt - (time.time() - step_start)
            if leftover > 0:
                time.sleep(leftover)
    if v is not None:
        v.close()
    return {k: np.asarray(vv) for k, vv in traj.items()}


def main(argv=None):
    """CLI mirror of the reference's deploy_mujoco.py entry (its __main__ takes
    a yaml config and opens the viewer; here --headless/--seconds make the
    same loop scriptable for CI and benches)."""
    import argparse

    ap = argparse.ArgumentParser("legged_gym_custom_tpu_torch mujoco deploy")
    ap.add_argument("--config", default="deploy_configs/go2.yaml")
    ap.add_argument("--bundle", default=None,
                    help="policy bundle .npz (default: config's bundle_path)")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--headless", action="store_true")
    ap.add_argument("--realtime", action="store_true")
    ap.add_argument("--cmd", type=float, nargs=3, default=[0.8, 0.0, 0.0],
                    metavar=("VX", "VY", "WZ"),
                    help="fixed command when no gamepad is attached")
    ap.add_argument("--scan_trace", default=None)
    ap.add_argument("--root", default=None,
                    help="root dir for {LEGGED_GYM_ROOT_DIR} expansion in the "
                    "config (default: the repo root)")
    args = ap.parse_args(argv)

    from legged_gym_custom_tpu_torch import LEGGED_GYM_TORCH_ROOT_DIR

    cfg = ConfigParser(args.config, root_dir=args.root or LEGGED_GYM_TORCH_ROOT_DIR)
    bundle = args.bundle or cfg.bundle_path
    cmd = np.asarray(args.cmd, np.float32)
    traj = run(
        cfg, bundle, duration_s=args.seconds, viewer=not args.headless,
        realtime=args.realtime, command_source=lambda: cmd,
        scan_trace_path=args.scan_trace,
    )
    qpos = traj["qpos"]
    dx = qpos[-1, 0] - qpos[0, 0]
    dy = qpos[-1, 1] - qpos[0, 1]
    print(
        f"ran {args.seconds:.1f}s: dx={dx:.3f} m dy={dy:.3f} m "
        f"min_z={qpos[:, 2].min():.3f} final_z={qpos[-1, 2]:.3f}"
    )


if __name__ == "__main__":
    main()
