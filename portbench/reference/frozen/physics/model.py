"""Static robot model (numpy copy of legged_gym_custom_tpu/physics/model.py).

The URDF is parsed once (physics/urdf.py) into a `RobotModel` of plain numpy
arrays: kinematic tree, spatial inertias, joint limits and a sphere-set
collision model.  Per-geom ``link`` labels keep the original URDF link names
so feet / penalized / termination bodies resolve by name substring as in the
reference.  `RobotModel.to_mjcf` (copied verbatim) writes the equivalent
MuJoCo model, the independent oracle of the dynamics and of the deploy loop.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Immutable articulated-body model (floating base + 1-DOF joints).

    Body 0 is the floating base; body i >= 1 has one revolute joint whose
    dof index is i-1.
    """

    nb: int
    parent: np.ndarray            # (nb,) int, parent[0] = -1
    joint_rot: np.ndarray         # (nb,3,3) E = R_{child<-parent} at q=0
    joint_pos: np.ndarray         # (nb,3) joint origin in parent frame
    joint_axis: np.ndarray        # (nb,3) rotation axis in child frame
    mass: np.ndarray              # (nb,)
    com: np.ndarray               # (nb,3) center of mass in body frame
    inertia_com: np.ndarray       # (nb,3,3) rotational inertia about com
    dof_names: List[str]
    dof_pos_limits: np.ndarray    # (nv,2)
    dof_vel_limits: np.ndarray    # (nv,)
    dof_effort_limits: np.ndarray  # (nv,)
    geom_body: np.ndarray         # (ng,) moving body index of each sphere
    geom_pos: np.ndarray          # (ng,3) sphere center in body frame
    geom_radius: np.ndarray       # (ng,)
    geom_link: np.ndarray         # (ng,) index into link_names
    link_names: List[str]
    link_body: np.ndarray         # (n_links,)
    link_pos: np.ndarray          # (n_links,3) link-frame origin in body frame
    body_names: List[str]
    name: str = "robot"

    @property
    def nv(self) -> int:
        return 6 + self.nb - 1

    @property
    def num_dof(self) -> int:
        return self.nb - 1

    @property
    def ng(self) -> int:
        return len(self.geom_radius)

    @property
    def n_links(self) -> int:
        return len(self.link_names)

    def link_ids_matching(self, substrings) -> np.ndarray:
        """Indices of report links whose name contains any given substring."""
        if isinstance(substrings, str):
            substrings = [substrings]
        return np.array(
            [i for i, n in enumerate(self.link_names) if any(s in n for s in substrings)],
            dtype=np.int32,
        )

    def dof_ids_matching(self, substrings) -> np.ndarray:
        if isinstance(substrings, str):
            substrings = [substrings]
        return np.array(
            [i for i, n in enumerate(self.dof_names) if any(s in n for s in substrings)],
            dtype=np.int32,
        )

    # ------------------------------------------------------------------
    # MJCF export — lets tests build an *equivalent* MuJoCo model so the TPU
    # dynamics can be validated step-by-step against the oracle (SURVEY §4).
    # ------------------------------------------------------------------
    def to_mjcf(self, contact: bool = False, friction: float = 1.0,
                timestep: float = 0.005, joint_damping=0.0,
                joint_armature=0.0, joint_frictionloss=0.0) -> str:
        """Equivalent MJCF. contact=False (dynamics-only oracle) disables all
        collisions; contact=True adds a ground plane + sphere contacts so the
        full stepping pipeline can be compared sim-to-sim.

        joint_damping / joint_armature / joint_frictionloss (scalar or
        per-dof) mirror the reference deploy plant's per-joint dynamics
        (go2.xml:9: damping=0.1 armature=0.01 frictionloss=0.2) so parity
        tests can compare against the *full* plant, not a zeroed one."""
        import xml.etree.ElementTree as ET

        def fmt(a):
            return " ".join(f"{x:.12g}" for x in np.asarray(a).ravel())

        root = ET.Element("mujoco", model=self.name)
        ET.SubElement(root, "option", timestep=f"{timestep}", integrator="Euler")
        ET.SubElement(
            root, "compiler", angle="radian", inertiafromgeom="false", balanceinertia="false"
        )
        world = ET.SubElement(root, "worldbody")
        if contact:
            ET.SubElement(
                world, "geom", type="plane", size="50 50 1", pos="0 0 0",
                friction=f"{friction} 0.005 0.0001", contype="1", conaffinity="1",
            )

        def mat_to_quat(E):
            # E = R_{child<-parent}; MuJoCo wants body quat = R_{parent<-child}
            R = E.T
            tr = np.trace(R)
            if tr > 0:
                s = np.sqrt(tr + 1.0) * 2
                q = np.array(
                    [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
                )
            else:
                i = int(np.argmax(np.diag(R)))
                j, k = (i + 1) % 3, (i + 2) % 3
                s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
                q = np.zeros(4)
                q[0] = (R[k, j] - R[j, k]) / s
                q[1 + i] = 0.25 * s
                q[1 + j] = (R[j, i] + R[i, j]) / s
                q[1 + k] = (R[k, i] + R[i, k]) / s
            return q / np.linalg.norm(q)

        elems = {}
        for i in range(self.nb):
            parent_el = world if self.parent[i] < 0 else elems[self.parent[i]]
            body = ET.SubElement(
                parent_el,
                "body",
                name=self.body_names[i],
                pos=fmt(self.joint_pos[i]),
                quat=fmt(mat_to_quat(self.joint_rot[i])),
            )
            elems[i] = body
            ET.SubElement(
                body,
                "inertial",
                pos=fmt(self.com[i]),
                mass=f"{self.mass[i]:.12g}",
                fullinertia=fmt(
                    [
                        self.inertia_com[i][0, 0],
                        self.inertia_com[i][1, 1],
                        self.inertia_com[i][2, 2],
                        self.inertia_com[i][0, 1],
                        self.inertia_com[i][0, 2],
                        self.inertia_com[i][1, 2],
                    ]
                ),
            )
            if i == 0:
                ET.SubElement(body, "freejoint", name="root")
            else:
                per_dof = lambda v: float(np.broadcast_to(
                    np.asarray(v, np.float64), (self.nb - 1,))[i - 1])
                ET.SubElement(
                    body,
                    "joint",
                    name=self.dof_names[i - 1],
                    type="hinge",
                    axis=fmt(self.joint_axis[i]),
                    limited="false",
                    damping=f"{per_dof(joint_damping):.12g}",
                    armature=f"{per_dof(joint_armature):.12g}",
                    frictionloss=f"{per_dof(joint_frictionloss):.12g}",
                )
        for g in range(self.ng):
            ET.SubElement(
                elems[self.geom_body[g]],
                "geom",
                type="sphere",
                size=f"{self.geom_radius[g]:.12g}",
                pos=fmt(self.geom_pos[g]),
                contype="1" if contact else "0",
                conaffinity="0",
                mass="0",
            )
        return ET.tostring(root, encoding="unicode")


_MAX_SPHERES_PER_AXIS = 3


def _axis_centers(extent: float, r: float) -> np.ndarray:
    """Sphere center offsets covering a 1-D extent with spheres of radius r."""
    half = extent / 2.0 - r
    if half <= 1e-6:
        return np.array([0.0])
    n = int(np.clip(round(extent / (2.0 * r)), 1, _MAX_SPHERES_PER_AXIS))
    if n == 1:
        return np.array([0.0])
    return np.linspace(-half, half, n)


def spheres_from_primitive(kind: str, params: dict) -> np.ndarray:
    """Approximate a URDF collision primitive by spheres in its local frame.

    Returns (n, 4) array of [x, y, z, radius].
    """
    if kind == "sphere":
        r = float(params["radius"])
        return np.array([[0.0, 0.0, 0.0, r]])
    if kind == "cylinder":
        r = float(params["radius"])
        length = float(params["length"])
        zs = _axis_centers(length, r)
        return np.array([[0.0, 0.0, z, r] for z in zs])
    if kind == "box":
        sx, sy, sz = [float(v) for v in params["size"].split()]
        r = min(sx, sy, sz) / 2.0
        xs, ys, zs = _axis_centers(sx, r), _axis_centers(sy, r), _axis_centers(sz, r)
        return np.array([[x, y, z, r] for x in xs for y in ys for z in zs])
    raise ValueError(f"unsupported collision primitive: {kind}")
