"""URDF -> RobotModel parser (numpy copy of legged_gym_custom_tpu/physics/urdf.py).

Fixed joints are folded into their moving parent body (mass properties
composed, collision geoms re-expressed in the parent frame); the original
link identity is kept per collision geom for contact reporting.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np

from .model import RobotModel, spheres_from_primitive


def _vec(s: str | None, default="0 0 0") -> np.ndarray:
    return np.array([float(x) for x in (s or default).split()])


def _rpy_matrix(rpy: np.ndarray) -> np.ndarray:
    """URDF rpy -> rotation matrix R_{parent<-child} (fixed-axis x,y,z)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def load_urdf(path: str, name: str = "robot") -> RobotModel:
    root = ET.parse(path).getroot()

    links: Dict[str, ET.Element] = {l.get("name"): l for l in root.findall("link")}
    joints = root.findall("joint")
    child_of = {}
    for j in joints:
        child_of[j.find("child").get("link")] = j
    # Root link: the one that is never a child.
    root_link = next(n for n in links if n not in child_of)

    children: Dict[str, List[ET.Element]] = {n: [] for n in links}
    for j in joints:
        children[j.find("parent").get("link")].append(j)

    # ---- enumerate moving bodies in URDF document order (matches Isaac's
    # dof ordering: FL_hip, FL_thigh, FL_calf, FR_*, RL_*, RR_* for Go2) ----
    body_names: List[str] = [root_link]
    parent: List[int] = [-1]
    joint_rot: List[np.ndarray] = [np.eye(3)]
    joint_pos: List[np.ndarray] = [np.zeros(3)]
    joint_axis: List[np.ndarray] = [np.zeros(3)]
    dof_names: List[str] = []
    limits: List[tuple] = []
    # link -> (moving body idx, R_{body<-link}... stored as R_bl with
    # p_l_in_body) pose of the link frame in its moving body's frame
    link_pose: Dict[str, tuple] = {root_link: (0, np.eye(3), np.zeros(3))}

    def visit(link_name: str):
        for j in children[link_name]:
            jtype = j.get("type")
            child = j.find("child").get("link")
            o = j.find("origin")
            xyz = _vec(o.get("xyz") if o is not None else None)
            rpy = _vec(o.get("rpy") if o is not None else None)
            R_pc = _rpy_matrix(rpy)  # child frame expressed in parent frame
            mb, R_bp, p_bp = link_pose[link_name]
            if jtype in ("revolute", "continuous", "prismatic"):
                if jtype == "prismatic":
                    raise NotImplementedError("prismatic joints not yet supported")
                body_idx = len(body_names)
                body_names.append(child)
                parent.append(mb)
                # Joint placement composes the (possibly folded) link offset:
                # child frame in parent *moving body* coordinates.
                joint_pos.append(p_bp + R_bp @ xyz)
                # E = R_{child<-parent_body} at q=0
                joint_rot.append((R_bp @ R_pc).T)
                ax = _vec(j.find("axis").get("xyz")) if j.find("axis") is not None else np.array([1.0, 0, 0])
                joint_axis.append(ax / np.linalg.norm(ax))
                dof_names.append(j.get("name"))
                lim = j.find("limit")
                limits.append(
                    (
                        float(lim.get("lower", "-1e9")) if lim is not None else -1e9,
                        float(lim.get("upper", "1e9")) if lim is not None else 1e9,
                        float(lim.get("velocity", "1e9")) if lim is not None else 1e9,
                        float(lim.get("effort", "1e9")) if lim is not None else 1e9,
                    )
                )
                link_pose[child] = (body_idx, np.eye(3), np.zeros(3))
            elif jtype == "fixed":
                # Fold into the moving parent: pose of child link in mb frame.
                R_bl = R_bp @ R_pc
                p_bl = p_bp + R_bp @ xyz
                link_pose[child] = (mb, R_bl, p_bl)
            else:
                raise NotImplementedError(f"joint type {jtype}")
            visit(child)

    visit(root_link)

    nb = len(body_names)
    mass = np.zeros(nb)
    h = np.zeros((nb, 3))  # mass * com accumulator
    I_o = np.zeros((nb, 3, 3))  # inertia about moving-body origin accumulator

    def hat(v):
        return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])

    geom_body, geom_pos, geom_radius, geom_link = [], [], [], []
    link_names: List[str] = []
    link_body_l: List[int] = []
    link_pos_l: List[np.ndarray] = []

    for lname, link in links.items():
        if lname not in link_pose:
            continue  # unreachable link
        mb, R_bl, p_bl = link_pose[lname]
        inr = link.find("inertial")
        if inr is not None:
            m = float(inr.find("mass").get("value"))
            io = inr.find("origin")
            c_l = _vec(io.get("xyz") if io is not None else None)
            R_ic = _rpy_matrix(_vec(io.get("rpy") if io is not None else None))
            Ie = inr.find("inertia")
            I_c = np.array(
                [
                    [float(Ie.get("ixx")), float(Ie.get("ixy")), float(Ie.get("ixz"))],
                    [float(Ie.get("ixy")), float(Ie.get("iyy")), float(Ie.get("iyz"))],
                    [float(Ie.get("ixz")), float(Ie.get("iyz")), float(Ie.get("izz"))],
                ]
            )
            # inertia tensor in body-frame axes, about the com
            I_b = (R_bl @ R_ic) @ I_c @ (R_bl @ R_ic).T
            c_b = p_bl + R_bl @ c_l  # com in moving-body frame
            mass[mb] += m
            h[mb] += m * c_b
            cx = hat(c_b)
            I_o[mb] += I_b + m * (cx @ cx.T)
        cols = link.findall("collision")
        if cols:
            link_id = len(link_names)
            link_names.append(lname)
            link_body_l.append(mb)
            link_pos_l.append(p_bl)
            for col in cols:
                o = col.find("origin")
                xyz = _vec(o.get("xyz") if o is not None else None)
                rpy = _vec(o.get("rpy") if o is not None else None)
                R_lc = _rpy_matrix(rpy)
                geo = col.find("geometry")
                for prim in geo:
                    if prim.tag == "mesh":
                        continue  # meshes are visual-grade; skip for contact
                    spheres = spheres_from_primitive(prim.tag, prim.attrib)
                    for s in spheres:
                        center_l = xyz + R_lc @ s[:3]
                        center_b = p_bl + R_bl @ center_l
                        geom_body.append(mb)
                        geom_pos.append(center_b)
                        geom_radius.append(s[3])
                        geom_link.append(link_id)

    com = np.where(mass[:, None] > 0, h / np.maximum(mass[:, None], 1e-12), 0.0)
    inertia_com = np.zeros((nb, 3, 3))
    for i in range(nb):
        cx = hat(com[i])
        inertia_com[i] = I_o[i] - mass[i] * (cx @ cx.T)

    lim = np.array(limits) if limits else np.zeros((0, 4))
    return RobotModel(
        nb=nb,
        parent=np.array(parent, dtype=np.int32),
        joint_rot=np.stack(joint_rot),
        joint_pos=np.stack(joint_pos),
        joint_axis=np.stack(joint_axis),
        mass=mass,
        com=com,
        inertia_com=inertia_com,
        dof_names=dof_names,
        dof_pos_limits=lim[:, 0:2].copy() if len(limits) else np.zeros((0, 2)),
        dof_vel_limits=lim[:, 2].copy() if len(limits) else np.zeros(0),
        dof_effort_limits=lim[:, 3].copy() if len(limits) else np.zeros(0),
        geom_body=np.array(geom_body, dtype=np.int32),
        geom_pos=np.stack(geom_pos) if geom_pos else np.zeros((0, 3)),
        geom_radius=np.array(geom_radius),
        geom_link=np.array(geom_link, dtype=np.int32),
        link_names=link_names,
        link_body=np.array(link_body_l, dtype=np.int32),
        link_pos=np.stack(link_pos_l) if link_pos_l else np.zeros((0, 3)),
        body_names=body_names,
        name=name,
    )
