"""Featherstone forward kinematics and the articulated rigid-body algorithms
(RNEA / CRBA / ABA), torch port of legged_gym_custom_tpu/physics/algorithms.py.

Layout is component-major with a trailing batch (physics/soa.py): quats
(4,)+bs, vectors (3,)+bs / (6,)+bs, matrices (6,6)+bs.  The tree loops unroll
in Python over the small static tree (13 bodies for Go2).

State conventions:
  * base_quat (w,x,y,z): world <- base rotation.
  * v_base: spatial velocity of the base in *base* coordinates [omega; v].
  * f_ext: per-body spatial force in world axes about each body's origin,
    shape (nb, 6)+bs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import soa
from .model import RobotModel


class ModelArrays(NamedTuple):
    """Static model data as tensors on one device."""

    parent: tuple          # python ints -> static tree structure
    joint_rot: torch.Tensor   # (nb,3,3)
    joint_pos: torch.Tensor   # (nb,3)
    joint_axis: torch.Tensor  # (nb,3)
    mass: torch.Tensor        # (nb,)
    com: torch.Tensor         # (nb,3)
    inertia_com: torch.Tensor  # (nb,3,3)
    geom_body: torch.Tensor
    geom_pos: torch.Tensor
    geom_radius: torch.Tensor
    geom_link: torch.Tensor
    link_body: torch.Tensor
    link_pos: torch.Tensor
    n_links: int

    @property
    def nb(self) -> int:
        return len(self.parent)


def model_arrays(model: RobotModel, device="cpu", dtype=torch.float32) -> ModelArrays:
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    i = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
    return ModelArrays(
        parent=tuple(int(p) for p in model.parent),
        joint_rot=f(model.joint_rot),
        joint_pos=f(model.joint_pos),
        joint_axis=f(model.joint_axis),
        mass=f(model.mass),
        com=f(model.com),
        inertia_com=f(model.inertia_com),
        geom_body=i(model.geom_body),
        geom_pos=f(model.geom_pos),
        geom_radius=f(model.geom_radius),
        geom_link=i(model.geom_link),
        link_body=i(model.link_body),
        link_pos=f(model.link_pos),
        n_links=model.n_links,
    )


def body_inertias(m: ModelArrays, added_mass=None, com_offset=None):
    """Per-body [(m ()+bs, h (3,)+bs, I (3,3)+bs)] with base-body domain rand
    (added_mass ()+bs, com_offset (3,)+bs; both None gives the unbatched
    nominal model)."""
    bs = () if added_mass is None else tuple(added_mass.shape)
    out = []
    for i in range(m.nb):
        mass_i = m.mass[i].expand(bs)
        com_i = soa.bcast(m.com[i], bs).expand((3,) + bs)
        if i == 0 and added_mass is not None:
            mass_i = mass_i + added_mass
        if i == 0 and com_offset is not None:
            com_i = com_i + com_offset
        h = mass_i * com_i
        cx = soa.hat(com_i)
        I_o = soa.bcast(m.inertia_com[i], bs) + mass_i * soa.mmt(cx, cx)
        out.append((mass_i, h, I_o))
    return out


def _S(m: ModelArrays, i: int, bs):
    """Joint motion subspace [axis; 0] as (6,)+(1,)*len(bs)."""
    s = torch.cat([m.joint_axis[i], torch.zeros_like(m.joint_axis[i])])
    return soa.bcast(s, bs)


def joint_transforms(m: ModelArrays, base_quat, dof_pos):
    """Per-body parent->child transforms and world poses.

    Returns E_up/p_up (parent->child coords) and E0 = R_{body<-world},
    p0 = body origin relative to the base origin, in world coords.
    """
    bs = tuple(base_quat.shape[1:])
    R_wb = soa.quat_to_matrix(base_quat)
    zero3 = torch.zeros((3,) + bs, dtype=base_quat.dtype, device=base_quat.device)
    E_up = [R_wb.transpose(0, 1)]
    p_up = [zero3]
    E0 = [E_up[0]]
    p0 = [zero3]
    for i in range(1, m.nb):
        E_j = soa.rot_axis(m.joint_axis[i], dof_pos[i - 1]).transpose(0, 1)
        E = soa.mm(E_j, soa.bcast(m.joint_rot[i], bs))
        E_up.append(E)
        p_tree = soa.bcast(m.joint_pos[i], bs)
        p_up.append(p_tree)
        p = m.parent[i]
        E0.append(soa.mm(E, E0[p]))
        p0.append(p0[p] + soa.mtv(E0[p], p_tree * torch.ones_like(p0[p])))
    return E_up, p_up, E0, p0


def forward_kinematics(m: ModelArrays, base_quat, base_pos, dof_pos, v_base, dof_vel):
    """World poses and spatial velocities (body coords) of all bodies."""
    E_up, p_up, E0, p0 = joint_transforms(m, base_quat, dof_pos)
    bs = tuple(base_quat.shape[1:])
    v = [v_base]
    for i in range(1, m.nb):
        vi = soa.xform_motion(E_up[i], p_up[i], v[m.parent[i]])
        v.append(vi + _S(m, i, bs) * dof_vel[i - 1])
    p0w = [base_pos + q for q in p0]
    return E_up, p_up, E0, p0w, v


def rnea(m, inertias, base_quat, dof_pos, v_base, dof_vel, qdd_base, qdd, f_ext=None,
         gravity=(0.0, 0.0, -9.81), armature=None):
    """Inverse dynamics: generalized forces producing given accelerations.

    Gravity enters via the fictitious base acceleration (Featherstone RBDA
    5.3).  Returns (f0 (6,)+bs base wrench in base coords, tau (ndof,)+bs);
    with qdd = 0 this is the bias force.  `armature` ((ndof,) or None) adds
    reflected rotor inertia in joint space: tau_i += armature_i * qdd_i.
    """
    nb = m.nb
    bs = tuple(base_quat.shape[1:])
    dtype, device = dof_pos.dtype, dof_pos.device
    E_up, p_up, E0, _ = joint_transforms(m, base_quat, dof_pos)
    g = soa.bcast(torch.tensor(gravity, dtype=dtype, device=device), bs)
    zero3 = torch.zeros((3,) + bs, dtype=dtype, device=device)

    v = [v_base]
    a = [soa.sv(zero3, -soa.mv(E0[0], g * torch.ones_like(zero3))) + qdd_base]
    for i in range(1, nb):
        p = m.parent[i]
        S = _S(m, i, bs)
        vJ = S * dof_vel[i - 1]
        vi = soa.xform_motion(E_up[i], p_up[i], v[p]) + vJ
        a.append(soa.xform_motion(E_up[i], p_up[i], a[p]) + S * qdd[i - 1] + soa.crm(vi, vJ))
        v.append(vi)
    f = []
    for i in range(nb):
        mass_i, h_i, I_i = inertias[i]
        Iv = soa.inertia_mul(mass_i, h_i, I_i, v[i])
        fi = soa.inertia_mul(mass_i, h_i, I_i, a[i]) + soa.crf(v[i], Iv)
        if f_ext is not None:
            fi = fi - soa.sv(soa.mv(E0[i], f_ext[i][0:3]), soa.mv(E0[i], f_ext[i][3:6]))
        f.append(fi)
    tau = [None] * (nb - 1)
    for i in range(nb - 1, 0, -1):
        tau[i - 1] = soa.dot(_S(m, i, bs) * torch.ones_like(f[i]), f[i])
        if armature is not None:
            tau[i - 1] = tau[i - 1] + armature[i - 1] * qdd[i - 1]
        p = m.parent[i]
        f[p] = f[p] + soa.inv_xform_force(E_up[i], p_up[i], f[i])
    return f[0], torch.stack(tau)


def crba(m, inertias, base_quat, dof_pos, armature=None):
    """Composite rigid-body algorithm: mass matrix (nv, nv)+bs.

    Row/col order: [base 6 dof (ang, lin in base coords); joints].
    `armature` adds reflected rotor inertia on each joint diagonal.
    """
    nb = m.nb
    bs = tuple(base_quat.shape[1:])
    dtype, device = dof_pos.dtype, dof_pos.device
    E_up, p_up, _, _ = joint_transforms(m, base_quat, dof_pos)
    Ic = [soa.inertia_to_mat66(*inertias[i]) for i in range(nb)]
    X = [None] + [soa.xform_to_mat66(E_up[i], p_up[i]) for i in range(1, nb)]
    for i in range(nb - 1, 0, -1):
        p = m.parent[i]
        Ic[p] = Ic[p] + soa.mtm(X[i], soa.mm(Ic[i], X[i]))
    nv = 6 + nb - 1
    ones6 = torch.ones((6,) + bs, dtype=dtype, device=device)
    # filled by index assignment into a fresh tensor (the reference's .at[].set)
    H = torch.zeros((nv, nv) + bs, dtype=dtype, device=device)
    H[0:6, 0:6] = Ic[0]
    for i in range(1, nb):
        S = _S(m, i, bs) * ones6
        F = soa.mv(Ic[i], S)
        d_ii = soa.dot(S, F)
        if armature is not None:
            d_ii = d_ii + armature[i - 1]
        H[6 + i - 1, 6 + i - 1] = d_ii
        j = i
        while m.parent[j] > 0:
            F = soa.mtv(X[j], F)
            j = m.parent[j]
            val = soa.dot(_S(m, j, bs) * ones6, F)
            H[6 + i - 1, 6 + j - 1] = val
            H[6 + j - 1, 6 + i - 1] = val
        F = soa.mtv(X[j], F)
        H[6 + i - 1, 0:6] = F
        H[0:6, 6 + i - 1] = F
    return H


def aba(m, inertias, base_quat, dof_pos, v_base, dof_vel, tau, f_ext=None,
        gravity=(0.0, 0.0, -9.81), armature=None):
    """Articulated-body forward dynamics.

    Returns (a_base (6,)+bs true spatial accel in base coords, qdd (ndof,)+bs).
    Gravity is an explicit per-body wrench at the com; `armature` ((ndof,)
    tensor or None) adds reflected rotor inertia in joint space.
    """
    nb = m.nb
    bs = tuple(base_quat.shape[1:])
    dtype, device = dof_pos.dtype, dof_pos.device
    E_up, p_up, E0, _ = joint_transforms(m, base_quat, dof_pos)
    g = soa.bcast(torch.tensor(gravity, dtype=dtype, device=device), bs)
    ones3 = torch.ones((3,) + bs, dtype=dtype, device=device)
    ones6 = torch.ones((6,) + bs, dtype=dtype, device=device)

    S = [None] + [_S(m, i, bs) for i in range(1, nb)]
    v = [v_base]
    c = [torch.zeros((6,) + bs, dtype=dtype, device=device)]
    for i in range(1, nb):
        vJ = S[i] * dof_vel[i - 1]
        vi = soa.xform_motion(E_up[i], p_up[i], v[m.parent[i]]) + vJ
        v.append(vi)
        c.append(soa.crm(vi, vJ))

    IA = [soa.inertia_to_mat66(*inertias[i]) for i in range(nb)]
    pA = []
    for i in range(nb):
        mass_i, h_i, I_i = inertias[i]
        pa = soa.crf(v[i], soa.inertia_mul(mass_i, h_i, I_i, v[i]))
        g_b = soa.mv(E0[i], g * ones3)
        pa = pa - soa.sv(soa.cross(h_i * ones3, g_b), mass_i * g_b)
        if f_ext is not None:
            pa = pa - soa.sv(soa.mv(E0[i], f_ext[i][0:3]), soa.mv(E0[i], f_ext[i][3:6]))
        pA.append(pa)

    U = [None] * nb
    d = [None] * nb
    u = [None] * nb
    for i in range(nb - 1, 0, -1):
        p = m.parent[i]
        Si = S[i] * ones6
        U[i] = soa.mv(IA[i], Si)
        d[i] = soa.dot(Si, U[i])
        if armature is not None:
            d[i] = d[i] + armature[i - 1]
        u[i] = tau[i - 1] - soa.dot(Si, pA[i])
        Ia = IA[i] - soa.outer(U[i], U[i]) / d[i]
        pa = pA[i] + soa.mv(Ia, c[i]) + U[i] * (u[i] / d[i])
        X = soa.xform_to_mat66(E_up[i], p_up[i])
        IA[p] = IA[p] + soa.mtm(X, soa.mm(Ia, X))
        pA[p] = pA[p] + soa.inv_xform_force(E_up[i], p_up[i], pa)

    # floating base equilibrium: IA[0] a0 + pA[0] = 0
    a0 = soa.solve66(IA[0], -pA[0])

    a = [a0]
    qdd = [None] * (nb - 1)
    for i in range(1, nb):
        ai = soa.xform_motion(E_up[i], p_up[i], a[m.parent[i]]) + c[i]
        qdd[i - 1] = (u[i] - soa.dot(U[i] * ones6, ai)) / d[i]
        a.append(ai + S[i] * qdd[i - 1])
    return a0, torch.stack(qdd)
