"""The fused control step: a hand-written CUDA kernel for Hopper
(ops/csrc/fused_step.cu) and its plain PyTorch version.

Replaces the Pallas TPU kernel `legged_gym_custom_tpu/ops/fused_step.py::
_build_fused` (pallas_call at :824, body `control_step_components` :667),
with joint damping and armature, in all the variants the reference
specialises at trace time and this port at build time:
  * K1, the plane variant (`hf_K == 0`): penalty contact against z = 0;
  * K3, the heightfield variant (`hf_K > 0`): contact against a per-env
    bilinear surface read from a (K, K) window of the height table
    (physics/patch.py), sampled at the first substep of each decimation
    tick and held through its substeps (reference `_tile_surface` :352);
  * K2, two options on either of them: control type 'T' (direct scaled
    torques, reference :690-691) in place of 'P', and implicit stiction
    (reference :524-527, :633-635): the tanh frictionloss torque is dropped
    and after the integration each joint sheds up to `fl_dqd` of velocity
    toward zero, which holds a joint at rest exactly.
One launch runs a whole 50 Hz control step, decimation x substeps of PD
torques, forward kinematics, penalty contact, joint-limit and passive
torques, ABA with armature and semi-implicit Euler, then one more forward
kinematics pass that writes the report links' world positions and linear
velocities (the reference computes these `link_states` in XLA after its
kernel).  A group of G lanes of a warp runs one env, each lane one branch
of the kinematic tree under the base (`ops/lane_plan.py::lane_plan`, host
numpy), with the state held in registers and shared memory across all
substeps.  Device memory traffic is the state, actions and DR parameters
(and for K3 each env's window and its offsets) in and the state, link
forces, torques and link states out.

The model constants are baked into the kernel at build time from a
`FusedSpec` (built host-side in numpy, as the reference's fix 841adc9
requires): `ops/fused_step.py` writes them and the lane plan into a generated
header and
compiles `fused_step.cu` with nvcc for sm_90a into a shared library with a
plain C interface, loaded with ctypes and cached per spec.

`fused_control_step` is the wrapper: for CPU tensors it runs
`control_step_components`, the plain version, and for CUDA tensors it
launches the kernel or raises.  A configuration the kernel does not cover
('V' control, which needs the previous step's joint velocities; per-substep
terrain sampling) raises NotImplementedError naming the missing variant on
either device.

`LGC_FUSED_KERNEL` set to `0`, `off` or `false`, in any case, reads as the
kernel turned off (`kernel_enabled`, JAX `_env_flag`); anything else (`auto`
by default) leaves it on.  `physics.engine.kernel_spec` is its one reader.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

from . import lane_plan as lane_plan_lib

_HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = os.path.join(_HERE, "csrc", "fused_step.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def env_flag() -> str:
    """The `LGC_FUSED_KERNEL` setting, lower case, `auto` when unset (JAX
    ops/fused_step.py:859-860)."""
    return os.environ.get("LGC_FUSED_KERNEL", "auto").lower()


def kernel_enabled() -> bool:
    """False where `LGC_FUSED_KERNEL` is 0 / off / false (JAX
    ops/fused_step.py:910-912)."""
    return env_flag() not in ("0", "off", "false")


# --------------------------------------------------------------------------
# Static model/parameter bundle (hashable -> kernel cache key)
# --------------------------------------------------------------------------


class FusedSpec(NamedTuple):
    """Everything static about the robot + sim config, as nested tuples
    (same fields as the reference's FusedSpec)."""

    parent: tuple
    joint_rot: tuple      # (nb, 3, 3)
    joint_pos: tuple      # (nb, 3)
    joint_axis: tuple     # (nb, 3)
    mass: tuple           # (nb,)
    com: tuple            # (nb, 3)
    inertia_com: tuple    # (nb, 3, 3)
    geom_body: tuple
    geom_pos: tuple       # (ng, 3)
    geom_radius: tuple
    geom_link: tuple
    n_links: int
    dt: float
    decimation: int
    substeps: int
    gravity: tuple
    stiffness: float
    damping: float
    friction_vel: float
    terrain_friction: float
    jl_stiffness: float
    jl_damping: float
    dof_vel_clamp: bool
    jd_damping: tuple
    jd_armature: tuple
    jd_frictionloss: tuple
    fl_eps: float
    p_gains: tuple
    d_gains: tuple
    default_dof_pos: tuple
    torque_limits: tuple
    action_scale: float
    dof_lo: tuple
    dof_hi: tuple
    dof_vlim: tuple
    hf_K: int = 0
    hf_hs: float = 0.0
    control_type: str = "P"
    fl_dqd: tuple = ()
    # the port's own: False (per-substep terrain sampling) is a heightfield
    # mode no variant covers, which `check_covered` refuses; JAX's spec has
    # no such field and its wrapper falls back to XLA instead
    terrain_tick_sample: bool = True
    # the port's own: the report links' bodies and frame origins in their
    # bodies' frames (ModelArrays.link_body / link_pos), whose world states
    # the kernel writes after the last substep; JAX computes them in XLA
    link_body: tuple = ()   # (n_links,)
    link_pos: tuple = ()    # (n_links, 3)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _t(x):
    a = np.asarray(_np(x), np.float64)
    if a.ndim == 0:
        return float(a)
    return tuple(_t(r) for r in a)


def build_spec(ma, params, pd, dof_limits, hf_K: int = 0, hf_hs: float = 0.0) -> FusedSpec:
    """Concretize ModelArrays/SimParams/PDParams into a hashable spec (host
    numpy only; `ma` leaves may be tensors on any device).  `hf_K` is the
    side of the per-env terrain window (0 on the plane), `hf_hs` its cell
    size in meters."""
    c = params.contact
    ndof = len(ma.parent) - 1

    def per_dof(x):
        return _t(x) if x is not None else (0.0,) * ndof

    # implicit stiction: the per-substep velocity clamp fl * dt_sub / meff in
    # host numpy float32, the arithmetic (and so the bits) of the reference
    # (fused_step.py:324-328); the kernel's header and the plain version are
    # both given this value
    fl_dqd = ()
    if (params.frictionloss_implicit and params.dof_frictionloss is not None
            and params.dof_meff is not None):
        fl_dqd = _t(_np(params.dof_frictionloss) * (params.dt / params.substeps)
                    / _np(params.dof_meff))

    return FusedSpec(
        hf_K=int(hf_K),
        hf_hs=float(hf_hs),
        terrain_tick_sample=bool(params.terrain_tick_sample),
        parent=tuple(int(p) for p in ma.parent),
        joint_rot=_t(ma.joint_rot),
        joint_pos=_t(ma.joint_pos),
        joint_axis=_t(ma.joint_axis),
        mass=_t(ma.mass),
        com=_t(ma.com),
        inertia_com=_t(ma.inertia_com),
        geom_body=tuple(int(b) for b in _np(ma.geom_body)),
        geom_pos=_t(ma.geom_pos),
        geom_radius=_t(ma.geom_radius),
        geom_link=tuple(int(l) for l in _np(ma.geom_link)),
        n_links=int(ma.n_links),
        dt=float(params.dt),
        decimation=int(params.decimation),
        substeps=int(params.substeps),
        gravity=tuple(float(g) for g in params.gravity),
        stiffness=float(c.stiffness),
        damping=float(c.damping),
        friction_vel=float(c.friction_vel),
        terrain_friction=float(c.terrain_friction),
        jl_stiffness=float(params.joint_limit_stiffness),
        jl_damping=float(params.joint_limit_damping),
        dof_vel_clamp=bool(params.dof_vel_clamp),
        jd_damping=per_dof(params.dof_damping),
        jd_armature=per_dof(params.dof_armature),
        jd_frictionloss=per_dof(params.dof_frictionloss),
        fl_eps=float(params.frictionloss_vel_eps),
        p_gains=_t(pd.p_gains),
        d_gains=_t(pd.d_gains),
        default_dof_pos=_t(pd.default_dof_pos),
        torque_limits=_t(pd.torque_limits),
        action_scale=float(pd.action_scale),
        control_type=str(pd.control_type),
        fl_dqd=fl_dqd,
        dof_lo=_t(dof_limits[0]),
        dof_hi=_t(dof_limits[1]),
        dof_vlim=_t(dof_limits[2]),
        link_body=tuple(int(b) for b in _np(ma.link_body)),
        link_pos=_t(ma.link_pos),
    )


@functools.lru_cache(maxsize=None)
def tick_spec(spec: FusedSpec) -> FusedSpec:
    """The one-tick 'T' spec of `spec`: one decimation tick of direct torques
    at action scale 1, everything else (substeps, contact, clamps, terrain
    window) as `spec` has it.  A stateful actuator's control step launches
    it once per tick with the tick's clipped torques as the actions
    (physics.engine.tickwise_control_step); cached, so each env builds one
    library per variant."""
    return spec._replace(decimation=1, control_type="T", action_scale=1.0)


def check_covered(spec: FusedSpec):
    """Raise NotImplementedError for a spec outside the kernel's variants:
    the plane or a heightfield sampled once per tick, 'P' or 'T' control,
    tanh or implicit frictionloss.  'V' control and per-substep terrain
    sampling have no variant."""
    where = " on a heightfield" if spec.hf_K else ""
    if spec.control_type not in ("P", "T"):
        raise NotImplementedError(
            f"control_type {spec.control_type!r}{where}: the fused kernel covers 'P' and 'T' "
            "('V' needs the previous step's joint velocities, which it does not carry)"
        )
    if spec.hf_K and not spec.terrain_tick_sample:
        raise NotImplementedError(
            "terrain_tick_sample=False: the heightfield kernel samples the surface once per "
            "decimation tick and has no per-substep variant")
    ndof = len(spec.parent) - 1
    if spec.fl_dqd and len(spec.fl_dqd) != ndof:
        raise ValueError(f"fl_dqd needs {ndof} entries, got {len(spec.fl_dqd)}")
    if len(spec.link_body) != spec.n_links or len(spec.link_pos) != spec.n_links:
        raise ValueError(f"link_body and link_pos need {spec.n_links} entries (n_links), got "
                         f"{len(spec.link_body)} and {len(spec.link_pos)}")
    if spec.hf_K and (spec.hf_K < 2 or spec.hf_hs <= 0.0):
        raise ValueError(f"heightfield spec needs hf_K >= 2 and hf_hs > 0, got "
                         f"{spec.hf_K}, {spec.hf_hs}")


# --------------------------------------------------------------------------
# Plain version: the kernel's math on lists of (B,) tensors.  Entries may be
# python floats (model constants); products and sums with a constant 0.0 or
# 1.0 fold away, as the CUDA compiler folds the baked-in constants.
# --------------------------------------------------------------------------


def _mul(a, b):
    if isinstance(a, float):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
    if isinstance(b, float):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
    return a * b


def _add(a, b):
    if isinstance(a, float) and a == 0.0:
        return b
    if isinstance(b, float) and b == 0.0:
        return a
    return a + b


def _sub(a, b):
    if isinstance(b, float) and b == 0.0:
        return a
    if isinstance(a, float) and a == 0.0:
        return -b
    return a - b


def _sum(terms):
    out = 0.0
    for t in terms:
        out = _add(out, t)
    return out


def _mv(M, v):
    return [_sum(_mul(M[i][j], v[j]) for j in range(len(v))) for i in range(len(M))]


def _mtv(M, v):
    return [_sum(_mul(M[j][i], v[j]) for j in range(len(v))) for i in range(len(M[0]))]


def _mm(A, B):
    n, k, m = len(A), len(B), len(B[0])
    return [[_sum(_mul(A[i][t], B[t][j]) for t in range(k)) for j in range(m)] for i in range(n)]


def _cross(a, b):
    return [
        _sub(_mul(a[1], b[2]), _mul(a[2], b[1])),
        _sub(_mul(a[2], b[0]), _mul(a[0], b[2])),
        _sub(_mul(a[0], b[1]), _mul(a[1], b[0])),
    ]


def _dot(a, b):
    return _sum(_mul(x, y) for x, y in zip(a, b))


def _vadd(a, b):
    return [_add(x, y) for x, y in zip(a, b)]


def _vsub(a, b):
    return [_sub(x, y) for x, y in zip(a, b)]


def _hat(v):
    return [
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ]


def _quat_to_matrix(q):
    w, x, y, z = q
    return [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]


def _xform_motion(E, p, m):
    w, v = m[0:3], m[3:6]
    return _mv(E, w) + _mv(E, _vsub(v, _cross(p, w)))


def _inv_xform_force(E, p, f):
    n = _mtv(E, f[0:3])
    ff = _mtv(E, f[3:6])
    return _vadd(n, _cross(p, ff)) + ff


def _inv3(M):
    a, b, c = M[0]
    d, e, f = M[1]
    g, h, i = M[2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    inv_det = 1.0 / (a * A + b * D + c * G)
    return [[A * inv_det, B * inv_det, C * inv_det],
            [D * inv_det, E * inv_det, F * inv_det],
            [G * inv_det, H * inv_det, I * inv_det]]


def _solve66(A, b):
    """SPD 6x6 solve via 3x3 Schur blocks."""
    A11 = [row[0:3] for row in A[0:3]]
    A12 = [row[3:6] for row in A[0:3]]
    A21 = [row[0:3] for row in A[3:6]]
    A22 = [row[3:6] for row in A[3:6]]
    b1, b2 = b[0:3], b[3:6]
    A11i = _inv3(A11)
    S = [[_sub(A22[i][j], _dot(A21[i], _mv(A11i, [A12[0][j], A12[1][j], A12[2][j]])))
          for j in range(3)] for i in range(3)]
    Si = _inv3(S)
    x2 = _mv(Si, _vsub(b2, _mv(A21, _mv(A11i, b1))))
    x1 = _mv(A11i, _vsub(b1, _mv(A12, x2)))
    return x1 + x2


def _crm(v, m):
    w, vl = v[0:3], v[3:6]
    mw, ml = m[0:3], m[3:6]
    return _cross(w, mw) + _vadd(_cross(w, ml), _cross(vl, mw))


def _crf(v, f):
    w, vl = v[0:3], v[3:6]
    n, ff = f[0:3], f[3:6]
    return _vadd(_cross(w, n), _cross(vl, ff)) + _cross(w, ff)


def _inertia_mul(m, h, I, v):
    w, vl = v[0:3], v[3:6]
    return _vadd(_mv(I, w), _cross(h, vl)) + _vsub([_mul(x, m) for x in vl], _cross(h, w))


def _inertia_to_mat66(m, h, I):
    hx = _hat(h)
    out = [[0.0] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            out[i][j] = I[i][j]
            out[i][3 + j] = hx[i][j]
            out[3 + i][j] = -hx[i][j]
        out[3 + i][3 + i] = m
    return out


def _xform_to_mat66(E, p):
    """[[E, 0], [-E hat(p), E]]; p is a float 3-list."""
    Epx = _mm(E, _hat(p))
    out = [[0.0] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            out[i][j] = E[i][j]
            out[3 + i][j] = -Epx[i][j]
            out[3 + i][3 + j] = E[i][j]
    return out


def _tile_surface(spec: FusedSpec, terrain, cx, cy):
    """Bilinear height and unit normal from each env's (K, K) window
    (reference `_tile_surface` :352-395): the same clamp to K - 1.001, floor
    and fractions, with four direct reads of the window in place of the
    one-hot K-row contraction; the taps and their weights are those of the
    contraction, so h, dh/dx and dh/dy are the same.  cx/cy are (B,) world
    coordinates; terrain holds `patch` (B, K, K) and `xoff`/`yoff` (B,),
    the world coordinates of window cell (0, 0).  Returns (h, nx, ny, nz)."""
    K = spec.hf_K
    inv_hs = 1.0 / spec.hf_hs
    patch = terrain["patch"]
    gx = torch.clamp((cx - terrain["xoff"]) * inv_hs, 0.0, K - 1.001)
    gy = torch.clamp((cy - terrain["yoff"]) * inv_hs, 0.0, K - 1.001)
    x0 = torch.floor(gx)
    fx = gx - x0
    y0 = torch.floor(gy)
    fy = gy - y0
    # the index clamp only acts on a NaN coordinate
    i = (torch.clamp(x0.long(), 0, K - 2) * K + torch.clamp(y0.long(), 0, K - 2))[:, None]
    flat = patch.reshape(patch.shape[0], K * K)
    p00 = torch.gather(flat, 1, i)[:, 0]
    p01 = torch.gather(flat, 1, i + 1)[:, 0]
    p10 = torch.gather(flat, 1, i + K)[:, 0]
    p11 = torch.gather(flat, 1, i + K + 1)[:, 0]
    u0 = (1.0 - fx) * p00 + fx * p10      # u[y0]  = sum_i Wx[i] P[i, y0]
    u1 = (1.0 - fx) * p01 + fx * p11      # u[y0 + 1]
    h = (1.0 - fy) * u0 + fy * u1
    dhdx = ((1.0 - fy) * (p10 - p00) + fy * (p11 - p01)) * inv_hs
    dhdy = (u1 - u0) * inv_hs
    inv_norm = 1.0 / torch.sqrt(dhdx * dhdx + dhdy * dhdy + 1.0)
    return h, -dhdx * inv_norm, -dhdy * inv_norm, inv_norm


def _outward_components(spec: FusedSpec, st):
    """Forward kinematics on component lists (reference `_substep_components`'
    outward pass): the base rotation R_wb0 (world <- base), the base's
    angular and linear velocity w_b, u_b in base coords, and per body its
    rotation E0 (body <- world), origin p0 relative to the base origin in
    world axes, joint rotation E_up (child <- parent) and spatial velocity v
    in body coords with the joint's velocity added."""
    nb = len(spec.parent)
    R_wb0 = _quat_to_matrix(st["quat"])
    w_b = _mtv(R_wb0, st["ang"])
    u_b = _mtv(R_wb0, st["lin"])
    E0 = [None] * nb
    p0 = [None] * nb
    E_up = [None] * nb
    v = [None] * nb
    E0[0] = [[R_wb0[j][i] for j in range(3)] for i in range(3)]
    p0[0] = [0.0, 0.0, 0.0]
    v[0] = w_b + u_b
    for i in range(1, nb):
        p = spec.parent[i]
        q = st["q"][i - 1]
        axis = spec.joint_axis[i]
        cq = torch.cos(q)
        sq = torch.sin(q)
        ax = _hat(axis)
        # R(axis, q) = c I + s [a]x + (1-c) a a^T ; E_j = R^T
        R = [[_add(_add(cq if r == c_ else 0.0, _mul(sq, ax[r][c_])),
                   _mul(1.0 - cq, axis[r] * axis[c_]))
              for c_ in range(3)] for r in range(3)]
        Ej = [[R[c_][r] for c_ in range(3)] for r in range(3)]
        E_up[i] = _mm(Ej, [list(r) for r in spec.joint_rot[i]])
        E0[i] = _mm(E_up[i], E0[p])
        jp = list(spec.joint_pos[i])
        p0[i] = _vadd(p0[p], _mtv(E0[p], jp))
        vi = _xform_motion(E_up[i], jp, v[p])
        qd = st["qd"][i - 1]
        v[i] = [_add(vi[k], _mul(axis[k], qd)) for k in range(3)] + vi[3:6]
    return R_wb0, w_b, u_b, E0, p0, E_up, v


def link_states_components(spec: FusedSpec, st):
    """World positions and linear velocities of the report links on
    component lists (the kernel's last outward pass; engine.link_states'
    math): pos = base_pos + p0[b] + E0[b]^T link_pos, vel = E0[b]^T (u_b +
    w_b x link_pos) for each link's body b.  Returns (pos, vel), [nl][3]."""
    _, _, _, E0, p0, _, v = _outward_components(spec, st)
    pos, vel = [], []
    for b, lp in zip(spec.link_body, spec.link_pos):
        lp = list(lp)
        off = _mtv(E0[b], lp)
        pos.append([_add(_add(st["pos"][k], p0[b][k]), off[k]) for k in range(3)])
        vel.append(_mtv(E0[b], _vadd(v[b][3:6], _cross(v[b][0:3], lp))))
    return pos, vel


def _substep_components(spec: FusedSpec, st, tau, friction, inertias, terrain=None,
                        surface=None):
    """One semi-implicit Euler substep on component lists: plane contact, or
    on a heightfield (spec.hf_K > 0) contact against `surface`, the per-geom
    (h, nx, ny, nz) list frozen for the current decimation tick; None means
    "sample now from this substep's kinematics" (terrain_tick_sample).
    Returns (st', link_force [n_links][3], surface)."""
    nb = len(spec.parent)
    ndof = nb - 1
    dt = spec.dt / spec.substeps
    R_wb0, w_b, u_b, E0, p0, E_up, v = _outward_components(spec, st)

    # penalty contact: the plane, or the tick's frozen heightfield surface
    ng = len(spec.geom_body)
    body_wrench = [[0.0] * 6 for _ in range(nb)]   # world axes, body origin
    link_force = [[0.0] * 3 for _ in range(spec.n_links)]
    sample_now = spec.hf_K > 0 and surface is None
    if sample_now:
        surface = [None] * ng
    mu = 0.5 * (friction + spec.terrain_friction)
    for g in range(ng):
        b = spec.geom_body[g]
        gpos = list(spec.geom_pos[g])
        Rg = E0[b]
        off = _mtv(Rg, gpos)
        center = [_add(_add(st["pos"][k], p0[b][k]), off[k]) for k in range(3)]
        vel_b = _vadd(v[b][3:6], _cross(v[b][0:3], gpos))
        vel_w = _mtv(Rg, vel_b)
        if spec.hf_K > 0:
            if sample_now:
                surface[g] = _tile_surface(spec, terrain, center[0], center[1])
            h, nx, ny, nz = surface[g]
            depth = spec.geom_radius[g] - nz * (center[2] - h)
            vn = vel_w[0] * nx + vel_w[1] * ny + vel_w[2] * nz
            vt = [vel_w[0] - vn * nx, vel_w[1] - vn * ny, vel_w[2] - vn * nz]
            vt_norm = torch.sqrt(vt[0] * vt[0] + vt[1] * vt[1] + vt[2] * vt[2])
            fn = torch.clamp(spec.stiffness * depth - spec.damping * vn, min=0.0)
            fn = torch.where(depth > 0.0, fn, torch.zeros_like(fn))
            ft_mag = torch.minimum(spec.friction_vel * vt_norm, mu * fn)
            inv_vt = ft_mag / (vt_norm + 1e-6)
            force = [fn * nx - vt[0] * inv_vt, fn * ny - vt[1] * inv_vt,
                     fn * nz - vt[2] * inv_vt]
        else:
            depth = spec.geom_radius[g] - center[2]
            vn = vel_w[2]
            fn = torch.clamp(spec.stiffness * depth - spec.damping * vn, min=0.0)
            fn = torch.where(depth > 0.0, fn, torch.zeros_like(fn))
            vt_norm = torch.sqrt(vel_w[0] * vel_w[0] + vel_w[1] * vel_w[1])
            ft_mag = torch.minimum(spec.friction_vel * vt_norm, mu * fn)
            inv_vt = ft_mag / (vt_norm + 1e-6)
            force = [-vel_w[0] * inv_vt, -vel_w[1] * inv_vt, fn]
        torque = _cross(off, force)
        for k in range(3):
            body_wrench[b][k] = _add(body_wrench[b][k], torque[k])
            body_wrench[b][3 + k] = _add(body_wrench[b][3 + k], force[k])
            lf = link_force[spec.geom_link[g]]
            lf[k] = _add(lf[k], force[k])

    # joint-limit torque + passive joint dynamics (viscous + tanh Coulomb;
    # implicit stiction clamps the velocity after the integration instead)
    tau_total = []
    for j in range(ndof):
        qj = st["q"][j]
        qdj = st["qd"][j]
        below = torch.clamp(qj - spec.dof_lo[j], max=0.0)
        above = torch.clamp(qj - spec.dof_hi[j], min=0.0)
        viol = (below < 0) | (above > 0)
        tjl = -spec.jl_stiffness * (below + above) - torch.where(
            viol, spec.jl_damping * qdj, torch.zeros_like(qdj))
        t = tau[j] + tjl
        if spec.jd_damping[j] != 0.0:
            t = t - spec.jd_damping[j] * qdj
        if spec.jd_frictionloss[j] != 0.0 and not spec.fl_dqd:
            t = t - spec.jd_frictionloss[j] * torch.tanh(qdj * (1.0 / spec.fl_eps))
        tau_total.append(t)

    # articulated-body algorithm
    g3 = list(spec.gravity)
    c_ = [None] * nb
    c_[0] = [0.0] * 6
    for i in range(1, nb):
        axis = spec.joint_axis[i]
        qd = st["qd"][i - 1]
        vJ = [_mul(axis[0], qd), _mul(axis[1], qd), _mul(axis[2], qd), 0.0, 0.0, 0.0]
        c_[i] = _crm(v[i], vJ)

    IA = [None] * nb
    pA = [None] * nb
    for i in range(nb):
        m_i, h_i, I_i = inertias[i]
        IA[i] = _inertia_to_mat66(m_i, h_i, I_i)
        pa = _crf(v[i], _inertia_mul(m_i, h_i, I_i, v[i]))
        g_b = _mv(E0[i], g3)
        hxg = _cross(h_i, g_b)
        fw = body_wrench[i]
        n_b = _mv(E0[i], fw[0:3])
        f_b = _mv(E0[i], fw[3:6])
        pA[i] = [_sub(_sub(pa[k], hxg[k]), n_b[k]) for k in range(3)] + [
            _sub(_sub(pa[3 + k], _mul(m_i, g_b[k])), f_b[k]) for k in range(3)]

    U = [None] * nb
    d_ = [None] * nb
    u_ = [None] * nb
    for i in range(nb - 1, 0, -1):
        p = spec.parent[i]
        S6 = list(spec.joint_axis[i]) + [0.0, 0.0, 0.0]
        U[i] = _mv(IA[i], S6)
        d_[i] = _add(_dot(S6, U[i]), spec.jd_armature[i - 1])
        u_[i] = _sub(tau_total[i - 1], _dot(S6, pA[i]))
        inv_d = 1.0 / d_[i]
        Ia = [[_sub(IA[i][r][cc], _mul(_mul(U[i][r], U[i][cc]), inv_d)) for cc in range(6)]
              for r in range(6)]
        pa2 = [_add(_add(pA[i][r], _dot(Ia[r], c_[i])), _mul(U[i][r], u_[i] * inv_d))
               for r in range(6)]
        jp = list(spec.joint_pos[i])
        X = _xform_to_mat66(E_up[i], jp)
        IaX = _mm(Ia, X)
        XtIaX = _mm([[X[t][r] for t in range(6)] for r in range(6)], IaX)
        IA[p] = [[_add(IA[p][r][cc], XtIaX[r][cc]) for cc in range(6)] for r in range(6)]
        pA[p] = _vadd(pA[p], _inv_xform_force(E_up[i], jp, pa2))

    a0 = _solve66(IA[0], [-x for x in pA[0]])

    a = [None] * nb
    a[0] = a0
    qdd = [None] * ndof
    for i in range(1, nb):
        p = spec.parent[i]
        ai = _vadd(_xform_motion(E_up[i], list(spec.joint_pos[i]), a[p]), c_[i])
        qdd[i - 1] = _sub(u_[i], _dot(U[i], ai)) * (1.0 / d_[i])
        axis = spec.joint_axis[i]
        a[i] = [_add(ai[k], _mul(axis[k], qdd[i - 1])) for k in range(3)] + ai[3:6]

    # semi-implicit Euler
    w_b2 = [w_b[k] + a0[k] * dt for k in range(3)]
    u_b2 = [u_b[k] + a0[3 + k] * dt for k in range(3)]
    lin = _mv(R_wb0, u_b2)
    ang = _mv(R_wb0, w_b2)
    pos = [st["pos"][k] + lin[k] * dt for k in range(3)]

    angle = torch.sqrt(w_b2[0] ** 2 + w_b2[1] ** 2 + w_b2[2] ** 2)
    angle = torch.clamp(angle, min=1e-9)
    inv_angle = 1.0 / angle
    half = 0.5 * angle * dt
    ch = torch.cos(half)
    sh = torch.sin(half)
    dq = [ch, w_b2[0] * inv_angle * sh, w_b2[1] * inv_angle * sh, w_b2[2] * inv_angle * sh]
    qw, qx, qy, qz = st["quat"]
    quat = [
        qw * dq[0] - qx * dq[1] - qy * dq[2] - qz * dq[3],
        qw * dq[1] + qx * dq[0] + qy * dq[3] - qz * dq[2],
        qw * dq[2] - qx * dq[3] + qy * dq[0] + qz * dq[1],
        qw * dq[3] + qx * dq[2] - qy * dq[1] + qz * dq[0],
    ]
    qn = torch.sqrt(quat[0] ** 2 + quat[1] ** 2 + quat[2] ** 2 + quat[3] ** 2)
    qn = 1.0 / torch.clamp(qn, min=1e-9)
    quat = [qq * qn for qq in quat]

    qd_new, q_new = [], []
    for j in range(ndof):
        qd = st["qd"][j] + qdd[j] * dt
        if spec.fl_dqd:
            # implicit Coulomb stiction, before the velocity limit
            qd = qd - torch.clamp(qd, -spec.fl_dqd[j], spec.fl_dqd[j])
        if spec.dof_vel_clamp:
            qd = torch.clamp(qd, -spec.dof_vlim[j], spec.dof_vlim[j])
        qd_new.append(qd)
        q_new.append(st["q"][j] + qd * dt)

    st2 = dict(pos=pos, quat=quat, lin=lin, ang=ang, q=q_new, qd=qd_new)
    return st2, link_force, surface


def _body_inertias_components(spec: FusedSpec, added_mass, com_offset):
    """Per-body (m, h, I_origin); the base body is randomized per env."""
    out = []
    for i in range(len(spec.parent)):
        if i == 0:
            m_i = spec.mass[0] + added_mass
            com_i = [spec.com[0][k] + com_offset[k] for k in range(3)]
        else:
            m_i = spec.mass[i]
            com_i = list(spec.com[i])
        h = [_mul(m_i, com_i[k]) for k in range(3)]
        cx = _hat(com_i)
        cxcxT = _mm(cx, [[cx[c][r] for c in range(3)] for r in range(3)])
        I_o = [[_add(spec.inertia_com[i][r][c], _mul(m_i, cxcxT[r][c])) for c in range(3)]
               for r in range(3)]
        out.append((m_i, h, I_o))
    return out


def control_step_components(spec: FusedSpec, st, actions, friction, added_mass, com_offset,
                            kp_mult, kd_mult, terrain=None):
    """The full control step on component lists of (B,) tensors: the plain
    version of the kernel (reference fused_step.py:667).

    st: dict with pos[3], quat[4], lin[3], ang[3] (world), q[ndof], qd[ndof].
    terrain (spec.hf_K > 0): dict with `patch` (B, K, K) and `xoff`, `yoff`
    (B,), the world coordinates of window cell (0, 0).
    Returns (st', link_force_mean [nl][3] of the last tick, tau [ndof]).
    """
    check_covered(spec)
    nl = spec.n_links
    ndof = len(spec.parent) - 1
    inertias = _body_inertias_components(spec, added_mass, com_offset)
    tau = None
    lf_mean = None
    for _tick in range(spec.decimation):
        tau = []
        for j in range(ndof):
            if spec.control_type == "T":
                t = actions[j] * spec.action_scale
            else:
                kp = kp_mult[j] * spec.p_gains[j]
                kd = kd_mult[j] * spec.d_gains[j]
                t = kp * (actions[j] * spec.action_scale + spec.default_dof_pos[j]
                          - st["q"][j]) - kd * st["qd"][j]
            tau.append(torch.clamp(t, -spec.torque_limits[j], spec.torque_limits[j]))
        lf_sum = [[0.0] * 3 for _ in range(nl)]
        surface = None  # sampled at the tick's first substep (terrain_tick_sample)
        for _s in range(spec.substeps):
            st, lf, surface = _substep_components(spec, st, tau, friction, inertias, terrain,
                                                  surface)
            lf_sum = [[_add(lf_sum[l][k], lf[l][k]) for k in range(3)] for l in range(nl)]
        inv_ns = 1.0 / spec.substeps
        lf_mean = [[_mul(lf_sum[l][k], inv_ns) for k in range(3)] for l in range(nl)]
    return st, lf_mean, tau


def plain_control_step(spec: FusedSpec, state, actions, dr, terrain=None):
    """`control_step_components` on (C, B) tensors, then
    `link_states_components` on its final state; returns the wrapper's
    output layout: ((pos, quat, lin, ang, q, qd), link_forces (nl, 3, B),
    torques (ndof, B), link_pos (nl, 3, B), link_vel (nl, 3, B)).
    terrain: (patch (B, K, K), xoff (B,), yoff (B,)) for a heightfield
    spec, else None."""
    pos, quat, lin, ang, q, qd = state
    friction, added_mass, com_offset, kp_mult, kd_mult = dr
    st = dict(pos=list(pos), quat=list(quat), lin=list(lin), ang=list(ang),
              q=list(q), qd=list(qd))
    tr = None
    if terrain is not None:
        tr = dict(zip(("patch", "xoff", "yoff"), terrain))
    st, lf, tau = control_step_components(
        spec, st, list(actions), friction, added_mass, list(com_offset),
        list(kp_mult), list(kd_mult), terrain=tr,
    )
    zeros = torch.zeros_like(pos[0])
    full = lambda x: x if isinstance(x, torch.Tensor) else zeros + x
    out_state = tuple(torch.stack([full(c) for c in st[k]])
                      for k in ("pos", "quat", "lin", "ang", "q", "qd"))
    rows = lambda m: torch.stack([torch.stack([full(c) for c in row]) for row in m])
    lpos, lvel = link_states_components(spec, st)
    return out_state, rows(lf), torch.stack(tau), rows(lpos), rows(lvel)


# --------------------------------------------------------------------------
# Build: spec header + nvcc -> shared library with a C interface (ctypes)
# --------------------------------------------------------------------------


def _flist(x):
    a = np.asarray(x, np.float32).ravel()
    return "{" + ", ".join(f"{float(v):.9e}f" for v in a) + "}"


def _ilist(x):
    return "{" + ", ".join(str(int(v)) for v in np.asarray(x).ravel()) + "}"


# A tree whose branches are deeper than this takes the layout for deep chains
# (four lanes a branch, the inward pass split by block).  The quadrupeds'
# legs are 3 deep; the bipeds' (Cassie, G1) 6.
DEEP_CHAIN_DEPTH = 3


@functools.lru_cache(maxsize=None)
def lanes_per_branch_for(spec: FusedSpec) -> int:
    """The kernel's layout for a spec up to PAIR_MAX_ENVS envs, from the
    tree's shape alone: four lanes of a warp per branch where a branch is
    deeper than DEEP_CHAIN_DEPTH and they fit a warp (all walk the branch,
    each takes a quarter of a body's spheres and one block of the inward
    pass), else a pair of lanes per branch wherever the pairs fit a warp
    (both walk the branch, each takes half of a body's spheres), else one
    lane per branch.  On an NVIDIA H100 80GB HBM3 at a 700 W power limit the
    pair is the faster for the quadruped at the 4096 envs every config runs
    and at MPPI's 128 rollouts, and four lanes for the bipeds' chains of 6
    at 4096 envs (PERF.md section 6)."""
    per_branch = lane_plan_lib.branches([int(p) for p in spec.parent])
    n_branches = len(per_branch)
    depth = max((len(b) for b in per_branch), default=0)
    if depth > DEEP_CHAIN_DEPTH and 4 * n_branches <= lane_plan_lib.MAX_LANES:
        return 4
    return 2 if 2 * n_branches <= lane_plan_lib.MAX_LANES else 1


# Above this many envs a launch runs one lane per branch: the pair's grid then
# outgrows one wave of resident blocks (Go2 on an H100: 132 SMs x 3 blocks x
# 16 envs), and one lane per leg was the faster at 8192-65536 envs
# (PERF.md section 6).
PAIR_MAX_ENVS = 4096


def lanes_for_batch(spec: FusedSpec, batch: int) -> int:
    """The wrapper's layout for `batch` envs: the spec's up to PAIR_MAX_ENVS,
    one lane per branch above."""
    return lanes_per_branch_for(spec) if batch <= PAIR_MAX_ENVS else 1


def spec_header(spec: FusedSpec, lanes_per_branch: int = 1) -> str:
    """The generated header that bakes a spec and its lane plan, at
    `lanes_per_branch` lanes a branch, into the kernel source."""
    nb = len(spec.parent)
    plan = lane_plan_lib.lane_plan(spec, lanes_per_branch)
    lines = [
        "// generated by legged_gym_custom_tpu_torch/ops/fused_step.py::spec_header",
        f"#define LGC_NB {nb}",
        f"#define LGC_NL {spec.n_links}",
        f"#define LGC_DECIMATION {spec.decimation}",
        f"#define LGC_SUBSTEPS {spec.substeps}",
        f"#define LGC_DOF_VEL_CLAMP {1 if spec.dof_vel_clamp else 0}",
        f"#define LGC_DT_SUB {_flist([spec.dt / spec.substeps])[1:-1]}",
        f"#define LGC_GRAVITY {_flist(spec.gravity)}",
        f"#define LGC_STIFFNESS {_flist([spec.stiffness])[1:-1]}",
        f"#define LGC_DAMPING {_flist([spec.damping])[1:-1]}",
        f"#define LGC_FRICTION_VEL {_flist([spec.friction_vel])[1:-1]}",
        f"#define LGC_TERRAIN_FRICTION {_flist([spec.terrain_friction])[1:-1]}",
        f"#define LGC_JL_STIFFNESS {_flist([spec.jl_stiffness])[1:-1]}",
        f"#define LGC_JL_DAMPING {_flist([spec.jl_damping])[1:-1]}",
        f"#define LGC_INV_FL_EPS {_flist([1.0 / spec.fl_eps])[1:-1]}",
        f"#define LGC_ACTION_SCALE {_flist([spec.action_scale])[1:-1]}",
        # heightfield variant (K3): window side, inverse cell size and the
        # clamp bound K - 1.001 as the reference's float32 arithmetic sees it
        f"#define LGC_HF_K {spec.hf_K}",
        f"#define LGC_HF_INV_HS {_flist([1.0 / spec.hf_hs if spec.hf_K else 0.0])[1:-1]}",
        f"#define LGC_HF_GMAX {_flist([spec.hf_K - 1.001 if spec.hf_K else 0.0])[1:-1]}",
        # K2 options: direct torque control; implicit stiction and its
        # per-substep velocity clamps by dof (zeros when off; the kernel reads
        # them by slot and lane, as the plan's DQD)
        f"#define LGC_CONTROL_T {1 if spec.control_type == 'T' else 0}",
        f"#define LGC_FL_IMPLICIT {1 if spec.fl_dqd else 0}",
        f"#define LGC_FL_DQD {_flist(spec.fl_dqd or (0.0,) * (nb - 1))}",
        # the base body, whose mass and com are randomized per env
        f"#define LGC_MASS0 {_flist([spec.mass[0]])[1:-1]}",
        f"#define LGC_COM0 {_flist(spec.com[0])}",
        f"#define LGC_ICOM0 {_flist(spec.inertia_com[0])}",
    ]
    lines += lane_plan_lib.header_lines(plan)
    return "\n".join(lines) + "\n"


def library_key(spec: FusedSpec, lanes_per_branch: int = 1) -> str:
    """What names a built library: a hash of the kernel source, the generated
    header (the spec and its lane plan) and the nvcc flags."""
    with open(KERNEL_SOURCE) as f:
        source = f.read()
    text = source + spec_header(spec, lanes_per_branch) + " ".join(NVCC_FLAGS)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


class FusedKernel(NamedTuple):
    lib: ctypes.CDLL
    ptxas: str            # nvcc -Xptxas -v report (registers, spills)
    build_seconds: float  # 0.0 when loaded from the build directory


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}; set CUDA_HOME")
    return path


_KERNELS: dict = {}   # (FusedSpec, lanes per branch) -> FusedKernel, built once each


class NvccBuild:
    """An nvcc build of `source` (with `NVCC_FLAGS` and `extra` flags) into
    the shared library `lib_path`, started in the background on construction
    so that several builds can run together.  A library already at
    `lib_path` is reused: the caller names it by a hash of what it is built
    from."""

    def __init__(self, lib_path: str, source: str, extra=()):
        self.lib_path = lib_path
        self.log_path = lib_path[:-3] + ".ptxas.txt"
        self.proc = None
        self.t0 = time.time()
        if os.path.exists(lib_path):
            return
        self.tmp = f"{lib_path}.{os.getpid()}.tmp"
        self.cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", self.tmp, source]
        self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True)

    def wait(self):
        """Wait for nvcc; returns (the ptxas report, build seconds: 0.0 when
        the library was there), or raises with nvcc's output."""
        build_seconds = 0.0
        if self.proc is not None:
            out, err = self.proc.communicate()
            build_seconds = time.time() - self.t0
            if self.proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({self.proc.returncode}):\n"
                                   f"{' '.join(self.cmd)}\n{out}\n{err}")
            with open(self.log_path, "w") as f:
                f.write(out + err)
            os.replace(self.tmp, self.lib_path)
        ptxas = ""
        if os.path.exists(self.log_path):
            with open(self.log_path) as f:
                ptxas = "\n".join(l.strip() for l in f
                                  if "ptxas" in l or "registers" in l or "spill" in l)
        return ptxas, build_seconds


class KernelBuild:
    """An nvcc build of the kernel for one spec, started in the background
    on construction so that several builds can run together; `finish`
    waits for it and loads the library.  A library already in BUILD_DIR
    for the same source, spec header and flags is reused.  `lanes_per_branch`
    defaults to the wrapper's layout, `lanes_per_branch_for(spec)`."""

    def __init__(self, spec: FusedSpec, lanes_per_branch: int = None):
        check_covered(spec)
        self.spec = spec
        if lanes_per_branch is None:
            lanes_per_branch = lanes_per_branch_for(spec)
        self.key = (spec, lanes_per_branch)
        key = library_key(spec, lanes_per_branch)
        os.makedirs(BUILD_DIR, exist_ok=True)
        lib_path = os.path.join(BUILD_DIR, f"fused_step_{key}.so")
        hdr_path = os.path.join(BUILD_DIR, f"fused_step_{key}.h")
        if not os.path.exists(lib_path):
            with open(hdr_path, "w") as f:
                f.write(spec_header(spec, lanes_per_branch))
        self.build = NvccBuild(lib_path, KERNEL_SOURCE, ("-include", hdr_path))

    def finish(self) -> FusedKernel:
        ptxas, build_seconds = self.build.wait()
        lib = ctypes.CDLL(self.build.lib_path)
        # 12 inputs, the K3 window and its offsets (null for K1), 8 outputs
        # and the two link-state outputs
        lib.lgc_fused_control_step.argtypes = [ctypes.c_void_p] * 25 + [ctypes.c_int,
                                                                         ctypes.c_void_p]
        lib.lgc_fused_control_step.restype = ctypes.c_int
        lib.lgc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.lgc_cuda_error_string.restype = ctypes.c_char_p
        lib.lgc_fused_launch_info.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.lgc_fused_launch_info.restype = ctypes.c_int
        kernel = FusedKernel(lib, ptxas, build_seconds)
        _KERNELS[self.key] = kernel
        return kernel


def load_kernel(spec: FusedSpec, batch: int) -> FusedKernel:
    """The kernel library for `spec` in the wrapper's layout for `batch` envs,
    built at first use (or taken from a `KernelBuild` finished before)."""
    lanes = lanes_for_batch(spec, batch)
    kernel = _KERNELS.get((spec, lanes))
    return kernel if kernel is not None else KernelBuild(spec, lanes).finish()


def launch_info(kernel: FusedKernel, B: int) -> dict:
    """The launch shape of a built kernel for B envs: lanes per env and per
    branch, block, grid, shared memory, and the resident blocks per SM that
    cudaOccupancyMaxActiveBlocksPerMultiprocessor reports."""
    names = ("lanes_per_env", "block", "grid", "static_shared_bytes", "dynamic_shared_bytes",
             "resident_blocks_per_sm", "registers", "local_bytes_per_thread", "lanes_per_branch")
    out = (ctypes.c_int * len(names))()
    err = kernel.lib.lgc_fused_launch_info(B, out)
    if err != 0:
        raise RuntimeError("fused control-step launch info failed: "
                           + kernel.lib.lgc_cuda_error_string(err).decode())
    return dict(zip(names, out))


def ptxas_summary(ptxas: str) -> dict:
    """Registers / spill bytes / stack frame from the ptxas report."""
    out = {}
    m = re.search(r"Used (\d+) registers", ptxas)
    if m:
        out["registers"] = int(m.group(1))
    m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                  ptxas)
    if m:
        out["stack_frame_bytes"] = int(m.group(1))
        out["spill_store_bytes"] = int(m.group(2))
        out["spill_load_bytes"] = int(m.group(3))
    return out


# --------------------------------------------------------------------------
# The wrapper
# --------------------------------------------------------------------------


def patch_inputs(lp):
    """The heightfield kernel's terrain inputs from a physics.patch.LocalPatch:
    (window (B, K, K), xoff (B,), yoff (B,)), the offsets being the world
    coordinates of window cell (0, 0) in float32 exactly as the reference
    computes them (fused_step.py:978-979)."""
    xoff = lp.x0.to(torch.float32) * lp.horizontal_scale - lp.border_offset
    yoff = lp.y0.to(torch.float32) * lp.horizontal_scale - lp.border_offset
    return lp.data.to(torch.float32).contiguous(), xoff, yoff


def _check_inputs(spec: FusedSpec, state, actions, dr, terrain):
    ndof = len(spec.parent) - 1
    pos, quat, lin, ang, q, qd = state
    friction, added_mass, com_offset, kp_mult, kd_mult = dr
    B = pos.shape[-1]
    expected = [
        ("base_pos", pos, (3, B)), ("base_quat", quat, (4, B)), ("lin_vel", lin, (3, B)),
        ("ang_vel", ang, (3, B)), ("dof_pos", q, (ndof, B)), ("dof_vel", qd, (ndof, B)),
        ("actions", actions, (ndof, B)), ("friction", friction, (B,)),
        ("added_mass", added_mass, (B,)), ("com_offset", com_offset, (3, B)),
        ("kp_mult", kp_mult, (ndof, B)), ("kd_mult", kd_mult, (ndof, B)),
    ]
    if spec.hf_K:
        if terrain is None:
            raise NotImplementedError(
                "heightfield spec with no per-env patch: the heightfield kernel (K3) reads "
                "each env's window; pass terrain=(patch, xoff, yoff)")
        K = spec.hf_K
        patch, xoff, yoff = terrain
        expected += [("patch", patch, (B, K, K)), ("xoff", xoff, (B,)), ("yoff", yoff, (B,))]
    elif terrain is not None:
        raise ValueError("terrain inputs given for a plane spec (hf_K == 0)")
    device = pos.device
    for name, t, shape in expected:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    return B, device


def launch_kernel(kernel: FusedKernel, spec: FusedSpec, state, actions, dr, terrain=None):
    """Launch a built kernel on checked CUDA inputs, on the current stream;
    returns the 10 output tensors, the last two the link positions and
    velocities, (3 nl, B).  Counts nothing: `fused_control_step` is the
    wrapper, this is also how a build of another layout is timed."""
    B, device = actions.shape[-1], actions.device
    ndof = len(spec.parent) - 1
    empty = lambda c: torch.empty((c, B), dtype=torch.float32, device=device)
    outs = (empty(3), empty(4), empty(3), empty(3), empty(ndof), empty(ndof),
            empty(3 * spec.n_links), empty(ndof), empty(3 * spec.n_links),
            empty(3 * spec.n_links))
    ins = (*state, actions, *dr)
    terrain_ptrs = [t.data_ptr() for t in terrain] if spec.hf_K else [None] * 3
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = kernel.lib.lgc_fused_control_step(
            *[t.data_ptr() for t in ins], *terrain_ptrs, *[t.data_ptr() for t in outs], B,
            stream
        )
    if err != 0:
        raise RuntimeError(
            "fused control-step kernel launch failed: "
            + kernel.lib.lgc_cuda_error_string(err).decode()
        )
    return outs


def fused_control_step(spec: FusedSpec, state, actions, dr, terrain=None):
    """One control step for B envs.

    state: (pos (3,B), quat (4,B), lin (3,B), ang (3,B), q (ndof,B), qd (ndof,B));
    actions (ndof,B); dr: (friction (B,), added_mass (B,), com_offset (3,B),
    kp_mult (ndof,B), kd_mult (ndof,B)); terrain, for a heightfield spec:
    (patch (B,K,K), xoff (B,), yoff (B,)) as `patch_inputs` gives them; all
    float32 and contiguous.
    Returns ((pos, quat, lin, ang, q, qd), link_forces (nl,3,B), torques (ndof,B),
    link_pos (nl,3,B), link_vel (nl,3,B)): the report links' world positions
    and linear velocities at the final state (physics.engine.link_states'
    math).

    CPU tensors run the plain version; CUDA tensors launch the kernel, in the
    layout `lanes_for_batch` picks for B, on the current stream, adding one
    to the variant's counter (`launch_counts`), or raise.
    """
    check_covered(spec)
    B, device = _check_inputs(spec, state, actions, dr, terrain)
    if device.type == "cpu":
        return plain_control_step(spec, state, actions, dr, terrain)
    if device.type != "cuda":
        raise RuntimeError(f"fused_control_step: unsupported device {device}")
    kernel = load_kernel(spec, B)
    outs = launch_kernel(kernel, spec, state, actions, dr, terrain)
    if spec.control_type == "T" or spec.fl_dqd:
        name = variant_name(spec)
        fused_control_step.k2_launches[name] = fused_control_step.k2_launches.get(name, 0) + 1
    elif spec.hf_K:
        fused_control_step.hf_launches += 1
    else:
        fused_control_step.launches += 1
    opos, oquat, olin, oang, oq, oqd, olf, otau, olpos, olvel = outs
    rows = lambda t: t.view(spec.n_links, 3, B)
    return (opos, oquat, olin, oang, oq, oqd), rows(olf), otau, rows(olpos), rows(olvel)


fused_control_step.launches = 0      # K1, the plane variant
fused_control_step.hf_launches = 0   # K3, the heightfield variant
fused_control_step.k2_launches = {}  # K2: `variant_name` -> launches


def variant_name(spec: FusedSpec) -> str:
    """The build-time variant of a spec: `fused_control_step` (K1), with
    `_T` for torque control, `_stiction` for implicit stiction (K2) and `_hf`
    on a heightfield (K3)."""
    return ("fused_control_step" + ("_T" if spec.control_type == "T" else "")
            + ("_stiction" if spec.fl_dqd else "") + ("_hf" if spec.hf_K else ""))


def launch_counts() -> dict:
    """Launches so far of every variant that has a counter, by `variant_name`."""
    return {"fused_control_step": fused_control_step.launches,
            "fused_control_step_hf": fused_control_step.hf_launches,
            **fused_control_step.k2_launches}


def reset_launch_counts() -> None:
    fused_control_step.launches = 0
    fused_control_step.hf_launches = 0
    fused_control_step.k2_launches = {}
