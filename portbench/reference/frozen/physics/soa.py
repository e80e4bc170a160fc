"""Component-major ("structure-of-arrays") primitives, torch port of
legged_gym_custom_tpu/physics/soa.py.

Convention: vectors are (3,)+bs / (6,)+bs, matrices (3,3)+bs / (6,6)+bs,
quaternions (4,)+bs wxyz world <- body, with the env batch bs trailing.  On
the GPU the trailing batch makes every per-component row contiguous, so
elementwise passes over a component read coalesced memory.
"""
from __future__ import annotations

import torch


def mv(M, v):
    """Matrix @ vector over leading axes: (i,j)+bs, (j,)+bs -> (i,)+bs."""
    return torch.einsum("ij...,j...->i...", M, v)


def mtv(M, v):
    """Matrix.T @ vector."""
    return torch.einsum("ji...,j...->i...", M, v)


def mm(M, N):
    return torch.einsum("ij...,jk...->ik...", M, N)


def mtm(M, N):
    """M.T @ N."""
    return torch.einsum("ji...,jk...->ik...", M, N)


def mmt(M, N):
    """M @ N.T."""
    return torch.einsum("ij...,kj...->ik...", M, N)


def outer(a, b):
    return torch.einsum("i...,j...->ij...", a, b)


def dot(a, b):
    return torch.sum(a * b, dim=0)


def cross(a, b):
    a0, a1, a2 = a[0], a[1], a[2]
    b0, b1, b2 = b[0], b[1], b[2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0])


def hat(v):
    z = torch.zeros_like(v[0])
    return torch.stack(
        [
            torch.stack([z, -v[2], v[1]]),
            torch.stack([v[2], z, -v[0]]),
            torch.stack([-v[1], v[0], z]),
        ]
    )


def eye3(like):
    """(3,3)+bs identity with the batch shape of `like` (a ()+bs scalar)."""
    e = torch.eye(3, dtype=like.dtype, device=like.device)
    return e.reshape((3, 3) + (1,) * like.dim()).expand((3, 3) + tuple(like.shape))


def bcast(x, bs):
    """Append singleton axes so a per-component constant broadcasts over bs."""
    return x.reshape(tuple(x.shape) + (1,) * len(bs))


# --------------------------------------------------------------------------
# Quaternions (4,)+bs, wxyz, world <- body
# --------------------------------------------------------------------------


def quat_to_matrix(q):
    w, x, y, z = q[0], q[1], q[2], q[3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    one = torch.ones_like(w)
    return torch.stack(
        [
            torch.stack([one - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)]),
            torch.stack([2 * (xy + wz), one - 2 * (xx + zz), 2 * (yz - wx)]),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), one - 2 * (xx + yy)]),
        ]
    )


def quat_mul(a, b):
    aw, ax, ay, az = a[0], a[1], a[2], a[3]
    bw, bx, by, bz = b[0], b[1], b[2], b[3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def quat_integrate(q, omega_body, dt):
    angle = torch.sqrt(torch.sum(omega_body**2, dim=0)).clamp(min=1e-9)
    axis = omega_body / angle
    half = 0.5 * angle * dt
    dq = torch.cat([torch.cos(half)[None], axis * torch.sin(half)[None]])
    out = quat_mul(q, dq)
    return out / torch.sqrt(torch.sum(out**2, dim=0)).clamp(min=1e-9)


def rot_axis(axis, q):
    """R(axis, q) rotating by +q about a static (3,) axis; q is ()+bs."""
    c, s = torch.cos(q), torch.sin(q)
    a = bcast(axis.to(q.dtype), q.shape) * torch.ones_like(q)
    return c * eye3(q) + s * hat(a) + (1 - c) * outer(a, a)


# --------------------------------------------------------------------------
# Spatial vectors (6,)+bs = [angular; linear]; transforms X = (E, p)
# --------------------------------------------------------------------------


def sv(angv, linv):
    return torch.cat([angv, linv], dim=0)


def xform_motion(E, p, m):
    w, v = m[0:3], m[3:6]
    return sv(mv(E, w), mv(E, v - cross(p, w)))


def inv_xform_force(E, p, f):
    ff = mtv(E, f[3:6])
    n = mtv(E, f[0:3])
    return sv(n + cross(p, ff), ff)


def crm(v, m):
    w, vl = v[0:3], v[3:6]
    mw, ml = m[0:3], m[3:6]
    return sv(cross(w, mw), cross(w, ml) + cross(vl, mw))


def crf(v, f):
    w, vl = v[0:3], v[3:6]
    n, ff = f[0:3], f[3:6]
    return sv(cross(w, n) + cross(vl, ff), cross(w, ff))


def inertia_mul(m, h, I, v):
    """Spatial inertia (m ()+bs, h (3,)+bs, I (3,3)+bs) applied to motion v."""
    w, vl = v[0:3], v[3:6]
    return sv(mv(I, w) + cross(h, vl), m * vl - cross(h, w))


def inertia_to_mat66(m, h, I):
    hx = hat(h)
    mI = m * eye3(m)
    top = torch.cat([I, hx], dim=1)
    bot = torch.cat([-hx, mI], dim=1)
    return torch.cat([top, bot], dim=0)


def xform_to_mat66(E, p):
    zero = torch.zeros_like(E)
    top = torch.cat([E, zero], dim=1)
    bot = torch.cat([-mm(E, hat(p)), E], dim=1)
    return torch.cat([top, bot], dim=0)


def inv3(M):
    """Closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[0, 0], M[0, 1], M[0, 2]
    d, e, f = M[1, 0], M[1, 1], M[1, 2]
    g, h, i = M[2, 0], M[2, 1], M[2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / det
    return torch.stack(
        [torch.stack([A, B, C]), torch.stack([D, E, F]), torch.stack([G, H, I])]
    ) * inv_det


def solve66(A, b):
    """Solve the SPD system A x = b for (6,6)+bs / (6,)+bs via 3x3 Schur blocks."""
    A11, A12 = A[0:3, 0:3], A[0:3, 3:6]
    A21, A22 = A[3:6, 0:3], A[3:6, 3:6]
    b1, b2 = b[0:3], b[3:6]
    A11i = inv3(A11)
    S = A22 - mm(A21, mm(A11i, A12))
    Si = inv3(S)
    x2 = mv(Si, b2 - mv(A21, mv(A11i, b1)))
    x1 = mv(A11i, b1 - mv(A12, x2))
    return torch.cat([x1, x2], dim=0)
