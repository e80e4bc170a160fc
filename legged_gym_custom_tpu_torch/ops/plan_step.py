"""A plain PyTorch control step that walks the lane plan (ops/lane_plan.py).

It computes the control step of `fused_step.plain_control_step` (the link
states of the kernel's last outward pass aside), in the order and by the
arithmetic of the CUDA kernel (ops/csrc/fused_step.cu): every lane of
the group walks its own slots, reads each model constant through
`LanePlan.const` (the shared value of the slot, or its row of the lane
table), turns a joint about a coordinate axis as a planar rotation (the
matrix holds a literal 1 and zeros, which fold), carries articulated inertias
as three 3x3 blocks (two of them symmetric, 6 entries each) and moves them to
the parent by rotating the blocks and shifting them with cross products; the
lanes meet at the base, by butterfly sums, and in the layout for deep chains
(`LanePlan.split`) also at every slot of the inward pass, where the lanes of
a branch each carry one of the blocks (`_inward_split`).  The kernel cannot
run without a card; this can, so a wrong index in the plan's tables shows
here, against the plain version.

What every lane of a group would compute alike is computed once here: a sum
of the butterfly is formed once and shared by the lanes that hold it, and the
base's 6x6 system is solved once.  Walked with one lane per branch, the step
therefore does the arithmetic the kernel's algorithm needs for one env and no
more, which is what `ops/roofline.py::count_kernel_ops` counts for the
kernel's bound and its roofline.
"""
from __future__ import annotations

import torch

from .fused_step import (_add, _body_inertias_components, _crf, _crm, _cross, _dot, _hat,
                         _inertia_mul, _inv_xform_force, _mm, _mtv, _mul, _mv, _quat_to_matrix,
                         _solve66, _sub, _tile_surface, _vadd, _xform_motion, check_covered)
from .lane_plan import SYM6, LanePlan


def _consts(plan: LanePlan, name, item, lane, n):
    return [plan.const(name, item, c, lane) for c in range(n)]


def _sym(v6):
    """A symmetric 3x3 from its 6 entries (xx, xy, xz, yy, yz, zz)."""
    return [[v6[0], v6[1], v6[2]], [v6[1], v6[3], v6[4]], [v6[2], v6[4], v6[5]]]


def _sym6(M):
    return [M[r][c] for r, c in SYM6]


def _transpose(A):
    return [[A[j][i] for j in range(3)] for i in range(3)]


def _butterfly(values, masks):
    """Each lane's sum over its butterfly partners: `values[g]` is a flat
    list; after mask m lane g holds its own plus lane g ^ m's.  The two lanes
    of an exchange hold the same sum to the bit (a + b is b + a), so it is
    formed once and both lanes refer to it."""
    for m in masks:
        formed = {}
        for g in range(len(values)):
            key = frozenset((id(values[g]), id(values[g ^ m])))
            if key not in formed:
                formed[key] = [_add(a, b) for a, b in zip(values[g], values[g ^ m])]
        values = [formed[frozenset((id(values[g]), id(values[g ^ m])))]
                  for g in range(len(values))]
    return values


def _sandwich(E, A, symmetric):
    """E^T A E; of a symmetric A only the upper triangle is formed and
    mirrored."""
    T = _mm(A, E)
    out = [[None] * 3 for _ in range(3)]
    for r in range(3):
        for c in range(3):
            if symmetric and c < r:
                out[r][c] = out[c][r]
            else:
                out[r][c] = _dot([E[0][r], E[1][r], E[2][r]], [T[0][c], T[1][c], T[2][c]])
    return out


def _masks(lo, hi):
    out, m = [], lo
    while m < hi:
        out.append(m)
        m *= 2
    return out


def _contact(spec, plan, e, lane, E0, p0, v, pos, mu, terrain, surf, sample_now):
    """One sphere entry of a body at (E0, p0, v): (torque, force) in world
    axes about the body origin.  An entry no geom fills has a radius that
    never touches, and so adds exactly zero."""
    gpos = _consts(plan, "GPOS", e, lane, 3)
    radius = plan.const("GRAD", e, 0, lane)
    off = _mtv(E0, gpos)
    cz = _add(_add(pos[2], p0[2]), off[2])
    vel_b = _vadd(v[3:6], _cross(v[0:3], gpos))
    vel_w = _mtv(E0, vel_b)
    if spec.hf_K > 0:
        if sample_now:
            cx, cy = (_add(_add(pos[k], p0[k]), off[k]) for k in (0, 1))
            surf[lane][e] = _tile_surface(spec, terrain, cx, cy)
        h, nx, ny, nz = surf[lane][e]
        depth = radius - nz * (cz - h)
        vn = vel_w[0] * nx + vel_w[1] * ny + vel_w[2] * nz
        vt = [vel_w[0] - vn * nx, vel_w[1] - vn * ny, vel_w[2] - vn * nz]
        vt_norm = torch.sqrt(vt[0] * vt[0] + vt[1] * vt[1] + vt[2] * vt[2])
        fn = torch.clamp(spec.stiffness * depth - spec.damping * vn, min=0.0)
        fn = torch.where(depth > 0.0, fn, torch.zeros_like(fn))
        ft_mag = torch.minimum(spec.friction_vel * vt_norm, mu * fn)
        inv_vt = ft_mag / (vt_norm + 1e-6)
        force = [fn * nx - vt[0] * inv_vt, fn * ny - vt[1] * inv_vt, fn * nz - vt[2] * inv_vt]
    else:
        depth = radius - cz
        vn = vel_w[2]
        fn = torch.clamp(spec.stiffness * depth - spec.damping * vn, min=0.0)
        fn = torch.where(depth > 0.0, fn, torch.zeros_like(fn))
        vt_norm = torch.sqrt(vel_w[0] * vel_w[0] + vel_w[1] * vel_w[1])
        ft_mag = torch.minimum(spec.friction_vel * vt_norm, mu * fn)
        inv_vt = ft_mag / (vt_norm + 1e-6)
        force = [-vel_w[0] * inv_vt, -vel_w[1] * inv_vt, fn]
    return _cross(off, force), force


def _substep(spec, plan: LanePlan, base, q, qd, tau, mu, base_inertia, terrain, surf, lf_acc,
             sample_now):
    """One substep.  `base`: dict of pos/quat/lin/ang component lists (every
    lane of the group holds the same); q, qd, tau: [lane][slot]; surf and
    lf_acc: [lane][entry].  Returns (base', q', qd')."""
    G, D, L = plan.G, plan.depth, plan.lanes_per_branch
    dt = spec.dt / spec.substeps
    grav = list(spec.gravity)
    zero3 = [0.0, 0.0, 0.0]
    pslot = plan.itab[plan.irow["PSLOT"]:plan.irow["PSLOT"] + D]

    R = _quat_to_matrix(base["quat"])
    E0b = _transpose(R)
    w_b, u_b = _mtv(R, base["ang"]), _mtv(R, base["lin"])
    v0 = w_b + u_b

    # ---- outward: kinematics, then each body's contacts
    E0 = [[None] * D for _ in range(G)]
    p0 = [[None] * D for _ in range(G)]
    Eup = [[None] * D for _ in range(G)]
    v = [[None] * D for _ in range(G)]
    cb = [[None] * D for _ in range(G)]
    wr = [[None] * D for _ in range(G)]
    wb = [None] * G
    for g in range(G):
        for s in range(D):
            ps = int(pslot[s, g])
            Ep, pp, vp = (E0b, zero3, v0) if ps < 0 else (E0[g][ps], p0[g][ps], v[g][ps])
            a = _consts(plan, "AXIS", s, g, 3)
            cq, sq = torch.cos(q[g][s]), torch.sin(q[g][s])
            k = plan.rot_axis[s]
            if k >= 0:    # about coordinate axis k with an identity joint frame: planar
                i, j = (k + 1) % 3, (k + 2) % 3
                Eup[g][s] = [[0.0] * 3 for _ in range(3)]
                Eup[g][s][k][k] = 1.0
                Eup[g][s][i][i] = Eup[g][s][j][j] = cq
                Eup[g][s][i][j], Eup[g][s][j][i] = sq, -sq
            else:
                ax = _hat(a)
                Rj = [[_add(_add(cq if r == c else 0.0, _mul(sq, ax[r][c])),
                            _mul(1.0 - cq, a[r] * a[c])) for c in range(3)] for r in range(3)]
                jrot = _consts(plan, "JROT", s, g, 9)
                Eup[g][s] = _mm(_transpose(Rj), [jrot[0:3], jrot[3:6], jrot[6:9]])
            E0[g][s] = _mm(Eup[g][s], Ep)
            jp = _consts(plan, "JPOS", s, g, 3)
            p0[g][s] = _vadd(pp, _mtv(Ep, jp))
            vi = _xform_motion(Eup[g][s], jp, vp)
            v[g][s] = [_add(vi[k], _mul(a[k], qd[g][s])) for k in range(3)] + vi[3:6]
            vJ = [_mul(a[k], qd[g][s]) for k in range(3)] + [0.0, 0.0, 0.0]
            cb[g][s] = _crm(v[g][s], vJ)
            w6 = [0.0] * 6
            for k in range(plan.n_sph[s]):
                e = plan.entry(s, k)
                torque, force = _contact(spec, plan, e, g, E0[g][s], p0[g][s], v[g][s],
                                         base["pos"], mu, terrain, surf, sample_now)
                w6 = [_add(w6[i], x) for i, x in enumerate(torque + force)]
                if lf_acc is not None:
                    lf_acc[g][e] = [_add(lf_acc[g][e][i], force[i]) for i in range(3)]
            wr[g][s] = w6
        w6 = [0.0] * 6
        for k in range(plan.n_sph_base):
            e = plan.entry(-1, k)
            torque, force = _contact(spec, plan, e, g, E0b, zero3, v0, base["pos"], mu, terrain,
                                     surf, sample_now)
            w6 = [_add(w6[i], x) for i, x in enumerate(torque + force)]
            if lf_acc is not None:
                lf_acc[g][e] = [_add(lf_acc[g][e][i], force[i]) for i in range(3)]
        wb[g] = w6
    # the lanes of a branch sum the wrenches of its bodies
    for s in range(D):
        summed = _butterfly([wr[g][s] for g in range(G)], _masks(1, L))
        for g in range(G):
            wr[g][s] = summed[g]

    # ---- bias forces and joint torques, then the inward pass
    pA = [[None] * D for _ in range(G)]
    tau_total = [[None] * D for _ in range(G)]
    for g in range(G):
        for s in range(D):
            m = plan.const("MASS", s, 0, g)
            h = _consts(plan, "MH", s, g, 3)
            I = _sym(_consts(plan, "IO", s, g, 6))
            pa = _crf(v[g][s], _inertia_mul(m, h, I, v[g][s]))
            g_b = _mv(E0[g][s], grav)
            hxg = _cross(h, g_b)
            n_b = _mv(E0[g][s], wr[g][s][0:3])
            f_b = _mv(E0[g][s], wr[g][s][3:6])
            pA[g][s] = [_sub(_sub(pa[k], hxg[k]), n_b[k]) for k in range(3)] + [
                _sub(_sub(pa[3 + k], _mul(m, g_b[k])), f_b[k]) for k in range(3)]
            qj, qdj = q[g][s], qd[g][s]
            below = torch.clamp(qj - plan.const("LO", s, 0, g), max=0.0)
            above = torch.clamp(qj - plan.const("HI", s, 0, g), min=0.0)
            viol = (below < 0) | (above > 0)
            t = tau[g][s] + (-spec.jl_stiffness * (below + above) - torch.where(
                viol, spec.jl_damping * qdj, torch.zeros_like(qdj)))
            t = _sub(t, _mul(plan.const("DAMP", s, 0, g), qdj))
            if not spec.fl_dqd:
                t = _sub(t, _mul(plan.const("FL", s, 0, g),
                                 torch.tanh(qdj * (1.0 / spec.fl_eps))))
            tau_total[g][s] = t
    inward = _inward_split if plan.split else _inward_lanes
    U, inv_d, u, P = inward(plan, pA, tau_total, cb, Eup)

    # ---- the base: the branches' sums, its own spheres over all lanes, the solve
    wb = _butterfly(wb, _masks(1, G))
    m0, h0, I0 = base_inertia
    pa0 = _crf(v0, _inertia_mul(m0, h0, I0, v0))
    g_b = _mv(E0b, grav)
    hxg = _cross(h0, g_b)
    # every lane of the group holds these sums and would solve alike: once here
    w = wb[0]
    Ib = _sym([_add(I0[r][c], P[i]) for i, (r, c) in enumerate(SYM6)])
    hx = _hat(h0)
    H = [[_add(hx[r][c], P[6 + 3 * r + c]) for c in range(3)] for r in range(3)]
    Mb = _sym([_add(m0 if r == c else 0.0, P[15 + i]) for i, (r, c) in enumerate(SYM6)])
    n_b, f_b = _mv(E0b, w[0:3]), _mv(E0b, w[3:6])
    pA0 = [_add(_sub(_sub(pa0[k], hxg[k]), n_b[k]), P[21 + k]) for k in range(3)] + [
        _add(_sub(_sub(pa0[3 + k], _mul(m0, g_b[k])), f_b[k]), P[24 + k]) for k in range(3)]
    A66 = [Ib[r] + H[r] for r in range(3)] + [
        [H[c][r] for c in range(3)] + Mb[r] for r in range(3)]
    a0 = _solve66(A66, [-x for x in pA0])

    # ---- outward: joint accelerations
    q_new = [[None] * D for _ in range(G)]
    qd_new = [[None] * D for _ in range(G)]
    for g in range(G):
        acc = [None] * D
        for s in range(D):
            ps = int(pslot[s, g])
            ap = a0 if ps < 0 else acc[ps]
            jp = _consts(plan, "JPOS", s, g, 3)
            ai = _vadd(_xform_motion(Eup[g][s], jp, ap), cb[g][s])
            qdd = _sub(u[g][s], _dot(U[g][s], ai)) * inv_d[g][s]
            a = _consts(plan, "AXIS", s, g, 3)
            acc[s] = [_add(ai[k], _mul(a[k], qdd)) for k in range(3)] + ai[3:6]
            vj = qd[g][s] + qdd * dt
            if spec.fl_dqd:
                lim = plan.const("DQD", s, 0, g)
                vj = vj - torch.clamp(vj, -lim, lim)
            if spec.dof_vel_clamp:
                lim = plan.const("VLIM", s, 0, g)
                vj = torch.clamp(vj, -lim, lim)
            qd_new[g][s] = vj
            q_new[g][s] = q[g][s] + vj * dt

    # ---- semi-implicit Euler of the base
    w2 = [w_b[k] + a0[k] * dt for k in range(3)]
    u2 = [u_b[k] + a0[3 + k] * dt for k in range(3)]
    lin, ang = _mv(R, u2), _mv(R, w2)
    pos = [base["pos"][k] + lin[k] * dt for k in range(3)]
    angle = torch.clamp(torch.sqrt(w2[0] ** 2 + w2[1] ** 2 + w2[2] ** 2), min=1e-9)
    inv_angle = 1.0 / angle
    half = 0.5 * angle * dt
    ch, sh = torch.cos(half), torch.sin(half)
    dq = [ch, w2[0] * inv_angle * sh, w2[1] * inv_angle * sh, w2[2] * inv_angle * sh]
    qw, qx, qy, qz = base["quat"]
    quat = [qw * dq[0] - qx * dq[1] - qy * dq[2] - qz * dq[3],
            qw * dq[1] + qx * dq[0] + qy * dq[3] - qz * dq[2],
            qw * dq[2] - qx * dq[3] + qy * dq[0] + qz * dq[1],
            qw * dq[3] + qx * dq[2] - qy * dq[1] + qz * dq[0]]
    qn = 1.0 / torch.clamp(torch.sqrt(quat[0] ** 2 + quat[1] ** 2 + quat[2] ** 2 + quat[3] ** 2),
                           min=1e-9)
    quat = [x * qn for x in quat]
    return dict(pos=pos, quat=quat, lin=lin, ang=ang), q_new, qd_new


def _inward_lanes(plan: LanePlan, pA, tau_total, cb, Eup):
    """The inward pass with each lane carrying its branch's whole
    articulated inertia (L = 1, 2).  pA, tau_total, cb, Eup: [lane][slot].
    Returns U, inv_d, u ([lane][slot]) and the group's sums at the base:
    I (6 entries), H (9), M (6) and the bias force (6)."""
    G, D, L = plan.G, plan.depth, plan.lanes_per_branch
    pslot = plan.itab[plan.irow["PSLOT"]:plan.irow["PSLOT"] + D]
    U = [[None] * D for _ in range(G)]
    inv_d = [[None] * D for _ in range(G)]
    u = [[None] * D for _ in range(G)]
    part = []     # per lane: what its branch adds to the base, 21 + 6 numbers
    for g in range(G):
        # children's blocks (I 6, H 9, M 6) and forces, by slot; -1 is the base
        IAc = {t: None for t in range(-1, D)}
        pAc = {t: None for t in range(-1, D)}
        for s in range(D - 1, -1, -1):
            m = plan.const("MASS", s, 0, g)
            h = _consts(plan, "MH", s, g, 3)
            I6 = _consts(plan, "IO", s, g, 6)
            H = _hat(h)
            M6 = [m, 0.0, 0.0, m, 0.0, m]
            pa = pA[g][s]
            if IAc[s] is not None:
                cI, cH, cM = IAc[s]
                I6 = [_add(x, y) for x, y in zip(I6, cI)]
                H = [[_add(H[r][c], cH[r][c]) for c in range(3)] for r in range(3)]
                M6 = [_add(x, y) for x, y in zip(M6, cM)]
                pa = _vadd(pa, pAc[s])
            a = _consts(plan, "AXIS", s, g, 3)
            Ib, Mb = _sym(I6), _sym(M6)
            Uw, Uv = _mv(Ib, a), _mtv(H, a)
            d = _add(_dot(a, Uw), plan.const("ARM", s, 0, g))
            u[g][s] = _sub(tau_total[g][s], _dot(a, pa[0:3]))
            inv_d[g][s] = 1.0 / d
            U[g][s] = Uw + Uv
            idg = inv_d[g][s]
            In = _sym([_sub(Ib[r][c], _mul(_mul(Uw[r], Uw[c]), idg)) for r, c in SYM6])
            Hn = [[_sub(H[r][c], _mul(_mul(Uw[r], Uv[c]), idg)) for c in range(3)]
                  for r in range(3)]
            Mn = _sym([_sub(Mb[r][c], _mul(_mul(Uv[r], Uv[c]), idg)) for r, c in SYM6])
            cw, cv = cb[g][s][0:3], cb[g][s][3:6]
            uid = u[g][s] * idg
            top = _vadd(_mv(In, cw), _mv(Hn, cv))
            bot = _vadd(_mtv(Hn, cw), _mv(Mn, cv))
            pa2 = [_add(_add(pa[k], top[k]), _mul(Uw[k], uid)) for k in range(3)] + [
                _add(_add(pa[3 + k], bot[k]), _mul(Uv[k], uid)) for k in range(3)]
            # to the parent: rotate the blocks by E, then shift them by p
            E = Eup[g][s]
            jp = _consts(plan, "JPOS", s, g, 3)
            px = _hat(jp)
            It = _sandwich(E, In, True)
            Ht = _sandwich(E, Hn, False)
            Mt = _sandwich(E, Mn, True)
            Hp = [[_add(Ht[r][c], _dot(px[r], [Mt[0][c], Mt[1][c], Mt[2][c]]))
                   for c in range(3)] for r in range(3)]
            # I' = I~ + (p^ H~^T)^T + p^ H'^T, its upper triangle
            Ip6 = [_add(_add(It[r][c], _dot(px[c], Ht[r])), _dot(px[r], Hp[c])) for r, c in SYM6]
            fp = _inv_xform_force(E, jp, pa2)
            ps = int(pslot[s, g])
            if IAc[ps] is None:
                IAc[ps], pAc[ps] = (Ip6, Hp, _sym6(Mt)), fp
            else:
                cI, cH, cM = IAc[ps]
                IAc[ps] = ([_add(x, y) for x, y in zip(cI, Ip6)],
                           [[_add(cH[r][c], Hp[r][c]) for c in range(3)] for r in range(3)],
                           [_add(x, y) for x, y in zip(cM, _sym6(Mt))])
                pAc[ps] = _vadd(pAc[ps], fp)
        cI, cH, cM = IAc[-1]
        part.append(list(cI) + [x for row in cH for x in row] + list(cM) + list(pAc[-1]))
    return U, inv_d, u, _butterfly(part, _masks(L, G))[0]


def _inward_split(plan: LanePlan, pA, tau_total, cb, Eup):
    """The inward pass of the layout for deep chains (L = 4), as the kernel
    splits it: lanes 0, 1 and 2 of a branch carry the blocks I, H and M of
    the articulated inertia (lane 3 repeats M and shares nothing), U takes
    I a and H^T a from the I and H lanes, the bias force sums the lanes'
    shares of Ia c by butterfly, and the shift to the parent takes M~ and H~
    from their lanes.  What the four lanes compute alike from the same
    inputs (U, d, u, the bias force, the shift's products) is computed once
    a branch from its first lane's values.  Arguments and result as
    `_inward_lanes`."""
    G, D, L = plan.G, plan.depth, plan.lanes_per_branch
    pslot = plan.itab[plan.irow["PSLOT"]:plan.irow["PSLOT"] + D]
    block = lambda g: min(g % L, 2)     # 0 I, 1 H, 2 M (the fourth lane: M again)
    U = [[None] * D for _ in range(G)]
    inv_d = [[None] * D for _ in range(G)]
    u = [[None] * D for _ in range(G)]
    Xc = [{} for _ in range(G)]   # per lane: slot -> its block summed over the slot's children
    Pc = [{} for _ in range(G)]   # per lane: slot -> the children's bias forces; -1 the base
    zero3 = [0.0, 0.0, 0.0]

    def add3(A, B):
        return [[_add(A[r][c], B[r][c]) for c in range(3)] for r in range(3)]

    for s in range(D - 1, -1, -1):
        X = []
        for g in range(G):     # each lane's own block: its body's plus its children's
            m = plan.const("MASS", s, 0, g)
            own = (_sym(_consts(plan, "IO", s, g, 6)), _hat(_consts(plan, "MH", s, g, 3)),
                   [[m if r == c else 0.0 for c in range(3)] for r in range(3)])[block(g)]
            X.append(own if s not in Xc[g] else add3(own, Xc[g][s]))
        for g0 in range(0, G, L):
            lanes = range(g0, g0 + L)
            a = _consts(plan, "AXIS", s, g0, 3)
            pa = pA[g0][s] if s not in Pc[g0] else _vadd(pA[g0][s], Pc[g0][s])
            Uw, Uv = _mv(X[g0], a), _mtv(X[g0 + 1], a)
            idg = 1.0 / _add(_dot(a, Uw), plan.const("ARM", s, 0, g0))
            u_s = _sub(tau_total[g0][s], _dot(a, pa[0:3]))
            Xn = {}
            for g in lanes:
                lv, rv = (Uv if block(g) == 2 else Uw), (Uw if block(g) == 0 else Uv)
                Xn[g] = [[_sub(X[g][r][c], _mul(_mul(lv[r], rv[c]), idg)) for c in range(3)]
                         for r in range(3)]
            cw, cv = cb[g0][s][0:3], cb[g0][s][3:6]
            shares = []
            for g in lanes:     # [I cw; 0], [H cv; H^T cw], [0; M cv], nothing
                role = g % L
                top = _mv(Xn[g], cw) if role == 0 else _mv(Xn[g], cv) if role == 1 else zero3
                bot = _mtv(Xn[g], cw) if role == 1 else _mtv(Xn[g], cv) if role == 2 else zero3
                shares.append(top + bot)
            iac = _butterfly(shares, _masks(1, L))[0]
            uid = u_s * idg
            pa2 = [_add(_add(pa[k], iac[k]), _mul(Uw[k], uid)) for k in range(3)] + [
                _add(_add(pa[3 + k], iac[3 + k]), _mul(Uv[k], uid)) for k in range(3)]
            Xt = {g: _sandwich(Eup[g][s], Xn[g], block(g) != 1) for g in lanes}
            Ht, Mt = Xt[g0 + 1], Xt[g0 + 2]
            jp = _consts(plan, "JPOS", s, g0, 3)
            px = _hat(jp)
            Hp = [[_add(Ht[r][c], _dot(px[r], [Mt[0][c], Mt[1][c], Mt[2][c]]))
                   for c in range(3)] for r in range(3)]
            It = Xt[g0]
            Ip = _sym([_add(_add(It[r][c], _dot(px[c], Ht[r])), _dot(px[r], Hp[c]))
                       for r, c in SYM6])
            fp = _inv_xform_force(Eup[g0][s], jp, pa2)
            for g in lanes:
                U[g][s], inv_d[g][s], u[g][s] = Uw + Uv, idg, u_s
                Xp = (Ip, Hp, Xt[g])[block(g)]
                ps = int(pslot[s, g])
                Xc[g][ps] = Xp if ps not in Xc[g] else add3(Xc[g][ps], Xp)
                Pc[g][ps] = fp if ps not in Pc[g] else _vadd(Pc[g][ps], fp)
    # the base: each lane's block and force summed over the group's branches,
    # then every lane takes the blocks from its branch's lanes
    flat = [[x for row in Xc[g][-1] for x in row] + list(Pc[g][-1]) for g in range(G)]
    flat = _butterfly(flat, _masks(L, G))
    I9, H9, M9 = flat[0][:9], flat[1][:9], flat[2][:9]
    sym6 = lambda v9: [v9[3 * r + c] for r, c in SYM6]
    return U, inv_d, u, sym6(I9) + H9 + sym6(M9) + flat[0][9:15]


def plan_control_step(spec, plan: LanePlan, state, actions, dr, terrain=None):
    """One control step on (C, B) tensors, walking `plan`; arguments and
    result as `fused_step.plain_control_step`."""
    check_covered(spec)
    pos, quat, lin, ang, q_in, qd_in = state
    friction, added_mass, com_offset, kp_mult, kd_mult = dr
    G, D = plan.G, plan.depth
    ndof, nl = len(spec.parent) - 1, spec.n_links
    zeros = torch.zeros_like(pos[0])
    tr = dict(zip(("patch", "xoff", "yoff"), terrain)) if terrain is not None else None
    jload = plan.itab[plan.irow["JLOAD"]:plan.irow["JLOAD"] + D]
    jstore = plan.itab[plan.irow["JSTORE"]:plan.irow["JSTORE"] + D]
    link = plan.itab[plan.irow["LINK"]:plan.irow["LINK"] + plan.n_entries]

    def rows(t):   # a (ndof, B) input as [lane][slot]; a masked slot reads zero
        return [[t[int(jload[s, g])] if jload[s, g] >= 0 else zeros for s in range(D)]
                for g in range(G)]

    q, qd, act, kpm, kdm = map(rows, (q_in, qd_in, actions, kp_mult, kd_mult))
    base = dict(pos=list(pos), quat=list(quat), lin=list(lin), ang=list(ang))
    mu = 0.5 * (friction + spec.terrain_friction)
    base_inertia = _body_inertias_components(spec, added_mass, list(com_offset))[0]
    tau = lf_acc = None
    for tick in range(spec.decimation):
        tau = [[None] * D for _ in range(G)]
        for g in range(G):
            for s in range(D):
                if spec.control_type == "T":
                    t = act[g][s] * spec.action_scale
                else:
                    kp = kpm[g][s] * plan.const("PG", s, 0, g)
                    kd = kdm[g][s] * plan.const("DG", s, 0, g)
                    t = kp * (act[g][s] * spec.action_scale + plan.const("DPOS", s, 0, g)
                              - q[g][s]) - kd * qd[g][s]
                lim = plan.const("TLIM", s, 0, g)
                tau[g][s] = torch.clamp(t, -lim, lim)
        # link forces are the mean over the last tick's substeps only
        last = tick == spec.decimation - 1
        lf_acc = [[[0.0] * 3 for _ in range(plan.n_entries)] for _ in range(G)] if last else None
        surf = [[None] * plan.n_entries for _ in range(G)]
        for s_ in range(spec.substeps):
            base, q, qd = _substep(spec, plan, base, q, qd, tau, mu, base_inertia, tr, surf,
                                   lf_acc, sample_now=s_ == 0)

    # ---- outputs: each dof from the lane that stores it; link forces summed
    # lane by lane, entry by entry
    full = lambda x: x if isinstance(x, torch.Tensor) else zeros + x
    q_out, qd_out, tau_out = [None] * ndof, [None] * ndof, [None] * ndof
    for g in range(G):
        for s in range(D):
            j = int(jstore[s, g])
            if j >= 0:
                q_out[j], qd_out[j], tau_out[j] = q[g][s], qd[g][s], tau[g][s]
    lf = [[0.0] * 3 for _ in range(nl)]
    for g in range(G):
        for e in range(plan.n_entries):
            l = int(link[e, g])
            if l >= 0:
                lf[l] = [_add(lf[l][k], lf_acc[g][e][k]) for k in range(3)]
    inv_ns = 1.0 / spec.substeps
    out_state = tuple(torch.stack([full(c) for c in comp]) for comp in
                      (base["pos"], base["quat"], base["lin"], base["ang"], q_out, qd_out))
    link_forces = torch.stack([torch.stack([full(_mul(c, inv_ns)) for c in row]) for row in lf])
    return out_state, link_forces, torch.stack([full(t) for t in tau_out])
