"""The lane plan of the fused control step: which lane of a warp runs which
part of the kinematic tree (host numpy only; nothing here is a tensor op).

The CUDA kernel (ops/csrc/fused_step.cu) runs one env on a group of G lanes
of a warp.  The tree splits at the base: every child of the base starts a
*branch* (the child and all its descendants), and the branches share nothing
until the base.  A lane owns one branch and walks its bodies through `depth`
*slots*, parent before child; a shorter branch is padded with masked slots
that add exactly zero.  With `lanes_per_branch` 2 a pair of lanes carries one
branch: both walk its chain, each takes every second collision sphere of a
body, and the pair sums the contact wrenches.  The base's own spheres are
dealt round over all G lanes.  G is the number of branches times
`lanes_per_branch`, rounded up to a power of two (the lanes combine by
butterfly shuffles); the extra lanes are masked throughout.

A model constant that every lane shares at a slot (on a quadruped: the joint
axes, the masses, most joint offsets' zeros) stays a compile-time constant of
that slot, so its zeros and ones still fold; one that differs by lane (the
legs mirror each other) goes into a lane table `[row][lane]` that the kernel
keeps in shared memory.  `LanePlan.const` is the one accessor of both, used
by the plain version that walks the plan (ops/plan_step.py),
and `header_lines` emits exactly the arrays it reads.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

MAX_LANES = 32          # one warp
ABSENT_RADIUS = -1.0e30  # a sphere entry no geom fills: never in contact

# per-slot constants: name -> components
SLOT_FIELDS = (("AXIS", 3), ("JROT", 9), ("JPOS", 3), ("MASS", 1), ("MH", 3), ("IO", 6),
               ("DAMP", 1), ("ARM", 1), ("FL", 1), ("PG", 1), ("DG", 1), ("DPOS", 1),
               ("TLIM", 1), ("LO", 1), ("HI", 1), ("VLIM", 1), ("DQD", 1))
# per-sphere-entry constants
SPHERE_FIELDS = (("GPOS", 3), ("GRAD", 1))
SYM6 = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))   # a symmetric 3x3 as 6 entries


class Field(NamedTuple):
    """One constant, `n` scalars: `eq[i]` 1 where every lane has `val[i]`,
    else the lanes' values are row `off[i]` of the lane table."""

    eq: np.ndarray    # (n,) int
    val: np.ndarray   # (n,) float64, 0 where the lanes differ
    off: np.ndarray   # (n,) int, -1 where the lanes agree


class LanePlan(NamedTuple):
    G: int                  # lanes per env, a power of two
    lanes_per_branch: int
    n_branches: int
    depth: int              # slots per lane
    body: np.ndarray        # (depth, G) body of a slot, -1 masked
    pslot: np.ndarray       # (depth, G) slot of the parent body, -1 the base
    pslot_level: tuple      # per slot: the lanes' common parent slot
    pslot_uniform: bool     # every slot's parent slot is the same in all lanes
    first: tuple            # per slot: the first (inward) to add to its parent
    has_child: tuple        # per slot: some lane has a child slot under it
    rot_axis: tuple         # per slot: k where every lane's joint turns about +e_k with an
                            # identity joint frame (a planar rotation), else -1
    jload: np.ndarray       # (depth, G) dof a slot reads, -1 masked
    jstore: np.ndarray      # (depth, G) dof a slot writes, -1 masked or a second lane
    n_sph: tuple            # per slot: sphere entries
    n_sph_base: int         # sphere entries of the base
    sphere: np.ndarray      # (entries, G) geom of an entry, -1 absent
    link: np.ndarray        # (entries, G) link of an entry's geom, -1 absent
    fields: dict            # name -> Field
    ftab: np.ndarray        # (rows, G) float64 lane table
    itab: np.ndarray        # (rows, G) int lane table: jload, jstore, link, pslot
    irow: dict              # name -> first row in itab

    @property
    def n_entries(self) -> int:
        return self.sphere.shape[0]

    def entry(self, slot: int, k: int) -> int:
        """Row of `sphere`/`link` of the k-th sphere entry of a slot; slot -1
        is the base."""
        if slot < 0:
            return sum(self.n_sph) + k
        return sum(self.n_sph[:slot]) + k

    def const(self, name: str, item: int, comp: int, lane: int) -> float:
        """Constant `name` of slot (or sphere entry) `item`, component `comp`,
        as lane `lane` reads it: the shared value or its row of the table."""
        f = self.fields[name]
        i = item * _NCOMP[name] + comp
        if f.eq[i]:
            return float(f.val[i])
        return float(self.ftab[f.off[i], lane])


_NCOMP = dict(SLOT_FIELDS + SPHERE_FIELDS)


def branches(parent):
    """Bodies of each branch under the base, each list parent before child."""
    nb = len(parent)
    root = [-1] * nb      # the child of the base a body hangs under
    out = {}
    for i in range(1, nb):
        p = parent[i]
        if not 0 <= p < i:
            raise ValueError(f"body {i}: parent {p} must come before it (and the base is body 0)")
        root[i] = i if p == 0 else root[p]
        out.setdefault(root[i], []).append(i)
    return [out[r] for r in sorted(out)]


def _origin_inertia(mass, com, icom):
    """(m h, I about the body origin as 6 entries) in float64."""
    c = np.asarray(com, np.float64)
    cx = np.array([[0, -c[2], c[1]], [c[2], 0, -c[0]], [-c[1], c[0], 0]])
    I = np.asarray(icom, np.float64) + mass * (cx @ cx.T)
    return mass * c, np.array([I[r, s] for r, s in SYM6])


def lane_plan(spec, lanes_per_branch: int = 1) -> LanePlan:
    """Split `spec`'s tree over the lanes of a group.  `spec` is a FusedSpec
    (any object with its fields); `lanes_per_branch` is 1 or 2."""
    if lanes_per_branch not in (1, 2):
        raise ValueError(f"lanes_per_branch must be 1 or 2, got {lanes_per_branch}")
    L = lanes_per_branch
    parent = [int(p) for p in spec.parent]
    nb = len(parent)
    per_branch = branches(parent)
    n_br = len(per_branch)
    G = 1
    while G < max(n_br, 1) * L:
        G *= 2
    if G > MAX_LANES:
        raise ValueError(f"{n_br} branches x {L} lanes exceed the {MAX_LANES} lanes of a warp")
    D = max([len(b) for b in per_branch], default=1)

    body = -np.ones((D, G), np.int64)
    pslot = -np.ones((D, G), np.int64)
    for b, bodies in enumerate(per_branch):
        for sub in range(L):
            g = b * L + sub
            for s, i in enumerate(bodies):
                body[s, g] = i
                pslot[s, g] = -1 if parent[i] == 0 else bodies.index(parent[i])
    # a masked slot copies the tree shape of the first lane that fills it
    donor = np.zeros(D, np.int64)
    for s in range(D):
        filled = np.nonzero(body[s] >= 0)[0]
        donor[s] = filled[0] if len(filled) else 0
        pslot[s, body[s] < 0] = pslot[s, donor[s]]
    pslot_level = tuple(int(pslot[s, donor[s]]) for s in range(D))
    pslot_uniform = bool(all((pslot[s] == pslot_level[s]).all() for s in range(D)))
    first = tuple(int(not any(pslot_level[t] == pslot_level[s] for t in range(s + 1, D)))
                  for s in range(D))
    has_child = tuple(int(bool((pslot[s + 1:] == s).any())) for s in range(D))

    sub_of = np.arange(G) % L
    jload = np.where(body >= 0, body - 1, -1)
    jstore = np.where((body >= 0) & (sub_of[None, :] == 0), body - 1, -1)

    # ---- sphere entries: a slot's spheres in geom order, every L-th to a
    # lane of the pair; then the base's, dealt round over all G lanes
    geom_body = [int(b) for b in spec.geom_body]
    geoms_of = {i: [g for g, b in enumerate(geom_body) if b == i] for i in range(nb)}
    per_slot = [[[] for _ in range(G)] for _ in range(D)]
    for s in range(D):
        for g in range(G):
            if body[s, g] >= 0:
                per_slot[s][g] = geoms_of[int(body[s, g])][int(sub_of[g])::L]
    n_sph = tuple(max(len(per_slot[s][g]) for g in range(G)) for s in range(D))
    base_geoms = [geoms_of[0][g::G] for g in range(G)]
    n_sph_base = max(len(x) for x in base_geoms)
    rows = []
    for s in range(D):
        for k in range(n_sph[s]):
            rows.append([per_slot[s][g][k] if k < len(per_slot[s][g]) else -1 for g in range(G)])
    for k in range(n_sph_base):
        rows.append([base_geoms[g][k] if k < len(base_geoms[g]) else -1 for g in range(G)])
    sphere = np.array(rows, np.int64).reshape(len(rows), G)
    geom_link = np.array([int(l) for l in spec.geom_link] + [-1], np.int64)
    link = geom_link[sphere]     # -1 indexes the appended -1

    # ---- per-lane values of every constant, then the shared value or a table row
    ndof = nb - 1
    fl_dqd = spec.fl_dqd or (0.0,) * ndof
    per_dof = dict(DAMP=spec.jd_damping, ARM=spec.jd_armature, FL=spec.jd_frictionloss,
                   PG=spec.p_gains, DG=spec.d_gains, DPOS=spec.default_dof_pos,
                   TLIM=spec.torque_limits, LO=spec.dof_lo, HI=spec.dof_hi, VLIM=spec.dof_vlim,
                   DQD=fl_dqd)
    geometric = ("AXIS", "JROT", "JPOS", "LO", "HI", "VLIM")
    neutral = dict(ARM=1.0)   # a masked slot: no mass, no torque, d = 1

    def slot_values(i):
        mh, io = _origin_inertia(spec.mass[i], spec.com[i], spec.inertia_com[i])
        out = dict(AXIS=np.asarray(spec.joint_axis[i], np.float64),
                   JROT=np.asarray(spec.joint_rot[i], np.float64).ravel(),
                   JPOS=np.asarray(spec.joint_pos[i], np.float64),
                   MASS=np.array([spec.mass[i]], np.float64), MH=mh, IO=io)
        for name, values in per_dof.items():
            out[name] = np.array([values[i - 1]], np.float64)
        return out

    values = {name: np.zeros((D, n, G)) for name, n in SLOT_FIELDS}
    for s in range(D):
        filled = {g: slot_values(int(body[s, g])) for g in range(G) if body[s, g] >= 0}
        for g in range(G):
            for name, n in SLOT_FIELDS:
                if g in filled:
                    values[name][s, :, g] = filled[g][name]
                elif name in geometric and filled:
                    values[name][s, :, g] = filled[int(donor[s])][name]
                else:
                    values[name][s, :, g] = neutral.get(name, 0.0)
    NE = sphere.shape[0]
    values["GPOS"] = np.zeros((NE, 3, G))
    values["GRAD"] = np.full((NE, 1, G), ABSENT_RADIUS)
    for e in range(NE):
        present = np.nonzero(sphere[e] >= 0)[0]
        for g in range(G):
            src = sphere[e, g] if sphere[e, g] >= 0 else sphere[e, present[0]]
            values["GPOS"][e, :, g] = spec.geom_pos[int(src)]
            if sphere[e, g] >= 0:
                values["GRAD"][e, 0, g] = spec.geom_radius[int(src)]

    rot_axis = []
    for s in range(D):
        ax = values["AXIS"][s].astype(np.float32)
        planar = [k for k in range(3) if (ax == np.eye(3, dtype=np.float32)[k][:, None]).all()]
        identity = (values["JROT"][s].astype(np.float32)
                    == np.eye(3, dtype=np.float32).ravel()[:, None]).all()
        rot_axis.append(planar[0] if planar and identity else -1)

    fields, table = {}, []
    for name, _ in SLOT_FIELDS + SPHERE_FIELDS:
        v = values[name].reshape(-1, G)
        v32 = v.astype(np.float32)
        eq = (v32 == v32[:, :1]).all(axis=1)
        off = -np.ones(len(v), np.int64)
        for i in np.nonzero(~eq)[0]:
            off[i] = len(table)
            table.append(v[i])
        fields[name] = Field(eq.astype(np.int64), np.where(eq, v[:, 0], 0.0), off)
    ftab = np.array(table, np.float64).reshape(len(table), G)

    irow, itab = {}, []
    for name, rows_ in (("JLOAD", jload), ("JSTORE", jstore), ("LINK", link), ("PSLOT", pslot)):
        irow[name] = len(itab)
        itab.extend(rows_.tolist())
    itab = np.array(itab, np.int64).reshape(len(itab), G)

    return LanePlan(G=G, lanes_per_branch=L, n_branches=n_br, depth=D, body=body, pslot=pslot,
                    pslot_level=pslot_level, pslot_uniform=pslot_uniform, first=first,
                    has_child=has_child, rot_axis=tuple(rot_axis), jload=jload, jstore=jstore, n_sph=n_sph,
                    n_sph_base=n_sph_base, sphere=sphere, link=link, fields=fields, ftab=ftab,
                    itab=itab, irow=irow)


def _floats(x) -> str:
    a = np.asarray(x, np.float32).ravel()
    return "{" + ", ".join(f"{float(v):.9e}f" for v in a) + "}"


def _ints(x) -> str:
    return "{" + ", ".join(str(int(v)) for v in np.asarray(x).ravel()) + "}"


def header_lines(plan: LanePlan) -> list:
    """The plan as the `LGC_P_*` defines of the generated header."""
    D = plan.depth
    lines = [
        "// lane plan (ops/lane_plan.py): G lanes of a warp per env, `depth` slots per lane",
        f"#define LGC_P_G {plan.G}",
        f"#define LGC_P_LPB {plan.lanes_per_branch}",
        f"#define LGC_P_DEPTH {D}",
        f"#define LGC_P_PSLOT {_ints(plan.pslot_level)}",
        f"#define LGC_P_PSLOT_UNIFORM {int(plan.pslot_uniform)}",
        f"#define LGC_P_FIRST {_ints(plan.first)}",
        f"#define LGC_P_HAS_CHILD {_ints(plan.has_child)}",
        f"#define LGC_P_ROTK {_ints(plan.rot_axis)}",
        f"#define LGC_P_ENT0 {_ints([plan.entry(s, 0) for s in range(D)])}",
        f"#define LGC_P_ENT0_BASE {plan.entry(-1, 0)}",
        f"#define LGC_P_MAX_NSPH {max(max(plan.n_sph), 1)}",
        f"#define LGC_P_NSPH {_ints(plan.n_sph)}",
        f"#define LGC_P_NSPH_BASE {plan.n_sph_base}",
        f"#define LGC_P_NENT {plan.n_entries}",
    ]
    for name, f in plan.fields.items():
        lines += [f"#define LGC_P_{name}_N {len(f.eq)}",
                  f"#define LGC_P_{name}_EQ {_ints(f.eq)}",
                  f"#define LGC_P_{name}_VAL {_floats(f.val)}",
                  f"#define LGC_P_{name}_OFF {_ints(f.off)}"]
    # a table is never empty in C: one unused row when every constant is shared
    ftab = plan.ftab if len(plan.ftab) else np.zeros((1, plan.G))
    lines += [f"#define LGC_P_FTAB_ROWS {len(ftab)}",
              f"#define LGC_P_FTAB {_floats(ftab)}",
              f"#define LGC_P_ITAB_ROWS {len(plan.itab)}",
              f"#define LGC_P_ITAB {_ints(plan.itab)}"]
    lines += [f"#define LGC_P_ROW_{name} {row}" for name, row in plan.irow.items()]
    return lines
