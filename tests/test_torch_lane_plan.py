"""The fused control step's lane plan (ops/lane_plan.py) and the plain version
that walks it (ops/plan_step.py), on the CPU.

The plan is the port's own host code and has no counterpart in the JAX
package: it says which lane of a warp runs which part of the kinematic tree
in the CUDA kernel.  It is checked on seven models: the synthetic Go2, the tiny
URDF of test_torch_physics.py, a single chain, the test tree, which forks
below the base, and the synthetic stand-ins of the other robots the port
trains: ANYmal-C (4 legs like Go2), and the bipeds Cassie (every joint frame
a dense rotation) and G1 (planar and tilted joints mixed), 2 branches of
depth 6 each, which also take the layout for deep chains (four lanes a
branch, the inward pass split by block).  The plan-walking step must equal `plain_control_step` (whose
parity with JAX `control_step_components` test_torch_physics.py,
test_torch_hf_step.py and test_torch_k2_step.py hold): a wrong index in the
plan's tables shows here, where no kernel can run.
"""
import numpy as np
import pytest
import torch

from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch.envs import task_registry
from legged_gym_custom_tpu_torch.ops import fused_step, lane_plan
from legged_gym_custom_tpu_torch.ops import plan_step
from test_torch_physics import GO2_DEFAULT, TINY_URDF
import torch_tree_model as tree_model

CHAIN_URDF = """<robot name="chain">
  <link name="base">
    <inertial><origin xyz="0 0 0" rpy="0 0 0"/><mass value="2.0"/>
      <inertia ixx="0.02" ixy="0" ixz="0" iyy="0.02" iyz="0" izz="0.02"/></inertial>
    <collision><origin xyz="0 0 0" rpy="0 0 0"/><geometry><sphere radius="0.05"/></geometry>
    </collision>
  </link>
  <link name="l1">
    <inertial><origin xyz="0 0 -0.05" rpy="0 0 0"/><mass value="0.4"/>
      <inertia ixx="0.002" ixy="0" ixz="0" iyy="0.002" iyz="0" izz="0.001"/></inertial>
  </link>
  <joint name="j1" type="revolute"><origin xyz="0.05 0 -0.02" rpy="0 0 0"/>
    <parent link="base"/><child link="l1"/><axis xyz="1 0 0"/>
    <limit lower="-1.0" upper="1.0" effort="20" velocity="25"/></joint>
  <link name="l2">
    <inertial><origin xyz="0 0 -0.1" rpy="0 0 0"/><mass value="0.3"/>
      <inertia ixx="0.002" ixy="0" ixz="0" iyy="0.002" iyz="0" izz="0.0005"/></inertial>
    <collision><origin xyz="0 0 -0.1" rpy="0 0 0"/><geometry><sphere radius="0.02"/></geometry>
    </collision>
  </link>
  <joint name="j2" type="revolute"><origin xyz="0 0.04 -0.1" rpy="0 0 0"/>
    <parent link="l1"/><child link="l2"/><axis xyz="0 1 0"/>
    <limit lower="-1.5" upper="1.5" effort="20" velocity="25"/></joint>
  <link name="l3">
    <inertial><origin xyz="0 0 -0.1" rpy="0 0 0"/><mass value="0.2"/>
      <inertia ixx="0.001" ixy="0" ixz="0" iyy="0.001" iyz="0" izz="0.0002"/></inertial>
    <collision><origin xyz="0 0 -0.2" rpy="0 0 0"/><geometry><sphere radius="0.025"/></geometry>
    </collision>
  </link>
  <joint name="j3" type="revolute"><origin xyz="0 0 -0.2" rpy="0 0 0"/>
    <parent link="l2"/><child link="l3"/><axis xyz="0 1 0"/>
    <limit lower="-2.5" upper="-0.3" effort="20" velocity="25"/></joint>
</robot>
"""
MODELS = ("go2", "tiny", "chain", "tree", "anymal_c", "cassie", "g1")
# G, depth, branches, sphere entries per slot, of the base, every lane's parent slots the same
SHAPES = {"go2": (4, 3, 4, (1, 3, 4), 2, True), "tiny": (1, 1, 1, (1,), 1, True),
          "chain": (1, 3, 1, (0, 1, 1), 1, True), "tree": (4, 3, 3, (2, 3, 1), 1, False),
          "anymal_c": (4, 3, 4, (0, 2, 3), 1, True),
          "cassie": (2, 6, 2, (0, 0, 2, 2, 2, 2), 1, True),
          "g1": (2, 6, 2, (0, 0, 2, 2, 0, 4), 1, True)}
# the task whose config gives a robot's URDF and default angles
ROBOT_TASKS = {"anymal_c": "anymal_c_flat", "cassie": "cassie", "g1": "g1"}
VARIANTS = {"plane-P-tanh": dict(), "plane-T-stiction": dict(control_type="T",
                                                             implicit_stiction=True),
            "hf-P-stiction": dict(hf_K=8, hf_hs=0.1, implicit_stiction=True),
            "hf-T-tanh": dict(hf_K=8, hf_hs=0.1, control_type="T")}


# float32, plan walk against plain version, per output (base_pos, base_quat,
# lin_vel, ang_vel, dof_pos, dof_vel, link_forces, torques): 1e-5 on positions
# and angles; a velocity is an acceleration of up to 1e3 /s^2 over 1.25 ms
# substeps, 1e-4; a contact force is 4e4 N/m times the position's rounding and
# sums to hundreds of newtons, 5e-3
FLOAT32_ATOL = (1e-5, 1e-5, 1e-4, 1e-4, 1e-5, 1e-4, 5e-3, 1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def urdfs(tmp_path_factory):
    root = tmp_path_factory.mktemp("urdf")
    (root / "tiny.urdf").write_text(TINY_URDF)
    (root / "chain.urdf").write_text(CHAIN_URDF)
    out = {"go2": (SYNTHETIC_GO2_URDF, GO2_DEFAULT), "tiny": (str(root / "tiny.urdf"), [0.0]),
           "chain": (str(root / "chain.urdf"), [0.1, 0.6, -1.2]),
           "tree": (tree_model.TEST_TREE_URDF, tree_model.DEFAULT_ANGLES)}
    for model, task in ROBOT_TASKS.items():
        out[model] = tree_model.robot_urdf_and_angles(task)
    return out


def _base_z(urdfs, model):
    """Base heights of the batches: the robots' own standing range, else
    model_batch's default."""
    return urdfs[model][2] if len(urdfs[model]) > 2 else (0.15, 0.35)


def _spec(urdfs, model, **variant):
    urdf, angles = urdfs[model][:2]
    return tree_model.plant_spec(urdf, angles, **variant)


# every model at one lane and a pair of lanes a branch; the bipeds also in the
# layout for deep chains, four lanes a branch
OWNER_CASES = [(m, lanes) for m in MODELS for lanes in (1, 2)] + [("cassie", 4), ("g1", 4)]


@pytest.mark.parametrize("model,lanes", OWNER_CASES)
def test_every_body_sphere_and_dof_has_one_owner(urdfs, model, lanes):
    spec = _spec(urdfs, model, implicit_stiction=True)
    plan = lane_plan.lane_plan(spec, lanes)
    nb, ndof, G, D = len(spec.parent), len(spec.parent) - 1, plan.G, plan.depth
    assert G & (G - 1) == 0 and G >= plan.n_branches * lanes
    assert plan.split == (lanes == 4)      # four lanes split the inward pass by block
    # the lanes of a branch are consecutive and aligned, so a branch's lane i
    # is lane i of its group of `lanes` (the kernel's shuffles rely on it)
    for g0 in range(0, G, lanes):
        assert all((plan.body[:, g] == plan.body[:, g0]).all() for g in range(g0, g0 + lanes))
    # each moving body is walked by the `lanes` lanes of one branch, stored by one
    for i in range(1, nb):
        assert int((plan.body == i).sum()) == lanes
        assert int((plan.jstore == i - 1).sum()) == 1 and int((plan.jload == i - 1).sum()) == lanes
    for s in range(D):
        for g in range(G):
            i, ps = int(plan.body[s, g]), int(plan.pslot[s, g])
            assert -1 <= ps < s                       # parents come before children
            if i < 0:                                 # a padded slot is masked
                assert plan.jload[s, g] == plan.jstore[s, g] == -1
                assert plan.const("MASS", s, 0, g) == 0.0 and plan.const("ARM", s, 0, g) == 1.0
                assert all(plan.const("IO", s, c, g) == 0.0 for c in range(6))
                assert plan.const("TLIM", s, 0, g) == 0.0 and plan.const("DQD", s, 0, g) == 0.0
            else:
                assert spec.parent[i] == (0 if ps < 0 else plan.body[ps, g])
    # each sphere is in one entry of one lane, on its body's slot, with its link
    owners = {}
    for e in range(plan.n_entries):
        for g in range(G):
            geom = int(plan.sphere[e, g])
            if geom < 0:
                assert plan.link[e, g] == -1
                assert plan.const("GRAD", e, 0, g) == lane_plan.ABSENT_RADIUS
                continue
            assert geom not in owners
            owners[geom] = (e, g)
            assert plan.link[e, g] == spec.geom_link[geom]
            assert plan.const("GRAD", e, 0, g) == spec.geom_radius[geom]
            assert [plan.const("GPOS", e, c, g) for c in range(3)] == list(spec.geom_pos[geom])
    assert sorted(owners) == list(range(len(spec.geom_body)))
    for s in range(D):
        for k in range(plan.n_sph[s]):
            for g in range(G):
                geom = int(plan.sphere[plan.entry(s, k), g])
                assert geom < 0 or spec.geom_body[geom] == plan.body[s, g]
    for k in range(plan.n_sph_base):
        for g in range(G):
            geom = int(plan.sphere[plan.entry(-1, k), g])
            assert geom < 0 or spec.geom_body[geom] == 0
    # within a lane the spheres keep the reference's order
    for g in range(G):
        mine = [int(x) for x in plan.sphere[:sum(plan.n_sph), g] if x >= 0]
        assert mine == sorted(mine)
    # the index table the kernel reads is these arrays, row for row
    for name, rows in (("JLOAD", plan.jload), ("JSTORE", plan.jstore), ("LINK", plan.link),
                       ("PSLOT", plan.pslot)):
        np.testing.assert_array_equal(plan.itab[plan.irow[name]:plan.irow[name] + len(rows)], rows)


@pytest.mark.parametrize("model", MODELS)
def test_lanes_and_depth_match_the_tree(urdfs, model):
    spec = _spec(urdfs, model)
    plan = lane_plan.lane_plan(spec)
    G, depth, branches, n_sph, n_sph_base, uniform = SHAPES[model]
    assert (plan.G, plan.depth, plan.n_branches, plan.n_sph, plan.n_sph_base,
            plan.pslot_uniform) == (G, depth, branches, n_sph, n_sph_base, uniform)
    if model == "go2":      # 4 legs x 3 levels, 8 spheres a leg, 5 on the base
        assert plan.body.tolist() == [[1, 4, 7, 10], [2, 5, 8, 11], [3, 6, 9, 12]]
        assert plan.pslot_level == (-1, 0, 1) and plan.rot_axis == (0, 1, 1)
        assert all(int((plan.sphere[:8, g] >= 0).sum()) == 8 for g in range(4))
        assert int((plan.sphere[8:] >= 0).sum()) == 5
        assert plan.first == (1, 1, 1) and plan.has_child == (1, 1, 0)
        pair = lane_plan.lane_plan(spec, 2)
        assert (pair.G, pair.n_sph, pair.n_sph_base) == (8, (1, 2, 2), 1)
    if model in ("cassie", "g1"):   # two chains of 6: four lanes a leg, G = 8 (a pair: 4)
        assert plan.body.T.tolist() == [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]]
        assert plan.pslot_level == (-1, 0, 1, 2, 3, 4) and plan.has_child == (1,) * 5 + (0,)
        assert plan.rot_axis == {"cassie": (-1,) * 6, "g1": (1, -1, 2, -1, 1, 0)}[model]
        assert lane_plan.lane_plan(spec, 2).G == 4
        deep = lane_plan.lane_plan(spec, fused_step.lanes_per_branch_for(spec))
        assert (deep.G, deep.lanes_per_branch, deep.split) == (8, 4, True)
        assert deep.body.T.tolist() == [[1, 2, 3, 4, 5, 6]] * 4 + [[7, 8, 9, 10, 11, 12]] * 4
        # a quarter of a body's spheres each, the base's dealt over all 8 lanes
        assert (deep.n_sph, deep.n_sph_base) == (
            {"cassie": (0, 0, 1, 1, 1, 1), "g1": (0, 0, 1, 1, 0, 1)}[model], 1)
    if model == "anymal_c":         # HAA about x, HFE and KFE about y, identity frames
        assert plan.rot_axis == (0, 1, 1) and lane_plan.lane_plan(spec, 2).G == 8
    if model == "tree":     # a2 and a3 both hang on a1; b3 hangs on b2
        assert plan.pslot[:, 0].tolist() == [-1, 0, 0] and plan.pslot[:, 1].tolist() == [-1, 0, 1]
        assert plan.body[:, 2].tolist() == [7, -1, -1] and (plan.body[:, 3] == -1).all()
        assert plan.rot_axis == (-1, 1, -1)    # oblique / y in every lane / z and y
    with pytest.raises(ValueError):
        lane_plan.lane_plan(spec, 3)


@pytest.mark.parametrize("model", MODELS)
def test_equal_flags_are_set_exactly_where_the_lanes_agree(urdfs, model):
    """A constant is a compile-time constant of its slot exactly where every
    lane's body has the same float32 value there; else each lane reads its own
    body's value from the table."""
    spec = _spec(urdfs, model, implicit_stiction=True)
    plan = lane_plan.lane_plan(spec)
    per_dof = dict(DAMP=spec.jd_damping, ARM=spec.jd_armature, FL=spec.jd_frictionloss,
                   PG=spec.p_gains, DG=spec.d_gains, DPOS=spec.default_dof_pos,
                   TLIM=spec.torque_limits, LO=spec.dof_lo, HI=spec.dof_hi, VLIM=spec.dof_vlim,
                   DQD=spec.fl_dqd)

    def of_body(name, i):
        if name in per_dof:
            return [per_dof[name][i - 1]]
        if name in ("MH", "IO"):
            mh, io = lane_plan._origin_inertia(spec.mass[i], spec.com[i], spec.inertia_com[i])
            return list(mh if name == "MH" else io)
        return list(np.ravel(dict(AXIS=spec.joint_axis, JROT=spec.joint_rot, JPOS=spec.joint_pos,
                                  MASS=spec.mass)[name][i]))

    some_differ = False
    for name, n in lane_plan.SLOT_FIELDS:
        f = plan.fields[name]
        for s in range(plan.depth):
            filled = [g for g in range(plan.G) if plan.body[s, g] >= 0]
            mine = {g: of_body(name, int(plan.body[s, g])) for g in filled}
            for c in range(n):
                for g in filled:
                    assert plan.const(name, s, c, g) == mine[g][c], (name, s, c, g)
                agree = len({np.float32(mine[g][c]) for g in filled}) == 1
                if len(filled) == plan.G:
                    assert bool(f.eq[s * n + c]) == agree, (name, s, c)
                else:       # a masked lane may break a tie, never make one
                    assert agree or not f.eq[s * n + c]
                assert (f.off[s * n + c] < 0) == bool(f.eq[s * n + c])
                some_differ |= not f.eq[s * n + c]
    assert some_differ == (plan.G > 1)
    offs = np.concatenate([f.off[f.off >= 0] for f in plan.fields.values()])
    assert sorted(offs) == list(range(len(plan.ftab)))     # every table row has one reader


def test_spec_header_carries_the_plan(urdfs):
    spec = _spec(urdfs, "go2")
    plan = lane_plan.lane_plan(spec)
    header = fused_step.spec_header(spec)
    for line in lane_plan.header_lines(plan):
        assert line in header
    assert f"#define LGC_P_G {plan.G}" in header and "#define LGC_P_DEPTH 3" in header
    assert "#define LGC_P_ROTK {0, 1, 1}" in header and "#define LGC_P_PSLOT {-1, 0, 1}" in header
    line = next(l for l in header.splitlines() if l.startswith("#define LGC_P_FTAB "))
    baked = np.array([np.float32(t.rstrip("f")) for t in line.split("{")[1].rstrip("}").split(", ")])
    np.testing.assert_array_equal(baked, plan.ftab.astype(np.float32).ravel())
    assert "#define LGC_P_G 8" in fused_step.spec_header(spec, lanes_per_branch=2)
    assert "#define LGC_P_SPLIT 0" in header
    deep = fused_step.spec_header(_spec(urdfs, "cassie"), lanes_per_branch=4)
    assert "#define LGC_P_G 8" in deep and "#define LGC_P_LPB 4" in deep
    assert "#define LGC_P_SPLIT 1" in deep


def test_library_key_follows_the_plan(urdfs):
    """Two specs that differ only in what the plan makes of them (the same
    bodies, another parent for one) are two libraries; so are two layouts of
    one spec."""
    spec = _spec(urdfs, "tree")
    moved = list(spec.parent)
    moved[3] = 2                     # a3 onto a2: branch a becomes a chain
    other = spec._replace(parent=tuple(moved))
    assert lane_plan.lane_plan(other).pslot_uniform and not lane_plan.lane_plan(spec).pslot_uniform
    strip = lambda h: [l for l in h.splitlines() if not l.startswith("#define LGC_P_")]
    assert strip(fused_step.spec_header(spec)) == strip(fused_step.spec_header(other))
    keys = {fused_step.library_key(spec), fused_step.library_key(other),
            fused_step.library_key(spec, lanes_per_branch=2)}
    assert len(keys) == 3
    assert fused_step.library_key(spec) == fused_step.library_key(spec)


@pytest.mark.parametrize("model", MODELS)
def test_layout_follows_from_the_spec(urdfs, model):
    """The spec's layout follows from the tree alone: four lanes per branch
    where a branch is deeper than DEEP_CHAIN_DEPTH (3) and they fit a warp
    (the bipeds' chains of 6), else a pair of lanes per branch wherever the
    pairs fit a warp (the other models), and one lane per branch beyond 16
    branches; the wrapper takes it up to PAIR_MAX_ENVS envs and one lane per
    branch above."""
    spec = _spec(urdfs, model)
    lanes = 4 if model in ("cassie", "g1") else 2
    assert fused_step.lanes_per_branch_for(spec) == lanes
    for batch in (1, 128, fused_step.PAIR_MAX_ENVS):
        assert fused_step.lanes_for_batch(spec, batch) == lanes
    for batch in (fused_step.PAIR_MAX_ENVS + 1, 65536):
        assert fused_step.lanes_for_batch(spec, batch) == 1
    assert lane_plan.lane_plan(spec, 2).G == 2 * lane_plan.lane_plan(spec, 1).G
    assert lane_plan.lane_plan(spec, 4).G == 4 * lane_plan.lane_plan(spec, 1).G
    star = spec._replace(parent=(-1,) + (0,) * 17)     # 17 branches: 34 lanes would not fit
    assert fused_step.lanes_per_branch_for(star) == 1
    assert fused_step.lanes_for_batch(star, 128) == 1
    with pytest.raises(ValueError):
        lane_plan.lane_plan(star._replace(parent=(-1,) + (0,) * 33))
    # chains of 4 under the base: deep, while four lanes each fit a warp
    chains = lambda n: (-1,) + tuple(0 if j == 0 else 1 + 4 * c + j - 1
                                     for c in range(n) for j in range(4))
    assert fused_step.lanes_per_branch_for(spec._replace(parent=chains(8))) == 4
    assert fused_step.lanes_per_branch_for(spec._replace(parent=chains(9))) == 2
    shallow = (-1,) + tuple(0 if j == 0 else 1 + 3 * c + j - 1 for c in range(8) for j in range(3))
    assert fused_step.lanes_per_branch_for(spec._replace(parent=shallow)) == 2


def _walk_and_plain(spec, model_angles, lanes, dtype, B=5, base_z=(0.15, 0.35)):
    state, actions, dr = tree_model.model_batch(3, B, model_angles, dtype=dtype, base_z=base_z)
    terrain = tree_model.tree_terrain(4, state, spec.hf_K, spec.hf_hs) if spec.hf_K else None
    plan = lane_plan.lane_plan(spec, lanes)
    got = plan_step.plan_control_step(spec, plan, state, actions, dr, terrain)
    ref = fused_step.plain_control_step(spec, state, actions, dr, terrain)
    return (*got[0], got[1], got[2]), (*ref[0], ref[1], ref[2])


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("model,lanes", [("tiny", 1), ("go2", 1), ("go2", 2), ("tree", 1),
                                         ("anymal_c", 2), ("cassie", 1), ("cassie", 2),
                                         ("g1", 2), ("cassie", 4), ("g1", 4), ("go2", 4),
                                         ("tree", 4)])
def test_plan_walk_matches_plain_version(urdfs, model, lanes, variant):
    """One control step at B = 5 (a ragged size) walking the plan, against
    `plain_control_step`: in float64 to 1e-10, which only a right index
    gives, and in float32 to `FLOAT32_ATOL` (the sums run in another order:
    wrenches by lane, the branches' inertias by butterfly).  The robots stand
    at their own height: a biped's metre-long legs buried at Go2's 0.15-0.35 m
    meet contact forces of tens of kN, where float32 rounding alone parts the
    two orders by millimetres in one step."""
    spec = _spec(urdfs, model, **VARIANTS[variant])
    angles = urdfs[model][1]
    z = _base_z(urdfs, model)
    got, ref = _walk_and_plain(spec, angles, lanes, torch.float64, base_z=z)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    if model in ("go2", "anymal_c", "cassie", "g1"):
        assert float(ref[6].abs().max()) > 0.0    # some sphere touches in the last tick
    got, ref = _walk_and_plain(spec, angles, lanes, torch.float32, base_z=z)
    for a, b, atol in zip(got, ref, FLOAT32_ATOL):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)
