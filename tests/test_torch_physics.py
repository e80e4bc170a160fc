"""Parity of the PyTorch port's physics and fused control step with the JAX
reference, on the CPU.

Same seeded numpy inputs go through the JAX function and its port; float32
on both sides.  Tolerances are those of tests/test_fused_step.py:126-135
(`TOL` below) unless a test states its own.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from legged_gym_custom_tpu import physics as jphys
from legged_gym_custom_tpu.ops import fused_step as jfused
from legged_gym_custom_tpu.physics import algorithms as jalg
from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch import physics as tphys
from legged_gym_custom_tpu_torch.ops import fused_step as tfused
import torch_tree_model as tree_model

TINY_URDF = """<robot name="tiny">
  <link name="base">
    <inertial>
      <origin xyz="0 0 0" rpy="0 0 0"/>
      <mass value="2.0"/>
      <inertia ixx="0.02" ixy="0" ixz="0" iyy="0.02" iyz="0" izz="0.02"/>
    </inertial>
    <collision>
      <origin xyz="0 0 0" rpy="0 0 0"/>
      <geometry><sphere radius="0.05"/></geometry>
    </collision>
  </link>
  <link name="leg">
    <inertial>
      <origin xyz="0 0 -0.1" rpy="0 0 0"/>
      <mass value="0.3"/>
      <inertia ixx="0.002" ixy="0" ixz="0" iyy="0.002" iyz="0" izz="0.001"/>
    </inertial>
    <collision>
      <origin xyz="0 0 -0.2" rpy="0 0 0"/>
      <geometry><sphere radius="0.02"/></geometry>
    </collision>
  </link>
  <joint name="hip" type="revolute">
    <origin xyz="0.05 0 -0.02" rpy="0 0 0"/>
    <parent link="base"/>
    <child link="leg"/>
    <axis xyz="0 1 0"/>
    <limit lower="-1.5" upper="1.5" effort="20" velocity="25"/>
  </joint>
</robot>
"""
GO2_DEFAULT = np.array([0.1, 0.8, -1.5, -0.1, 0.8, -1.5, 0.1, 1.0, -1.5, -0.1, 1.0, -1.5])
# (atol, rtol) per output, tests/test_fused_step.py:126-135
TOL = dict(base_pos=(1e-4, 1e-4), base_quat=(1e-4, 1e-4), lin_vel=(1e-3, 1e-3),
           ang_vel=(1e-3, 1e-3), dof_pos=(1e-4, 1e-4), dof_vel=(1e-2, 1e-3),
           torques=(1e-2, 1e-3), link_forces=(0.05, 1e-3))
# the link states: those of the base's position and linear velocity
TOL.update(link_pos=TOL["base_pos"], link_vel=TOL["lin_vel"])
STATE = ("base_pos", "base_quat", "lin_vel", "ang_vel", "dof_pos", "dof_vel")


@pytest.fixture(scope="module", params=["tiny", "go2_synthetic"])
def robot(request, tmp_path_factory):
    if request.param == "tiny":
        path = tmp_path_factory.mktemp("urdf") / "tiny.urdf"
        path.write_text(TINY_URDF)
        return str(path), np.zeros(1)
    return SYNTHETIC_GO2_URDF, GO2_DEFAULT


def _plant(ndof, jax_side: bool):
    """The go2 plant (go2_config.sim): stiff contact, 4 substeps, joint
    damping / armature / tanh frictionloss."""
    ph = jphys if jax_side else tphys
    full = (lambda v: jnp.full(ndof, v)) if jax_side else (lambda v: torch.full((ndof,), v))
    return ph.SimParams(
        substeps=4,
        contact=ph.ContactParams(stiffness=40000.0, damping=250.0, friction_vel=250.0,
                                 terrain_friction=1.0),
        dof_damping=full(0.1), dof_armature=full(0.01), dof_frictionloss=full(0.2),
    )


def _rand_batch(seed, B, default_pos):
    """Seeded (C, B) numpy batch like tests/test_fused_step.py:_rand_batch."""
    rng = np.random.default_rng(seed)
    ndof = len(default_pos)
    quat = rng.normal(size=(4, B)) * 0.1 + np.array([1.0, 0, 0, 0])[:, None]
    quat /= np.linalg.norm(quat, axis=0, keepdims=True)
    state = [
        np.concatenate([rng.uniform(-1, 1, (2, B)), rng.uniform(0.25, 0.45, (1, B))]),
        quat, rng.normal(size=(3, B)) * 0.5, rng.normal(size=(3, B)) * 0.5,
        default_pos[:, None] + rng.normal(size=(ndof, B)) * 0.2,
        rng.normal(size=(ndof, B)) * 2.0,
    ]
    dr = [rng.uniform(0.5, 1.25, B), rng.uniform(-1.0, 1.0, B), rng.normal(size=(3, B)) * 0.01,
          np.full((ndof, B), 1.05), np.full((ndof, B), 0.95)]
    actions = np.clip(rng.normal(size=(ndof, B)), -3.14, 3.14)
    f = lambda a: np.ascontiguousarray(a, np.float32)
    return [f(a) for a in state], [f(a) for a in dr], f(actions)


def _both(urdf, default_pos):
    """(JAX, torch) model arrays, PD params and dof limits of one URDF."""
    mj, mt = jphys.load_urdf(urdf, "r"), tphys.load_urdf(urdf, "r")
    ndof = mt.num_dof
    pd_j = jphys.PDParams(jnp.full(ndof, 40.0), jnp.full(ndof, 1.0),
                          jnp.asarray(default_pos, jnp.float32),
                          jnp.asarray(mj.dof_effort_limits, jnp.float32), 0.25)
    pd_t = tphys.PDParams(torch.full((ndof,), 40.0), torch.full((ndof,), 1.0),
                          torch.as_tensor(default_pos, dtype=torch.float32),
                          torch.as_tensor(mt.dof_effort_limits, dtype=torch.float32), 0.25)
    lim = (mj.dof_pos_limits[:, 0], mj.dof_pos_limits[:, 1], mj.dof_vel_limits)
    dl_j = tuple(jnp.asarray(x, jnp.float32) for x in lim)
    dl_t = tuple(torch.as_tensor(np.asarray(x), dtype=torch.float32) for x in lim)
    return (jphys.model_arrays(mj), pd_j, dl_j), (tphys.model_arrays(mt), pd_t, dl_t)


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in _flat(e)]
    return [float(x)]


def _close(name, got, ref, tol=None):
    atol, rtol = tol or TOL[name]
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=rtol,
                               err_msg=name)


def test_load_urdf_matches_reference(robot):
    urdf, _ = robot
    mj, mt = jphys.load_urdf(urdf, "r"), tphys.load_urdf(urdf, "r")
    for field in ("nb", "parent", "joint_rot", "joint_pos", "joint_axis", "mass", "com",
                  "inertia_com", "dof_names", "dof_pos_limits", "dof_vel_limits",
                  "dof_effort_limits", "geom_body", "geom_pos", "geom_radius", "geom_link",
                  "link_names", "link_body", "link_pos", "body_names"):
        a, b = getattr(mj, field), getattr(mt, field)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            assert a == b, field


def test_synthetic_go2_has_go2_topology():
    m = tphys.load_urdf(SYNTHETIC_GO2_URDF, "go2")
    assert m.nb == 13 and m.num_dof == 12
    legs = ("FL", "FR", "RL", "RR")
    assert m.dof_names == [f"{l}_{j}_joint" for l in legs for j in ("hip", "thigh", "calf")]
    assert len(m.link_ids_matching("foot")) == 4
    assert len(m.link_ids_matching("Head")) >= 1


def test_kinematics_and_aba_match_reference(robot):
    """FK and ABA (armature, random external wrench) at B = 16; float32
    tolerance 1e-5 + 1e-4 relative on FK, 1e-3 on accelerations."""
    urdf, default_pos = robot
    (ma_j, _, _), (ma_t, _, _) = _both(urdf, default_pos)
    ndof = len(default_pos)
    state, dr, actions = _rand_batch(1, 16, default_pos)
    pos, quat, lin, ang, q, qd = state
    v_base = np.concatenate([ang, lin]).astype(np.float32)
    rng = np.random.default_rng(2)
    f_ext = rng.normal(size=(ma_t.nb, 6, 16)).astype(np.float32)
    tau = (rng.normal(size=(ndof, 16)) * 5).astype(np.float32)
    arm = np.full(ndof, 0.01, np.float32)
    T = torch.as_tensor

    fk_j = jalg.forward_kinematics(ma_j, quat, pos, q, v_base, qd)
    fk_t = tphys.forward_kinematics(ma_t, T(quat), T(pos), T(q), T(v_base), T(qd))
    for part_j, part_t in zip(fk_j, fk_t):
        for a, b in zip(part_j, part_t):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-4)

    in_j = jalg.body_inertias(ma_j, dr[1], dr[2])
    in_t = tphys.body_inertias(ma_t, T(dr[1]), T(dr[2]))
    a0_j, qdd_j = jalg.aba(ma_j, in_j, quat, q, v_base, qd, tau, f_ext=f_ext,
                            armature=jnp.asarray(arm))
    a0_t, qdd_t = tphys.aba(ma_t, in_t, T(quat), T(q), T(v_base), T(qd), T(tau),
                            f_ext=T(f_ext), armature=T(arm))
    np.testing.assert_allclose(a0_t.numpy(), np.asarray(a0_j), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(qdd_t.numpy(), np.asarray(qdd_j), atol=1e-3, rtol=1e-3)


def test_eager_control_step_matches_reference(robot, monkeypatch):
    """One eager `control_step` (no spec) against JAX `engine.control_step`
    with the kernel off, on the go2 plant at B = 32."""
    monkeypatch.setenv("LGC_FUSED_KERNEL", "0")
    urdf, default_pos = robot
    (ma_j, pd_j, dl_j), (ma_t, pd_t, dl_t) = _both(urdf, default_pos)
    ndof = len(default_pos)
    state, dr, actions = _rand_batch(3, 32, default_pos)
    ref_state, ref_info, _ = jax.jit(
        lambda s, a, d: jphys.control_step(ma_j, jphys.plane(), _plant(ndof, True), pd_j, d,
                                           dl_j, s, a)
    )(jphys.PhysicsState(*state), actions, jphys.DomainRandParams(*dr))
    T = torch.as_tensor
    st, info = tphys.control_step(ma_t, tphys.plane(), _plant(ndof, False), pd_t,
                                  tphys.DomainRandParams(*map(T, dr)), dl_t,
                                  tphys.PhysicsState(*map(T, state)), T(actions), spec=None)
    for name, a, b in zip(STATE, ref_state, st):
        _close(name, b, a)
    _close("link_forces", info.link_forces, ref_info.link_forces)
    _close("torques", info.torques, ref_info.torques)
    _close("base_pos", info.link_pos, ref_info.link_pos)
    _close("lin_vel", info.link_vel, ref_info.link_vel)


@pytest.mark.parametrize("model", ["go2", "cassie", "g1", "tree"])
def test_plain_kernel_matches_reference_components(model):
    """The port's plain version of the kernel (`control_step_components`)
    against the JAX kernel body (`fused_step.control_step_components`,
    called with plain arrays as tests/test_fused_step.py:72-107 does) at
    B = 64 with the go2 plant: on the synthetic Go2 (K1), on the
    synthetic bipeds whose chains of 6 the card runs in the layout for deep
    chains, Cassie on a bumpy heightfield window (K3) and G1 on the plane
    (K1), each standing at its own height (up to 5 cm below its spawn
    height), and on the test tree (K1: padded slots, parents that differ by
    lane, a dense joint rotation).  The plain version's link states (the
    kernel's last outward pass) against JAX `link_states` of the JAX
    kernel body's output state."""
    rng = np.random.default_rng(8)
    if model == "go2":
        urdf, default_pos = SYNTHETIC_GO2_URDF, GO2_DEFAULT
    elif model == "tree":
        urdf, default_pos = tree_model.TEST_TREE_URDF, tree_model.DEFAULT_ANGLES
    else:
        urdf, default_pos, base_z = tree_model.robot_urdf_and_angles(model)
    ndof, B = len(default_pos), 64
    (ma_j, pd_j, dl_j), (ma_t, pd_t, dl_t) = _both(urdf, default_pos)
    state, dr, actions = _rand_batch(4, B, default_pos)
    hf = dict(hf_K=24, hf_hs=0.1) if model == "cassie" else {}
    terrain_t = terrain_j = None
    if model not in ("go2", "tree"):
        state[0][2] = rng.uniform(*base_z, B).astype(np.float32)
    if hf:   # a bumpy window under each base, centred on it
        patch = (rng.normal(size=(B, 24, 24)) * 0.03 + 0.05).astype(np.float32)
        half = np.float32(0.5 * 23 * 0.1)
        xoff, yoff = state[0][0] - half, state[0][1] - half
        terrain_t = tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in (patch, xoff, yoff))
        terrain_j = dict(patch=jnp.moveaxis(jnp.asarray(patch), 0, -1), xoff=jnp.asarray(xoff),
                         yoff=jnp.asarray(yoff))
    spec_j = jfused.build_spec(ma_j, _plant(ndof, True), pd_j, dl_j, **hf)
    spec_t = tfused.build_spec(ma_t, _plant(ndof, False), pd_t, dl_t, **hf)
    # the port's spec adds the terrain sampling mode and the report links,
    # which JAX's lacks
    assert tfused.FusedSpec._fields == jfused.FusedSpec._fields + (
        "terrain_tick_sample", "link_body", "link_pos")
    assert spec_t.terrain_tick_sample is True
    assert spec_t.link_body == tuple(int(b) for b in ma_j.link_body)
    np.testing.assert_array_equal(np.array(spec_t.link_pos), np.asarray(ma_j.link_pos, np.float64))
    for field in jfused.FusedSpec._fields:
        a, b = getattr(spec_t, field), getattr(spec_j, field)
        if isinstance(a, str):
            assert a == b, field
        else:
            np.testing.assert_allclose(_flat(a), _flat(b), rtol=1e-6, err_msg=field)
    if model in ("cassie", "g1"):
        assert tfused.lanes_per_branch_for(spec_t) == 4     # the card's layout for deep chains

    split = lambda a: [a[i] for i in range(a.shape[0])]
    keys = ("pos", "quat", "lin", "ang", "q", "qd")
    sj, aj, dj = [jnp.asarray(x) for x in state], jnp.asarray(actions), [jnp.asarray(x) for x in dr]
    st_j, lf_j, tau_j = jfused.control_step_components(
        spec_j, dict(zip(keys, map(split, sj))), split(aj), dj[0], dj[1], split(dj[2]),
        split(dj[3]), split(dj[4]), terrain=terrain_j)
    out_state, lf_t, tau_t, lpos_t, lvel_t = tfused.plain_control_step(
        spec_t, tuple(map(torch.as_tensor, state)), torch.as_tensor(actions),
        tuple(map(torch.as_tensor, dr)), terrain_t)
    for name, k, got in zip(STATE, keys, out_state):
        _close(name, got, np.stack(st_j[k]))
    _close("link_forces", lf_t, np.asarray(lf_j))
    _close("torques", tau_t, np.stack(tau_j))
    lpos_j, lvel_j = jphys.link_states(ma_j, jphys.PhysicsState(*[jnp.stack(st_j[k])
                                                                  for k in keys]))
    _close("link_pos", lpos_t, lpos_j)
    _close("link_vel", lvel_t, lvel_j)
    assert float(np.abs(np.asarray(lf_j)).max()) > 1.0      # the feet touch


def _go2_spec():
    _, (ma_t, pd_t, dl_t) = _both(SYNTHETIC_GO2_URDF, GO2_DEFAULT)
    return tfused.build_spec(ma_t, _plant(12, False), pd_t, dl_t)


def _batch_t(B=8):
    state, dr, actions = _rand_batch(5, B, GO2_DEFAULT)
    T = torch.as_tensor
    return tuple(map(T, state)), T(actions), tuple(map(T, dr))


def test_wrapper_runs_plain_version_on_cpu_and_counts_no_launch():
    spec = _go2_spec()
    state, actions, dr = _batch_t()
    before = tfused.fused_control_step.launches
    out = tfused.fused_control_step(spec, state, actions, dr)
    ref = tfused.plain_control_step(spec, state, actions, dr)
    assert tfused.fused_control_step.launches == before
    assert len(out) == len(ref) == 5
    for a, b in zip((*out[0], *out[1:]), (*ref[0], *ref[1:])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert out[1].shape == out[3].shape == out[4].shape == (spec.n_links, 3, 8)


@pytest.mark.parametrize("bad", ["shape", "dtype", "contiguous", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    spec = _go2_spec()
    state, actions, dr = _batch_t()
    if bad == "shape":
        actions = actions[:6]
    elif bad == "dtype":
        actions = actions.double()
    elif bad == "contiguous":
        actions = torch.as_tensor(np.asfortranarray(actions.numpy()))
        assert not actions.is_contiguous()
    else:
        state = tuple(t.to("meta") for t in state)
        actions, dr = actions.to("meta"), tuple(t.to("meta") for t in dr)
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        tfused.fused_control_step(spec, state, actions, dr)


def test_uncovered_variants_raise():
    """'V' control, on the plane and on a heightfield, a heightfield step
    with no window, and per-substep terrain resampling raise
    NotImplementedError rather than running another path; the K2 options
    ('T' control, implicit stiction) are covered and run.  The terrain
    modes are refused where a kernel would launch (the engine's check on
    the card, whose message names the opt-out, and the wrapper for a
    per-substep spec); their spec builds."""
    spec = _go2_spec()
    state, actions, dr = _batch_t()
    hf_spec = spec._replace(hf_K=24, hf_hs=0.1)
    terrain = (torch.zeros(8, 24, 24), torch.zeros(8), torch.zeros(8))
    for bad, tr in ((spec._replace(control_type="V"), None),
                    (hf_spec._replace(control_type="V"), terrain),
                    (hf_spec, None),
                    (hf_spec._replace(terrain_tick_sample=False), terrain)):
        with pytest.raises(NotImplementedError):
            tfused.fused_control_step(bad, state, actions, dr, tr)
    for covered, tr in ((spec._replace(control_type="T"), None),
                        (hf_spec._replace(control_type="T"), terrain),
                        (spec._replace(fl_dqd=(0.1,) * 12), None),
                        (hf_spec._replace(fl_dqd=(0.1,) * 12), terrain)):
        out = tfused.fused_control_step(covered, state, actions, dr, tr)
        assert all(bool(torch.isfinite(t).all()) for t in (*out[0], *out[1:]))
    _, (ma_t, pd_t, dl_t) = _both(SYNTHETIC_GO2_URDF, GO2_DEFAULT)
    per_substep = _plant(12, False)._replace(terrain_tick_sample=False)
    assert tfused.build_spec(ma_t, per_substep, pd_t, dl_t, hf_K=24, hf_hs=0.1) == \
        tfused.build_spec(ma_t, _plant(12, False), pd_t, dl_t, hf_K=24,
                          hf_hs=0.1)._replace(terrain_tick_sample=False)
    hf = tphys.from_raw(np.zeros((64, 64), np.int16), 0.1, 0.005, 1.0)
    for params, mode in ((per_substep, "terrain_tick_sample"),
                         (_plant(12, False)._replace(patch_halfwidth=0.0), "patch_halfwidth")):
        with pytest.raises(NotImplementedError, match=f"{mode}.*LGC_FUSED_KERNEL=0"):
            tphys.engine._check_kernel_terrain(hf, params)


def test_spec_header_bakes_the_model():
    spec = _go2_spec()
    header = tfused.spec_header(spec)
    assert "#define LGC_NB 13" in header
    assert f"#define LGC_NL {spec.n_links}" in header
    assert "#define LGC_SUBSTEPS 4" in header
