"""Parity of the K2 options of the fused control step ('T' torque control
and implicit stiction) with the JAX reference, on the CPU.

The plain PyTorch version of the kernel (`plain_control_step`) goes against
the JAX kernel body (`control_step_components`, called eagerly with plain
arrays) and against the port's eager engine; the eager engine goes against
JAX `engine.control_step` with the kernel off.  Plane cases use the sim
parameters and the tolerances of tests/test_fused_step.py::
test_fused_T_control_parity (:550) and ::test_fused_stiction_component_parity
(:578); the heightfield case (both options on a window of a bumpy table with
a gap) those of tests/test_torch_hf_step.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from legged_gym_custom_tpu import physics as jphys
from legged_gym_custom_tpu.ops import fused_step as jfused
from legged_gym_custom_tpu.physics import patch as jpatch
from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch import physics as tphys
from legged_gym_custom_tpu_torch.ops import fused_step as tfused
from legged_gym_custom_tpu_torch.physics import patch as tpatch
from test_torch_hf_step import K, TOL as HF_TOL, _batch as _hf_batch, _terrain
from test_torch_physics import GO2_DEFAULT, STATE, TINY_URDF, _both, _rand_batch

B = 32
KEYS = ("pos", "quat", "lin", "ang", "q", "qd")
# (atol, rtol): test_fused_T_control_parity and test_fused_stiction_component_parity
T_TOL = dict(torques=(1e-4, 1e-5), base_pos=(1e-5, 1e-5), dof_vel=(1e-3, 1e-4),
             link_forces=(0.01, 1e-3))
STICTION_TOL = dict(dof_vel=(1e-3, 1e-4), dof_pos=(1e-4, 1e-5), torques=(1e-3, 1e-4))
# the link states, with those of test_torch_physics.py's base position and
# linear velocity
for _tol in (T_TOL, STICTION_TOL):
    _tol.update(link_pos=(1e-4, 1e-4), link_vel=(1e-3, 1e-3))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny, so one thread is faster than many, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["tiny", "go2_synthetic"])
def robot(request, tmp_path_factory):
    if request.param == "tiny":
        path = tmp_path_factory.mktemp("urdf") / "tiny.urdf"
        path.write_text(TINY_URDF)
        return str(path), np.zeros(1)
    return SYNTHETIC_GO2_URDF, GO2_DEFAULT


def _setup(urdf, default_pos, control="P", stiction=False, **sim):
    """(JAX, torch) model, PD params, dof limits and SimParams for one option
    set: `control` 'P' or 'T' (action scale 5 as test_fused_step.py:558),
    `stiction` adds damping 0.1, armature 0.01, frictionloss 0.2 resolved
    implicitly with each side's own `effective_joint_inertia`."""
    (ma_j, pd_j, dl_j), (ma_t, pd_t, dl_t) = _both(urdf, default_pos)
    ndof = len(default_pos)
    if control == "T":
        pd_j = pd_j._replace(control_type="T", action_scale=5.0)
        pd_t = pd_t._replace(control_type="T", action_scale=5.0)
    sim_j, sim_t = dict(sim), dict(sim)
    if stiction:
        q0 = np.asarray(default_pos, np.float32)
        sim_j.update(dof_damping=jnp.full(ndof, 0.1), dof_armature=jnp.full(ndof, 0.01),
                     dof_frictionloss=jnp.full(ndof, 0.2), frictionloss_implicit=True,
                     dof_meff=jphys.effective_joint_inertia(ma_j, q0,
                                                            armature=jnp.full(ndof, 0.01)))
        full = lambda v: torch.full((ndof,), v)
        sim_t.update(dof_damping=full(0.1), dof_armature=full(0.01), dof_frictionloss=full(0.2),
                     frictionloss_implicit=True,
                     dof_meff=tphys.effective_joint_inertia(ma_t, q0, armature=full(0.01)))
    return (ma_j, pd_j, dl_j, jphys.SimParams(**sim_j)), (ma_t, pd_t, dl_t, tphys.SimParams(**sim_t))


def _close(tol, name, got, ref):
    atol, rtol = tol[name]
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=rtol,
                               err_msg=name)


def _jax_components(ma_j, spec_j, state, actions, dr, terrain=None):
    """The JAX kernel body's outputs, and JAX `link_states` of its state."""
    split = lambda a: [a[i] for i in range(a.shape[0])]
    sj, aj = [jnp.asarray(x) for x in state], jnp.asarray(actions)
    dj = [jnp.asarray(x) for x in dr]
    st, lf, tau = jfused.control_step_components(
        spec_j, dict(zip(KEYS, map(split, sj))), split(aj), dj[0], dj[1], split(dj[2]),
        split(dj[3]), split(dj[4]), terrain=terrain)
    out = dict(zip(STATE, (np.stack(st[k]) for k in KEYS)))
    lpos, lvel = jphys.link_states(ma_j, jphys.PhysicsState(*out.values()))
    return dict(out, link_forces=np.asarray(lf), torques=np.stack(tau), link_pos=lpos,
                link_vel=lvel)


def _torch_plain(spec_t, state, actions, dr, terrain=None):
    T = torch.as_tensor
    st, lf, tau, lpos, lvel = tfused.plain_control_step(spec_t, tuple(map(T, state)), T(actions),
                                                        tuple(map(T, dr)), terrain)
    return dict(zip(STATE, st), link_forces=lf, torques=tau, link_pos=lpos, link_vel=lvel)


def _torch_eager(ma_t, hf_t, sim_t, pd_t, dl_t, state, actions, dr):
    T = torch.as_tensor
    st, info = tphys.control_step(ma_t, hf_t, sim_t, pd_t, tphys.DomainRandParams(*map(T, dr)),
                                  dl_t, tphys.PhysicsState(*map(T, state)), T(actions))
    return dict(zip(STATE, st), link_forces=info.link_forces, torques=info.torques,
                link_pos=info.link_pos, link_vel=info.link_vel)


@pytest.mark.parametrize("option", ["T", "stiction"])
def test_plain_k2_matches_reference_on_the_plane(robot, option, monkeypatch):
    """One option at a time, decimation 2 x substeps 1 as the reference's
    tests: plain K2 against the JAX kernel body, against the port's eager
    engine, and the eager engine against JAX `engine.control_step`."""
    monkeypatch.setenv("LGC_FUSED_KERNEL", "0")
    urdf, default_pos = robot
    tol = T_TOL if option == "T" else STICTION_TOL
    (ma_j, pd_j, dl_j, sim_j), (ma_t, pd_t, dl_t, sim_t) = _setup(
        urdf, default_pos, control="T" if option == "T" else "P", stiction=option == "stiction",
        decimation=2, substeps=1)
    state, dr, actions = _rand_batch(3 if option == "T" else 11, B, default_pos)
    spec_j = jfused.build_spec(ma_j, sim_j, pd_j, dl_j)
    spec_t = tfused.build_spec(ma_t, sim_t, pd_t, dl_t)
    assert spec_t.control_type == spec_j.control_type
    assert bool(spec_t.fl_dqd) == bool(spec_j.fl_dqd) == (option == "stiction")

    ref = _jax_components(ma_j, spec_j, state, actions, dr)
    plain = _torch_plain(spec_t, state, actions, dr)
    eager = _torch_eager(ma_t, tphys.plane(), sim_t, pd_t, dl_t, state, actions, dr)
    ref_state, ref_info, _ = jphys.control_step(
        ma_j, jphys.plane(), sim_j, pd_j, jphys.DomainRandParams(*dr), dl_j,
        jphys.PhysicsState(*state), jnp.asarray(actions))
    engine = dict(zip(STATE, ref_state), link_forces=ref_info.link_forces,
                  torques=ref_info.torques, link_pos=ref_info.link_pos,
                  link_vel=ref_info.link_vel)
    for name in tol:
        _close(tol, name, plain[name], ref[name])
        _close(tol, name, plain[name], eager[name])
        _close(tol, name, eager[name], engine[name])
    if option == "T":   # the scaled action, clipped to the effort limits
        tlim = pd_t.torque_limits[:, None]
        torch.testing.assert_close(
            plain["torques"], torch.maximum(torch.minimum(torch.as_tensor(actions) * 5.0, tlim),
                                            -tlim), rtol=0, atol=0)


def test_plain_k2_matches_reference_on_a_heightfield(robot, monkeypatch):
    """Both options together on a heightfield window, on the go2 plant's
    contact and 4 substeps: plain K2 against the JAX kernel body and against
    the port's eager engine, and that against JAX `engine.control_step`."""
    monkeypatch.setenv("LGC_FUSED_KERNEL", "0")
    urdf, default_pos = robot
    contact = dict(stiffness=40000.0, damping=250.0, friction_vel=250.0, terrain_friction=1.0)
    (ma_j, pd_j, dl_j, sim_j), (ma_t, pd_t, dl_t, sim_t) = _setup(
        urdf, default_pos, control="T", stiction=True, substeps=4)
    sim_j = sim_j._replace(contact=jphys.ContactParams(**contact))
    sim_t = sim_t._replace(contact=tphys.ContactParams(**contact))
    hf_j, hf_t = _terrain()
    state, dr, actions = _hf_batch(17, default_pos)
    state[0][2] -= 0.1   # low enough that the one-legged robot meets the ground too
    spec_j = jfused.build_spec(ma_j, sim_j, pd_j, dl_j, hf_K=K, hf_hs=0.1)
    spec_t = tfused.build_spec(ma_t, sim_t, pd_t, dl_t, hf_K=K, hf_hs=0.1)
    assert spec_t.control_type == "T" and spec_t.fl_dqd and spec_t.hf_K == K

    lp_j = jpatch.extract(hf_j, jnp.asarray(state[0][0]), jnp.asarray(state[0][1]), K)
    lp_t = tpatch.extract(hf_t, torch.as_tensor(state[0][0]), torch.as_tensor(state[0][1]), K)
    terrain_j = dict(patch=jnp.moveaxis(lp_j.data, 0, -1),
                     xoff=lp_j.x0.astype(jnp.float32) * 0.1 - lp_j.border_offset,
                     yoff=lp_j.y0.astype(jnp.float32) * 0.1 - lp_j.border_offset)
    ref = _jax_components(ma_j, spec_j, state, actions, dr, terrain_j)
    plain = _torch_plain(spec_t, state, actions, dr, tfused.patch_inputs(lp_t))
    eager = _torch_eager(ma_t, hf_t, sim_t, pd_t, dl_t, state, actions, dr)
    ref_state, ref_info, _ = jax.jit(
        lambda s, a, d: jphys.control_step(ma_j, hf_j, sim_j, pd_j, d, dl_j, s, a)
    )(jphys.PhysicsState(*state), jnp.asarray(actions), jphys.DomainRandParams(*dr))
    engine = dict(zip(STATE, ref_state), link_forces=ref_info.link_forces,
                  torques=ref_info.torques, link_pos=ref_info.link_pos,
                  link_vel=ref_info.link_vel)
    for name in HF_TOL:
        _close(HF_TOL, name, plain[name], ref[name])
        _close(HF_TOL, name, plain[name], eager[name])
        _close(HF_TOL, name, eager[name], engine[name])
    assert float(np.abs(ref["link_forces"]).max()) > 1.0   # the terrain was touched


@pytest.mark.parametrize("torque,holds", [(0.1, True), (1.0, False)], ids=["below", "above"])
def test_stiction_holds_a_joint_at_rest_below_frictionloss(robot, torque, holds, monkeypatch):
    """A floating robot at rest in zero gravity, 'T' control, one joint
    driven by a constant torque: below frictionloss (0.2 N m) the implicit
    clamp absorbs the whole velocity step and every joint ends at exactly
    qd == 0 in the port's eager step, the plain K2 and the JAX engine; above
    it the driven joint moves in all three."""
    monkeypatch.setenv("LGC_FUSED_KERNEL", "0")
    urdf, default_pos = robot
    ndof = len(default_pos)
    (ma_j, pd_j, dl_j, sim_j), (ma_t, pd_t, dl_t, sim_t) = _setup(
        urdf, default_pos, control="T", stiction=True, substeps=4, gravity=(0.0, 0.0, 0.0))
    pd_j, pd_t = pd_j._replace(action_scale=1.0), pd_t._replace(action_scale=1.0)
    n = 2
    f = lambda a: np.ascontiguousarray(a, np.float32)
    state = [f(np.tile([[0.0], [0.0], [1.0]], (1, n))), f(np.tile([[1.0], [0], [0], [0]], (1, n))),
             f(np.zeros((3, n))), f(np.zeros((3, n))),
             f(np.tile(np.asarray(default_pos)[:, None], (1, n))), f(np.zeros((ndof, n)))]
    dr = [f(np.ones(n)), f(np.zeros(n)), f(np.zeros((3, n))), f(np.ones((ndof, n))),
          f(np.ones((ndof, n)))]
    actions = f(np.zeros((ndof, n)))
    actions[ndof - 1] = torque

    spec_t = tfused.build_spec(ma_t, sim_t, pd_t, dl_t)
    plain = _torch_plain(spec_t, state, actions, dr)
    eager = _torch_eager(ma_t, tphys.plane(), sim_t, pd_t, dl_t, state, actions, dr)
    ref_state, ref_info, _ = jphys.control_step(
        ma_j, jphys.plane(), sim_j, pd_j, jphys.DomainRandParams(*dr), dl_j,
        jphys.PhysicsState(*state), jnp.asarray(actions))
    np.testing.assert_allclose(np.asarray(ref_info.torques)[ndof - 1], torque, rtol=1e-6)
    for what, qd in (("plain K2", plain["dof_vel"].numpy()), ("eager", eager["dof_vel"].numpy()),
                     ("JAX engine", np.asarray(ref_state.dof_vel))):
        if holds:
            assert np.all(qd == 0.0), (what, qd)
        else:
            assert np.all(np.abs(qd[ndof - 1]) > 0.1), (what, qd)


def test_build_spec_bakes_the_k2_options(monkeypatch):
    """`fl_dqd` is the reference's to float32: bit-equal from the same
    effective inertias, and within 1e-4 relative from the port's own (an
    18 x 18 float32 inverse by another LAPACK binding).  The generated header
    carries the three K2 defines and round-trips `fl_dqd` as float32."""
    (ma_j, pd_j, dl_j, sim_j), (ma_t, pd_t, dl_t, sim_t) = _setup(
        SYNTHETIC_GO2_URDF, GO2_DEFAULT, control="T", stiction=True, substeps=4)
    spec_j = jfused.build_spec(ma_j, sim_j, pd_j, dl_j)
    spec_t = tfused.build_spec(ma_t, sim_t, pd_t, dl_t)
    assert len(spec_t.fl_dqd) == 12
    np.testing.assert_allclose(spec_t.fl_dqd, spec_j.fl_dqd, rtol=1e-4)
    same_meff = sim_t._replace(dof_meff=torch.as_tensor(np.array(sim_j.dof_meff)))
    spec_same = tfused.build_spec(ma_t, same_meff, pd_t, dl_t)
    assert spec_same.fl_dqd == spec_j.fl_dqd
    assert all(np.float32(v) == v for v in spec_t.fl_dqd)   # float32 values, held as floats

    header = tfused.spec_header(spec_t)
    assert "#define LGC_CONTROL_T 1" in header and "#define LGC_FL_IMPLICIT 1" in header
    line = next(l for l in header.splitlines() if l.startswith("#define LGC_FL_DQD "))
    baked = [np.float32(tok.rstrip("f")) for tok in line.split("{")[1].rstrip("}").split(", ")]
    assert baked == [np.float32(v) for v in spec_t.fl_dqd]
    off = tfused.spec_header(spec_t._replace(control_type="P", fl_dqd=()))
    assert "#define LGC_CONTROL_T 0" in off and "#define LGC_FL_IMPLICIT 0" in off
    assert "#define LGC_FL_DQD {" + ", ".join(["0.000000000e+00f"] * 12) + "}" in off
    # no implicit stiction without the effective inertias, as the reference
    assert tfused.build_spec(ma_t, sim_t._replace(dof_meff=None), pd_t, dl_t).fl_dqd == ()
    assert tfused.variant_name(spec_t) == "fused_control_step_T_stiction"
    assert tfused.variant_name(spec_t._replace(hf_K=24, hf_hs=0.1, control_type="P")) \
        == "fused_control_step_stiction_hf"


def test_check_covered_raises_only_for_velocity_control():
    _, (ma_t, pd_t, dl_t, sim_t) = _setup(SYNTHETIC_GO2_URDF, GO2_DEFAULT, stiction=True)
    spec = tfused.build_spec(ma_t, sim_t, pd_t, dl_t)
    for control in ("P", "T"):
        for fl in (spec.fl_dqd, ()):
            for hf in (dict(), dict(hf_K=24, hf_hs=0.1)):
                tfused.check_covered(spec._replace(control_type=control, fl_dqd=fl, **hf))
    for hf in (dict(), dict(hf_K=24, hf_hs=0.1)):
        with pytest.raises(NotImplementedError, match="'V'"):
            tfused.check_covered(spec._replace(control_type="V", **hf))
    spec_v = tfused.build_spec(ma_t, sim_t, pd_t._replace(control_type="V"), dl_t)
    state, dr, actions = _rand_batch(1, 4, GO2_DEFAULT)
    T = torch.as_tensor
    for call in (lambda: tfused.KernelBuild(spec_v),   # raises before any compiler is looked for
                 lambda: tfused.fused_control_step(spec_v, tuple(map(T, state)), T(actions),
                                                   tuple(map(T, dr)))):
        with pytest.raises(NotImplementedError, match="'V'"):
            call()
    with pytest.raises(ValueError):
        tfused.check_covered(spec._replace(fl_dqd=(0.1,) * 3))
