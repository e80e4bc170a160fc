"""Parity of the PyTorch port's inverse dynamics and mass matrix (`rnea`,
`crba`, `effective_joint_inertia`) with the JAX reference, on the CPU.

Same seeded numpy inputs through both, in float64 (JAX under
`jax.enable_x64`), rtol 1e-9: the two run the same arithmetic in another
order, so what is left is float64 rounding.  `effective_joint_inertia` is
also held in float32, the type the env uses it in and the only one the
reference's function has, at rtol 1e-4 (an 18 x 18 inverse by two LAPACK
bindings).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from legged_gym_custom_tpu import physics as jphys
from legged_gym_custom_tpu.physics import algorithms as jalg
from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch import physics as tphys
from test_torch_physics import GO2_DEFAULT, TINY_URDF, _rand_batch

B = 8
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module", params=["tiny", "go2_synthetic"])
def robot(request, tmp_path_factory):
    if request.param == "tiny":
        path = tmp_path_factory.mktemp("urdf") / "tiny.urdf"
        path.write_text(TINY_URDF)
        return str(path), np.zeros(1)
    return SYNTHETIC_GO2_URDF, GO2_DEFAULT


def _inputs(urdf, default_pos, seed):
    """float64 inputs: state, DR, armature, a random wrench and accelerations."""
    state, dr, _ = _rand_batch(seed, B, default_pos)
    ndof = len(default_pos)
    pos, quat, lin, ang, q, qd = [np.asarray(a, np.float64) for a in state]
    quat = quat / np.linalg.norm(quat, axis=0, keepdims=True)
    rng = np.random.default_rng(seed + 50)
    nb = tphys.load_urdf(urdf, "r").nb
    return dict(
        quat=quat, q=q, qd=qd, v_base=np.concatenate([ang, lin]),
        added_mass=np.asarray(dr[1], np.float64), com_offset=np.asarray(dr[2], np.float64),
        arm=rng.uniform(0.005, 0.02, ndof), f_ext=rng.normal(size=(nb, 6, B)),
        qdd_base=rng.normal(size=(6, B)), qdd=rng.normal(size=(ndof, B)) * 5.0,
        tau=rng.normal(size=(ndof, B)) * 5.0)


def _models(urdf):
    ma_j = jalg.model_arrays(jphys.load_urdf(urdf, "r"), dtype=jnp.float64)
    ma_t = tphys.model_arrays(tphys.load_urdf(urdf, "r"), dtype=torch.float64)
    return ma_j, ma_t


def test_crba_matches_reference_and_is_symmetric(robot):
    urdf, default_pos = robot
    x = _inputs(urdf, default_pos, 1)
    T = torch.as_tensor
    with jax.enable_x64(True):
        ma_j, ma_t = _models(urdf)
        in_j = jalg.body_inertias(ma_j, jnp.asarray(x["added_mass"]), jnp.asarray(x["com_offset"]))
        H_j = np.asarray(jalg.crba(ma_j, in_j, jnp.asarray(x["quat"]), jnp.asarray(x["q"]),
                                   armature=jnp.asarray(x["arm"])))
    in_t = tphys.body_inertias(ma_t, T(x["added_mass"]), T(x["com_offset"]))
    H_t = tphys.crba(ma_t, in_t, T(x["quat"]), T(x["q"]), armature=T(x["arm"])).numpy()
    assert H_t.dtype == np.float64 and H_t.shape == (6 + len(default_pos),) * 2 + (B,)
    np.testing.assert_allclose(H_t, H_j, **TOL)
    np.testing.assert_allclose(H_t, np.swapaxes(H_t, 0, 1), rtol=0, atol=1e-12)
    # positive definite in every env
    assert np.linalg.eigvalsh(np.moveaxis(H_t, -1, 0)).min() > 0.0


@pytest.mark.parametrize("with_accel", [False, True], ids=["bias", "accel"])
def test_rnea_matches_reference(robot, with_accel):
    """The bias force (zero accelerations) and the full inverse dynamics with
    accelerations, an external wrench and armature."""
    urdf, default_pos = robot
    x = _inputs(urdf, default_pos, 2)
    if not with_accel:
        x["qdd_base"], x["qdd"] = np.zeros_like(x["qdd_base"]), np.zeros_like(x["qdd"])
    J, T = jnp.asarray, torch.as_tensor
    with jax.enable_x64(True):
        ma_j, ma_t = _models(urdf)
        in_j = jalg.body_inertias(ma_j, J(x["added_mass"]), J(x["com_offset"]))
        f0_j, tau_j = jalg.rnea(ma_j, in_j, J(x["quat"]), J(x["q"]), J(x["v_base"]), J(x["qd"]),
                                J(x["qdd_base"]), J(x["qdd"]), f_ext=J(x["f_ext"]),
                                armature=J(x["arm"]))
        f0_j, tau_j = np.asarray(f0_j), np.asarray(tau_j)
    in_t = tphys.body_inertias(ma_t, T(x["added_mass"]), T(x["com_offset"]))
    f0_t, tau_t = tphys.rnea(ma_t, in_t, T(x["quat"]), T(x["q"]), T(x["v_base"]), T(x["qd"]),
                             T(x["qdd_base"]), T(x["qdd"]), f_ext=T(x["f_ext"]),
                             armature=T(x["arm"]))
    assert tau_t.dtype == torch.float64
    np.testing.assert_allclose(f0_t.numpy(), f0_j, **TOL)
    np.testing.assert_allclose(tau_t.numpy(), tau_j, **TOL)


def test_rnea_of_aba_accelerations_gives_back_the_torques(robot):
    """Forward then inverse dynamics in the port, float64: `rnea` of the
    accelerations `aba` gives for (tau, wrench, armature) returns tau and a
    zero base wrench, to 1e-8 (the two walk the tree in opposite orders)."""
    urdf, default_pos = robot
    x = _inputs(urdf, default_pos, 3)
    T = torch.as_tensor
    ma_t = tphys.model_arrays(tphys.load_urdf(urdf, "r"), dtype=torch.float64)
    inertias = tphys.body_inertias(ma_t, T(x["added_mass"]), T(x["com_offset"]))
    common = (ma_t, inertias, T(x["quat"]), T(x["q"]), T(x["v_base"]), T(x["qd"]))
    a0, qdd = tphys.aba(*common, T(x["tau"]), f_ext=T(x["f_ext"]), armature=T(x["arm"]))
    f0, tau = tphys.rnea(*common, a0, qdd, f_ext=T(x["f_ext"]), armature=T(x["arm"]))
    np.testing.assert_allclose(tau.numpy(), x["tau"], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(f0.numpy(), 0.0, atol=1e-7)


def test_effective_joint_inertia_matches_reference(robot):
    """1 / diag(inv(H))[6:] at the float32-rounded default pose.  The
    reference's function works in float32 whatever the model's type, so in
    float64 the port is held against the same formula on the reference's
    float64 `crba`, and in float32 (as the env calls it) against the
    reference's function."""
    urdf, default_pos = robot
    ndof = len(default_pos)
    arm = np.full(ndof, 0.01)
    q0 = np.asarray(default_pos, np.float32)
    with jax.enable_x64(True):
        ma_j, ma_t = _models(urdf)
        H = jalg.crba(ma_j, jalg.body_inertias(ma_j), jnp.asarray([1.0, 0.0, 0.0, 0.0]),
                      jnp.asarray(q0, jnp.float64), armature=jnp.asarray(arm))
        meff_j = 1.0 / np.diagonal(np.linalg.inv(np.asarray(H)))[6:]
    meff_t = tphys.effective_joint_inertia(ma_t, q0, armature=torch.as_tensor(arm))
    assert meff_t.dtype == torch.float64
    assert meff_t.shape == (ndof,) and bool((meff_t > 0.01).all())   # above the armature
    np.testing.assert_allclose(meff_t.numpy(), meff_j, **TOL)

    ma_j32 = jalg.model_arrays(jphys.load_urdf(urdf, "r"))
    ma_t32 = tphys.model_arrays(tphys.load_urdf(urdf, "r"))
    m_j = np.asarray(jphys.effective_joint_inertia(ma_j32, q0, armature=jnp.full(ndof, 0.01)))
    m_t = tphys.effective_joint_inertia(ma_t32, q0, armature=torch.full((ndof,), 0.01))
    assert m_j.dtype == np.float32 and m_t.dtype == torch.float32
    np.testing.assert_allclose(m_t.numpy(), m_j, rtol=1e-4)
    np.testing.assert_allclose(m_t.numpy(), meff_j, rtol=1e-4)
