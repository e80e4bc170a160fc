"""The port's MJCF export and its dynamics against MuJoCo, on the CPU.

`RobotModel.to_mjcf` must write the JAX package's XML string exactly (both
URDFs, the dynamics-only model and the contact model with per-dof joint
dynamics).  On that model MuJoCo is an oracle independent of JAX: the cases of
tests/test_dynamics_vs_mujoco.py run on the port's `crba`, `rnea` and `aba` in
float64 on the synthetic Go2, at that file's tolerances (mass matrix rtol
1e-6; ABA qacc rtol 1e-5 with atol 1e-5 on the base and 1e-4 on the joints;
RNEA round trip rtol 1e-6; bias rtol 1e-6, atol 1e-8).

Conventions (MuJoCo free joint): qvel[0:3] is the linear velocity of the body
origin in WORLD coords, qvel[3:6] the angular velocity in BODY coords; the
engine's generalized velocity is [omega_body; v_body(origin); qd].
"""
import mujoco
import numpy as np
import pytest
import torch

from legged_gym_custom_tpu.physics.urdf import load_urdf as jax_load_urdf
from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch import physics as tphys
from legged_gym_custom_tpu_torch.physics import soa
from torch_tree_model import TEST_TREE_URDF

NDOF = 12
T = lambda a: torch.as_tensor(np.asarray(a, np.float64))


@pytest.mark.parametrize("urdf", [SYNTHETIC_GO2_URDF, TEST_TREE_URDF], ids=["go2", "tree"])
@pytest.mark.parametrize("kwargs", [
    {},
    dict(contact=True, friction=0.8, timestep=0.002, joint_damping=0.1,
         joint_armature=0.01, joint_frictionloss=0.2),
    "per_dof",
], ids=["dynamics_only", "contact_scalar", "contact_per_dof"])
def test_to_mjcf_matches_reference_exactly(urdf, kwargs):
    model = tphys.load_urdf(urdf, "robot")
    if kwargs == "per_dof":
        rng = np.random.default_rng(5)
        n = model.num_dof
        kwargs = dict(contact=True, friction=1.0, joint_damping=rng.uniform(0, 0.5, n),
                      joint_armature=rng.uniform(0, 0.05, n),
                      joint_frictionloss=rng.uniform(0, 0.3, n))
    xml = model.to_mjcf(**kwargs)
    assert xml == jax_load_urdf(urdf, "robot").to_mjcf(**kwargs)
    mjm = mujoco.MjModel.from_xml_string(xml)
    assert mjm.nv == 6 + model.num_dof and mjm.nbody == model.nb + 1


@pytest.fixture(scope="module")
def setup():
    model = tphys.load_urdf(SYNTHETIC_GO2_URDF, "go2")
    mjm = mujoco.MjModel.from_xml_string(model.to_mjcf())
    ma = tphys.model_arrays(model, dtype=torch.float64)
    return model, mjm, ma


def _rand_state(rng, model):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    pos = rng.normal(size=3)
    dof_pos = rng.uniform(model.dof_pos_limits[:, 0], model.dof_pos_limits[:, 1])
    v_world = rng.normal(size=3)
    w_body = rng.normal(size=3)
    dof_vel = rng.normal(size=NDOF)
    return pos, q, v_world, w_body, dof_pos, dof_vel


def _set_mj_state(mjd, pos, q, v_world, w_body, dof_pos, dof_vel):
    mjd.qpos[:3] = pos
    mjd.qpos[3:7] = q  # wxyz, as MuJoCo
    mjd.qpos[7:] = dof_pos
    mjd.qvel[:3] = v_world
    mjd.qvel[3:6] = w_body
    mjd.qvel[6:] = dof_vel


def _R(q):
    return soa.quat_to_matrix(T(q)).numpy()


def _my_vbase(q, v_world, w_body):
    return T(np.concatenate([w_body, _R(q).T @ v_world]))


def _check_qacc(a0, qdd, v_base, q, qacc):
    """The engine's (base spatial acceleration, qdd) against MuJoCo's qacc."""
    a0, w_b, u_b = a0.numpy(), v_base[:3].numpy(), v_base[3:].numpy()
    # qacc linear = d/dt v_world = R (udot + w x u)
    qacc_lin_mine = _R(q) @ (a0[3:] + np.cross(w_b, u_b))
    np.testing.assert_allclose(qacc_lin_mine, qacc[0:3], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a0[:3], qacc[3:6], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(qdd.numpy(), qacc[6:], rtol=1e-5, atol=1e-4)


def test_velocity_convention(setup, rng):
    """The assumed MuJoCo free-joint velocity convention, through cvel."""
    model, mjm, ma = setup
    mjd = mujoco.MjData(mjm)
    pos, q, v_world, w_body, dof_pos, dof_vel = _rand_state(rng, model)
    _set_mj_state(mjd, pos, q, v_world, w_body, dof_pos, np.zeros(NDOF))
    mujoco.mj_forward(mjm, mjd)
    np.testing.assert_allclose(mjd.cvel[1][:3], _R(q) @ w_body, atol=1e-9)


def _energy_matches(rng, H, M_mj, q, n=5):
    """u' H u in the engine's coordinates equals MuJoCo's u' M u."""
    Rm = _R(q)
    for _ in range(n):
        u_mj = rng.normal(size=6 + NDOF)
        u_mine = np.concatenate([u_mj[3:6], Rm.T @ u_mj[0:3], u_mj[6:]])
        np.testing.assert_allclose(u_mine @ H @ u_mine, u_mj @ M_mj @ u_mj, rtol=1e-6)


def test_mass_matrix_vs_mujoco(setup, rng):
    model, mjm, ma = setup
    mjd = mujoco.MjData(mjm)
    inertias = tphys.body_inertias(ma)
    for _ in range(3):
        pos, q, v_world, w_body, dof_pos, dof_vel = _rand_state(rng, model)
        _set_mj_state(mjd, pos, q, v_world, w_body, dof_pos, dof_vel)
        mujoco.mj_forward(mjm, mjd)
        M_mj = np.zeros((mjm.nv, mjm.nv))
        mujoco.mj_fullM(mjm, mjd, M_mj)
        H = tphys.crba(ma, inertias, T(q), T(dof_pos)).numpy()
        _energy_matches(rng, H, M_mj, q)


def test_aba_vs_mujoco(setup, rng):
    """Forward dynamics with joint torques and an external force at a world
    point on a calf body."""
    model, mjm, ma = setup
    mjd = mujoco.MjData(mjm)
    inertias = tphys.body_inertias(ma)
    fpt_body = 3
    for _ in range(5):
        pos, q, v_world, w_body, dof_pos, dof_vel = _rand_state(rng, model)
        tau = rng.normal(size=NDOF) * 5.0
        _set_mj_state(mjd, pos, q, v_world, w_body, dof_pos, dof_vel)
        mjd.qfrc_applied[:] = 0.0
        mjd.qfrc_applied[6:] = tau
        point = mjd.qpos[:3] + np.array([0.1, 0.05, -0.2])
        force = rng.normal(size=3) * 20.0
        mujoco.mj_forward(mjm, mjd)
        mujoco.mj_applyFT(mjm, mjd, force, np.zeros(3), point, fpt_body + 1, mjd.qfrc_applied)
        mujoco.mj_forward(mjm, mjd)

        # the same force as a wrench about the body origin, world coords
        _, _, _, p0 = tphys.joint_transforms(ma, T(q), T(dof_pos))
        body_origin_w = pos + p0[fpt_body].numpy()
        f_ext = np.zeros((model.nb, 6))
        f_ext[fpt_body] = np.concatenate([np.cross(point - body_origin_w, force), force])
        v_base = _my_vbase(q, v_world, w_body)
        a0, qdd = tphys.aba(ma, inertias, T(q), T(dof_pos), v_base, T(dof_vel), T(tau),
                            f_ext=T(f_ext))
        _check_qacc(a0, qdd, v_base, q, mjd.qacc.copy())


def test_full_plant_vs_mujoco(setup, rng):
    """CRBA and ABA with armature and viscous joint damping against the
    MuJoCo model with the go2 plant's joint dynamics (damping 0.1, armature
    0.01).  Frictionloss is left out: MuJoCo resolves it in the constraint
    solver, not in the smooth forward dynamics (tests/test_torch_sim_parity.py
    holds it over a drop)."""
    model, _, ma = setup
    damping, armature = 0.1, 0.01
    mjm = mujoco.MjModel.from_xml_string(
        model.to_mjcf(joint_damping=damping, joint_armature=armature))
    mjd = mujoco.MjData(mjm)
    arm = torch.full((NDOF,), armature, dtype=torch.float64)
    inertias = tphys.body_inertias(ma)
    for _ in range(3):
        pos, q, v_world, w_body, dof_pos, dof_vel = _rand_state(rng, model)
        tau = rng.normal(size=NDOF) * 5.0
        _set_mj_state(mjd, pos, q, v_world, w_body, dof_pos, dof_vel)
        mjd.qfrc_applied[:] = 0.0
        mjd.qfrc_applied[6:] = tau
        mujoco.mj_forward(mjm, mjd)
        M_mj = np.zeros((mjm.nv, mjm.nv))
        mujoco.mj_fullM(mjm, mjd, M_mj)
        H = tphys.crba(ma, inertias, T(q), T(dof_pos), armature=arm).numpy()
        _energy_matches(rng, H, M_mj, q, n=1)
        # damping enters as an explicit joint torque, armature through ABA
        v_base = _my_vbase(q, v_world, w_body)
        a0, qdd = tphys.aba(ma, inertias, T(q), T(dof_pos), v_base, T(dof_vel),
                            T(tau - damping * dof_vel), armature=arm)
        _check_qacc(a0, qdd, v_base, q, mjd.qacc.copy())


def test_rnea_aba_roundtrip(setup, rng):
    """Inverse dynamics of forward dynamics gives back the torques."""
    model, _, ma = setup
    pos, q, v_world, w_body, dof_pos, dof_vel = _rand_state(rng, model)
    tau = T(rng.normal(size=NDOF) * 3.0)
    v_base = _my_vbase(q, v_world, w_body)
    inertias = tphys.body_inertias(ma)
    common = (ma, inertias, T(q), T(dof_pos), v_base, T(dof_vel))
    a0, qdd = tphys.aba(*common, tau)
    f0, tau_rec = tphys.rnea(*common, a0, qdd)
    np.testing.assert_allclose(tau_rec.numpy(), tau.numpy(), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(f0.numpy(), np.zeros(6), atol=1e-8)


def test_bias_vs_mujoco(setup, rng):
    model, mjm, ma = setup
    mjd = mujoco.MjData(mjm)
    pos, q, v_world, w_body, dof_pos, dof_vel = _rand_state(rng, model)
    _set_mj_state(mjd, pos, q, v_world, w_body, dof_pos, dof_vel)
    mujoco.mj_forward(mjm, mjd)
    v_base = _my_vbase(q, v_world, w_body)
    # MuJoCo's qacc = 0 in the engine's coordinates: w_dot = 0, v_world_dot = 0
    # => u_b_dot = -w_b x u_b
    w_b, u_b = v_base[:3].numpy(), v_base[3:].numpy()
    qdd_base = T(np.concatenate([np.zeros(3), -np.cross(w_b, u_b)]))
    _, tau_b = tphys.rnea(ma, tphys.body_inertias(ma), T(q), T(dof_pos), v_base, T(dof_vel),
                          qdd_base, torch.zeros(NDOF, dtype=torch.float64))
    np.testing.assert_allclose(tau_b.numpy(), mjd.qfrc_bias[6:], rtol=1e-6, atol=1e-8)
