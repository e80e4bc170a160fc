"""The batched physics engine, torch port of
legged_gym_custom_tpu/physics/engine.py.

One *control step* = `decimation` torque updates x `substeps` integrator
substeps (reference legged_robot.py:79-85).  Layout: component-major with
the env batch trailing (physics/soa.py); PhysicsState leaves are (3, B) /
(4, B) / (ndof, B).

On heightfield terrain a (K, K) window of the height table is cut around
each env once per control step (physics/patch.py), and the contact surface
under each sphere is sampled at the first substep of every decimation tick
and held through the tick (`terrain_tick_sample`).

`kernel_spec` decides once, when an env or an MPPI solver is built, whether
its control steps run the hand-written kernel (ops/fused_step.py,
ops/csrc/fused_step.cu): it returns the kernel's FusedSpec, or None where
the config's `sim.fused_kernel` or `LGC_FUSED_KERNEL=0` turns the kernel
off.  `control_step` and `actuated_control_step` follow one rule: with a
spec, on CUDA tensors, the kernel runs the step (one launch, the plane
variant on the flat plane, the heightfield variant with the per-env windows
as input on a heightfield; one launch a tick for a stateful actuator) and
also writes the link states of the final state; a configuration it does
not cover raises NotImplementedError rather than fall back.  Otherwise
(CPU tensors, or no spec) the eager loop, in plain PyTorch ops, runs it:
that is how the heightfield modes the kernel does not cover run on the
card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import soa
from .actuator import PDParams, compute_torques
from .algorithms import ModelArrays, aba, body_inertias, crba, forward_kinematics
from . import patch
from .contact import ContactParams, compute_contacts, geom_centers, sample_surface
from .heightfield import Heightfield
from ..utils.profiling import span


class PhysicsState(NamedTuple):
    """Dynamic state: base_pos (3,)+bs, base_quat (4,)+bs wxyz world<-body,
    lin_vel/ang_vel (3,)+bs world frame, dof_pos/dof_vel (ndof,)+bs."""

    base_pos: torch.Tensor
    base_quat: torch.Tensor
    lin_vel: torch.Tensor
    ang_vel: torch.Tensor
    dof_pos: torch.Tensor
    dof_vel: torch.Tensor


class SimParams(NamedTuple):
    dt: float = 0.005
    decimation: int = 4
    substeps: int = 2
    gravity: tuple = (0.0, 0.0, -9.81)
    contact: ContactParams = ContactParams()
    joint_limit_stiffness: float = 60.0
    joint_limit_damping: float = 2.0
    dof_vel_clamp: bool = True
    # Half-width [m] of the per-env terrain window cut once per control step
    # (physics/patch.py): it must cover the collision spheres' reach plus the
    # base drift within one step.  0 samples the global table instead.
    patch_halfwidth: float = 1.2
    # joint passive dynamics: each None (off) or an (ndof,) tensor
    dof_damping: Optional[torch.Tensor] = None       # viscous: -d * qd
    dof_armature: Optional[torch.Tensor] = None      # reflected rotor inertia
    dof_frictionloss: Optional[torch.Tensor] = None  # Coulomb: -fl * tanh(qd/eps)
    frictionloss_vel_eps: float = 0.1
    # True stiction: resolve frictionloss as an implicit velocity-space
    # Coulomb clamp instead of the tanh torque.  After integrating the
    # unconstrained velocity each joint sheds up to fl * dt / m_eff of
    # velocity toward zero, the discrete form of a friction torque bounded
    # by +-fl that can hold a joint exactly at rest.  `dof_meff` is the
    # per-joint effective inertia (`effective_joint_inertia`).
    frictionloss_implicit: bool = False
    dof_meff: Optional[torch.Tensor] = None          # (ndof,) [kg m^2]
    # Sample the terrain under each sphere once per decimation tick and hold
    # it through the substeps (the reference plant's collision cadence,
    # legged_robot.py:79-85); False resamples at every substep.  No effect
    # on the flat plane.
    terrain_tick_sample: bool = True


class DomainRandParams(NamedTuple):
    """Per-env dynamics randomization: friction ()+bs, added_mass ()+bs,
    com_offset (3,)+bs, kp_mult/kd_mult (ndof,)+bs."""

    friction: torch.Tensor
    added_mass: torch.Tensor
    com_offset: torch.Tensor
    kp_mult: torch.Tensor
    kd_mult: torch.Tensor


class StepInfo(NamedTuple):
    link_forces: torch.Tensor   # (n_links, 3)+bs contact forces, mean over the last tick
    link_pos: torch.Tensor      # (n_links, 3)+bs world positions of link frames
    link_vel: torch.Tensor      # (n_links, 3)+bs world linear velocities
    torques: torch.Tensor       # (ndof,)+bs last applied torques


def _spatial_vbase(state: PhysicsState):
    R = soa.quat_to_matrix(state.base_quat)
    return torch.cat([soa.mtv(R, state.ang_vel), soa.mtv(R, state.lin_vel)], dim=0)


def _joint_limit_torque(params: SimParams, limits_lo, limits_hi, dof_pos, dof_vel):
    bs = tuple(dof_pos.shape[1:])
    below = torch.clamp(dof_pos - soa.bcast(limits_lo, bs), max=0.0)
    above = torch.clamp(dof_pos - soa.bcast(limits_hi, bs), min=0.0)
    viol = (below < 0) | (above > 0)
    return -params.joint_limit_stiffness * (below + above) - torch.where(
        viol, params.joint_limit_damping * dof_vel, torch.zeros_like(dof_vel)
    )


def _joint_passive_torque(params: SimParams, dof_vel):
    """Viscous damping + tanh-smoothed Coulomb friction at the joints; in
    implicit mode the friction is the velocity clamp in `substep` instead."""
    bs = tuple(dof_vel.shape[1:])
    tau = None
    if params.dof_damping is not None:
        tau = -soa.bcast(params.dof_damping, bs) * dof_vel
    if params.dof_frictionloss is not None and not params.frictionloss_implicit:
        fric = -soa.bcast(params.dof_frictionloss, bs) * torch.tanh(
            dof_vel / params.frictionloss_vel_eps
        )
        tau = fric if tau is None else tau + fric
    return tau


def effective_joint_inertia(ma: ModelArrays, dof_pos0, armature=None):
    """Per-joint apparent inertia 1 / (M^-1)_jj at a reference pose
    (unbatched, in the model's dtype; the angles are rounded to float32
    first, as the reference does), floating base included: the inertia a
    joint torque works against when the base and the other joints are free,
    so the implicit friction clamp fl * dt / m_eff absorbs exactly the
    velocity a sub-threshold torque injects."""
    dtype, device = ma.mass.dtype, ma.mass.device
    quat0 = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)
    q0 = torch.as_tensor(np.asarray(dof_pos0, np.float32), device=device).to(dtype)
    H = crba(ma, body_inertias(ma), quat0, q0, armature=armature)
    return 1.0 / torch.diagonal(torch.linalg.inv(H))[6:]


def substep(ma: ModelArrays, hf, params: SimParams, dr: DomainRandParams,
            dof_limits: tuple, state: PhysicsState, tau, dt: float, inertias, surface=None):
    """One semi-implicit Euler substep. Returns (state', contacts).  `hf` is a
    Heightfield or a patch.LocalPatch; `surface` an optional frozen contact
    surface per geom (contact.sample_surface)."""
    v_base = _spatial_vbase(state)
    _, _, E0, p0w, v_body = forward_kinematics(
        ma, state.base_quat, state.base_pos, state.dof_pos, v_base, state.dof_vel
    )
    contacts = compute_contacts(ma, hf, params.contact, dr.friction, E0, p0w, v_body,
                                surface=surface)
    tau_total = tau + _joint_limit_torque(
        params, dof_limits[0], dof_limits[1], state.dof_pos, state.dof_vel
    )
    tau_passive = _joint_passive_torque(params, state.dof_vel)
    if tau_passive is not None:
        tau_total = tau_total + tau_passive
    a0, qdd = aba(
        ma, inertias, state.base_quat, state.dof_pos, v_base, state.dof_vel,
        tau_total, f_ext=contacts.body_wrench, gravity=params.gravity,
        armature=params.dof_armature,
    )
    # semi-implicit Euler in the base frame
    w_b = v_base[0:3] + a0[0:3] * dt
    u_b = v_base[3:6] + a0[3:6] * dt
    R = soa.quat_to_matrix(state.base_quat)
    lin_vel = soa.mv(R, u_b)
    ang_vel = soa.mv(R, w_b)
    base_pos = state.base_pos + lin_vel * dt
    base_quat = soa.quat_integrate(state.base_quat, w_b, dt)
    dof_vel = state.dof_vel + qdd * dt
    if (params.dof_frictionloss is not None and params.frictionloss_implicit
            and params.dof_meff is not None):
        # implicit Coulomb clamp: shed up to fl * dt / m_eff toward zero
        dqd_max = soa.bcast(params.dof_frictionloss * dt / params.dof_meff,
                            tuple(dof_vel.shape[1:]))
        dof_vel = dof_vel - torch.maximum(torch.minimum(dof_vel, dqd_max), -dqd_max)
    if params.dof_vel_clamp:
        vlim = soa.bcast(dof_limits[2], tuple(dof_vel.shape[1:]))
        dof_vel = torch.maximum(torch.minimum(dof_vel, vlim), -vlim)
    dof_pos = state.dof_pos + dof_vel * dt
    return PhysicsState(base_pos, base_quat, lin_vel, ang_vel, dof_pos, dof_vel), contacts


def link_states(ma: ModelArrays, state: PhysicsState):
    """World positions and velocities of all report-link frames."""
    bs = tuple(state.dof_pos.shape[1:])
    v_base = _spatial_vbase(state)
    _, _, E0, p0w, v_body = forward_kinematics(
        ma, state.base_quat, state.base_pos, state.dof_pos, v_base, state.dof_vel
    )
    lb = ma.link_body
    R_wb = torch.stack([E.transpose(0, 1) for E in E0])[lb]   # (nl,3,3)+bs
    p_w = torch.stack(p0w)[lb]
    w_b = torch.stack([v[0:3] for v in v_body])[lb]
    u_b = torch.stack([v[3:6] for v in v_body])[lb]
    lpos = ma.link_pos.reshape(tuple(ma.link_pos.shape) + (1,) * len(bs))
    lpos = lpos * torch.ones_like(p_w)
    pos = p_w + torch.einsum("lij...,lj...->li...", R_wb, lpos)
    vel_b = u_b + torch.cross(w_b, lpos, dim=1)
    vel = torch.einsum("lij...,lj...->li...", R_wb, vel_b)
    return pos, vel


def patch_K(hf: Heightfield, params: SimParams) -> int:
    """Side of the per-env terrain window the control step cuts (reference
    engine.py:310-313), or 0 on the plane or with `patch_halfwidth` 0."""
    if hf.is_plane or params.patch_halfwidth <= 0:
        return 0
    return patch.patch_size(params.patch_halfwidth, hf.horizontal_scale)


def _eager_loop(ma: ModelArrays, hf: Heightfield, params: SimParams, pd: PDParams,
                dr: DomainRandParams, dof_limits: tuple, state: PhysicsState, actions,
                torque_fn=None, actuator_state=None):
    """decimation x substeps in plain PyTorch ops; the torques of each tick
    are the PD law's, or `torque_fn`'s (an `lgc.actuator` span) clipped to
    the effort limits."""
    dt_sub = params.dt / params.substeps
    inertias = body_inertias(ma, dr.added_mass, dr.com_offset)
    terrain = hf
    K = patch_K(hf, params)
    if K and state.base_pos.dim() == 2:
        terrain = patch.extract(hf, state.base_pos[0], state.base_pos[1], K)
    tick_sample = params.terrain_tick_sample and not hf.is_plane
    tlim = soa.bcast(pd.torque_limits, tuple(state.dof_pos.shape[1:]))
    link_forces = tau = None
    for _tick in range(params.decimation):
        if torque_fn is None:
            tau = compute_torques(pd, actions, state.dof_pos, state.dof_vel, dr.kp_mult,
                                  dr.kd_mult)
        else:
            with span("lgc.actuator"):
                tau, actuator_state = torque_fn(actions, state.dof_pos, state.dof_vel,
                                                actuator_state)
            tau = torch.maximum(torch.minimum(tau, tlim), -tlim)
        surface = None
        if tick_sample:
            # freeze the contact surface for this 200 Hz tick
            _, _, E0, p0w, _ = forward_kinematics(
                ma, state.base_quat, state.base_pos, state.dof_pos, _spatial_vbase(state),
                state.dof_vel)
            surface = sample_surface(ma, terrain, geom_centers(ma, E0, p0w))
        lf_sum = 0.0
        for _s in range(params.substeps):
            state, contacts = substep(ma, terrain, params, dr, dof_limits, state, tau, dt_sub,
                                      inertias, surface=surface)
            lf_sum = lf_sum + contacts.link_force
        # mean over the tick's substeps (PhysX contact_collection=2 analog)
        link_forces = lf_sum / params.substeps
    pos, vel = link_states(ma, state)
    return state, StepInfo(link_forces, pos, vel, tau), actuator_state


def _check_kernel_terrain(hf: Heightfield, params: SimParams):
    """Raise for a heightfield the kernel's variants do not cover."""
    if hf.is_plane:
        return
    opt_out = ("; an env with sim.fused_kernel = False (or built under LGC_FUSED_KERNEL=0) "
               "runs it on the card through the eager engine")
    if patch_K(hf, params) == 0:
        raise NotImplementedError(
            "heightfield terrain with no per-env patch (patch_halfwidth=0): the "
            "heightfield kernel reads its window, there is no global-table kernel" + opt_out)
    if not params.terrain_tick_sample:
        raise NotImplementedError(
            "terrain_tick_sample=False: the heightfield kernel samples the surface "
            "once per decimation tick and has no per-substep variant" + opt_out)


def kernel_spec(ma: ModelArrays, hf: Heightfield, params: SimParams, pd: PDParams,
                dof_limits: tuple, enabled: bool = True):
    """The fused kernel's FusedSpec for this plant on `hf`, built host-side
    once by the caller: K1 on the plane, K3 with the contact window's size
    on a heightfield, each with the K2 options ('T' control, implicit
    stiction) the plant asks for.  None where `enabled` (the config's
    `sim.fused_kernel`) is False or `LGC_FUSED_KERNEL` turns the kernel off:
    the control steps given None run the eager loop on either device."""
    from ..ops import fused_step

    if not (enabled and fused_step.kernel_enabled()):
        return None
    return fused_step.build_spec(ma, params, pd, dof_limits, hf_K=patch_K(hf, params),
                                 hf_hs=0.0 if hf.is_plane else hf.horizontal_scale)


def control_step(ma: ModelArrays, hf: Heightfield, params: SimParams, pd: PDParams,
                 dr: DomainRandParams, dof_limits: tuple, state: PhysicsState, actions,
                 spec=None):
    """Full 50 Hz control step.  Returns (state', StepInfo).

    With a `spec` (`kernel_spec`), CUDA tensors go through the fused kernel:
    on a heightfield the per-env windows are cut here and passed to the
    kernel's heightfield variant.  Otherwise the eager loop runs the step.
    """
    with span("lgc.physics"):
        if spec is None or not state.dof_pos.is_cuda:
            return _eager_loop(ma, hf, params, pd, dr, dof_limits, state, actions)[:2]
        from ..ops import fused_step

        terrain = None
        _check_kernel_terrain(hf, params)
        if not hf.is_plane:
            lp = patch.extract(hf, state.base_pos[0], state.base_pos[1], patch_K(hf, params))
            terrain = fused_step.patch_inputs(lp)
        out_state, link_forces, torques, lpos, lvel = fused_step.fused_control_step(
            spec,
            tuple(state),
            actions,
            (dr.friction, dr.added_mass, dr.com_offset, dr.kp_mult, dr.kd_mult),
            terrain,
        )
        return PhysicsState(*out_state), StepInfo(link_forces, lpos, lvel, torques)


def tickwise_control_step(ma: ModelArrays, hf: Heightfield, params: SimParams, pd: PDParams,
                          dr: DomainRandParams, dof_limits: tuple, state: PhysicsState, actions,
                          actuator_state, torque_fn, spec):
    """A stateful actuator's control step through the fused kernel, one
    launch per decimation tick.  At each tick `torque_fn` gives the torques
    from the current dof state, clipped to the effort limits, and one launch
    of `spec`'s one-tick 'T' spec (`fused_step.tick_spec`) runs that tick's
    substeps with them as the actions; each `torque_fn` call is an
    `lgc.actuator` span.  On a heightfield the per-env windows
    are cut once, before the first tick, and every tick reads them, as the
    reference's XLA path does (engine.py:306-315); the link states returned
    are the last tick's.
    `fused_control_step` runs the kernel on CUDA tensors and its plain
    version on CPU tensors.
    Returns (state', StepInfo, actuator_state')."""
    from ..ops import fused_step

    one = fused_step.tick_spec(spec)
    terrain = None
    if one.hf_K:
        lp = patch.extract(hf, state.base_pos[0], state.base_pos[1], one.hf_K)
        terrain = fused_step.patch_inputs(lp)
    dr_in = (dr.friction, dr.added_mass, dr.com_offset, dr.kp_mult, dr.kd_mult)
    tlim = soa.bcast(pd.torque_limits, tuple(state.dof_pos.shape[1:]))
    st, link_forces, tau, lpos, lvel = tuple(state), None, None, None, None
    for _tick in range(spec.decimation):
        with span("lgc.actuator"):
            tau, actuator_state = torque_fn(actions, st[4], st[5], actuator_state)
        tau = torch.maximum(torch.minimum(tau, tlim), -tlim).contiguous()
        st, link_forces, tau, lpos, lvel = fused_step.fused_control_step(one, st, tau, dr_in,
                                                                         terrain)
    return PhysicsState(*st), StepInfo(link_forces, lpos, lvel, tau), actuator_state


def actuated_control_step(ma: ModelArrays, hf: Heightfield, params: SimParams, pd: PDParams,
                          dr: DomainRandParams, dof_limits: tuple, state: PhysicsState, actions,
                          actuator_state, torque_fn, spec=None):
    """The control step of a stateful actuator model (the ANYmal SEA LSTM),
    the counterpart of the reference's `control_step(..., torque_fn=...)`
    (engine.py:301-380): `torque_fn(actions, dof_pos, dof_vel, act_state) ->
    (tau, act_state')` replaces the PD law at every decimation tick.
    Returns (state', StepInfo, actuator_state').

    With a `spec`, CUDA tensors run `tickwise_control_step` through the
    kernel; otherwise the eager loop runs the step, as in `control_step`."""
    with span("lgc.physics"):
        if spec is None or not state.dof_pos.is_cuda:
            return _eager_loop(ma, hf, params, pd, dr, dof_limits, state, actions, torque_fn,
                               actuator_state)
        _check_kernel_terrain(hf, params)
        return tickwise_control_step(ma, hf, params, pd, dr, dof_limits, state, actions,
                                     actuator_state, torque_fn, spec)
