"""Penalty contact of the collision spheres against the terrain, torch port
of legged_gym_custom_tpu/physics/contact.py.

Compliant spring-damper normal force plus regularized Coulomb friction,
branchless.  Friction combines the per-env shape friction with the terrain
friction by PhysX's default average mode.  The terrain is the z = 0 plane,
a global heightfield table or per-env windows of one (physics/patch.py).
Layout: per-geom arrays are (ng, 3)+bs with the env batch trailing
(physics/soa.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import heightfield as hfield
from . import patch
from .algorithms import ModelArrays


class ContactParams(NamedTuple):
    stiffness: float = 6000.0    # [N/m] normal penetration spring
    damping: float = 100.0       # [N s/m] normal velocity damping
    friction_vel: float = 80.0   # [N s/m] tangential viscous slope (pre-saturation)
    terrain_friction: float = 1.0  # combined (averaged) with per-env friction


class ContactOutput(NamedTuple):
    geom_force: torch.Tensor    # (ng, 3)+bs world-frame force on each sphere
    body_wrench: torch.Tensor   # (nb, 6)+bs [n; f] world axes about body origins
    link_force: torch.Tensor    # (n_links, 3)+bs net world force per report link


def _geom_frames(ma: ModelArrays, E0: list, p_wg):
    """(R_wb of each geom's body, geom offsets, arm = R_wb @ gpos) per geom;
    p_wg is the world origin of each geom's body, (ng, 3)+bs."""
    bs = tuple(p_wg.shape[2:])
    Rg = torch.stack([E.transpose(0, 1) for E in E0])[ma.geom_body]   # (ng,3,3)+bs
    gpos = ma.geom_pos.reshape(tuple(ma.geom_pos.shape) + (1,) * len(bs))
    gpos = gpos * torch.ones_like(p_wg)
    return Rg, gpos, torch.einsum("gij...,gj...->gi...", Rg, gpos)


def geom_centers(ma: ModelArrays, E0: list, p0w: list) -> torch.Tensor:
    """World positions of all collision-sphere centers, (ng, 3)+bs."""
    p_wg = torch.stack(p0w)[ma.geom_body]
    return p_wg + _geom_frames(ma, E0, p_wg)[2]


def sample_surface(ma: ModelArrays, hf, centers):
    """Terrain surface (h, (nx, ny, nz)) under each collision sphere.

    The engine freezes it once per decimation tick (the reference plant's
    PhysX collides per 200 Hz sim step, legged_robot.py:79-85)."""
    if isinstance(hf, patch.LocalPatch):
        return patch.surface_cm(hf, centers[:, 0], centers[:, 1])
    return hfield.surface(hf, centers[:, 0], centers[:, 1])


def compute_contacts(ma: ModelArrays, hf, params: ContactParams, friction,
                     E0: list, p0w: list, v_body: list, surface=None) -> ContactOutput:
    """Contact forces.  hf: a Heightfield (plane or global table) or a
    patch.LocalPatch; friction ()+bs; E0 per-body R_{body<-world} (3,3)+bs;
    p0w per-body world origins (3,)+bs; v_body per-body spatial velocity in
    body coords (6,)+bs; surface: an optional precomputed (h, (nx, ny, nz))
    per geom, (ng,)+bs each."""
    bs = tuple(p0w[0].shape[1:])
    dtype, device = p0w[0].dtype, p0w[0].device
    gb = ma.geom_body
    w_b = torch.stack([v[0:3] for v in v_body])[gb]          # (ng,3)+bs
    u_b = torch.stack([v[3:6] for v in v_body])[gb]
    p_wg = torch.stack(p0w)[gb]
    Rg, gpos, arm = _geom_frames(ma, E0, p_wg)
    centers = p_wg + arm
    vel_b = u_b + torch.cross(w_b, gpos, dim=1)
    vel_w = torch.einsum("gij...,gj...->gi...", Rg, vel_b)   # (ng,3)+bs
    radius = ma.geom_radius.reshape(tuple(ma.geom_radius.shape) + (1,) * len(bs))
    mu = 0.5 * (friction + params.terrain_friction)

    if surface is None and not isinstance(hf, patch.LocalPatch) and hf.is_plane:
        depth = radius - centers[:, 2]
        vn = vel_w[:, 2]
        vt = vel_w[:, 0:2]
        vt_norm = torch.sqrt(torch.sum(vt * vt, dim=1))
        fn = torch.clamp(params.stiffness * depth - params.damping * vn, min=0.0)
        fn = torch.where(depth > 0.0, fn, torch.zeros_like(fn))
        ft_mag = torch.minimum(params.friction_vel * vt_norm, mu * fn)
        inv_vt = ft_mag / (vt_norm + 1e-6)
        force = torch.stack([-vt[:, 0] * inv_vt, -vt[:, 1] * inv_vt, fn], dim=1)
    else:
        if surface is None:
            surface = sample_surface(ma, hf, centers)
        h, (nx, ny, nz) = surface
        depth = radius - nz * (centers[:, 2] - h)
        vn = vel_w[:, 0] * nx + vel_w[:, 1] * ny + vel_w[:, 2] * nz
        n_vec = torch.stack([nx, ny, nz], dim=1)                 # (ng,3)+bs
        vt = vel_w - vn[:, None] * n_vec
        vt_norm = torch.sqrt(torch.sum(vt * vt, dim=1))
        fn = torch.clamp(params.stiffness * depth - params.damping * vn, min=0.0)
        fn = torch.where(depth > 0.0, fn, torch.zeros_like(fn))
        ft_mag = torch.minimum(params.friction_vel * vt_norm, mu * fn)
        t_dir = vt / (vt_norm[:, None] + 1e-6)
        force = fn[:, None] * n_vec - ft_mag[:, None] * t_dir  # (ng,3)+bs world

    torque = torch.cross(arm, force, dim=1)
    wrench = torch.cat([torque, force], dim=1)                # (ng,6)+bs
    body_wrench = torch.zeros((ma.nb, 6) + bs, dtype=dtype, device=device)
    body_wrench = body_wrench.index_add(0, gb, wrench)
    link_force = torch.zeros((ma.n_links, 3) + bs, dtype=dtype, device=device)
    link_force = link_force.index_add(0, ma.geom_link, force)
    return ContactOutput(force, body_wrench, link_force)
