"""Heightfield terrain and its samplers, torch port of
legged_gym_custom_tpu/physics/heightfield.py.

World (x, y) maps to grid index ``(x + border_size) / horizontal_scale``
(reference legged_robot.py:1020-1021); the row axis is x / terrain length,
the column axis y / terrain width.

Two samplers over the global table:
  * ``height_min3`` - the reference's scandot sampler: floor index, min over
    {(px,py), (px+1,py), (px,py+1)} (legged_robot.py:1027-1031);
  * ``height_bilinear`` / ``surface`` - bilinear height and normal for the
    penalty contact.
The per-env windows of physics/patch.py give the same values from a (K, K)
cut of the table.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Heightfield(NamedTuple):
    data: Optional[torch.Tensor] = None   # (rows, cols) float32 heights [m]
    horizontal_scale: float = 1.0         # meters per cell
    border_offset: float = 0.0            # meters added to world xy before indexing
    is_plane: bool = True                 # static: z = 0 plane everywhere


def plane() -> Heightfield:
    return Heightfield(is_plane=True)


def from_raw(height_field_raw: np.ndarray, horizontal_scale: float, vertical_scale: float,
             border_size: float, device="cpu") -> Heightfield:
    """The int16 terrain grid scaled to meters, as a float32 table on `device`."""
    data = torch.as_tensor(height_field_raw.astype(np.float32) * vertical_scale, device=device)
    return Heightfield(data=data, horizontal_scale=float(horizontal_scale),
                       border_offset=float(border_size), is_plane=False)


def _grid_coords(hf: Heightfield, x, y):
    return (x + hf.border_offset) / hf.horizontal_scale, (y + hf.border_offset) / hf.horizontal_scale


def height_min3(hf: Heightfield, x, y):
    """Reference scandot sampling: floor index, min of 3 taps."""
    if hf.is_plane:
        return torch.zeros_like(x)
    gx, gy = _grid_coords(hf, x, y)
    R, C = hf.data.shape
    px = torch.clamp(torch.floor(gx).long(), 0, R - 2)
    py = torch.clamp(torch.floor(gy).long(), 0, C - 2)
    h1 = hf.data[px, py]
    h2 = hf.data[px + 1, py]
    h3 = hf.data[px, py + 1]
    return torch.minimum(torch.minimum(h1, h2), h3)


def _bilinear_taps(hf: Heightfield, x, y):
    gx, gy = _grid_coords(hf, x, y)
    R, C = hf.data.shape
    gx = torch.clamp(gx, 0.0, R - 1.001)
    gy = torch.clamp(gy, 0.0, C - 1.001)
    # the index clamp only acts on a NaN coordinate, where JAX clamps its
    # gather and torch would index out of range
    x0 = torch.clamp(torch.floor(gx).long(), 0, R - 2)
    y0 = torch.clamp(torch.floor(gy).long(), 0, C - 2)
    fx = gx - x0
    fy = gy - y0
    d = hf.data
    return d[x0, y0], d[x0 + 1, y0], d[x0, y0 + 1], d[x0 + 1, y0 + 1], fx, fy


def height_bilinear(hf: Heightfield, x, y):
    if hf.is_plane:
        return torch.zeros_like(x)
    h00, h10, h01, h11, fx, fy = _bilinear_taps(hf, x, y)
    return h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy) + h01 * (1 - fx) * fy + h11 * fx * fy


def surface(hf: Heightfield, x, y):
    """Bilinear height and outward unit normal at (x, y): (h, (nx, ny, nz)).

    The normal comes from the bilinear gradient; steep faces of parkour
    terrain become near-horizontal normals over one cell, which is how the
    penalty contact sees vertical walls.
    """
    if hf.is_plane:
        z = torch.zeros_like(x)
        return z, (z, z, torch.ones_like(x))
    h00, h10, h01, h11, fx, fy = _bilinear_taps(hf, x, y)
    h = h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy) + h01 * (1 - fx) * fy + h11 * fx * fy
    s = hf.horizontal_scale
    dhdx = ((h10 - h00) * (1 - fy) + (h11 - h01) * fy) / s
    dhdy = ((h01 - h00) * (1 - fx) + (h11 - h10) * fx) / s
    inv_norm = 1.0 / torch.sqrt(dhdx * dhdx + dhdy * dhdy + 1.0)
    return h, (-dhdx * inv_norm, -dhdy * inv_norm, inv_norm)
