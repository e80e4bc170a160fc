"""Per-env local heightfield windows, torch port of
legged_gym_custom_tpu/physics/patch.py.

Once per control step a (K, K) window of the global height table is cut
around each base position (`extract`); every later sample - contact heights
and normals in all decimation x substeps, and the scandots - reads that
window.  The TPU version turns each sample into one-hot weight rows and a
matmul, because a TPU has no lane-parallel gather; here the samples are
direct index reads of the window, which give the same values.

Semantics match physics/heightfield.py (reference grid mapping,
legged_robot.py:1020-1031).  A window covers +/- K/2 cells around the base
position at extraction time; queries outside it clamp to its edge, as the
global samplers clamp to the table's border.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .heightfield import Heightfield


class LocalPatch(NamedTuple):
    data: torch.Tensor         # (B, K, K) float32 local heights, batch leading
    x0: torch.Tensor           # (B,) int64 global row index of data[:, 0, 0]
    y0: torch.Tensor           # (B,) int64 global column index
    horizontal_scale: float
    border_offset: float


def patch_size(halfwidth: float, horizontal_scale: float) -> int:
    """Window side in cells for a half-width in meters, rounded up to a
    multiple of 8 (reference engine.py:313, base_env.py:207-209)."""
    k = int(round(2 * halfwidth / horizontal_scale))
    return -(-k // 8) * 8


def extract(hf: Heightfield, cx, cy, K: int) -> LocalPatch:
    """Cut (K, K) windows centered at world (cx, cy), one per env; the
    window is clamped inside the table, like the global samplers."""
    cx = cx.reshape(-1)
    cy = cy.reshape(-1)
    R, C = hf.data.shape
    gx = (cx + hf.border_offset) / hf.horizontal_scale
    gy = (cy + hf.border_offset) / hf.horizontal_scale
    x0 = torch.clamp(torch.floor(gx).long() - K // 2, 0, R - K)
    y0 = torch.clamp(torch.floor(gy).long() - K // 2, 0, C - K)
    k = torch.arange(K, device=hf.data.device)
    rows = (x0[:, None] + k)[:, :, None]
    cols = (y0[:, None] + k)[:, None, :]
    return LocalPatch(hf.data[rows, cols], x0, y0, hf.horizontal_scale, hf.border_offset)


def _local_coords(lp: LocalPatch, x, y):
    """World (x, y) of shape (B, G) -> fractional patch-grid coordinates."""
    gx = (x + lp.border_offset) / lp.horizontal_scale - lp.x0[:, None]
    gy = (y + lp.border_offset) / lp.horizontal_scale - lp.y0[:, None]
    return gx, gy


def _read(lp: LocalPatch, i, j):
    """data[b, i[b, g], j[b, g]] for (B, G) index tensors."""
    K = lp.data.shape[-1]
    return torch.gather(lp.data.reshape(lp.data.shape[0], K * K), 1, i * K + j)


def _floor_frac(g, K: int):
    """Clamp to the patch interior (reference patch.py:77), floor and
    fraction.  The index clamp acts only on a NaN coordinate."""
    g = torch.clamp(g, 0.0, K - 1.001)
    i0 = torch.clamp(torch.floor(g).long(), 0, K - 2)
    return i0, g - i0


def surface(lp: LocalPatch, x, y):
    """Bilinear height + outward unit normal, batch-leading (B, G) in/out,
    term for term as the reference's interpolation-weight contraction:
        h    = sum_kl Wx_k Wy_l P_kl
        dhdx = sum_kl dWx_k Wy_l P_kl / s
        dhdy = sum_kl Wx_k dWy_l P_kl / s
    with the two nonzero taps of each weight row read directly."""
    K = lp.data.shape[-1]
    gx, gy = _local_coords(lp, x, y)
    i0, fx = _floor_frac(gx, K)
    j0, fy = _floor_frac(gy, K)
    p00, p10 = _read(lp, i0, j0), _read(lp, i0 + 1, j0)
    p01, p11 = _read(lp, i0, j0 + 1), _read(lp, i0 + 1, j0 + 1)
    t0 = (1.0 - fx) * p00 + fx * p10          # sum_k Wx_k P_k,j0
    t1 = (1.0 - fx) * p01 + fx * p11          # sum_k Wx_k P_k,j0+1
    h = t0 * (1.0 - fy) + t1 * fy
    s = lp.horizontal_scale
    dhdx = ((p10 - p00) * (1.0 - fy) + (p11 - p01) * fy) / s
    dhdy = (t1 - t0) / s
    inv_norm = 1.0 / torch.sqrt(dhdx * dhdx + dhdy * dhdy + 1.0)
    return h, (-dhdx * inv_norm, -dhdy * inv_norm, inv_norm)


def surface_cm(lp: LocalPatch, x, y):
    """Component-major wrapper: x/y (G, B) -> (G, B) outputs, the layout
    physics/contact.py works in."""
    h, (nx, ny, nz) = surface(lp, x.T, y.T)
    return h.T, (nx.T, ny.T, nz.T)


def height_min3(lp: LocalPatch, x, y):
    """Reference scandot sampler (legged_robot.py:1027-1031) from the
    patch: floor index, min over {(px,py), (px+1,py), (px,py+1)}.
    Batch-leading (B, P) in/out."""
    K = lp.data.shape[-1]
    gx, gy = _local_coords(lp, x, y)
    px = torch.clamp(torch.floor(gx).long(), 0, K - 2)
    py = torch.clamp(torch.floor(gy).long(), 0, K - 2)
    h1 = _read(lp, px, py)
    h2 = _read(lp, px + 1, py)
    h3 = _read(lp, px, py + 1)
    return torch.minimum(torch.minimum(h1, h2), h3)
