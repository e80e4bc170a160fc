"""Parity of the PyTorch port's terrain and terrain samplers with the JAX
reference, on the CPU.

The terrain generator is numpy in both packages, so the port's copy must
give bit-equal tables and origins from the same seeded generator.  The
samplers run on a bumpy table and on a parkour gap course (2 m deep gaps
with vertical walls) at the same seeded query points, following
tests/test_patch.py:34-64.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from legged_gym_custom_tpu import physics as jphys
from legged_gym_custom_tpu.envs.go2_parkour_config import Go2ParkourCfg as JParkourCfg
from legged_gym_custom_tpu.physics import patch as jpatch
from legged_gym_custom_tpu.terrain import Terrain as JTerrain
from legged_gym_custom_tpu_torch import physics as tphys
from legged_gym_custom_tpu_torch.envs import Go2ParkourCfg
from legged_gym_custom_tpu_torch.physics import patch as tpatch
from legged_gym_custom_tpu_torch.terrain import Terrain

# float32 bilinear surface: the same taps and weights on both sides; the
# reference's einsum may fuse a multiply-add where the port rounds twice
SURF_TOL = dict(atol=1e-5, rtol=1e-5)


def _parkour_terrain_cfg(cfg_cls, curriculum: bool):
    """go2_parkour's terrain at 2 x 2 courses (the full config has 12 x 20)."""
    t = cfg_cls.terrain
    t.num_rows, t.num_cols, t.curriculum = 2, 2, curriculum
    return t


@pytest.mark.parametrize("curriculum", [True, False])
def test_terrain_copy_is_bit_equal(curriculum):
    jt = JTerrain(_parkour_terrain_cfg(JParkourCfg(), curriculum), 8, np.random.default_rng(5))
    tt = Terrain(_parkour_terrain_cfg(Go2ParkourCfg(), curriculum), 8, np.random.default_rng(5))
    assert tt.height_field_raw.dtype == np.int16
    assert tt.height_field_raw.shape == (2 * 280 + 500, 2 * 100 + 500)
    np.testing.assert_array_equal(tt.height_field_raw, jt.height_field_raw)
    np.testing.assert_array_equal(tt.env_origins, jt.env_origins)
    assert tt.height_field_raw.min() == -400   # 2 m deep gaps at 5 mm per unit


def _tables():
    rng = np.random.default_rng(0)
    bumpy = rng.integers(-40, 40, (300, 260)).astype(np.int16)
    tt = Terrain(_parkour_terrain_cfg(Go2ParkourCfg(), True), 8, np.random.default_rng(1))
    return {"bumpy": (bumpy, 2.0), "gap_course": (tt.height_field_raw, 25.0)}


TABLES = _tables()


@pytest.fixture(scope="module", params=sorted(TABLES))
def tables(request):
    raw, border = TABLES[request.param]
    return (jphys.from_raw(raw, 0.1, 0.005, border),
            tphys.from_raw(raw, 0.1, 0.005, border))


def _points(hf_j, B, G, reach, seed):
    """Centers well inside the table and queries around them; on the gap
    course a quarter of the centers sit within 0.3 m of a gap edge."""
    rng = np.random.default_rng(seed)
    R, C = hf_j.data.shape
    s, b = hf_j.horizontal_scale, hf_j.border_offset
    cx = rng.uniform(3.0 - b, (R - 1) * s - b - 3.0, B)
    cy = rng.uniform(3.0 - b, (C - 1) * s - b - 3.0, B)
    if b == 25.0:
        # row 1 holds 0.2 m gaps centred at x = 28 + 5 + 3.5 k (row 0's
        # 0.1 m gaps round to zero cells); its near edges are 0.1 m before
        edges = 33.0 + 3.5 * rng.integers(0, 7, B // 4) - 0.1 + rng.uniform(-0.3, 0.3, B // 4)
        cx[: B // 4] = edges
        cy = rng.uniform(1.0, 9.0, B)
    px = cx[:, None] + rng.uniform(-reach, reach, (B, G))
    py = cy[:, None] + rng.uniform(-reach, reach, (B, G))
    f = lambda a: np.asarray(a, np.float32)
    return f(cx), f(cy), f(px), f(py)


def _close(got, ref, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), err_msg=what, **tol)


def test_global_samplers_match_reference(tables):
    hf_j, hf_t = tables
    np.testing.assert_array_equal(hf_t.data.numpy(), np.asarray(hf_j.data))
    _, _, px, py = _points(hf_j, 64, 53, 1.0, seed=2)
    T = torch.as_tensor
    h_j, n_j = jphys.surface(hf_j, jnp.asarray(px), jnp.asarray(py))
    h_t, n_t = tphys.surface(hf_t, T(px), T(py))
    _close(h_t, h_j, SURF_TOL, "h")
    for k in range(3):
        _close(n_t[k], n_j[k], SURF_TOL, f"n{k}")
    _close(tphys.height_bilinear(hf_t, T(px), T(py)),
           jphys.height_bilinear(hf_j, jnp.asarray(px), jnp.asarray(py)), SURF_TOL, "bilinear")
    # min3 picks table entries: exact
    np.testing.assert_array_equal(tphys.height_min3(hf_t, T(px), T(py)).numpy(),
                                  np.asarray(jphys.height_min3(hf_j, jnp.asarray(px),
                                                               jnp.asarray(py))))


def test_patch_samplers_match_reference(tables):
    hf_j, hf_t = tables
    T = torch.as_tensor
    cx, cy, px, py = _points(hf_j, 64, 53, 0.9, seed=3)
    lp_j = jpatch.extract(hf_j, jnp.asarray(cx), jnp.asarray(cy), 24)
    lp_t = tpatch.extract(hf_t, T(cx), T(cy), 24)
    np.testing.assert_array_equal(lp_t.data.numpy(), np.asarray(lp_j.data))
    np.testing.assert_array_equal(lp_t.x0.numpy(), np.asarray(lp_j.x0))
    np.testing.assert_array_equal(lp_t.y0.numpy(), np.asarray(lp_j.y0))
    h_j, n_j = jpatch.surface(lp_j, jnp.asarray(px), jnp.asarray(py))
    h_t, n_t = tpatch.surface(lp_t, T(px), T(py))
    _close(h_t, h_j, SURF_TOL, "patch h")
    for k in range(3):
        _close(n_t[k], n_j[k], SURF_TOL, f"patch n{k}")
    h_cm, n_cm = tpatch.surface_cm(lp_t, T(px).T, T(py).T)
    torch.testing.assert_close(h_cm, h_t.T, rtol=0, atol=0)
    torch.testing.assert_close(n_cm[0], n_t[0].T, rtol=0, atol=0)

    # scandots: the K = 40 window and 132 points of go2_parkour
    cx, cy, px, py = _points(hf_j, 64, 132, 1.4, seed=4)
    lp_j = jpatch.extract(hf_j, jnp.asarray(cx), jnp.asarray(cy), 40)
    lp_t = tpatch.extract(hf_t, T(cx), T(cy), 40)
    np.testing.assert_array_equal(
        tpatch.height_min3(lp_t, T(px), T(py)).numpy(),
        np.asarray(jpatch.height_min3(lp_j, jnp.asarray(px), jnp.asarray(py))))


def test_patch_size_matches_reference_rounding():
    # engine.py:313 (contact window) and base_env.py:207-209 (scan window)
    assert tpatch.patch_size(1.2, 0.1) == 24
    radius = float(np.hypot(1.2, 0.75)) + 0.3
    assert tpatch.patch_size(radius, 0.1) == 40
