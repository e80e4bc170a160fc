"""Heightfield primitive generators (numpy, build-time), a copy of
legged_gym_custom_tpu/terrain/primitives.py.

Re-implementations with the same parameterization and int16 grid semantics as
the reference's terrain_utils.py generators (random_uniform :9, sloped :54,
pyramid_sloped :72, discrete_obstacles :95, wave :121, stairs :136,
pyramid_stairs :151, stepping_stones :168, parkour :318, gap/pit
terrain.py:322-343).  All functions mutate `SubTerrain.height_field_raw`
(int16, rows = length/x, cols = width/y) and take arguments in meters.

Randomness is explicit: functions that draw randomness take a
`numpy.random.Generator` instead of global state (JAX-style key discipline at
the numpy layer).
"""
from __future__ import annotations

import numpy as np
from scipy.interpolate import RegularGridInterpolator


class SubTerrain:
    """Single terrain patch (reference terrain_utils.py:468-477)."""

    def __init__(self, name="terrain", width=256, length=256,
                 vertical_scale=1.0, horizontal_scale=1.0):
        self.terrain_name = name
        self.vertical_scale = vertical_scale
        self.horizontal_scale = horizontal_scale
        self.width = width     # cols / y
        self.length = length   # rows / x
        self.height_field_raw = np.zeros((length, width), dtype=np.int16)


def random_uniform_terrain(terrain, min_height, max_height, step=1,
                           downsampled_scale=None, rng=None):
    rng = rng or np.random.default_rng()
    if downsampled_scale is None:
        downsampled_scale = terrain.horizontal_scale
    min_h = int(min_height / terrain.vertical_scale)
    max_h = int(max_height / terrain.vertical_scale)
    step_i = max(1, int(step / terrain.vertical_scale))
    heights_range = np.arange(min_h, max_h + step_i, step_i)

    down_rows = max(2, int(terrain.length * terrain.horizontal_scale / downsampled_scale))
    down_cols = max(2, int(terrain.width * terrain.horizontal_scale / downsampled_scale))
    coarse = rng.choice(heights_range, (down_rows, down_cols))

    y = np.linspace(0, 1, down_rows)
    x = np.linspace(0, 1, down_cols)
    interp = RegularGridInterpolator((y, x), coarse.astype(np.float64), method="linear")
    uy = np.linspace(0, 1, terrain.length)
    ux = np.linspace(0, 1, terrain.width)
    gy, gx = np.meshgrid(uy, ux, indexing="ij")
    z = np.rint(interp(np.stack([gy.ravel(), gx.ravel()], -1)).reshape(terrain.length, terrain.width))
    terrain.height_field_raw += z.astype(np.int16)
    return terrain


def sloped_terrain(terrain, slope=1):
    length, width = terrain.height_field_raw.shape
    max_h = int(slope * (terrain.horizontal_scale / terrain.vertical_scale) * width)
    grad = (np.arange(width) / (width - 1)) * max_h
    terrain.height_field_raw += grad.astype(np.int16)[None, :]
    return terrain


def pyramid_sloped_terrain(terrain, slope=1, platform_size=1.0):
    length, width = terrain.height_field_raw.shape
    ctr_x = width // 2
    ctr_y = length // 2
    x = (ctr_x - np.abs(np.arange(width) - ctr_x)) / ctr_x
    y = (ctr_y - np.abs(np.arange(length) - ctr_y)) / ctr_y
    yy, xx = np.meshgrid(y, x, indexing="ij")
    max_h = int(slope * (terrain.horizontal_scale / terrain.vertical_scale) * (width / 2))
    terrain.height_field_raw += (max_h * xx * yy).astype(np.int16)
    half = int(platform_size / terrain.horizontal_scale / 2)
    x1, x2 = ctr_x - half, ctr_x + half
    y1, y2 = ctr_y - half, ctr_y + half
    min_h = min(terrain.height_field_raw[y1, x1], 0)
    max_h2 = max(terrain.height_field_raw[y1, x1], 0)
    terrain.height_field_raw = np.clip(terrain.height_field_raw, min_h, max_h2)
    return terrain


def discrete_obstacles_terrain(terrain, max_height, min_size, max_size,
                               num_rects, platform_size=1.0, rng=None):
    rng = rng or np.random.default_rng()
    h_max = int(max_height / terrain.vertical_scale)
    min_s = int(min_size / terrain.horizontal_scale)
    max_s = int(max_size / terrain.horizontal_scale)
    plat = int(platform_size / terrain.horizontal_scale)
    length, width = terrain.height_field_raw.shape
    choices = [-h_max, -h_max // 2, h_max // 2, h_max]
    for _ in range(num_rects):
        w = rng.choice(range(min_s, max_s, 4))
        l = rng.choice(range(min_s, max_s, 4))
        row0 = rng.choice(range(0, length - l, 4))
        col0 = rng.choice(range(0, width - w, 4))
        terrain.height_field_raw[row0:row0 + l, col0:col0 + w] = rng.choice(choices)
    cx1, cx2 = (width - plat) // 2, (width + plat) // 2
    cy1, cy2 = (length - plat) // 2, (length + plat) // 2
    terrain.height_field_raw[cy1:cy2, cx1:cx2] = 0
    return terrain


def wave_terrain(terrain, num_waves=1, amplitude=1.0):
    amp = int(0.5 * amplitude / terrain.vertical_scale)
    if num_waves <= 0:
        return terrain
    length, width = terrain.height_field_raw.shape
    div_y = length / (num_waves * 2 * np.pi)
    div_x = width / (num_waves * 2 * np.pi)
    yy, xx = np.meshgrid(np.arange(length), np.arange(width), indexing="ij")
    surf = amp * (np.cos(yy / div_y) + np.sin(xx / div_x))
    terrain.height_field_raw += surf.astype(np.int16)
    return terrain


def stairs_terrain(terrain, step_width, step_height):
    step_w = int(step_width / terrain.horizontal_scale)
    step_h = int(step_height / terrain.vertical_scale)
    length, _ = terrain.height_field_raw.shape
    num_steps = length // step_w
    height = step_h
    for s in range(num_steps):
        terrain.height_field_raw[s * step_w:(s + 1) * step_w, :] += height
        height += step_h
    return terrain


def pyramid_stairs_terrain(terrain, step_width, step_height, platform_size=1.0):
    step_w = int(step_width / terrain.horizontal_scale)
    step_h = int(step_height / terrain.vertical_scale)
    plat = int(platform_size / terrain.horizontal_scale)
    length, width = terrain.height_field_raw.shape
    top = 0
    r0, r1, c0, c1 = 0, length, 0, width
    while (r1 - r0) > plat and (c1 - c0) > plat:
        r0 += step_w
        r1 -= step_w
        c0 += step_w
        c1 -= step_w
        top += step_h
        terrain.height_field_raw[r0:r1, c0:c1] = top
    return terrain


def stepping_stones_terrain(terrain, stone_size, stone_distance, max_height,
                            platform_size=1.0, depth=-10, rng=None):
    rng = rng or np.random.default_rng()
    stone_sz = int(stone_size / terrain.horizontal_scale)
    stone_gap = int(stone_distance / terrain.horizontal_scale)
    h_max = int(max_height / terrain.vertical_scale)
    plat = int(platform_size / terrain.horizontal_scale)
    pit_depth = int(depth / terrain.vertical_scale)
    length, width = terrain.height_field_raw.shape
    terrain.height_field_raw[:] = pit_depth
    choices = np.arange(-h_max - 1, h_max, 1)
    row = 0
    while row < length:
        row_end = min(length, row + stone_sz)
        col = rng.integers(0, stone_sz)
        gap_end = max(0, col - stone_gap)
        terrain.height_field_raw[row:row_end, 0:gap_end] = rng.choice(choices)
        while col < width:
            col_end = min(width, col + stone_sz)
            terrain.height_field_raw[row:row_end, col:col_end] = rng.choice(choices)
            col += stone_sz + stone_gap
        row += stone_sz + stone_gap
    cx1, cx2 = (width - plat) // 2, (width + plat) // 2
    cy1, cy2 = (length - plat) // 2, (length + plat) // 2
    terrain.height_field_raw[cy1:cy2, cx1:cx2] = 0
    return terrain


def gap_terrain(terrain, gap_size, platform_size=1.0):
    gap = int(gap_size / terrain.horizontal_scale)
    plat = int(platform_size / terrain.horizontal_scale)
    center_x = terrain.length // 2
    center_y = terrain.width // 2
    x1 = (terrain.length - plat) // 2
    x2 = x1 + gap
    y1 = (terrain.width - plat) // 2
    y2 = y1 + gap
    terrain.height_field_raw[center_x - x2:center_x + x2, center_y - y2:center_y + y2] = -1000
    terrain.height_field_raw[center_x - x1:center_x + x1, center_y - y1:center_y + y1] = 0
    return terrain


def pit_terrain(terrain, depth, platform_size=1.0):
    d = int(depth / terrain.vertical_scale)
    plat = int(platform_size / terrain.horizontal_scale / 2)
    x1, x2 = terrain.length // 2 - plat, terrain.length // 2 + plat
    y1, y2 = terrain.width // 2 - plat, terrain.width // 2 + plat
    terrain.height_field_raw[x1:x2, y1:y2] = -d
    return terrain


def parkour_terrain(terrain, start_platform_length=2.5, start_platform_height=0.5,
                    x_positions=(7.0, 11.0, 14.5), y_positions=(0.0, 0.0, 0.0),
                    obstacle_lengths=(0.5, 0.5, 0.5), obstacle_heights=None,
                    half_valid_width=2.5, border_width=0.1, border_height=0.5):
    """Hurdle/gap course at exact positions (reference terrain_utils.py:318-399).

    Negative obstacle_heights carve gaps (the parkour gap course); positive
    heights raise hurdles.  Side walls of border_height flank the course.
    """
    num = len(x_positions)
    assert len(y_positions) == num and len(obstacle_lengths) == num
    assert obstacle_heights is not None and len(obstacle_heights) == num
    terrain.hurdle_positions = []
    mid_y = terrain.width // 2
    h_scale = terrain.horizontal_scale
    v_scale = terrain.vertical_scale

    platform_cells = round(start_platform_length / h_scale)
    platform_h = round(start_platform_height / v_scale)
    terrain.height_field_raw[:platform_cells, :] = platform_h
    half_gap = round(half_valid_width / h_scale)

    for i in range(num):
        current_x = round(x_positions[i] / h_scale)
        current_y = mid_y + round(y_positions[i] / h_scale)
        hurdle_h = round(obstacle_heights[i] / v_scale)
        stone_cells = round(obstacle_lengths[i] / h_scale)
        x_start = current_x - stone_cells // 2
        x_end = current_x + stone_cells // 2
        terrain.height_field_raw[x_start:x_end, :] = hurdle_h
        terrain.height_field_raw[x_start:x_end, :current_y - half_gap] = 0
        terrain.height_field_raw[x_start:x_end, current_y + half_gap:] = 0
        terrain.hurdle_positions.append((x_positions[i], y_positions[i]))

    pad_cells = int(border_width / h_scale)
    pad_h = int(border_height / v_scale)
    hf = terrain.height_field_raw
    hf[:, :pad_cells] = pad_h
    hf[:, -pad_cells:] = pad_h
    return terrain


def convert_heightfield_to_trimesh(height_field_raw, horizontal_scale,
                                   vertical_scale, slope_threshold=None):
    """Heightfield -> (vertices, triangles) with vertical-surface correction.

    Only needed for visualization parity; collision uses the heightfield
    directly (reference terrain_utils.py:401-465 semantics).
    """
    hf = height_field_raw
    num_rows, num_cols = hf.shape
    y = np.linspace(0, (num_cols - 1) * horizontal_scale, num_cols)
    x = np.linspace(0, (num_rows - 1) * horizontal_scale, num_rows)
    yy, xx = np.meshgrid(y, x)
    if slope_threshold is not None:
        slope_threshold *= horizontal_scale / vertical_scale
        move_x = np.zeros((num_rows, num_cols))
        move_y = np.zeros((num_rows, num_cols))
        move_corners = np.zeros((num_rows, num_cols))
        move_x[:-1, :] += hf[1:, :] - hf[:-1, :] > slope_threshold
        move_x[1:, :] -= hf[:-1, :] - hf[1:, :] > slope_threshold
        move_y[:, :-1] += hf[:, 1:] - hf[:, :-1] > slope_threshold
        move_y[:, 1:] -= hf[:, :-1] - hf[:, 1:] > slope_threshold
        move_corners[:-1, :-1] += hf[1:, 1:] - hf[:-1, :-1] > slope_threshold
        move_corners[1:, 1:] -= hf[:-1, :-1] - hf[1:, 1:] > slope_threshold
        xx += (move_x + move_corners * (move_x == 0)) * horizontal_scale
        yy += (move_y + move_corners * (move_y == 0)) * horizontal_scale
    vertices = np.zeros((num_rows * num_cols, 3), dtype=np.float32)
    vertices[:, 0] = xx.flatten()
    vertices[:, 1] = yy.flatten()
    vertices[:, 2] = hf.flatten() * vertical_scale
    triangles = -np.ones((2 * (num_rows - 1) * (num_cols - 1), 3), dtype=np.uint32)
    for i in range(num_rows - 1):
        ind0 = np.arange(0, num_cols - 1) + i * num_cols
        ind1 = ind0 + 1
        ind2 = ind0 + num_cols
        ind3 = ind2 + 1
        start = 2 * i * (num_cols - 1)
        stop = start + 2 * (num_cols - 1)
        triangles[start:stop:2, 0] = ind0
        triangles[start:stop:2, 1] = ind3
        triangles[start:stop:2, 2] = ind1
        triangles[start + 1:stop:2, 0] = ind0
        triangles[start + 1:stop:2, 1] = ind2
        triangles[start + 1:stop:2, 2] = ind3
    return vertices, triangles


# Registry replacing the reference's `eval()`-based selected-terrain dispatch
# (terrain.py:84) — names keep the reference's "terrain_utils.*" spelling so
# configs carry over unchanged.
TERRAIN_REGISTRY = {
    "terrain_utils.random_uniform_terrain": random_uniform_terrain,
    "terrain_utils.sloped_terrain": sloped_terrain,
    "terrain_utils.pyramid_sloped_terrain": pyramid_sloped_terrain,
    "terrain_utils.discrete_obstacles_terrain": discrete_obstacles_terrain,
    "terrain_utils.wave_terrain": wave_terrain,
    "terrain_utils.stairs_terrain": stairs_terrain,
    "terrain_utils.pyramid_stairs_terrain": pyramid_stairs_terrain,
    "terrain_utils.stepping_stones_terrain": stepping_stones_terrain,
    "terrain_utils.parkour_terrain": parkour_terrain,
    "terrain_utils.gap_terrain": gap_terrain,
    "terrain_utils.pit_terrain": pit_terrain,
}
