"""Global terrain composer: curriculum grid of subterrain patches + origins,
a copy of legged_gym_custom_tpu/terrain/terrain.py.

Numpy build-time port of the reference Terrain class (utils/terrain.py:8-318)
with identical generation-mode selection logic:
  curriculum (rows=difficulty x cols=choice, :88), parkour_selected (:118),
  parkour_curriculum (:103), selected (:71, via registry not eval),
  randomized (:60).

The composed int16 grid feeds (a) the physics heightfield collider
(physics/heightfield.py) — replacing the PhysX heightfield — and (b) the
scandot sampler.  The trimesh conversion exists for visualization parity only.
"""
from __future__ import annotations

import numpy as np

from . import primitives as tu
from .primitives import SubTerrain


class Terrain:
    def __init__(self, cfg, num_robots: int, rng: np.random.Generator | None = None):
        self.cfg = cfg
        self.num_robots = num_robots
        self.type = cfg.mesh_type
        self.rng = rng or np.random.default_rng(0)
        if self.type in ["none", "plane"]:
            return

        self.env_length = cfg.terrain_length
        self.env_width = cfg.terrain_width
        self.proportions = [
            np.sum(cfg.terrain_proportions[: i + 1])
            for i in range(len(cfg.terrain_proportions))
        ]
        self.num_sub_terrains = cfg.num_rows * cfg.num_cols
        self.env_origins = np.zeros((cfg.num_rows, cfg.num_cols, 3))

        self.width_per_env_pixels = int(self.env_width / cfg.horizontal_scale)
        self.length_per_env_pixels = int(self.env_length / cfg.horizontal_scale)
        self.border = int(cfg.border_size / cfg.horizontal_scale)
        self.tot_cols = int(cfg.num_cols * self.width_per_env_pixels) + 2 * self.border
        self.tot_rows = int(cfg.num_rows * self.length_per_env_pixels) + 2 * self.border
        self.height_field_raw = np.zeros((self.tot_rows, self.tot_cols), dtype=np.int16)

        parkour = getattr(cfg, "parkour", False)
        if cfg.curriculum and not parkour:
            self.curriculum()
        elif parkour and not cfg.curriculum:
            self.parkour_selected_terrain()
        elif parkour and cfg.curriculum:
            self.parkour_curriculum()
        elif getattr(cfg, "selected", False):
            self.selected_terrain()
        else:
            self.randomized_terrain()

        self.heightsamples = self.height_field_raw

    def make_trimesh(self):
        return tu.convert_heightfield_to_trimesh(
            self.height_field_raw,
            self.cfg.horizontal_scale,
            self.cfg.vertical_scale,
            self.cfg.slope_treshold,
        )

    # ------------------------------------------------------------------
    def _new_subterrain(self):
        return SubTerrain(
            "terrain",
            width=self.width_per_env_pixels,
            length=self.length_per_env_pixels,
            vertical_scale=self.cfg.vertical_scale,
            horizontal_scale=self.cfg.horizontal_scale,
        )

    def randomized_terrain(self):
        for k in range(self.num_sub_terrains):
            i, j = np.unravel_index(k, (self.cfg.num_rows, self.cfg.num_cols))
            choice = self.rng.uniform(0, 1)
            difficulty = self.rng.choice([0.5, 0.75, 0.9])
            self.add_terrain_to_map(self.make_terrain(choice, difficulty), i, j)

    def selected_terrain(self):
        kwargs = dict(self.cfg.terrain_kwargs)
        terrain_type = kwargs.pop("type")
        fn = tu.TERRAIN_REGISTRY[terrain_type]
        for k in range(self.num_sub_terrains):
            i, j = np.unravel_index(k, (self.cfg.num_rows, self.cfg.num_cols))
            terrain = self._new_subterrain()
            try:
                fn(terrain, rng=self.rng, **kwargs)
            except TypeError:
                fn(terrain, **kwargs)
            self.add_terrain_to_map(terrain, i, j)

    def curriculum(self):
        for j in range(self.cfg.num_cols):
            for i in range(self.cfg.num_rows):
                difficulty = i / self.cfg.num_rows
                choice = j / self.cfg.num_cols + 0.001
                self.add_terrain_to_map(self.make_terrain(choice, difficulty), i, j)

    def parkour_curriculum(self):
        # Optional fine-grained difficulty ladder: cfg.parkour_row_widths
        # maps row -> gap width directly (the round-5 cliff curriculum needs
        # sub-0.05 m steps around the 0.15→0.2 m commitment cliff); default
        # is the reference's coarse (i+1)/10 (reference terrain.py:103).
        widths = getattr(self.cfg, "parkour_row_widths", None)
        for j in range(self.cfg.num_cols):
            for i in range(self.cfg.num_rows):
                difficulty = widths[i] if widths else (i + 1) / 10
                choice = j / self.cfg.num_cols + 0.001
                terrain = self.make_parkour_terrain(choice, difficulty)
                self.add_parkour_terrain_to_map(terrain, i, j)

    def parkour_selected_terrain(self):
        for k in range(self.num_sub_terrains):
            i, j = np.unravel_index(k, (self.cfg.num_rows, self.cfg.num_cols))
            terrain = self._new_subterrain()
            tu.parkour_terrain(terrain, **self.cfg.parkour_kwargs)
            self.add_parkour_terrain_to_map(terrain, i, j)

    # ------------------------------------------------------------------
    def make_terrain(self, choice, difficulty):
        """Difficulty-parameterized terrain menu (reference terrain.py:135-191)."""
        terrain = self._new_subterrain()
        slope = difficulty * 0.5
        step_height = 0.05 + 0.115 * difficulty
        discrete_obstacles_height = 0.05 + difficulty * 0.15
        stepping_stones_size = 1.5 * (1.05 - difficulty)
        stone_distance = 0.05 if difficulty == 0 else 0.1
        gap_size = 1.0 * difficulty

        if choice < self.proportions[0]:
            if choice < self.proportions[0] / 2:
                slope *= -1
            tu.pyramid_sloped_terrain(terrain, slope=slope, platform_size=3.0)
        elif choice < self.proportions[1]:
            tu.pyramid_sloped_terrain(terrain, slope=slope, platform_size=3.0)
            tu.random_uniform_terrain(
                terrain, min_height=-0.06, max_height=0.06, step=0.005,
                downsampled_scale=0.2, rng=self.rng,
            )
        elif choice < self.proportions[3]:
            if choice < self.proportions[2]:
                step_height *= -1
            tu.pyramid_stairs_terrain(terrain, step_width=0.25, step_height=step_height, platform_size=2.0)
        elif choice < self.proportions[4]:
            tu.discrete_obstacles_terrain(
                terrain, discrete_obstacles_height, 1.0, 2.0, 20, platform_size=3.0, rng=self.rng
            )
        elif choice < self.proportions[5]:
            tu.stepping_stones_terrain(
                terrain, stone_size=stepping_stones_size, stone_distance=stone_distance,
                max_height=0.0, platform_size=4.0, rng=self.rng,
            )
        elif len(self.proportions) > 6 and choice < self.proportions[6]:
            tu.random_uniform_terrain(
                terrain, min_height=-0.06, max_height=0.06, step=0.005,
                downsampled_scale=0.2, rng=self.rng,
            )
        else:
            tu.gap_terrain(terrain, gap_size=gap_size, platform_size=3.0)
        return terrain

    def make_parkour_terrain(self, choice, difficulty):
        """Gap vs hurdle course by proportion (reference terrain.py:194-245)."""
        gap_x_start, gap_dx, num_gaps = 5.0, 3.5, 7
        hurdle_x_start, hurdle_dx, num_hurdles = 4.0, 1.99, 14
        terrain = self._new_subterrain()
        if choice < self.proportions[0]:
            tu.parkour_terrain(
                terrain,
                start_platform_length=3.0,
                start_platform_height=0.0,
                x_positions=list(np.arange(gap_x_start, gap_x_start + num_gaps * gap_dx, gap_dx)),
                y_positions=[0.0] * num_gaps,
                obstacle_heights=[-2.0] * num_gaps,
                obstacle_lengths=[difficulty] * num_gaps,
                half_valid_width=5.0,
                border_width=0.50,
                border_height=-2.0,
            )
        else:
            tu.parkour_terrain(
                terrain,
                start_platform_length=3.0,
                start_platform_height=0.0,
                x_positions=list(np.arange(hurdle_x_start, hurdle_x_start + num_hurdles * hurdle_dx, hurdle_dx)),
                y_positions=[0.0] * num_hurdles,
                obstacle_heights=[0.05 + 0.44 * difficulty] * num_hurdles,
                obstacle_lengths=[0.35] * num_hurdles,
                half_valid_width=5.0,
                border_width=0.50,
                border_height=-2.0,
            )
        return terrain

    # ------------------------------------------------------------------
    def _patch(self, terrain, i, j):
        if getattr(self.cfg, "add_roughness_to_selected_terrain", False):
            tu.random_uniform_terrain(
                terrain, min_height=-0.04, max_height=0.04, step=0.005,
                downsampled_scale=0.2, rng=self.rng,
            )
        sx = self.border + i * self.length_per_env_pixels
        sy = self.border + j * self.width_per_env_pixels
        self.height_field_raw[
            sx:sx + self.length_per_env_pixels, sy:sy + self.width_per_env_pixels
        ] = terrain.height_field_raw

    def _safe_z(self, terrain):
        x1 = int((self.env_length / 2.0 - 1) / terrain.horizontal_scale)
        x2 = int((self.env_length / 2.0 + 1) / terrain.horizontal_scale)
        y1 = int((self.env_width / 2.0 - 1) / terrain.horizontal_scale)
        y2 = int((self.env_width / 2.0 + 1) / terrain.horizontal_scale)
        return np.max(terrain.height_field_raw[x1:x2, y1:y2]) * terrain.vertical_scale

    def add_terrain_to_map(self, terrain, row, col):
        self._patch(terrain, row, col)
        env_origin_x = (row + 0.5) * self.env_length
        env_origin_y = (col + 0.5) * self.env_width
        self.env_origins[row, col] = [env_origin_x, env_origin_y, self._safe_z(terrain)]

    def add_parkour_terrain_to_map(self, terrain, row, col):
        """Parkour origins sit at x_min of the course (reference terrain.py:281-318)."""
        self._patch(terrain, row, col)
        env_origin_x = row * self.env_length
        env_origin_y = (col + 0.5) * self.env_width
        self.env_origins[row, col] = [env_origin_x, env_origin_y, 0.0]
