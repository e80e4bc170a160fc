"""Terrain generation (build-time numpy), a copy of
legged_gym_custom_tpu/terrain/__init__.py (reference utils/terrain*.py)."""
from .primitives import (
    SubTerrain,
    TERRAIN_REGISTRY,
    convert_heightfield_to_trimesh,
    gap_terrain,
    parkour_terrain,
    pit_terrain,
    pyramid_sloped_terrain,
    pyramid_stairs_terrain,
    random_uniform_terrain,
    sloped_terrain,
    stairs_terrain,
    stepping_stones_terrain,
    discrete_obstacles_terrain,
    wave_terrain,
)
from .terrain import Terrain
