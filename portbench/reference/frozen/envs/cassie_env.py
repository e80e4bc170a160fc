"""Cassie biped environment, torch port of
legged_gym_custom_tpu/envs/cassie_env.py (reference
legged_gym/envs/cassie/cassie.py:42-46).

The base legged-robot machinery; the single-stance `no_fly` term lives in
envs/rewards.py.
"""
from .base_env import LeggedEnv


class CassieEnv(LeggedEnv):
    pass
