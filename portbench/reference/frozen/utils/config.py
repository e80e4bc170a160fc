"""Nested-class config DSL (copy of legged_gym_custom_tpu/utils/config.py).

Configs are code: plain nested classes, inheritance-by-override, recursively
instantiated so instances can be mutated per-run.  Same developer-facing
semantics as the reference so its configs carry over nearly unchanged.
"""
from __future__ import annotations

import copy
import random
from typing import Any, Dict

import numpy as np


class BaseConfig:
    def __init__(self) -> None:
        self.init_member_classes(self)

    @staticmethod
    def init_member_classes(obj) -> None:
        for key in dir(obj):
            if key.startswith("__"):
                continue
            var = getattr(obj, key)
            if isinstance(var, type):
                i_var = var()
                setattr(obj, key, i_var)
                BaseConfig.init_member_classes(i_var)
            elif isinstance(var, (dict, list)):
                # copy mutable defaults onto the instance: in-place mutation
                # of e.g. cfg.terrain.parkour_kwargs must not leak into the
                # CLASS attribute and poison every later get_cfgs() call
                # (a latent footgun inherited from the reference DSL,
                # base_config.py:38-55)
                setattr(obj, key, copy.deepcopy(var))


def class_to_dict(obj) -> Dict[str, Any]:
    """A config instance (or class) as nested dicts of its public attributes,
    methods left out (copy of the JAX package's utils/config.py:39-59)."""
    if not hasattr(obj, "__dict__") and not hasattr(obj, "__class__"):
        return obj
    result = {}
    for key in dir(obj):
        if key.startswith("_"):
            continue
        element = []
        val = getattr(obj, key)
        if callable(val) and not isinstance(val, type):
            continue
        if isinstance(val, type) or hasattr(val, "__dict__") and not isinstance(
            val, (np.ndarray,)
        ) and val.__class__.__module__ != "builtins":
            element = class_to_dict(val)
        elif isinstance(val, list):
            element = val
        else:
            element = val
        result[key] = element
    return result


def update_class_from_dict(obj, d: Dict[str, Any]) -> None:
    """Set `obj`'s attributes from the nested dict `d`, recursing into nested
    config objects (copy of utils/config.py:62-68 of the JAX package)."""
    for key, val in d.items():
        attr = getattr(obj, key, None)
        if isinstance(val, dict) and attr is not None and not isinstance(attr, dict):
            update_class_from_dict(attr, val)
        else:
            setattr(obj, key, val)


def set_seed(seed: int | None) -> int:
    """Seed python/numpy globals; torch uses explicit Generators seeded from this."""
    if seed is None or seed < 0:
        seed = np.random.randint(0, 10000)
    random.seed(seed)
    np.random.seed(seed)
    return seed


def deep_copy_cfg(cfg):
    return copy.deepcopy(cfg)
