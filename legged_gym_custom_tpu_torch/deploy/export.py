"""Policy export for deployment, torch port of
legged_gym_custom_tpu/deploy/export.py.

The bundle is a single .npz of named numpy arrays for the four inference
modules (policy / adaptation_module / estimator / scan_encoder) in the layout
the pure-numpy deploy controller (deploy/controller.py) executes without
torch, the same file the JAX package writes.

Naming scheme: `<module>/<idx>/kernel|bias` for dense layers in forward
order, kernels as (in, out); conv layers carry `.../convkernel` as
(k, in, out) and come before the dense layers of their module, as the
reference's sorted flax names (`Conv_*` < `Dense_*`) put them.
`export_policy_bundle` is the inverse of `models.networks.params_from_bundle`.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _dense(layer) -> tuple:
    """nn.Linear -> ((in, out) kernel, bias)."""
    return "kernel", np.ascontiguousarray(_np(layer.weight).T), _np(layer.bias)


def _conv(layer) -> tuple:
    """nn.Conv1d (out, in, k) -> ((k, in, out) convkernel, bias)."""
    return "convkernel", np.ascontiguousarray(np.transpose(_np(layer.weight), (2, 1, 0))), \
        _np(layer.bias)


def export_policy_bundle(nets, out_dir: str, cfg_meta: Optional[Dict] = None,
                         filename: str = "policy_bundle.npz") -> str:
    """Write the inference modules of `nets` (models.networks.
    ActorCriticNetworks) and `std` to `out_dir/filename`; `cfg_meta` entries
    go under `meta/<key>`.  Returns the path."""
    os.makedirs(out_dir, exist_ok=True)
    ad = nets.adapt_encoder
    modules = {
        "policy": [_dense(l) for l in nets.actor.layers],
        "estimator": [_dense(l) for l in nets.estimator.mlp.layers],
        "scan_encoder": [_dense(l) for l in nets.scan_encoder.layers],
        "adaptation_module": [*(_conv(c) for c in ad.convs), _dense(ad.proj), _dense(ad.out)],
    }
    arrays = {}
    for mod_name, layers in modules.items():
        for i, (kind, kernel, bias) in enumerate(layers):
            arrays[f"{mod_name}/{i}/{kind}"] = kernel
            arrays[f"{mod_name}/{i}/bias"] = bias
    arrays["std"] = _np(nets.std)
    if cfg_meta:
        for k, v in cfg_meta.items():
            arrays[f"meta/{k}"] = np.asarray(v)
    path = os.path.join(out_dir, filename)
    np.savez(path, **arrays)
    return path


def load_policy_bundle(path: str) -> Dict[str, Dict[int, dict]]:
    """Load into {module: [layer dicts in order]} for the numpy runtime."""
    data = np.load(path)
    modules: Dict[str, dict] = {}
    for key in data.files:
        if key.startswith("meta/") or key == "std":
            continue
        mod, idx, kind = key.split("/")
        modules.setdefault(mod, {}).setdefault(int(idx), {})[kind] = data[key]
    out = {}
    for mod, layers in modules.items():
        out[mod] = [layers[i] for i in sorted(layers)]
    out["std"] = data["std"]
    out["meta"] = {
        k.split("/", 1)[1]: data[k] for k in data.files if k.startswith("meta/")
    }
    return out
