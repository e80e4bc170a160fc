"""Import the reference's shipped TorchScript policies into our .npz bundle
(copy of legged_gym_custom_tpu/deploy/import_torchscript.py).

The reference ships trained Go2 policies as 4 TorchScript modules per model
(deploy/networks/go2/<model>/{policy, adaptation_module, estimator,
scan_encoder}.pt — SURVEY §2.2).  This converter maps their state dicts into
the framework's deploy bundle so those exact networks run through the
pure-numpy controller and the MuJoCo loop — the control-sequence parity path
of SURVEY §7.2 step 8.

Weight-layout notes:
  * torch Linear stores (out, in); our runtime uses x @ kernel with
    (in, out) -> transpose.
  * torch Conv1d stores (out, in, k); flax/our layout is (k, in, out).
  * torch's post-conv Flatten is channel-major; our NumpyAdaptationEncoder
    flattens channel-major too (controller.py), so fc_final needs no
    permutation.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np


def _torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    import torch

    m = torch.jit.load(path, map_location="cpu")
    return {k: v.detach().numpy() for k, v in m.state_dict().items()}


def _mlp_layers(sd: Dict[str, np.ndarray]):
    """Ordered dense layers from a torch Sequential state dict."""
    idx = sorted(
        {int(k.split(".")[-2]) for k in sd if k.endswith("weight")}
    )
    return [
        dict(
            kernel=np.ascontiguousarray(
                next(v for k, v in sd.items() if k.endswith(f"{i}.weight")).T
            ),
            bias=next(v for k, v in sd.items() if k.endswith(f"{i}.bias")),
        )
        for i in idx
    ]


def import_torchscript_policy(model_dir: str, out_path: str) -> str:
    """Convert a reference policy dir to a bundle .npz; returns the path."""
    arrays = {}

    for mod, fname in [
        ("policy", "policy.pt"),
        ("estimator", "estimator.pt"),
        ("scan_encoder", "scan_encoder.pt"),
    ]:
        sd = _torch_state_dict(os.path.join(model_dir, fname))
        for i, layer in enumerate(_mlp_layers(sd)):
            arrays[f"{mod}/{i}/kernel"] = layer["kernel"]
            arrays[f"{mod}/{i}/bias"] = layer["bias"]

    sd = _torch_state_dict(os.path.join(model_dir, "adaptation_module.pt"))
    # dense layers keep "kernel", convs get flax (k, in, out) "convkernel"
    arrays["adaptation_module/0/kernel"] = sd["fc_encoder.0.weight"].T
    arrays["adaptation_module/0/bias"] = sd["fc_encoder.0.bias"]
    arrays["adaptation_module/1/convkernel"] = np.transpose(
        sd["conv_layers.0.weight"], (2, 1, 0)
    )
    arrays["adaptation_module/1/bias"] = sd["conv_layers.0.bias"]
    arrays["adaptation_module/2/convkernel"] = np.transpose(
        sd["conv_layers.2.weight"], (2, 1, 0)
    )
    arrays["adaptation_module/2/bias"] = sd["conv_layers.2.bias"]
    arrays["adaptation_module/3/kernel"] = sd["fc_final.0.weight"].T
    arrays["adaptation_module/3/bias"] = sd["fc_final.0.bias"]

    arrays["std"] = np.zeros(arrays["policy/3/bias"].shape if "policy/3/bias" in arrays
                             else 12)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **arrays)
    return out_path
