"""ANYmal SEA actuator-network weights, torch port of
legged_gym_custom_tpu/models/actuator_net.py.

Loads the reference TorchScript checkpoint (resources/actuator_nets/
anydrive_v3_lstm.pt, reference anymal.py:52-54) and takes its tensors into
the `LSTMWeights` that physics.actuator.lstm_actuator runs as plain tensor
ops: a 2-layer LSTM (input 2 = [position error, velocity], hidden 8) and a
linear head to the torque.  The state dict is searched as the reference does:
`weight_ih_l{k}`, `weight_hh_l{k}`, `bias_ih_l{k}`, `bias_hh_l{k}` by key
suffix for each layer k, and the head is the 2-D `weight` (with its 1-D
`bias`) whose key does not contain "lstm"; `in_scale` / `out_scale` buffers
are taken when present.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from portbench.reference.frozen.physics.actuator import LSTMWeights


def lstm_weights_from_numpy(w_ih, w_hh, b_ih, b_hh, w_out, b_out, in_scale=1.0,
                            out_scale=1.0, device="cpu") -> LSTMWeights:
    """`LSTMWeights` from numpy arrays (per-layer sequences for the LSTM, as
    the JAX package's `LSTMWeights` holds them), float32 on `device`."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return LSTMWeights(
        w_ih=tuple(map(t, w_ih)), w_hh=tuple(map(t, w_hh)),
        b_ih=tuple(map(t, b_ih)), b_hh=tuple(map(t, b_hh)),
        w_out=t(w_out), b_out=t(b_out),
        in_scale=t(np.asarray(in_scale).reshape(-1)), out_scale=t(np.asarray(out_scale).reshape(())),
    )


def load_actuator_net(path: str, device="cpu") -> LSTMWeights:
    """The SEA network of a TorchScript file as `LSTMWeights` on `device`.
    A missing file raises FileNotFoundError: the ANYmal tasks never fall
    back to PD control."""
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"actuator network not found: control.actuator_net_file = {path!r}")
    module = torch.jit.load(path, map_location="cpu")
    sd = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}

    def find(suffix):
        for k, v in sd.items():
            if k.endswith(suffix):
                return v
        raise KeyError(suffix)

    layers = {name: [] for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
    layer = 0
    while any(k.endswith(f"weight_ih_l{layer}") for k in sd):
        for name, found in layers.items():
            found.append(find(f"{name}_l{layer}"))
        layer += 1
    if layer == 0:
        raise ValueError(f"no LSTM weights found in {path}: keys={list(sd)}")

    lin_w = lin_b = None
    for k, v in sd.items():
        if "lstm" not in k and k.endswith("weight") and v.ndim == 2:
            lin_w = v
        if "lstm" not in k and k.endswith("bias") and v.ndim == 1:
            lin_b = v
    if lin_w is None:
        raise ValueError(f"no output linear layer found in {path}")
    return lstm_weights_from_numpy(
        layers["weight_ih"], layers["weight_hh"], layers["bias_ih"], layers["bias_hh"],
        lin_w, lin_b, sd.get("in_scale", 1.0), sd.get("out_scale", 1.0), device=device)
