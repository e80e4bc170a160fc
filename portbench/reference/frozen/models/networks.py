"""Policy/value networks + encoders, torch port of
legged_gym_custom_tpu/models/networks.py (reference rsl_rl/modules).

  * Actor MLP  in=proprio*(1+H) + latent(20) + scan_latent(32) + est(3)
               hidden [512,256,128] -> num_actions
  * Critic MLP in=num_critic_obs, hidden [512,256,128] -> 1
  * PrivilegedEncoder MLP priv -> [64,20] -> 20
  * ScanEncoder MLP 132 -> [128,64] -> 32
  * MlpEstimator 572 -> [256,128] -> 3
  * AdaptationEncoder: per-step linear 52->30 + 1-D CNN over the history
    (Conv 30->20 k4 s2, 20->10 k2 s1) + linear 30->20, all ELU

The Gaussian policy std is a free (num_actions,) parameter of
`ActorCriticNetworks`.  Weights start as the JAX package's `_safe_lecun_normal`
(truncated-normal lecun, zeros for a zero fan-in), biases at zero.
`params_from_flax` carries a JAX parameter tree (as numpy arrays) into a
`state_dict` of these modules; `params_from_bundle` does the same for the
inference modules of an exported policy bundle (the `.npz` layout of
legged_gym_custom_tpu/deploy/export.py:4-11).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

_ACTIVATIONS = {
    "elu": nn.ELU,
    "selu": nn.SELU,
    "relu": nn.ReLU,
    "crelu": nn.ReLU,
    "lrelu": lambda: nn.LeakyReLU(0.01),
    "tanh": nn.Tanh,
    "sigmoid": nn.Sigmoid,
}

# stddev of a standard normal truncated to [-2, 2] (jax variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _safe_lecun_normal_(weight: torch.Tensor, fan_in: int, generator=None):
    """flax's default kernel init (lecun_normal: truncated normal with
    variance 1/fan_in), tolerating zero fan-in."""
    if fan_in == 0:
        nn.init.zeros_(weight)
        return
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _linear(n_in: int, n_out: int, generator=None) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    _safe_lecun_normal_(layer.weight, n_in, generator)
    nn.init.zeros_(layer.bias)
    return layer


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden_dims: Sequence[int], out_dim: int,
                 activation: str = "elu", generator=None):
        super().__init__()
        dims = [in_dim, *hidden_dims, out_dim]
        self.layers = nn.ModuleList(
            _linear(a, b, generator) for a, b in zip(dims[:-1], dims[1:]))
        self.act = _ACTIVATIONS[activation]()

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = self.act(layer(x))
        return self.layers[-1](x)


class MlpEstimator(nn.Module):
    def __init__(self, num_proprio: int, in_dim: int, out_dim: int,
                 hidden_dims: Sequence[int] = (256, 128), activation: str = "elu",
                 use_history: bool = True, generator=None):
        super().__init__()
        self.num_proprio = num_proprio
        self.use_history = use_history
        self.mlp = MLP(in_dim if use_history else num_proprio, hidden_dims, out_dim,
                       activation, generator)

    def forward(self, obs_with_history):
        x = obs_with_history
        if not self.use_history:
            x = x[..., -self.num_proprio:]
        return self.mlp(x)


class AdaptationEncoder(nn.Module):
    """ROA adaptation encoder over the obs history (support_networks.py:129-175).

    Input: the history part of the obs buffer as (B, H, P).  Each conv runs
    only when the sequence is long enough for its kernel (H = 10 gives the
    reference stack 10 -> k4s2 -> 4 -> k2s1 -> 3 -> flatten 30); the flatten
    is channel-major, as in torch and the JAX version.
    """

    def __init__(self, num_proprio: int, history_buffer_length: int, out_dim: int = 20,
                 activation: str = "elu", channel_size: int = 10, generator=None):
        super().__init__()
        c = channel_size
        self.act = _ACTIVATIONS[activation]()
        self.proj = _linear(num_proprio, 3 * c, generator)
        length, channels = history_buffer_length, 3 * c
        self.convs = nn.ModuleList()
        for out_ch, k, s in ((2 * c, 4, 2), (c, 2, 1)):
            if length >= k:
                conv = nn.Conv1d(channels, out_ch, kernel_size=k, stride=s)
                _safe_lecun_normal_(conv.weight, channels * k, generator)
                nn.init.zeros_(conv.bias)
                self.convs.append(conv)
                length = (length - k) // s + 1
                channels = out_ch
        self.out = _linear(channels * length, out_dim, generator)

    def forward(self, obs_history):
        x = self.act(self.proj(obs_history))           # (B, H, 3c)
        x = x.transpose(-1, -2)                        # (B, C, L)
        for conv in self.convs:
            x = self.act(conv(x))
        return self.act(self.out(x.flatten(-2)))


class ActorCriticNetworks(nn.Module):
    """Actor, critic, the three encoders, the estimator and the action std."""

    def __init__(self, cfg_policy, num_proprio, num_privileged_obs, num_critic_obs,
                 num_estimated_obs, num_scan_obs, num_actions, history_buffer_length,
                 generator=None):
        super().__init__()
        p = cfg_policy
        g = generator
        self.num_proprio = num_proprio
        self.history_buffer_length = history_buffer_length
        self.num_actions = num_actions
        num_obs = num_proprio * (1 + history_buffer_length)
        lat = p.latent_encoder_output_dim
        actor_in = num_obs + lat + p.scan_encoder_output_dim + num_estimated_obs
        self.actor = MLP(actor_in, p.actor_hidden_dims, num_actions, p.activation, g)
        self.critic = MLP(num_critic_obs, p.critic_hidden_dims, 1, p.activation, g)
        self.priv_encoder = MLP(num_privileged_obs, p.priv_encoder_hidden_dims, lat, "elu", g)
        self.scan_encoder = MLP(num_scan_obs, p.scan_encoder_hidden_dims,
                                p.scan_encoder_output_dim, "elu", g)
        self.adapt_encoder = AdaptationEncoder(num_proprio, history_buffer_length, lat,
                                               "elu", generator=g)
        self.estimator = MlpEstimator(num_proprio, num_obs, num_estimated_obs,
                                      p.estimator_hidden_dims, p.activation, p.use_history, g)
        self.std = nn.Parameter(p.init_noise_std * torch.ones(num_actions))

    def history_part(self, obs):
        """Slice + reshape the history block (actor_critic.py:179-180)."""
        hist = obs[..., : -self.num_proprio]
        return hist.reshape(obs.shape[:-1] + (self.history_buffer_length, self.num_proprio))

    def latent(self, obs, privileged_obs, adaptation_mode: bool):
        if adaptation_mode:
            return self.adapt_encoder(self.history_part(obs))
        return self.priv_encoder(privileged_obs)

    def action_mean(self, obs, privileged_obs, estimated_obs, scan_obs, adaptation_mode: bool):
        lat = self.latent(obs, privileged_obs, adaptation_mode)
        scan_lat = self.scan_encoder(scan_obs)
        return self.actor(torch.cat([obs, lat, scan_lat, estimated_obs], dim=-1))

    def value(self, critic_obs):
        return self.critic(critic_obs)[..., 0]

    def estimate(self, obs):
        return self.estimator(obs)


def _mlp_entries(prefix: str, mlp_params) -> dict:
    """Flax MLP ({'Dense_i': {'kernel' (in,out), 'bias'}}) -> MLP state."""
    out = {}
    n = len(mlp_params)
    for i in range(n):
        d = mlp_params[f"Dense_{i}"]
        out[f"{prefix}.layers.{i}.weight"] = np.asarray(d["kernel"]).T
        out[f"{prefix}.layers.{i}.bias"] = np.asarray(d["bias"])
    return out


def params_from_flax(np_params) -> dict:
    """The JAX package's parameter tree (`ActorCriticNetworks.init_params`,
    leaves as numpy arrays) -> a `state_dict` for `ActorCriticNetworks`.

    Dense kernels are (in, out) and become (out, in) Linear weights; Conv
    kernels are (k, in, out) and become (out, in, k) Conv1d weights.
    """
    sd = {}
    for name in ("actor", "critic", "priv_encoder", "scan_encoder"):
        sd.update(_mlp_entries(name, np_params[name]["params"]["MLP_0"]))
    sd.update(_mlp_entries("estimator.mlp", np_params["estimator"]["params"]["MLP_0"]))
    ad = np_params["adapt_encoder"]["params"]
    sd["adapt_encoder.proj.weight"] = np.asarray(ad["Dense_0"]["kernel"]).T
    sd["adapt_encoder.proj.bias"] = np.asarray(ad["Dense_0"]["bias"])
    n_conv = sum(1 for k in ad if k.startswith("Conv_"))
    for i in range(n_conv):
        sd[f"adapt_encoder.convs.{i}.weight"] = np.transpose(
            np.asarray(ad[f"Conv_{i}"]["kernel"]), (2, 1, 0))
        sd[f"adapt_encoder.convs.{i}.bias"] = np.asarray(ad[f"Conv_{i}"]["bias"])
    sd["adapt_encoder.out.weight"] = np.asarray(ad["Dense_1"]["kernel"]).T
    sd["adapt_encoder.out.bias"] = np.asarray(ad["Dense_1"]["bias"])
    sd["std"] = np.asarray(np_params["std"])
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in sd.items()}


def params_from_bundle(path) -> dict:
    """An exported policy bundle (`policy_bundle.npz`) -> a partial
    `state_dict` for `ActorCriticNetworks`, loaded with strict=False.

    The bundle holds the four inference modules, each layer as
    `<module>/<i>/kernel|convkernel` and `.../bias` in the order the export
    sorts the flax layers (`Conv_*` before `Dense_*`, by index), plus `std`;
    the critic and the privileged encoder are not in it.
    """
    data = np.load(path)
    layers = {}
    for key in data.files:
        if key.startswith("meta/") or key == "std":
            continue
        mod, idx, kind = key.split("/")
        layers.setdefault(mod, {}).setdefault(int(idx), {})[kind] = np.asarray(data[key])
    sd = {}
    for mod, prefix in (("policy", "actor"), ("estimator", "estimator.mlp"),
                        ("scan_encoder", "scan_encoder")):
        for i, idx in enumerate(sorted(layers[mod])):
            sd[f"{prefix}.layers.{i}.weight"] = layers[mod][idx]["kernel"].T
            sd[f"{prefix}.layers.{i}.bias"] = layers[mod][idx]["bias"]
    ad = [layers["adaptation_module"][i] for i in sorted(layers["adaptation_module"])]
    convs = [l for l in ad if "convkernel" in l]
    dense = [l for l in ad if "kernel" in l]
    for i, conv in enumerate(convs):
        sd[f"adapt_encoder.convs.{i}.weight"] = np.transpose(conv["convkernel"], (2, 1, 0))
        sd[f"adapt_encoder.convs.{i}.bias"] = conv["bias"]
    for name, layer in zip(("proj", "out"), dense):
        sd[f"adapt_encoder.{name}.weight"] = layer["kernel"].T
        sd[f"adapt_encoder.{name}.bias"] = layer["bias"]
    sd["std"] = np.asarray(data["std"])
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32)
            for k, v in sd.items()}
