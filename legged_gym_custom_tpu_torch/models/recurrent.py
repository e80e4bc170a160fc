"""Recurrent actor-critic, torch port of legged_gym_custom_tpu/models/recurrent.py
(reference rsl_rl/modules/actor_critic_recurrent.py).

The reference keeps an LSTM/GRU `Memory`-wrapped actor-critic that predates
the 5-stream API and is documented as deprecated (reference README.md:41);
the runner trains the feed-forward `ActorCriticNetworks` (models/networks.py).
It is here for users who carry a recurrent policy across.  The carry is that
of the JAX package: (c, h) for the LSTM, h for the GRU.

`params_from_flax_recurrent` carries the JAX package's parameter tree (as
numpy arrays) into a `state_dict` of `ActorCriticRecurrent`: flax's
OptimizedLSTMCell keeps one dense a gate, `ii`/`if`/`ig`/`io` on the input
without a bias and `hi`/`hf`/`hg`/`ho` on the hidden state with one, which
stack into torch's (i, f, g, o) weights with the biases on the hidden side;
flax's GRUCell biases the input denses `ir`/`iz`/`in` and only `hn` of the
hidden ones, which are torch's `b_ih` (r, z, n) and `b_hh` (0, 0, n).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from .networks import MLP


class Memory(nn.Module):
    """Single-layer LSTM/GRU memory (actor_critic_recurrent.py:79-116)."""

    def __init__(self, input_size: int, hidden_size: int = 256, rnn_type: str = "lstm"):
        super().__init__()
        if rnn_type not in ("lstm", "gru"):
            raise ValueError(rnn_type)
        self.rnn_type = rnn_type
        self.hidden_size = hidden_size
        cell = nn.LSTMCell if rnn_type == "lstm" else nn.GRUCell
        self.cell = cell(input_size, hidden_size)

    def initialize_carry(self, batch_dims=()):
        zeros = lambda: torch.zeros((*batch_dims, self.hidden_size))
        return (zeros(), zeros()) if self.rnn_type == "lstm" else zeros()

    def forward(self, x, carry):
        """(features, carry') from x (..., input) and the carry."""
        if self.rnn_type == "lstm":
            c, h = carry
            h, c = self.cell(x, (h, c))
            return h, (c, h)
        h = self.cell(x, carry)
        return h, h


class ActorCriticRecurrent(nn.Module):
    def __init__(self, num_obs: int, num_critic_obs: int, num_actions: int,
                 actor_hidden_dims: Sequence[int] = (256, 256, 256),
                 critic_hidden_dims: Sequence[int] = (256, 256, 256),
                 rnn_hidden_size: int = 256, rnn_type: str = "lstm", activation: str = "elu"):
        super().__init__()
        self.memory_a = Memory(num_obs, rnn_hidden_size, rnn_type)
        self.memory_c = Memory(num_critic_obs, rnn_hidden_size, rnn_type)
        self.actor = MLP(rnn_hidden_size, actor_hidden_dims, num_actions, activation)
        self.critic = MLP(rnn_hidden_size, critic_hidden_dims, 1, activation)

    def act(self, obs, carry_a):
        feat, carry_a = self.memory_a(obs, carry_a)
        return self.actor(feat), carry_a

    def evaluate(self, critic_obs, carry_c):
        feat, carry_c = self.memory_c(critic_obs, carry_c)
        return self.critic(feat)[..., 0], carry_c

    def forward(self, obs, critic_obs, carry_a, carry_c):
        mean, carry_a = self.act(obs, carry_a)
        value, carry_c = self.evaluate(critic_obs, carry_c)
        return mean, value, carry_a, carry_c


def _memory_entries(prefix: str, mem) -> dict:
    """A flax Memory's cell (one dense a gate, kernels (in, out)) -> torch's
    stacked `weight_ih` / `weight_hh` / `bias_ih` / `bias_hh`."""
    (name, cell), = mem.items()
    k = lambda g: np.asarray(cell[g]["kernel"]).T
    b = lambda g: np.asarray(cell[g]["bias"])
    if name.startswith("OptimizedLSTMCell") or name.startswith("LSTMCell"):
        gates = ("i", "f", "g", "o")
        hidden = k("hi").shape[0]
        w_ih = np.concatenate([k("i" + g) for g in gates])
        w_hh = np.concatenate([k("h" + g) for g in gates])
        b_ih = np.zeros(4 * hidden, np.float32)
        b_hh = np.concatenate([b("h" + g) for g in gates])
    elif name.startswith("GRUCell"):
        gates = ("r", "z", "n")
        hidden = k("hn").shape[0]
        w_ih = np.concatenate([k("i" + g) for g in gates])
        w_hh = np.concatenate([k("h" + g) for g in gates])
        b_ih = np.concatenate([b("i" + g) for g in gates])
        b_hh = np.concatenate([np.zeros(2 * hidden, np.float32), b("hn")])
    else:
        raise ValueError(f"unknown flax cell {name!r}")
    return {f"{prefix}.cell.weight_ih": w_ih, f"{prefix}.cell.weight_hh": w_hh,
            f"{prefix}.cell.bias_ih": b_ih, f"{prefix}.cell.bias_hh": b_hh}


def params_from_flax_recurrent(np_params) -> dict:
    """The JAX package's `ActorCriticRecurrent` parameters ({'params': ...},
    leaves as numpy arrays) -> a `state_dict` for `ActorCriticRecurrent`."""
    p = np_params["params"]
    sd = {}
    for name in ("memory_a", "memory_c"):
        sd.update(_memory_entries(name, p[name]))
    for name in ("actor", "critic"):
        for i in range(len(p[name])):
            d = p[name][f"Dense_{i}"]
            sd[f"{name}.layers.{i}.weight"] = np.asarray(d["kernel"]).T
            sd[f"{name}.layers.{i}.bias"] = np.asarray(d["bias"])
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=torch.float32) for k, v in sd.items()}
