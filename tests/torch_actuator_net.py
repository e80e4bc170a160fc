"""A seeded stand-in for the ANYmal SEA actuator network (TorchScript).

The reference's resources/actuator_nets/anydrive_v3_lstm.pt is not in this
repository.  `write_sea_net` writes a TorchScript module of its shape and
calling convention (reference anymal.py:62-80): `nn.LSTM(2, 8, 2,
batch_first=True)` over [position error, velocity] scaled by an `in_scale`
buffer, then `nn.Linear(8, 1)` scaled by an `out_scale` buffer; called as
`module(input (N, 1, 2), (h, c) each (2, N, 8)) -> (torque (N, 1, 1), (h, c))`.
The weights are drawn from a seeded numpy generator, so the torques are
those of no real drive.  The CPU tests and `chip_smoke.py` use it.

    python tests/torch_actuator_net.py [PATH]

writes it to PATH, by default to the path the ANYmal configs name
(`control.actuator_net_file` under LEGGED_GYM_RESOURCES), so that
`python -m legged_gym_custom_tpu_torch.scripts.train --task anymal_c_flat`
finds a network.
"""
from __future__ import annotations

import os
import sys
from typing import Tuple

import numpy as np
import torch
from torch import nn

IN_SCALE = (2.0, 0.2)     # position error [rad], velocity [rad/s]
OUT_SCALE = 40.0          # [N m]


class SeaNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.lstm = nn.LSTM(2, 8, 2, batch_first=True)
        self.linear = nn.Linear(8, 1)
        self.register_buffer("in_scale", torch.tensor(IN_SCALE))
        self.register_buffer("out_scale", torch.tensor(OUT_SCALE))

    def forward(self, x, hc: Tuple[torch.Tensor, torch.Tensor]):
        y, (h, c) = self.lstm(x * self.in_scale, hc)
        return self.linear(y) * self.out_scale, (h, c)


def sea_net(seed: int = 0) -> torch.jit.ScriptModule:
    """The scripted stand-in with weights U(-1/sqrt(8), 1/sqrt(8)) from a
    seeded numpy generator (torch's own LSTM initialisation, made
    reproducible across torch versions)."""
    net = SeaNet()
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(8.0)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(torch.as_tensor(rng.uniform(-bound, bound, tuple(p.shape)),
                                    dtype=torch.float32))
    return torch.jit.script(net.eval())


def write_sea_net(path: str, seed: int = 0) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    sea_net(seed).save(path)
    return path


if __name__ == "__main__":
    if len(sys.argv) > 1:
        out = sys.argv[1]
    else:
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        from legged_gym_custom_tpu_torch.envs import task_registry

        out = task_registry.get_cfgs("anymal_c_flat")[0].control.actuator_net_file
    print(write_sea_net(out))
