"""FLOPs of a training iteration, counted from shapes: the networks' matrix
products (2 x M x N x K each, from an aten-level trace of the frozen networks
on one sample, and of the frozen SEA actuator network where the task has
one), the physics from the frozen kernel count, and the update's
forward and backward passes (backward twice the forward of each module that
gets gradients).  Work the program does twice (the privileged encoder, run
again for the ROA loss) is counted once; elementwise work outside the kernel
is not counted, so the share is a floor."""
from __future__ import annotations

from typing import Dict

import torch

from .frozen.models.actuator_net import load_actuator_net
from .frozen.models.networks import ActorCriticNetworks
from .frozen.physics.actuator import lstm_actuator

_MATMUL = {"mm", "addmm", "bmm", "convolution"}


def _matmul_flops(func, args, out) -> int:
    name = func.overloadpacket.__name__
    if name == "convolution":
        w = args[1]                          # (C_out, C_in, k)
        return 2 * out.numel() * w.shape[1] * w.shape[2]
    a, b = (args[1], args[2]) if name == "addmm" else (args[0], args[1])
    return 2 * out.numel() * a.shape[-1]


def count(fn) -> int:
    from torch.utils._python_dispatch import TorchDispatchMode

    total = [0]

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ in _MATMUL:
                total[0] += _matmul_flops(func, args, out)
            return out

    with Counter(), torch.no_grad():
        fn()
    return total[0]


def actuator_flops(control) -> int:
    """Matrix-product FLOPs of the actuator network a dof and decimation
    tick: the frozen `lstm_actuator` on the network of
    `control.actuator_net_file`, run on 2 dofs x 2 envs (no axis of size 1
    for the products to fold) and divided by 4; 0 where the task has no
    network."""
    if not getattr(control, "use_actuator_network", False):
        return 0
    w = load_actuator_net(control.actuator_net_file)
    dofs, envs = 2, 2
    state = torch.zeros(len(w.w_ih), dofs, w.w_hh[0].shape[1], envs)
    err = torch.zeros(dofs, envs)
    return count(lambda: lstm_actuator(w, err, err, state, state)) // (dofs * envs)


def module_flops(env_cfg, train_cfg) -> Dict[str, int]:
    """Forward FLOPs per sample of each module, on the frozen networks, and
    the actuator network's a dof and tick (`actuator_flops`)."""
    e = env_cfg.env
    nets = ActorCriticNetworks(train_cfg.policy, num_proprio=e.num_proprio,
                               num_privileged_obs=e.num_privileged_obs,
                               num_critic_obs=e.num_critic_obs,
                               num_estimated_obs=e.num_estimated_obs, num_scan_obs=e.num_scan_obs,
                               num_actions=e.num_actions,
                               history_buffer_length=e.history_buffer_length)
    num_obs = e.num_proprio * (1 + e.history_buffer_length)
    obs = torch.zeros(1, num_obs)
    lat = torch.zeros(1, train_cfg.policy.latent_encoder_output_dim)
    scan_lat = torch.zeros(1, train_cfg.policy.scan_encoder_output_dim)
    est = torch.zeros(1, e.num_estimated_obs)
    return {
        "estimator": count(lambda: nets.estimate(obs)),
        "priv_encoder": count(lambda: nets.priv_encoder(torch.zeros(1, e.num_privileged_obs))),
        "adapt_encoder": count(lambda: nets.adapt_encoder(nets.history_part(obs))),
        "scan_encoder": count(lambda: nets.scan_encoder(torch.zeros(1, e.num_scan_obs))),
        "actor": count(lambda: nets.actor(torch.cat([obs, lat, scan_lat, est], dim=-1))),
        "critic": count(lambda: nets.critic(torch.zeros(1, e.num_critic_obs))),
        "actuator": actuator_flops(env_cfg.control),
    }


def iteration_flops(f: Dict[str, int], kernel_flops_per_env_step: int, envs: int, steps: int,
                    epochs: int, dagger: bool) -> float:
    """FLOPs of one iteration: `steps` env steps of `envs` envs (physics and
    the policy's and critic's forward passes), the last values, and the
    update over `epochs` passes of the envs x steps samples."""
    latent = f["adapt_encoder"] if dagger else f["priv_encoder"]
    act = f["estimator"] + latent + f["scan_encoder"] + f["actor"] + f["critic"]
    collect = steps * envs * (kernel_flops_per_env_step + act) + envs * f["critic"]
    samples = epochs * steps * envs
    if dagger:      # the privileged latent without gradients; the adaptation encoder trained
        update = samples * (f["priv_encoder"] + 3 * f["adapt_encoder"])
    else:           # every module but the adaptation encoder (run without gradients) trained
        trained = (f["estimator"] + f["priv_encoder"] + f["scan_encoder"] + f["actor"]
                   + f["critic"])
        update = samples * (3 * trained + f["adapt_encoder"])
    return float(collect + update)
