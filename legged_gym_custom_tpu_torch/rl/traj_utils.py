"""Trajectory batching for recurrent policies, torch port of
legged_gym_custom_tpu/rl/traj_utils.py (reference rsl_rl/utils/utils.py:33-71).

Splits (T, B, ...) rollouts at episode boundaries and zero-pads each
trajectory to the horizon T, with the inverse unpad: the recurrent
minibatch path kept for models/recurrent.py.
"""
from __future__ import annotations

import torch


def split_and_pad_trajectories(tensor: torch.Tensor, dones: torch.Tensor):
    """tensor (T, B, ...), dones (T, B) -> (padded (T, n_traj, ...), mask
    (T, n_traj) bool): the trajectories of env 0 first, each in time order,
    a trajectory ending after each done step and at the horizon."""
    T = dones.shape[0]
    ends = dones.bool().clone()
    ends[-1] = True
    flat_ends = ends.transpose(0, 1).reshape(-1)            # env-major, time within
    stops = torch.nonzero(flat_ends)[:, 0] + 1
    starts = torch.cat([stops.new_zeros(1), stops[:-1]])
    lengths = stops - starts
    flat = tensor.transpose(0, 1).reshape(-1, *tensor.shape[2:])
    mask = torch.arange(T, device=tensor.device)[:, None] < lengths[None, :]
    # the flat row of each valid (t, trajectory) entry, in the order padded[mask] fills
    rows = (starts[None, :] + torch.arange(T, device=tensor.device)[:, None])[mask]
    padded = tensor.new_zeros((T, len(lengths), *tensor.shape[2:]))
    padded[mask] = flat[rows]
    return padded, mask


def unpad_trajectories(trajectories: torch.Tensor, masks: torch.Tensor):
    """The inverse of split_and_pad_trajectories: the valid steps of every
    trajectory, trajectory after trajectory, as one (N, ...) tensor."""
    return trajectories.transpose(0, 1)[masks.transpose(0, 1)]
