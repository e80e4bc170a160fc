"""Training checkpoints, torch port of legged_gym_custom_tpu/utils/checkpoint.py.

A checkpoint is one `torch.save` file holding the networks' `state_dict`,
the `state_dict` of all three optimizers (policy, adaptation, estimator;
the reference drops the last two, on_policy_runner.py:283-288), the
adaptive learning rate, the update count and the iteration.

With a mesh the save is collective (JAX's orbax path, :60-120): every rank
calls it, the primary writes the file atomically (a temp file, then
`os.replace`) and all ranks pass a barrier, after which any rank may load
it.  The parameters are replicated, so there is nothing to shard.
"""
from __future__ import annotations

import os

import torch

from legged_gym_custom_tpu_torch.parallel.mesh import barrier

KEYS = ("model_state_dict", "optimizer_policy", "optimizer_adapt", "optimizer_est",
        "learning_rate", "total_updates", "iter", "infos")


def save_checkpoint(path: str, ts, iteration: int, infos=None, mesh=None) -> None:
    """Write `ts` (rl.ppo.TrainState) and the iteration to `path`; with a
    mesh (parallel/mesh.py), collectively."""
    if mesh is not None and not mesh.is_primary:
        barrier(mesh)
        return
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = dict(zip(KEYS, (
        ts.nets.state_dict(), ts.opt_policy.state_dict(), ts.opt_adapt.state_dict(),
        ts.opt_est.state_dict(), ts.learning_rate, ts.total_updates, iteration, infos,
    )))
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    barrier(mesh)


def load_checkpoint(path: str, map_location="cpu") -> dict:
    """Read a checkpoint written by `save_checkpoint` (tensors, dicts and
    python scalars only)."""
    return torch.load(path, map_location=map_location, weights_only=True)
