"""The numbers that decide `correct`: gaps between what the program produced
and what the plain reference computes from the same inputs."""
from __future__ import annotations

import statistics
from typing import Dict

import torch


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.clamp(torch.linalg.norm(b), min=1e-30))


def leaf_norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  leaves=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's (some
    gradients are all but zero)."""
    leaves = list(ref) if leaves is None else list(leaves)
    norms = {k: float(torch.linalg.norm(ref[k].double())) for k in ref}
    med = statistics.median(norms.values())
    return max(abs(float(torch.linalg.norm(prog[k].double())) - norms[k])
               / max(norms[k], med, 1e-30) for k in leaves)


def moving_leaves(first_grad: Dict[str, torch.Tensor], floor: float = 1e-3) -> list:
    """Leaves whose first gradient in the reference is at least `floor` of the
    median leaf's: the others (a key's bias under softmax, for one) move
    under Adam by round-off alone."""
    norms = {k: float(torch.linalg.norm(g.double())) for k, g in first_grad.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= floor * med]


def per_env_gap(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B,) each env's largest absolute gap in a batch-leading leaf, over the
    leaf's RMS in the reference (so that leaves of every unit compare); 0
    where the leaf holds nothing for an env (ANYmal's empty scan stream)."""
    p, r = prog.double(), ref.double()
    if p[0].numel() == 0:
        return torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    scale = torch.sqrt(torch.mean(r * r)).clamp(min=1e-6)
    return ((p - r).abs().reshape(p.shape[0], -1).amax(dim=1)) / scale
