"""The data-parallel mesh on torch.distributed, torch port of
legged_gym_custom_tpu/parallel/mesh.py.

One process is one rank and owns one contiguous shard of the global env
batch; parameters are identical on every rank.  Where the JAX package's
GSPMD / `shard_map` puts a `pmean` / `psum` on its 'data' axis, the port
calls one of the helpers below: each issues one collective over a single
flat buffer and records its kind and bytes in the mesh's `CommLog`, by the
phase the caller names (`scripts/comm_budget.py` reads it).  At world size 1
every helper is the identity and issues no collective.

The gloo backend takes CPU tensors: a CUDA tensor is reduced through a host
copy of its flat buffer (gloo is the backend of ranks that share one card,
`parallel/multihost.py`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from legged_gym_custom_tpu_torch import resolve_device


class CommLog:
    """Collectives issued through the helpers: phase -> kind -> [count, bytes]."""

    def __init__(self):
        self.phase = "setup"
        self.entries: Dict[str, Dict[str, List[int]]] = {}

    def record(self, kind: str, nbytes: int) -> None:
        entry = self.entries.setdefault(self.phase, {}).setdefault(kind, [0, 0])
        entry[0] += 1
        entry[1] += int(nbytes)

    @contextlib.contextmanager
    def in_phase(self, name: str):
        """Record what the block issues under `name`."""
        prev, self.phase = self.phase, name
        try:
            yield
        finally:
            self.phase = prev

    def reset(self) -> None:
        self.entries = {}

    def summary(self, phase: str) -> dict:
        """{"total_bytes": .., "counts": {kind: n}, "bytes": {kind: b}} of
        one phase."""
        kinds = self.entries.get(phase, {})
        return {"total_bytes": sum(b for _, b in kinds.values()),
                "counts": {k: n for k, (n, _) in kinds.items()},
                "bytes": {k: b for k, (_, b) in kinds.items()}}


@dataclasses.dataclass
class DataMesh:
    """This rank's place on the 1-D data axis."""

    rank: int = 0
    world_size: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None              # the process group; None: the default one
    backend: Optional[str] = None  # None when no process group is up
    comm: CommLog = dataclasses.field(default_factory=CommLog)
    data_axis = "data"             # the one axis: the env batch is split along it

    @property
    def distributed(self) -> bool:
        return self.world_size > 1

    @property
    def is_primary(self) -> bool:
        return self.rank == 0


def make_mesh(devices=None) -> DataMesh:
    """The mesh over the default process group, or a world of 1 when none is
    up.  `devices`: this rank's device, the card unless the caller asks for
    the CPU."""
    up = dist.is_available() and dist.is_initialized()
    return DataMesh(rank=dist.get_rank() if up else 0,
                    world_size=dist.get_world_size() if up else 1,
                    device=resolve_device("cuda" if devices is None else devices),
                    backend=dist.get_backend() if up else None)


def _is_leaf(x) -> bool:
    return isinstance(x, torch.Tensor)


def _tree_map(fn, tree):
    """`fn` over the tensors of a (nested) tuple / list / dict / dataclass."""
    if _is_leaf(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def is_sharded(mesh: DataMesh, x) -> bool:
    """JAX's rule (mesh.py:38-49): a leaf whose leading dim divides by the
    world size is split along it; every other leaf is replicated."""
    n = mesh.world_size
    return _is_leaf(x) and x.dim() >= 1 and x.shape[0] % n == 0 and x.shape[0] >= n


def shard_env_state(mesh: DataMesh, state):
    """This rank's contiguous slice of every sharded leaf of `state` (a
    tensor, or a nested tuple / dict / dataclass of them); replicated leaves
    and non-tensors stay whole."""
    if not mesh.distributed:
        return state

    def place(x):
        if not is_sharded(mesh, x):
            return x
        n = x.shape[0] // mesh.world_size
        return x[mesh.rank * n:(mesh.rank + 1) * n]

    return _tree_map(place, state)


def _flat_collective(mesh: DataMesh, tensors, kind: str, op) -> list:
    """One collective over the concatenation of `tensors` (one dtype), the
    result written back into them; recorded under the current phase."""
    if not tensors:
        return tensors
    dtype = tensors[0].dtype
    if any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{kind}: one dtype per flat buffer, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    wire = flat.cpu() if mesh.backend == "gloo" else flat
    op(wire)
    if wire is not flat:
        flat.copy_(wire)
    mesh.comm.record(kind, flat.numel() * flat.element_size())
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


def all_reduce_sum_(mesh: Optional[DataMesh], tensors) -> list:
    """Sum `tensors` over the ranks, in place, in one all-reduce."""
    if mesh is None or not mesh.distributed:
        return tensors
    return _flat_collective(mesh, tensors, "all-reduce",
                            lambda buf: dist.all_reduce(buf, group=mesh.group))


def all_reduce_mean_(mesh: Optional[DataMesh], tensors) -> list:
    """Average `tensors` over the ranks (JAX's `pmean`), in place, in one
    all-reduce."""
    if mesh is None or not mesh.distributed:
        return tensors

    def op(buf):
        dist.all_reduce(buf, group=mesh.group)
        buf.div_(mesh.world_size)

    return _flat_collective(mesh, tensors, "all-reduce", op)


def broadcast_(mesh: Optional[DataMesh], tensors, src: int = 0) -> list:
    """Rank `src`'s values of `tensors` on every rank, in one broadcast."""
    if mesh is None or not mesh.distributed:
        return tensors
    return _flat_collective(mesh, tensors, "broadcast",
                            lambda buf: dist.broadcast(buf, src, group=mesh.group))


def broadcast_object(mesh: Optional[DataMesh], obj, src: int = 0):
    """Rank `src`'s `obj` (picklable) on every rank, in one broadcast: a
    seed, a run directory, a checkpoint path that one rank picks for all."""
    if mesh is None or not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, group=mesh.group)
    mesh.comm.record("broadcast-object", 0)
    return box[0]


def shard_params(mesh: Optional[DataMesh], module: torch.nn.Module) -> torch.nn.Module:
    """Replicate rank 0's parameters and buffers (JAX `device_put` on a
    replicated sharding), in place."""
    tensors = list(module.state_dict(keep_vars=True).values())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        broadcast_(mesh, [t for t in tensors if t.dtype == dtype])
    return module


def barrier(mesh: Optional[DataMesh]) -> None:
    """Every rank waits here for the others."""
    if mesh is None or not mesh.distributed:
        return
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index or 0])
    else:
        dist.barrier(group=mesh.group)
    mesh.comm.record("barrier", 0)
