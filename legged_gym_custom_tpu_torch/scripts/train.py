"""Training entry point, torch port of legged_gym_custom_tpu/scripts/train.py.

Usage: python -m legged_gym_custom_tpu_torch.scripts.train --task go2
       [--num_envs N] [--max_iterations M] [--seed S] [--device cuda|cuda:i|cpu]
       [--resume] [--load_run R] [--checkpoint C]

`--resume` loads the newest checkpoint of the newest run of the experiment
(or the one `--load_run` / `--checkpoint` name) and goes on from its iteration.
A task whose config sets `runner.resume` (the go2_parkour stages after the
first: `--task go2_parkour_finetune`, ...) resumes so without the flag.

Data parallel over every local card, as the JAX command trains over every
local chip (its runner's mesh, runner.py:102-105): started plainly with
`--device cuda`, the command runs one rank per card, `parallel.mesh_shape`
of the task's config cards (an int) or every visible card (None, the
default), each rank a process of this module on its own card (nccl).
Under torch's variables (`torchrun --nproc_per_node N -m
legged_gym_custom_tpu_torch.scripts.train ...`: RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT) each process is one rank.  `--num_envs` is the
global count; each rank steps its share.  The primary rank picks the seed
(when `--seed` is not given), the run directory and the checkpoint to
resume, prints the console block with the global env-steps/s, and alone
writes TensorBoard and the checkpoints.  With one card, a named card
(`--device cuda:i`) or `--device cpu` it stays one process.

Runs on the GPU unless `--device cpu` is given; with no GPU it raises
rather than falling back to the CPU.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from legged_gym_custom_tpu_torch import DEFAULT_DEVICE, resolve_device
from legged_gym_custom_tpu_torch.envs import task_registry
from legged_gym_custom_tpu_torch.parallel import multihost

MODULE = "legged_gym_custom_tpu_torch.scripts.train"


def get_args(argv=None):
    """CLI args (reference helpers.py:152-178); --device picks the card or
    the CPU."""
    p = argparse.ArgumentParser("legged_gym_custom_tpu_torch train")
    p.add_argument("--task", default="go2")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--experiment_name", default=None)
    p.add_argument("--run_name", default=None)
    p.add_argument("--load_run", default=None)
    p.add_argument("--checkpoint", type=int, default=None)
    p.add_argument("--num_envs", type=int, default=None, help="GLOBAL env count")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max_iterations", type=int, default=None)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    p.add_argument("--headless", action="store_true")  # accepted for parity
    return p.parse_args(argv)


def cards_to_use(args) -> int:
    """The ranks a plain start runs: the task's `parallel.mesh_shape` cards
    (an int), else every visible card; 1 for the CPU or a named card."""
    dev = torch.device(args.device)
    if dev.type != "cuda" or dev.index is not None:
        return 1
    visible = torch.cuda.device_count()
    shape = task_registry.get_cfgs(args.task)[0].parallel.mesh_shape
    n = visible if shape is None else int(np.prod(shape))
    if n > visible:
        raise ValueError(f"parallel.mesh_shape asks for {n} cards, {visible} visible")
    return n


def _join(device):
    """(this rank's device, its mesh or None, whether this call joined the
    process group).  A group already up is joined as it is; torch's
    variables start one; with neither, one process and no mesh."""
    if dist.is_available() and dist.is_initialized():
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev, multihost.global_mesh(dev), False
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dev = multihost.init_distributed(device=device)
        return dev, multihost.global_mesh(dev), True
    return resolve_device(device), None, False


def rank_report(runner, history) -> dict:
    """Every rank's device and envs, its kernel launches (since the counters
    were last set to 0), whether its losses of `history` are finite and a checksum of
    its parameters, gathered (a collective); and whether the parameters are
    bit-equal across ranks."""
    from legged_gym_custom_tpu_torch.ops import fused_step

    env, mesh = runner.env, runner.mesh
    flat = torch.cat([t.detach().reshape(-1).float().cpu()
                      for t in runner.nets.state_dict().values()]).numpy()
    losses = [v for h in history for k, v in h.items() if k.endswith("loss")]
    mine = {"rank": mesh.rank, "device": str(env.device), "local_envs": env.num_envs, "env_offset": env.env_offset,
            "launches": {k: n for k, n in fused_step.launch_counts().items() if n},
            "losses_finite": bool(losses) and bool(np.isfinite(losses).all()),
            "params_sha256": hashlib.sha256(flat.tobytes()).hexdigest()}
    ranks = [None] * mesh.world_size
    dist.all_gather_object(ranks, mine, group=mesh.group)
    return {"world_size": mesh.world_size, "backend": mesh.backend,
            "iteration": runner.current_learning_iteration, "log_dir": runner.log_dir,
            "params_bit_equal": len({r["params_sha256"] for r in ranks}) == 1, "ranks": ranks}


def train(args, log_root="default", env_cfg=None):
    """Build the env (from `env_cfg` if given, else the task's config) and
    the runner, and train; returns (runner, per-iteration history).  Inside
    a process group (already up, or started here from torch's variables)
    this process is one rank of a data-parallel run, and the primary prints
    `rank_report` after the last iteration."""
    device, mesh, joined = _join(args.device)
    try:
        env, _ = task_registry.make_env(name=args.task, args=args, env_cfg=env_cfg,
                                        device=device, mesh=mesh)
        if mesh is not None and device.type == "cuda":
            multihost.load_kernel_rank0_first(env, mesh)
        runner, train_cfg = task_registry.make_alg_runner(env=env, name=args.task, args=args,
                                                          log_root=log_root)
        history = runner.learn(num_learning_iterations=train_cfg.runner.max_iterations,
                               init_at_random_ep_len=True)
        if mesh is not None and mesh.distributed:
            report = rank_report(runner, history)
            if mesh.is_primary:
                print(f"[train] ranks: {json.dumps(report)}", flush=True)
        return runner, history
    finally:
        if joined:
            multihost.shutdown()


def main(argv=None):
    """Train in this process, or, started plainly where `cards_to_use` is
    above 1, as that many ranks of this module, one a card."""
    args = get_args(argv)
    inside = "RANK" in os.environ or (dist.is_available() and dist.is_initialized())
    n = 1 if inside else cards_to_use(args)
    if n > 1:
        print(f"[train] {n} ranks, one per card", flush=True)
        multihost.launch_module(MODULE, n, sys.argv[1:] if argv is None else list(argv),
                                timeout=None, torch_env=True, capture=False)
        return None
    return train(args)


if __name__ == "__main__":
    main()
