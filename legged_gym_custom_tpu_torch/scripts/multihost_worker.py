"""Multi-process training worker: one process a rank, torch port of
legged_gym_custom_tpu/scripts/multihost_worker.py.

Every rank runs this same program: `parallel.multihost.init_distributed`
joins the process group (backend by its rule: `nccl` when every rank has a
card of its own, `gloo` on the CPU or when ranks share a card), each rank
builds and owns its `B_global / world_size` envs, the PPO update all-reduces
each minibatch's gradients, and the checkpoint is saved collectively.

    python -m legged_gym_custom_tpu_torch.scripts.multihost_worker \\
        --coordinator 127.0.0.1:29500 --num_processes 2 --process_id 0 \\
        --task go2 --num_envs 4096 --iterations 2 --warmup 1 --device cuda:0

(one per rank; `launch` below starts them all on one machine).  Without
`--coordinator` the torchrun variables are read (`torchrun --nproc_per_node
2 -m legged_gym_custom_tpu_torch.scripts.multihost_worker --task go2`), and
with neither it trains as a single process.  On the card, rank 0 builds the
fused kernel first and the others load it after a barrier.

The primary prints one JSON line with the JAX worker's keys plus `backend`
and `device`, and, gathered from every rank: its kernel launches during
training, a checksum of its parameters, and whether the parameters are bit
equal across ranks.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import shutil
import sys
import tempfile
import time

from legged_gym_custom_tpu_torch import DEFAULT_DEVICE

MODULE = "legged_gym_custom_tpu_torch.scripts.multihost_worker"


def get_args(argv=None):
    p = argparse.ArgumentParser("legged_gym_custom_tpu_torch multihost worker")
    p.add_argument("--coordinator", default=None, help="host:port of rank 0's store")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--task", default="go2")
    p.add_argument("--num_envs", type=int, default=64, help="GLOBAL env count")
    p.add_argument("--iterations", type=int, default=2)
    p.add_argument("--warmup", type=int, default=0,
                   help="untimed iterations first (kernel load and allocator excluded from fps)")
    p.add_argument("--ckpt_dir", default=None,
                   help="shared dir: save a collective checkpoint, reload it, and verify the "
                        "restored iteration counter")
    p.add_argument("--result_json", default=None)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (the card of the local rank), cuda:i, or cpu")
    return p.parse_args(argv)


def _flat_params(nets):
    import torch

    return torch.cat([t.detach().reshape(-1).float().cpu()
                      for t in nets.state_dict().values()]).numpy()


def run(args, device, mesh) -> dict:
    import numpy as np
    import torch.distributed as dist

    from legged_gym_custom_tpu_torch.envs import task_registry
    from legged_gym_custom_tpu_torch.ops import fused_step
    from legged_gym_custom_tpu_torch.parallel import multihost
    from legged_gym_custom_tpu_torch.rl.runner import OnPolicyRunner

    env_cfg, train_cfg = task_registry.get_cfgs(args.task)
    env_cfg.env.num_envs = multihost.local_env_count(args.num_envs)
    train_cfg.runner.max_iterations = args.iterations
    env = task_registry.get_task_class(args.task)(env_cfg, env_cfg.asset.file, name=args.task,
                                                  device=device, mesh=mesh)
    if device.type == "cuda":
        multihost.load_kernel_rank0_first(env, mesh)
    runner = OnPolicyRunner(env, train_cfg, log_dir=None)

    fused_step.reset_launch_counts()
    if args.warmup:
        runner.learn(args.warmup)
    mesh.comm.reset()
    t0 = time.time()
    history = runner.learn(args.iterations)
    dt = time.time() - t0
    fps = args.iterations * runner.num_steps_per_env * args.num_envs / dt
    launches = {k: n for k, n in fused_step.launch_counts().items() if n}
    comm = {phase: mesh.comm.summary(phase) for phase in ("collect", "update")}

    ckpt_path = restored_iteration = None
    if args.ckpt_dir:
        ckpt_path = os.path.join(args.ckpt_dir, "multihost_model.pt")
        runner.save(ckpt_path)  # collective: the primary writes, all pass a barrier
        runner.current_learning_iteration = 0  # clobber, then prove the restore
        runner.load(ckpt_path)
        restored_iteration = int(runner.current_learning_iteration)

    flat = _flat_params(runner.nets)
    losses = [v for h in history for k, v in h.items() if k.endswith("loss")]
    mine = {"rank": mesh.rank, "device": str(device), "local_envs": env.num_envs,
            "env_offset": env.env_offset, "launches": launches,
            "params_sha256": hashlib.sha256(flat.tobytes()).hexdigest(),
            "losses_finite": bool(losses) and all(math.isfinite(v) for v in losses)}
    # through the backend whenever a process group is up, at world size 1 too
    ranks = [(mine, flat)]
    if dist.is_initialized():
        ranks = [None] * mesh.world_size
        dist.all_gather_object(ranks, (mine, flat))
    bits = [f.view(np.uint32) for _, f in ranks]
    return {
        "process_count": mesh.world_size,
        "global_devices": mesh.world_size,
        "local_devices": 1,
        "num_envs": args.num_envs,
        "iterations": args.iterations,
        "fps": round(float(fps), 1),
        # last iteration's phase split: collection = rollout + GAE and the
        # episode statistics' all-reduce; learning = the minibatched update
        # with one gradient all-reduce a minibatch
        "collection_s": round(float(runner.collection_time), 3),
        "learning_s": round(float(runner.learn_time), 3),
        "value_loss": float(history[-1].get("value_loss", float("nan"))),
        "ckpt": ckpt_path,
        "restored_iteration": restored_iteration,
        "backend": mesh.backend,
        "device": str(device),
        "warmup": args.warmup,
        # the collectives of the timed iterations, by phase
        "collectives": comm,
        "ranks": [m for m, _ in ranks],
        "params_bit_equal": all(b.shape == bits[0].shape and np.array_equal(b, bits[0])
                                for b in bits),
    }


def main(argv=None):
    args = get_args(argv)
    from legged_gym_custom_tpu_torch.parallel import multihost

    device = multihost.init_distributed(args.coordinator, args.num_processes, args.process_id,
                                        args.device)
    try:
        mesh = multihost.global_mesh(device)
        result = run(args, device, mesh)
        if mesh.is_primary:
            line = json.dumps(result)
            print(line, flush=True)
            if args.result_json:
                with open(args.result_json, "w") as f:
                    f.write(line)
        return result
    finally:
        multihost.shutdown()


def launch(num_processes: int, argv, timeout: float = 900.0, env=None, pin_cores=False):
    """Start `num_processes` workers on this machine (`multihost.launch_module`,
    each with `argv` and the `--coordinator` arguments), wait for all, and
    return (the primary's result, every rank's output).  A rank that fails,
    or a run past `timeout` seconds, kills every rank and raises with their
    output.  `pin_cores` pins rank i to core i (taskset)."""
    from legged_gym_custom_tpu_torch.parallel.multihost import launch_module

    tmp = tempfile.mkdtemp(prefix="lgc_workers_")
    result_json = os.path.join(tmp, "result.json")
    try:
        outputs = launch_module(MODULE, num_processes, [*argv, "--result_json", result_json],
                                timeout=timeout, env=env, pin_cores=pin_cores)
        if not os.path.exists(result_json):
            raise RuntimeError(f"{num_processes} workers wrote no result:\n{outputs[0][-3000:]}")
        with open(result_json) as f:
            return json.load(f), outputs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
