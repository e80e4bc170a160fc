"""Multi-process launch helpers, torch port of
legged_gym_custom_tpu/parallel/multihost.py.

Every process runs the same program: `init_distributed()` joins the process
group, `global_mesh()` gives this rank's `DataMesh`, and each rank builds
and owns `B_global / world_size` envs.  Parameters are replicated; the PPO
gradient reductions are the all-reduces of `parallel/mesh.py`.
`launch_module` starts the ranks of such a program on one machine
(`scripts/train.py` over every local card, `scripts/multihost_worker.py`).

The backend follows one rule, agreed on by every rank before the group is
made: `nccl` when every rank has a card of its own; `gloo` on the CPU and
when ranks share a card (NCCL refuses two ranks on one device).  Each rank
writes its device's identity into the rendezvous store and reads every
other rank's, so all ranks pick the same backend.  A peer that never comes
raises after `timeout` seconds instead of hanging.
"""
from __future__ import annotations

import datetime
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from legged_gym_custom_tpu_torch import LEGGED_GYM_TORCH_ROOT_DIR, resolve_device
from .mesh import DataMesh, barrier, make_mesh

DEFAULT_TIMEOUT_S = 300.0


def _device_identity(device: torch.device) -> str:
    if device.type != "cuda":
        return f"{socket.gethostname()}:cpu"
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    return str(uuid) if uuid is not None else f"{socket.gethostname()}:cuda:{device.index}"


def choose_backend(identities) -> str:
    """`nccl` when every rank has a card of its own, else `gloo`."""
    cards = [i for i in identities if not i.endswith(":cpu")]
    return "nccl" if len(cards) == len(identities) and len(set(cards)) == len(cards) else "gloo"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device=None,
                     timeout: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group from the arguments or torch's usual variables
    (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, as torchrun sets them);
    with neither, stay a single process (JAX :26-28).  Returns this rank's
    device: `device` ("cuda" picks the card of the local rank, "cuda:i" that
    card, "cpu" the CPU), the card by default."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', 29500)}"
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    dev = resolve_device(device if device is not None else "cuda")
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator_address is None:
        return dev  # single process
    if dist.is_initialized():
        raise RuntimeError("init_distributed: a process group is already up")
    host, port = coordinator_address.rsplit(":", 1)
    td = datetime.timedelta(seconds=timeout)
    # torchrun's agent already serves the store at MASTER_PORT
    agent_store = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0 and not agent_store,
                          timeout=td)
    store.set(f"lgc/device/{rank}", _device_identity(dev))
    identities = [store.get(f"lgc/device/{r}").decode() for r in range(world)]
    backend = choose_backend(identities)
    dist.init_process_group(backend, store=dist.PrefixStore("lgc/pg", store), rank=rank,
                            world_size=world, timeout=td)
    return dev


def global_mesh(device=None) -> DataMesh:
    """This rank's mesh over the default process group (a world of 1 when
    none is up)."""
    return make_mesh(devices=device)


def local_env_count(total_envs: int) -> int:
    n = dist.get_world_size() if dist.is_initialized() else 1
    assert total_envs % n == 0, (total_envs, n)
    return total_envs // n


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A free localhost port for rank 0's store."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_main(rank, world_size, port, device, timeout, fn, args, out_path):
    if str(device).startswith("cpu"):   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dev = init_distributed(f"127.0.0.1:{port}", world_size, rank, device, timeout)
    try:
        torch.save(fn(global_mesh(dev), *args), out_path)
    finally:
        shutdown()


def _exit_code(p):
    """A `multiprocessing.Process`'s or a `subprocess.Popen`'s exit code,
    None while it runs."""
    return p.poll() if hasattr(p, "poll") else p.exitcode


def wait_ranks(procs, timeout: float | None) -> None:
    """Wait for every rank's process (`multiprocessing.Process` or
    `subprocess.Popen`); raise RuntimeError as soon as one exits non-zero, or
    when some still run `timeout` seconds on (None: no limit).  The caller
    ends the others with `stop_ranks`."""
    deadline = float("inf") if timeout is None else time.time() + timeout
    while True:
        codes = [_exit_code(p) for p in procs]
        if any(c not in (None, 0) for c in codes):
            raise RuntimeError(f"rank(s) failed, exit codes {codes}")
        if None not in codes:
            return
        if time.time() > deadline:
            raise RuntimeError(f"ranks still running after {timeout}s, exit codes {codes}")
        time.sleep(0.1)


def stop_ranks(procs) -> None:
    """Kill every started process that still runs, and reap them all."""
    for p in procs:
        if p.pid is None:   # a Process that never started
            continue
        if _exit_code(p) is None:
            p.kill()
        (p.wait if hasattr(p, "wait") else p.join)(5)


def spawn_ranks(fn, world_size: int, args=(), device="cpu", timeout: float = DEFAULT_TIMEOUT_S):
    """Run `fn(mesh, *args)` on `world_size` ranks of this machine
    (torch.multiprocessing, spawn; `fn` importable, its result picklable)
    and return the results by rank.  The process group times out after
    `timeout` seconds; a rank that fails, or ranks still running then, are
    killed and raise (`wait_ranks`)."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="lgc_ranks_")
    port = free_port()
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world_size)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, port, device, timeout, fn, args, outs[r]))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        wait_ranks(procs, timeout)
        return [torch.load(o, weights_only=False) for o in outs]
    finally:
        stop_ranks(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def load_kernel_rank0_first(env, mesh) -> None:
    """Rank 0 builds (or loads) the kernel library of the env's control step
    for its batch; the others load it after a barrier, so ranks that share a
    build directory run one nvcc.  Nothing to load for an env with the
    kernel off (`env.fused_spec` is None)."""
    from legged_gym_custom_tpu_torch.ops import fused_step

    if env.fused_spec is None:
        return
    spec = env.fused_spec if env._torque_fn is None else fused_step.tick_spec(env.fused_spec)
    if mesh.is_primary:
        fused_step.load_kernel(spec, env.num_envs)
    barrier(mesh)
    if not mesh.is_primary:
        fused_step.load_kernel(spec, env.num_envs)


def launch_module(module: str, num_processes: int, argv, timeout: float | None = 900.0,
                  env=None, torch_env: bool = False, capture: bool = True,
                  pin_cores: bool = False):
    """Run `python -m module *argv` as `num_processes` ranks on this machine
    (rank 0's store on a free localhost port) and wait for all.  The ranks
    find each other through torch's variables (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK, LOCAL_RANK) with `torch_env`, else through the
    arguments `--coordinator --num_processes --process_id`.  With `capture`
    each rank's output goes to a file and the list of outputs is returned;
    without, the ranks write to this process's stdout and stderr.  A rank
    that fails, or a run past `timeout` seconds (None: no limit), kills
    every rank and raises RuntimeError with the ranks' output.  `pin_cores`
    pins rank i to core i (taskset)."""
    tmp = tempfile.mkdtemp(prefix="lgc_ranks_")
    port = free_port()
    procs, logs = [], []
    base_env = dict(os.environ if env is None else env)
    try:
        for rank in range(num_processes):
            cmd = ["taskset", "-c", str(rank % (os.cpu_count() or 1))] if pin_cores else []
            cmd += [sys.executable, "-m", module, *argv]
            rank_env = dict(base_env)
            if torch_env:
                rank_env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                                WORLD_SIZE=str(num_processes), RANK=str(rank),
                                LOCAL_RANK=str(rank))
            else:
                cmd += ["--coordinator", f"127.0.0.1:{port}", "--num_processes",
                        str(num_processes), "--process_id", str(rank)]
            out = None
            if capture:
                logs.append(open(os.path.join(tmp, f"rank{rank}.log"), "w+"))
                out = logs[-1]
            procs.append(subprocess.Popen(cmd, stdout=out,
                                          stderr=subprocess.STDOUT if capture else None,
                                          text=True, env=rank_env,
                                          cwd=LEGGED_GYM_TORCH_ROOT_DIR))
        failed = None
        try:
            wait_ranks(procs, timeout)
        except RuntimeError as e:
            failed = e
        stop_ranks(procs)
        outputs = []
        for f in logs:
            f.flush()
            f.seek(0)
            outputs.append(f.read())
        if failed is not None:
            tails = "\n".join(f"--- rank {r} (exit {p.poll()}):\n{out[-3000:]}"
                              for r, (p, out) in enumerate(zip(procs, outputs)))
            raise RuntimeError(f"{num_processes} ranks of {module} failed ({failed}):\n{tails}")
        return outputs
    finally:
        stop_ranks(procs)
        for f in logs:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)
