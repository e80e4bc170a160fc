"""What every run shares: finding a cell's files by name, the seeds, the
device checks, the program's snapshot for the check, the comparison against
the limits and the result line."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import resource
import sys
import time
from typing import Dict, NamedTuple, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Modules that no run may hold once its window has closed, by whole top-level
# name: the JAX stack and the JAX package the port was made from.
BANNED = ("jax", "jaxlib", "flax", "optax", "legged_gym_custom_tpu")


def process_start_time() -> float:
    """The wall-clock time at which this process started (Linux /proc), so
    that `setup_s` counts the interpreter's and the imports' time too."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def load_json(kind: str, name: str) -> dict:
    """`portbench/<kind>/<name>.json`: a configuration or a workload."""
    path = os.path.join(HERE, kind, name + ".json")
    if not os.path.exists(path):
        raise SystemExit(f"portbench: no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_workload(name: str) -> dict:
    """A cell: its own file, with its traffic mix's parameters beneath it."""
    cell = load_json("workloads", name)
    return {**load_json("traffic", cell["traffic"]), **cell}


def load_module(kind: str, name: str):
    """`portbench/<kind>/<name>.py` as a module (a driver or a metric
    reader); loaded by path, so a name may hold dots."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise SystemExit(f"portbench: no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def metrics_for(cell: str, section: str) -> list:
    """The `end_to_end` or `per_layer` entries of BENCHMARK.json that this
    cell reports: those that list it, and those that list no cells."""
    return [m for m in benchmark()[section] if cell in m.get("workloads", [cell])]


class Seeds(NamedTuple):
    terrain: int
    runner: int
    weights: int
    sample: int


def seeds(seed: int) -> Seeds:
    """Four independent 31-bit seeds from the run's seed (which may exceed
    32 bits): the terrain, the program's generator, the weights and the
    choice of what the check samples."""
    s = np.random.SeedSequence(int(seed)).generate_state(4)
    return Seeds(*[int(x) & 0x7FFFFFFF for x in s])


def make_weights(module, seed: int, device):
    """Every weight of `module` from the seed, on `device`, in one draw:
    N(0, 1/fan_in) for matrices and kernels, N(0, 0.05^2) for biases; a
    policy's action std stays at the config's initial value, and a weight
    with no elements (a layer on an empty input) draws nothing."""
    import torch

    params = [(n, p) for n, p in module.named_parameters() if n != "std" and p.numel()]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(p.numel() for _, p in params), generator=g, device=device)
    off = 0
    with torch.no_grad():
        for _, p in params:
            n = p.numel()
            scale = 1.0 / math.sqrt(p[0].numel()) if p.dim() > 1 else 0.05
            p.copy_(flat[off:off + n].view_as(p) * scale)
            off += n


def seeded_networks(cfgs, seed: int, device) -> Dict[str, str]:
    """The networks a task loads from a file, made from the weights seed, so
    that the program and the reference load the same file through their own
    loaders.  Where the env config has `control.use_actuator_network`, the
    SEA actuator network: `nn.LSTM(2, 8, 2)` over [position error, velocity]
    and `nn.Linear(8, 1)` to the torque (the shapes `models/actuator_net.py`
    reads), drawn as `make_weights` draws, with `in_scale` and `out_scale` 1,
    written as TorchScript to `build/portbench/sea_lstm_<seed>.pt` inside the
    checkout.  Sets the file on the configs `cfgs` and returns the override
    that names it, to add to the run's overrides."""
    import torch

    if not getattr(cfgs[0].control, "use_actuator_network", False):
        return {}

    class SeaNetwork(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lstm = torch.nn.LSTM(2, 8, 2, batch_first=True)
            self.linear = torch.nn.Linear(8, 1)
            self.register_buffer("in_scale", torch.ones(2))
            self.register_buffer("out_scale", torch.ones(()))

        def forward(self, x, hc: Tuple[torch.Tensor, torch.Tensor]):
            y, (h, c) = self.lstm(x * self.in_scale, hc)
            return self.linear(y) * self.out_scale, (h, c)

    net = SeaNetwork().to(device)
    make_weights(net, seed, device)
    path = os.path.join(ROOT, "build", "portbench", f"sea_lstm_{seed}.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.jit.script(net.cpu().eval()).save(path + ".tmp")
    os.replace(path + ".tmp", path)
    set_path(cfgs, "control.actuator_net_file", path)
    return {"control.actuator_net_file": path}


def require_cards(chips: int):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"portbench: the cell needs {chips} CUDA device(s); "
                         f"torch.cuda.is_available()={torch.cuda.is_available()}, count {n}")


def set_environment():
    """Every build and kernel cache inside the checkout, at fixed paths: the
    port's kernels build into `build/kernels/` (its own fixed path); torch's
    and Triton's caches go beside it.  One CPU thread for torch's and the
    BLAS's pools: the host launches the work, and idle pool threads only
    compete with it for the cores."""
    os.environ["OMP_NUM_THREADS"] = "1"
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ["USE_FLAX"] = "0"


def set_path(cfgs, dotted: str, value):
    """Set `section.key` (deeper keys dotted too) on whichever of the
    (env, train) config objects has the section."""
    head, *rest = dotted.split(".")
    obj = getattr(next(c for c in cfgs if hasattr(c, head)), head)
    for k in rest[:-1]:
        obj = getattr(obj, k)
    setattr(obj, rest[-1], value)


def get_path(cfgs, dotted: str):
    head, *rest = dotted.split(".")
    obj = getattr(next(c for c in cfgs if hasattr(c, head)), head)
    for k in rest:
        obj = getattr(obj, k)
    return obj


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def snapshot(x):
    """A deep copy of the program's state in plain containers: tensors
    cloned, a dataclass or named tuple as a dict of its fields, a generator
    as its state."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, torch.Generator):
        return {"generator_state": x.get_state(), "device": str(x.device)}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: snapshot(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: snapshot(v) for k, v in zip(x._fields, x)}
    if isinstance(x, (tuple, list)):
        return type(x)(snapshot(v) for v in x)
    if isinstance(x, dict):
        return {k: snapshot(v) for k, v in x.items()}
    return x


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, the compared numbers with their limits).  A number missing
    or not finite fails; so does one above its limit."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok &= bool(good)
        out[name] = {"value": None if v is None else float(v), "limit": float(limit)}
    return ok, out


def device_info(chips: int) -> dict:
    import torch

    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}


class HostSample:
    """The host's state over a stretch of a run, to tell the program's own
    variation from the machine's (printed on standard error, compared with
    nothing): this process's CPU seconds beside the wall seconds, and the
    milliseconds that a fixed pure-Python loop takes at the stretch's start
    and end, a measure of how fast the host's core runs at that moment."""

    def __init__(self):
        self.probe_ms = probe_ms()
        self.t = time.perf_counter()
        self.ru = resource.getrusage(resource.RUSAGE_SELF)

    def since(self) -> dict:
        wall = time.perf_counter() - self.t
        ru = resource.getrusage(resource.RUSAGE_SELF)
        cpu = lambda r: r.ru_utime + r.ru_stime
        return {"wall_s": wall, "process_cpu_s": cpu(ru) - cpu(self.ru),
                "probe_ms": [self.probe_ms, probe_ms()]}


def probe_ms(n: int = 500_000) -> float:
    t = time.perf_counter()
    x = 0
    for i in range(n):
        x += i * i
    return (time.perf_counter() - t) * 1e3
