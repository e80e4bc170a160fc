"""Where the tick-wise control step of a stateful actuator departs from the
eager engine, and whether by rounding or by a fault.

    python -m legged_gym_custom_tpu_torch.scripts.tickwise_witness \
        [--envs 4096] [--steps 12] [--seed 0] [--device cuda] [--out witness.json]

For ANYmal-C on its rough trimesh terrain (`anymal_c_rough`) and on the
plane (`anymal_c_flat`), with a SEA network drawn from `--seed` (weights
N(0, 1/fan_in), biases N(0, 0.05^2), input and output scale 1), the env is
reset at random episode lengths and driven `--steps` env steps by random
actions; on the states it reaches, three comparisons, each on identical
state, actions, domain randomization, actuator state and terrain window:

* `tick`: one launch of the one-tick 'T' spec (`fused_step.tick_spec`)
  against one tick of the eager engine, both with the SEA network's first
  torques;
* `fixed`: the tick-wise path (`physics.tickwise_control_step`) with a
  torque function that ignores the state, against the eager loop with it;
* `lstm`: the tick-wise path with the SEA network against the eager loop.

Each leaf reads each env's largest gap over the leaf's RMS (the benchmark's
per-env gap), as its median, 99th percentile and largest.  Each path is
also held against the eager engine in float64 on the same float32 inputs,
the answer both float32 paths round away from: where the float32 eager
engine lies as far from it as the tick-wise path does, the gap between them
is rounding; a fault would put the tick-wise path farther.  On CUDA tensors
the tick-wise path runs the kernel, on CPU tensors its plain version; the
envs are built with the kernel on (`LGC_FUSED_KERNEL` not 0).

Prints one JSON object with the card's name and power limit, also written
to `--out`."""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict

import torch

from legged_gym_custom_tpu_torch import physics as phys
from legged_gym_custom_tpu_torch.bench import device_info
from legged_gym_custom_tpu_torch.envs import task_registry
from legged_gym_custom_tpu_torch.envs.anymal_env import sea_torque_fn
from legged_gym_custom_tpu_torch.ops import fused_step
from legged_gym_custom_tpu_torch.physics.actuator import LSTMWeights

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
STATE = ("base_pos", "base_quat", "lin_vel", "ang_vel", "dof_pos", "dof_vel")
INFO = ("link_forces", "link_pos", "link_vel", "torques")


def seeded_sea_weights(seed: int, device) -> LSTMWeights:
    """A SEA network of the published shape (2-layer LSTM over [position
    error, velocity], hidden 8, linear head) drawn from `seed`: matrices
    N(0, 1/fan_in), biases N(0, 0.05^2), in the order of `nn.LSTM`'s and
    `nn.Linear`'s parameters; input and output scale 1."""
    g = torch.Generator().manual_seed(seed)
    draw = lambda *shape: torch.randn(shape, generator=g) * (
        1.0 / math.sqrt(shape[-1]) if len(shape) > 1 else 0.05)
    w_ih, w_hh, b_ih, b_hh = [], [], [], []
    for n_in in (2, 8):
        w_ih.append(draw(32, n_in))
        w_hh.append(draw(32, 8))
        b_ih.append(draw(32))
        b_hh.append(draw(32))
    w_out, b_out = draw(1, 8), draw(1)
    to = lambda x: x.to(device)
    return LSTMWeights(tuple(map(to, w_ih)), tuple(map(to, w_hh)), tuple(map(to, b_ih)),
                       tuple(map(to, b_hh)), to(w_out), to(b_out.reshape(())),
                       to(torch.ones(2)), to(torch.ones(())))


def write_sea_network(weights: LSTMWeights, path: str) -> str:
    """`weights` as the TorchScript module the ANYmal env loads
    (`models/actuator_net.py`)."""
    class Sea(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lstm = torch.nn.LSTM(2, 8, 2, batch_first=True)
            self.linear = torch.nn.Linear(8, 1)
            self.register_buffer("in_scale", torch.ones(2))
            self.register_buffer("out_scale", torch.ones(()))

        def forward(self, x, hc: tuple[torch.Tensor, torch.Tensor]):
            y, (h, c) = self.lstm(x * self.in_scale, hc)
            return self.linear(y) * self.out_scale, (h, c)

    net = Sea()
    with torch.no_grad():
        for k in range(2):
            for name, src in (("weight_ih", weights.w_ih), ("weight_hh", weights.w_hh),
                              ("bias_ih", weights.b_ih), ("bias_hh", weights.b_hh)):
                getattr(net.lstm, f"{name}_l{k}").copy_(src[k].cpu())
        net.linear.weight.copy_(weights.w_out.cpu())
        net.linear.bias.copy_(weights.b_out.cpu().reshape(1))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.jit.script(net.eval()).save(path)
    return path


def cast(x, dtype):
    """`x` with every floating tensor inside it (named tuples, tuples) in
    `dtype`."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[cast(v, dtype) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(cast(v, dtype) for v in x)
    return x


def fixed_torque_fn(tau):
    def torque_fn(actions, dof_pos, dof_vel, act_state):
        return tau, act_state
    return torque_fn


def gaps(a: torch.Tensor, b: torch.Tensor) -> Dict[str, float]:
    """Each env's largest absolute gap over the leaf's RMS in `b` (batch
    last): median, 99th percentile, largest; and the largest absolute gap."""
    a, b = a.double(), b.double()
    scale = float(torch.sqrt(torch.mean(b * b)).clamp(min=1e-6))
    per_env = (a - b).abs().reshape(-1, a.shape[-1]).amax(dim=0)
    rel = per_env / scale
    return {"median": float(rel.median()), "p99": float(torch.quantile(rel, 0.99)),
            "max": float(rel.max()), "abs_max": float(per_env.max()), "rms": scale}


def leaves(state, info, act=None) -> Dict[str, torch.Tensor]:
    out = dict(zip(STATE, state))
    out.update(zip(INFO, (info.link_forces, info.link_pos, info.link_vel, info.torques)))
    if act is not None:
        out.update(hidden=act[0], cell=act[1])
    return out


def compare(paths: Dict[str, Dict[str, torch.Tensor]]) -> dict:
    """Leaf by leaf: the tick-wise (or kernel) path against the float32
    eager engine, and each against the float64 one."""
    k, e, t = paths["kernel"], paths["eager"], paths["eager64"]
    out = {}
    for name in e:
        out[name] = {"kernel_vs_eager": gaps(k[name], e[name]),
                     "kernel_vs_f64": gaps(k[name], t[name]),
                     "eager_vs_f64": gaps(e[name], t[name])}
    worst = lambda key: max(out, key=lambda n: out[n][key]["p99"])
    out["_worst"] = {key: [worst(key), out[worst(key)][key]["p99"]]
                     for key in ("kernel_vs_eager", "kernel_vs_f64", "eager_vs_f64")}
    return out


def reached_states(task: str, envs: int, steps: int, seed: int, net_file: str, device):
    """The env, and the (C, B) physics state, domain randomization, actions
    and SEA state it reaches after `steps` env steps of random actions from
    a reset at random episode lengths."""
    env_cfg, _ = task_registry.get_cfgs(task)
    env_cfg.env.num_envs = envs
    env_cfg.control.actuator_net_file = net_file
    env, _ = task_registry.make_env(task, args=argparse.Namespace(seed=seed), env_cfg=env_cfg,
                                    device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    state, _ = env.reset_all(gen, init_at_random_ep_len=True)
    a = torch.zeros(envs, env.num_actions, device=device)
    for _ in range(steps):
        a = torch.randn(envs, env.num_actions, generator=gen, device=device)
        state, *_ = env.step(state, a)
    a = torch.randn(envs, env.num_actions, generator=gen, device=device)
    to_cb = lambda x: x.movedim(0, -1).contiguous()
    return (env, phys.PhysicsState(*map(to_cb, state.physics)),
            phys.DomainRandParams(*map(to_cb, state.dr)), to_cb(a),
            tuple(map(to_cb, state.actuator_state)))


def witness(task: str, weights: LSTMWeights, envs: int, steps: int, seed: int, net_file: str,
            device) -> dict:
    env, state, dr, actions, act = reached_states(task, envs, steps, seed, net_file, device)
    spec = env.fused_spec
    one = fused_step.tick_spec(spec)
    base = (env.ma, env.hf, env.sim_params, env.pd, dr, env.dof_limits, state, actions)
    f64 = lambda x: cast(x, torch.float64)
    default = env.default_dof_pos[:, None]
    scale = env.cfg.control.action_scale
    sea, sea64 = sea_torque_fn(weights, scale, default), \
        sea_torque_fn(f64(weights), scale, f64(default))
    tlim = env.pd.torque_limits[:, None]
    tau0 = torch.maximum(torch.minimum(sea(actions, state.dof_pos, state.dof_vel, act)[0], tlim),
                         -tlim).contiguous()
    eager = lambda args, a, fn: phys.actuated_control_step(*args, a, fn, spec=None)
    out = {"task": task, "envs": envs, "terrain": "plane" if env.hf.is_plane else "trimesh",
           "window": one.hf_K}

    # tick: one launch of the one-tick spec, one tick of the eager engine
    terrain = None
    if one.hf_K:
        terrain = fused_step.patch_inputs(phys.patch.extract(env.hf, state.base_pos[0],
                                                             state.base_pos[1], one.hf_K))
    dr_in = tuple(dr)
    st, lf, tq, lp, lv = fused_step.fused_control_step(one, tuple(state), tau0, dr_in, terrain)
    tick = lambda args: args[:2] + (args[2]._replace(decimation=1),) + args[3:]
    e_st, e_info, _ = eager(tick(base), act, fixed_torque_fn(tau0))
    t_st, t_info, _ = eager(tick(f64(base)), f64(act), fixed_torque_fn(f64(tau0)))
    out["tick"] = compare({"kernel": leaves(st, phys.StepInfo(lf, lp, lv, tq)),
                           "eager": leaves(e_st, e_info), "eager64": leaves(t_st, t_info)})

    # fixed: the tick-wise path with a torque function that ignores the state
    k_st, k_info, _ = phys.tickwise_control_step(*base, act, fixed_torque_fn(tau0), spec)
    e_st, e_info, _ = eager(base, act, fixed_torque_fn(tau0))
    t_st, t_info, _ = eager(f64(base), f64(act), fixed_torque_fn(f64(tau0)))
    out["fixed"] = compare({"kernel": leaves(k_st, k_info), "eager": leaves(e_st, e_info),
                            "eager64": leaves(t_st, t_info)})

    # lstm: the tick-wise path with the SEA network
    k_st, k_info, k_act = phys.tickwise_control_step(*base, act, sea, spec)
    e_st, e_info, e_act = eager(base, act, sea)
    t_st, t_info, t_act = eager(f64(base), f64(act), sea64)
    out["lstm"] = compare({"kernel": leaves(k_st, k_info, k_act),
                           "eager": leaves(e_st, e_info, e_act),
                           "eager64": leaves(t_st, t_info, t_act)})
    return out


def main(argv=None):
    p = argparse.ArgumentParser("tickwise_witness")
    p.add_argument("--envs", type=int, default=4096)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tasks", default="anymal_c_rough,anymal_c_flat")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    weights = seeded_sea_weights(args.seed, device)
    net_file = write_sea_network(weights, os.path.join(ROOT, "build", "witness",
                                                       f"sea_{args.seed}.pt"))
    result = {"card": device_info(device), "seed": args.seed, "steps": args.steps}
    for task in args.tasks.split(","):
        with torch.no_grad():
            result[task] = witness(task, weights, args.envs, args.steps, args.seed, net_file,
                                   device)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return result


if __name__ == "__main__":
    main()
