"""The plain reference of the training cells, on the frozen copy of the
port's plain modules (`frozen/`): its own env (eager engine, its own terrain
from the same seed) and its own networks and PPO / DAgger update.

A rollout is chaotic (contact thresholds flip on rounding), so the reference
follows the program step by step from the program's own recorded state: the
env steps that the check samples, from the state and generator the program
stepped from; the collection's policy and critic forward passes on the
program's observations; each update, from the parameters, optimizer state,
rollout and generator it began with: its first three optimizer steps one by
one, the number of steps it took and the parameters' change over all of
them.  The weights the first update begins with are the benchmark's, made
from the seed; every later state is the program's."""
from __future__ import annotations

import contextlib
import random
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from . import compare
from ..harness import set_path
from .frozen.envs import TASKS
from .frozen.envs.base_env import EnvState, Obs
from .frozen.models.networks import ActorCriticNetworks
from .frozen.physics.engine import DomainRandParams, PhysicsState
from .frozen.rl import ppo

CHECK_STEPS = 3          # optimizer steps the check follows one by one
ADAM_BETA1 = 0.9         # torch.optim.Adam's default, as the port uses it


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matrix products with TF32 off (the port's precision), or on
    (the control: the nearest precision below)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def configs(task: str, overrides: Dict[str, object]):
    _, env_cls, train_cls = TASKS[task]
    cfgs = env_cls(), train_cls()
    for k, v in overrides.items():
        set_path(cfgs, k, v)
    return cfgs


def make_env(task: str, overrides, terrain_seed: int, device):
    """The reference's env; the global generators seeded as the program's
    registry seeds them for the same terrain seed."""
    env_cfg, _ = configs(task, overrides)
    random.seed(terrain_seed)
    np.random.seed(terrain_seed)
    return TASKS[task][0](env_cfg, env_cfg.asset.file, name=task, device=device,
                          terrain_seed=terrain_seed)


def generator(snap) -> torch.Generator:
    g = torch.Generator(device=snap["device"])
    g.set_state(snap["generator_state"])
    return g


def to_state(snap) -> EnvState:
    """The program's recorded env state as the reference's EnvState."""
    fields = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in snap.items()}
    fields["physics"] = PhysicsState(**{k: v.clone() for k, v in snap["physics"].items()})
    fields["dr"] = DomainRandParams(**{k: v.clone() for k, v in snap["dr"].items()})
    fields["rng"] = generator(snap["rng"])
    return EnvState(**fields)


def _actuator(act_state) -> Dict[str, torch.Tensor]:
    """A stateful actuator's state, the SEA LSTM's (hidden, cell) pair,
    batch-leading, as outputs of the step; none for a stateless env's (B,)
    placeholder."""
    if not isinstance(act_state, (tuple, list)):
        return {}
    return {f"actuator.{i}": v for i, v in enumerate(act_state)}


def step_outputs(state: EnvState, obs: Obs, rew, done) -> Dict[str, torch.Tensor]:
    out = {"physics." + k: v for k, v in state.physics._asdict().items()}
    out.update({"obs." + k: v for k, v in obs._asdict().items()})
    out.update(rew=rew, obs_history=state.obs_history, commands=state.commands)
    out.update(_actuator(state.actuator_state))
    return out


def program_outputs(out) -> Dict[str, torch.Tensor]:
    state, obs, rew, done = out
    d = {"physics." + k: v for k, v in state["physics"].items()}
    d.update({"obs." + k: v for k, v in obs.items()})
    d.update(rew=rew, obs_history=state["obs_history"], commands=state["commands"])
    d.update(_actuator(state["actuator_state"]))
    return d


def env_step_gaps(env, rec, tf32: bool = False, fault: str = None) -> dict:
    """Each env's largest gap over the step's outputs (physics state, the
    five observation streams, the history, commands, rewards, and a stateful
    actuator's state where the env has one), which envs
    the reference reset, and how many envs' reset decision differs.
    `fault`, held against the reference in the program's place:
    "unchanged", a step that returns its input state and resets nothing;
    "reset_skipped", a step whose resetting envs keep the state they
    stepped from."""
    with precision(tf32), torch.no_grad():
        state, obs, rew, done, _ = env.step(to_state(rec["state"]), rec["actions"].clone())
    ref = step_outputs(state, obs, rew, done)
    reset = done.bool()
    if fault is None:
        prog = program_outputs(rec["out"])
        prog_done = rec["out"][3]
    else:
        old = rec["state"]["physics"]
        keep = reset if fault == "reset_skipped" else torch.ones_like(reset)
        prog = dict(ref)
        prog.update({"physics." + k: torch.where(keep.view((-1,) + (1,) * (v.dim() - 1)), v,
                                                 ref["physics." + k]) for k, v in old.items()})
        prog_done = torch.zeros_like(done) if fault == "unchanged" else done
    gaps = torch.stack([compare.per_env_gap(prog[k], ref[k]) for k in ref]).amax(dim=0)
    return {"per_env": gaps.cpu(), "reset": reset.cpu(),
            "done_mismatch": int((prog_done.bool() != reset).sum())}


def env_numbers(step_gaps: List[dict]) -> Dict[str, float]:
    """Over the sampled steps' envs: the median and 99th percentile of the
    gaps, their largest, the median over the envs that reset (0 where none
    did), and the envs whose reset decision differs."""
    g = torch.cat([s["per_env"] for s in step_gaps]).double()
    reset = g[torch.cat([s["reset"] for s in step_gaps])]
    return {"env_median": float(g.median()), "env_p99": float(torch.quantile(g, 0.99)),
            "env_max": float(g.max()),
            "env_reset_median": float(reset.median()) if reset.numel() else 0.0,
            "env_done_mismatch": float(sum(s["done_mismatch"] for s in step_gaps))}


def _nets(rec, env_cfg, train_cfg, device):
    e = env_cfg.env
    nets = ActorCriticNetworks(train_cfg.policy, num_proprio=e.num_proprio,
                               num_privileged_obs=e.num_privileged_obs,
                               num_critic_obs=e.num_critic_obs,
                               num_estimated_obs=e.num_estimated_obs, num_scan_obs=e.num_scan_obs,
                               num_actions=e.num_actions,
                               history_buffer_length=e.history_buffer_length).to(device)
    nets.load_state_dict(rec["params"])
    return nets


class Update(NamedTuple):
    """What one update did, as the check compares it: the loss of each of
    its first CHECK_STEPS optimizer steps, the first gradient, the
    parameters' change after CHECK_STEPS steps, the number of optimizer steps
    taken, and the parameters' change over the whole update."""
    losses: List[float]
    first: Dict[str, torch.Tensor]
    change: Dict[str, torch.Tensor]
    steps: int
    whole: Dict[str, torch.Tensor]


def run_update(rec, task: str, overrides, device, tf32: bool = False, half: bool = False,
               drop_last: bool = False):
    """The reference's collection forward passes and the whole update that
    `rec` recorded.  Returns (the Update, (action means, values) of the
    collection).  Faults, for the calibration: `half`, minibatches that
    leave out half the batch and take the mean over the rest; `drop_last`,
    an update that skips the optimizer step of each epoch's last
    minibatch."""
    env_cfg, train_cfg = configs(task, overrides)
    with precision(tf32):
        nets = _nets(rec, env_cfg, train_cfg, device)
        cfg = ppo.PPOConfig.from_cfg(train_cfg.algorithm, resume=False)
        ts = ppo.TrainState(nets, cfg)
        for name, opt in (("policy", ts.opt_policy), ("adapt", ts.opt_adapt), ("est", ts.opt_est)):
            opt.load_state_dict(rec["opt"][name])
        ts.learning_rate, ts.total_updates = rec["learning_rate"], rec["total_updates"]
        traj = ppo.Transition(**rec["traj"])
        dagger = rec["kind"] == "dagger"
        T, B = traj.rewards.shape
        flat = lambda x: x.reshape((T * B,) + tuple(x.shape[2:]))
        with torch.no_grad():
            obs = flat(traj.obs)
            mean = nets.action_mean(obs, flat(traj.privileged), nets.estimate(obs),
                                    flat(traj.scan), dagger).reshape(traj.mu.shape)
            values = nets.value(flat(traj.critic)).reshape(traj.values.shape)
            # The update starts from the rollout as the program recorded it
            # (its values, means and log-probabilities, which `mean` and
            # `values` check): recomputed ones differ at rounding, and that
            # flips the clipped surrogate of samples at the clip's edge.
            returns, adv = ppo.compute_gae(traj, nets.value(rec["final_critic_obs"]),
                                           cfg.gamma, cfg.lam)
        if half:
            B = traj.rewards.shape[1] // 2
            traj = ppo.Transition(*[x[:, :B] for x in traj])
            returns, adv = returns[:, :B], adv[:, :B]
        names = {p: n for n, p in nets.named_parameters()}
        opts = (ts.opt_adapt,) if dagger else (ts.opt_policy, ts.opt_est)
        before = {n: p.detach().clone() for n, p in nets.named_parameters()}
        losses, first, change = [], {}, {}
        moved = lambda: {n: nets.get_parameter(n).detach() - before[n] for n in first}
        nmb = cfg.num_mini_batches
        state = {"skip": False, "steps": 0}

        def record(i, loss):     # called before the optimizers' step i
            if i < CHECK_STEPS:
                losses.append(float(loss))
            if i == 1:     # Adam's state after the first step
                first.update(first_gradients(opts, names))
            if i == CHECK_STEPS:
                change.update(moved())
            state["skip"] = drop_last and i % nmb == nmb - 1

        for opt in opts:
            def step(*a, _step=opt.step, _last=opt is opts[-1], **k):
                if not state["skip"]:
                    state["steps"] += _last
                    return _step(*a, **k)
            opt.step = step
        gen = generator(rec["generator"])
        if dagger:
            ppo.dagger_update(cfg, ts, traj, gen, record=record)
        else:
            ppo.ppo_update(cfg, ts, traj, returns, adv, gen, record=record)
        if len(losses) == CHECK_STEPS and not change:     # an update of CHECK_STEPS steps
            change.update(moved())
    return Update(losses, first, change, state["steps"], moved()), (mean, values)


def first_gradients(opts, names) -> Dict[str, torch.Tensor]:
    """The first gradient as each optimizer got it, from its state after one
    step: Adam's first moment over (1 - beta1)."""
    out = {}
    for opt in opts:
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p)
                if st and "exp_avg" in st:
                    out[names[p]] = st["exp_avg"].detach().clone() / (1.0 - ADAM_BETA1)
    return out


def update_numbers(prog: Update, ref: Update) -> Dict[str, float]:
    """Gaps of one update: each of the first steps' loss, the first
    gradient by the worst leaf, the parameters' change after those steps
    and after the whole update by the worst moving leaf, and how many
    optimizer steps the program took more or fewer than the reference."""
    steps = float(abs(prog.steps - ref.steps))
    if len(prog.losses) != len(ref.losses) or set(prog.first) != set(ref.first) or \
            set(prog.change) != set(ref.change):    # a step that never came reads as failed
        return {"loss": float("inf"), "grad": float("inf"), "change": float("inf"),
                "update_change": float("inf"), "update_steps": steps}
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog.losses, ref.losses))
    moving = compare.moving_leaves(ref.first)
    return {"loss": loss, "grad": compare.leaf_norm_gap(prog.first, ref.first),
            "change": compare.leaf_norm_gap(prog.change, ref.change, moving),
            "update_change": compare.leaf_norm_gap(prog.whole, ref.whole, moving),
            "update_steps": steps}
