"""PPO with ROA regularization, state-estimator supervision and DAgger,
torch port of legged_gym_custom_tpu/rl/ppo.py (reference rsl_rl/algorithms/ppo.py).

  * clipped surrogate + clipped value loss + entropy bonus      (:248-270)
  * adaptive-KL learning rate (:234-246) or fixed schedule
  * ROA regularization ||priv_latent - sg(adapt_latent)|| with the linear
    coefficient schedule 0 -> 0.05 over updates 5000..15000   (:39-46, :211-221)
  * supervised estimator loss ||est(obs) - true||^2             (:223-231)
  * DAgger distillation of the adaptation encoder               (:309-349)
  * three Adam groups, each with its own global-norm gradient clip:
    policy (actor+critic+priv+scan+std) / adaptation / estimator (:58-70)
  * GAE with advantage normalization, one minibatch permutation reused
    across epochs, max-std clamp.

The optimizers are `torch.optim.Adam`; the global-norm clip follows optax's
`clip_by_global_norm` (scale by max_norm / norm only when norm >= max_norm).
Minibatch permutations come from a `torch.Generator`, or are passed in
(`perm`) so a test can feed both frameworks the same one.

Data parallel (`mesh`, parallel/mesh.py): each rank permutes and minibatches
only its local (T, B / n) shard; a minibatch's gradients and metrics are
averaged over the ranks in one all-reduce after `backward()`, before the
adaptive-KL branch reads the KL and before the clip (the JAX package's
`pmean` under `shard_map`, ppo.py:311-316, :397-399), so every rank takes
the same step.  GAE's advantage statistics are global (the all-reduce GSPMD
inserts in JAX, runner.py:247-248).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from portbench.reference.frozen.models.networks import ActorCriticNetworks
from portbench.reference.frozen.parallel.mesh import DataMesh, all_reduce_mean_, all_reduce_sum_


class PPOConfig(NamedTuple):
    clip_param: float = 0.2
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    value_loss_coef: float = 1.0
    entropy_coef: float = 0.01
    learning_rate: float = 1e-3
    estimator_learning_rate: float = 1e-3
    max_grad_norm: float = 1.0
    use_clipped_value_loss: bool = True
    schedule: str = "adaptive"
    desired_kl: float = 0.01
    gamma: float = 0.99
    lam: float = 0.95
    max_action_std: float = 1.0
    # ROA schedule (reference ppo.py:41-43); resume flips to flat 0.1
    roa_start_val: float = 0.0
    roa_end_val: float = 0.05
    roa_start_step: float = 5000.0
    roa_duration: float = 10000.0

    @staticmethod
    def from_cfg(alg_cfg, resume: bool = False) -> "PPOConfig":
        base = PPOConfig(
            clip_param=alg_cfg.clip_param,
            num_learning_epochs=alg_cfg.num_learning_epochs,
            num_mini_batches=alg_cfg.num_mini_batches,
            value_loss_coef=alg_cfg.value_loss_coef,
            entropy_coef=alg_cfg.entropy_coef,
            learning_rate=alg_cfg.learning_rate,
            estimator_learning_rate=getattr(alg_cfg, "estimator_learning_rate",
                                            alg_cfg.learning_rate),
            max_grad_norm=alg_cfg.max_grad_norm,
            use_clipped_value_loss=alg_cfg.use_clipped_value_loss,
            schedule=alg_cfg.schedule,
            desired_kl=alg_cfg.desired_kl,
            gamma=alg_cfg.gamma,
            lam=alg_cfg.lam,
        )
        if resume:
            base = base._replace(
                roa_start_val=0.0, roa_end_val=0.1, roa_start_step=0.0, roa_duration=1.0)
        return base


POLICY_GROUP = ("actor", "critic", "priv_encoder", "scan_encoder", "std")


def group_params(nets: ActorCriticNetworks, names) -> list:
    out = []
    for n in names:
        attr = getattr(nets, n)
        out.extend([attr] if isinstance(attr, torch.nn.Parameter) else attr.parameters())
    return out


class TrainState:
    """The networks, the three optimizers and the scalars the update carries."""

    def __init__(self, nets: ActorCriticNetworks, cfg: PPOConfig):
        self.nets = nets
        self.policy_params = group_params(nets, POLICY_GROUP)
        self.adapt_params = group_params(nets, ("adapt_encoder",))
        self.est_params = group_params(nets, ("estimator",))
        self.opt_policy = torch.optim.Adam(self.policy_params, lr=cfg.learning_rate)
        self.opt_adapt = torch.optim.Adam(self.adapt_params, lr=cfg.learning_rate)
        self.opt_est = torch.optim.Adam(self.est_params, lr=cfg.estimator_learning_rate)
        self.learning_rate = float(cfg.learning_rate)   # adaptive-KL LR (policy group)
        self.total_updates = 0.0                        # counts PPO + DAgger updates


class Transition(NamedTuple):
    """A rollout: every leaf is (T, B, ...)."""

    obs: torch.Tensor
    privileged: torch.Tensor
    critic: torch.Tensor
    estimated: torch.Tensor       # ground-truth estimator targets
    scan: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    values: torch.Tensor
    log_probs: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor


@torch.no_grad()
def policy_act(nets: ActorCriticNetworks, obs5, generator, adaptation_mode: bool):
    """Sample an action + bookkeeping (reference ppo.py:129-153)."""
    estimated = nets.estimate(obs5.obs)
    mean = nets.action_mean(obs5.obs, obs5.privileged, estimated, obs5.scan, adaptation_mode)
    std = nets.std.expand_as(mean)
    noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    actions = mean + std * noise
    log_prob = gaussian_log_prob(actions, mean, std)
    values = nets.value(obs5.critic)
    return actions, log_prob, mean, std, values


def gaussian_log_prob(x, mean, std):
    var = std ** 2
    lp = -0.5 * ((x - mean) ** 2 / var + torch.log(2 * math.pi * var))
    return torch.sum(lp, dim=-1)


def gaussian_entropy(std):
    return torch.sum(0.5 * torch.log(2 * math.pi * math.e * std ** 2), dim=-1)


@torch.no_grad()
def compute_gae(traj: Transition, last_values, gamma: float, lam: float,
                mesh: Optional[DataMesh] = None):
    """GAE over the (T, B) trajectory (rollout_storage.py:110-124).
    Returns (returns, normalized advantages).  With a mesh the normalization
    takes the mean and variance of the global batch: the sum, the sum of
    squares and the count, in float64, summed over the ranks."""
    T = traj.rewards.shape[0]
    adv = torch.zeros_like(last_values)
    v_next = last_values
    advantages = torch.empty_like(traj.values)
    for t in range(T - 1, -1, -1):
        not_terminal = 1.0 - traj.dones[t].float()
        delta = traj.rewards[t] + not_terminal * gamma * v_next - traj.values[t]
        adv = delta + not_terminal * gamma * lam * adv
        advantages[t] = adv
        v_next = traj.values[t]
    returns = advantages + traj.values
    if mesh is not None and mesh.distributed:
        a = advantages.double()
        stats = torch.stack([a.sum(), (a * a).sum(),
                             torch.tensor(float(a.numel()), dtype=torch.float64, device=a.device)])
        all_reduce_sum_(mesh, [stats])
        mean64 = stats[0] / stats[2]
        mean, var = mean64.float(), torch.clamp(stats[1] / stats[2] - mean64 ** 2, min=0).float()
    else:
        mean = advantages.mean()
        var = torch.mean((advantages - mean) ** 2)
    return returns, (advantages - mean) / (torch.sqrt(var) + 1e-8)


def roa_coefficient(cfg: PPOConfig, total_updates: float) -> float:
    stage = min(max((total_updates - cfg.roa_start_step) / cfg.roa_duration, 0.0), 1.0)
    return cfg.roa_start_val + stage * (cfg.roa_end_val - cfg.roa_start_val)


def clip_by_global_norm_(params, max_norm: float):
    """optax.clip_by_global_norm on the .grad of `params`, in place."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


def _pmean_grads_(mesh: DataMesh, params, metrics: torch.Tensor) -> torch.Tensor:
    """Average the .grad of `params` and the vector `metrics` over the ranks
    in one flat all-reduce; returns the averaged metrics.  A parameter
    without a gradient contributes zeros, so every rank's buffer has the
    same layout."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_mean_(mesh, [p.grad for p in params] + [metrics])
    return metrics


def _permutation(batch: int, mb_size: int, nmb: int, generator, perm, device):
    if perm is None:
        perm = torch.randperm(batch, generator=generator, device=device)
    return torch.as_tensor(perm, device=device)[: nmb * mb_size]


def ppo_update(cfg: PPOConfig, ts: TrainState, traj: Transition, returns, advantages,
               generator=None, perm: Optional[torch.Tensor] = None,
               mesh: Optional[DataMesh] = None, record=None) -> Dict[str, torch.Tensor]:
    """Full PPO update: epochs x minibatches (reference ppo.py:182-293).

    traj leaves are (T, B, ...), flattened to (T*B, ...) and permuted once;
    the same permutation is reused across epochs (rollout_storage.py:142).
    Updates `ts` in place and returns the mean metrics as 0-d tensors.
    With a mesh, `traj` is this rank's shard and `perm` this rank's
    permutation of it; the metrics are means over the ranks.
    """
    nets = ts.nets
    T, B = traj.rewards.shape
    batch = T * B
    nmb = cfg.num_mini_batches
    mb_size = batch // nmb
    flat = Transition(*[x.reshape((batch,) + tuple(x.shape[2:])) for x in traj])
    returns_f = returns.reshape(batch)
    adv_f = advantages.reshape(batch)
    perm = _permutation(batch, mb_size, nmb, generator, perm, returns.device)
    reg_coef = roa_coefficient(cfg, ts.total_updates)
    lr = ts.learning_rate
    sums: Dict[str, torch.Tensor] = {}
    n_steps = cfg.num_learning_epochs * nmb
    for i in range(n_steps):
        idx = perm[(i % nmb) * mb_size:(i % nmb + 1) * mb_size]
        t = Transition(*[x[idx] for x in flat])
        ret, adv = returns_f[idx], adv_f[idx]

        estimated = nets.estimate(t.obs)  # grads flow to the estimator only
        mean = nets.action_mean(t.obs, t.privileged, t.estimated, t.scan, adaptation_mode=False)
        std = nets.std.expand_as(mean)
        log_prob = gaussian_log_prob(t.actions, mean, std)
        value = nets.value(t.critic)
        entropy = gaussian_entropy(std)

        # ROA regularization (adapt latent is stop-gradient, ppo.py:211-216)
        priv_latent = nets.priv_encoder(t.privileged)
        with torch.no_grad():
            adapt_latent = nets.adapt_encoder(nets.history_part(t.obs))
        reg_loss = torch.mean(torch.linalg.norm(priv_latent - adapt_latent, dim=-1))
        est_loss = torch.mean(torch.sum((estimated - t.estimated) ** 2, dim=-1))

        ratio = torch.exp(log_prob - t.log_probs)
        surr = -adv * ratio
        surr_clipped = -adv * torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param)
        surrogate_loss = torch.mean(torch.maximum(surr, surr_clipped))
        if cfg.use_clipped_value_loss:
            v_clipped = t.values + torch.clamp(value - t.values, -cfg.clip_param, cfg.clip_param)
            value_loss = torch.mean(torch.maximum((value - ret) ** 2, (v_clipped - ret) ** 2))
        else:
            value_loss = torch.mean((ret - value) ** 2)
        loss = (surrogate_loss + cfg.value_loss_coef * value_loss
                - cfg.entropy_coef * torch.mean(entropy) + reg_coef * reg_loss)
        with torch.no_grad():
            kl = torch.mean(torch.sum(
                torch.log(std / t.sigma + 1e-5)
                + (t.sigma ** 2 + (t.mu - mean) ** 2) / (2.0 * std ** 2) - 0.5,
                dim=-1))

        ts.opt_policy.zero_grad(set_to_none=True)
        ts.opt_est.zero_grad(set_to_none=True)
        (loss + est_loss).backward()
        if mesh is not None and mesh.distributed:
            # the gradients and the metrics the adaptive LR reads, in one
            # all-reduce (JAX pmeans `aux` so that every rank's LR agrees)
            reduced = _pmean_grads_(mesh, ts.policy_params + ts.est_params, torch.stack(
                [value_loss.detach(), surrogate_loss.detach(), reg_loss.detach(),
                 est_loss.detach(), kl]))
            value_loss, surrogate_loss, reg_loss, est_loss, kl = reduced.unbind()

        # adaptive-KL LR (ppo.py:234-246), applied to this minibatch's step;
        # the host reads the KL here, once per minibatch, only in this mode
        if cfg.schedule == "adaptive" and cfg.desired_kl is not None:
            kl_host = kl.item()
            if kl_host > cfg.desired_kl * 2.0:
                lr = max(1e-5, lr / 1.5)
            elif 0.0 < kl_host < cfg.desired_kl / 2.0:
                lr = min(1e-2, lr * 1.5)
            for group in ts.opt_policy.param_groups:
                group["lr"] = lr
        clip_by_global_norm_(ts.policy_params, cfg.max_grad_norm)
        clip_by_global_norm_(ts.est_params, cfg.max_grad_norm)
        if record is not None:
            record(i, (loss + est_loss).detach())
        ts.opt_policy.step()
        ts.opt_est.step()

        for k, v in (("value_loss", value_loss), ("surrogate_loss", surrogate_loss),
                     ("reg_loss", reg_loss), ("est_loss", est_loss), ("kl_mean", kl)):
            sums[k] = sums.get(k, 0.0) + v.detach()

    with torch.no_grad():  # max-std clamp (ppo.py:301-307)
        nets.std.clamp_(max=cfg.max_action_std)
    metrics = {k: v / n_steps for k, v in sums.items()}
    metrics["reg_coef"] = torch.tensor(reg_coef)
    metrics["learning_rate"] = torch.tensor(lr)
    ts.learning_rate = lr
    ts.total_updates += 1.0
    return metrics


def dagger_update(cfg: PPOConfig, ts: TrainState, traj: Transition, generator=None,
                  perm: Optional[torch.Tensor] = None,
                  mesh: Optional[DataMesh] = None, record=None) -> Dict[str, torch.Tensor]:
    """Adaptation-encoder distillation (reference ppo.py:309-349).  With a
    mesh: this rank's shard and permutation, gradients and loss averaged
    over the ranks as in `ppo_update`."""
    nets = ts.nets
    T, B = traj.rewards.shape
    batch = T * B
    nmb = cfg.num_mini_batches
    mb_size = batch // nmb
    flat_obs = traj.obs.reshape((batch,) + tuple(traj.obs.shape[2:]))
    flat_priv = traj.privileged.reshape((batch,) + tuple(traj.privileged.shape[2:]))
    perm = _permutation(batch, mb_size, nmb, generator, perm, flat_obs.device)
    total = 0.0
    n_steps = cfg.num_learning_epochs * nmb
    for i in range(n_steps):
        idx = perm[(i % nmb) * mb_size:(i % nmb + 1) * mb_size]
        obs, priv = flat_obs[idx], flat_priv[idx]
        with torch.no_grad():
            priv_latent = nets.priv_encoder(priv)
        adapt_latent = nets.adapt_encoder(nets.history_part(obs))
        loss = torch.mean(torch.linalg.norm(priv_latent - adapt_latent, dim=-1))
        ts.opt_adapt.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None and mesh.distributed:
            loss = _pmean_grads_(mesh, ts.adapt_params, loss.detach().reshape(1))[0]
        clip_by_global_norm_(ts.adapt_params, cfg.max_grad_norm)
        if record is not None:
            record(i, loss.detach())
        ts.opt_adapt.step()
        total = total + loss.detach()
    ts.total_updates += 1.0
    return {"adaptation_loss": total / n_steps}
