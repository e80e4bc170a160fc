"""Training driver, torch port of legged_gym_custom_tpu/rl/runner.py
(reference rsl_rl/runners/on_policy_runner.py).

One iteration = a T-step rollout (policy act + env step, T = 24 for go2)
followed by a DAgger update when `it % dagger_update_freq == 0`, else a PPO
update (on_policy_runner.py:147,182-186).  The collection and learning
halves are timed separately (the device is synchronized at each boundary)
so the console block reports the reference's collection/learning split.

Episode bookkeeping stays on the device as per-env sums; the host reads the
iteration's scalars once.  Checkpoints hold the parameters and all three
optimizer states (utils/checkpoint.py); `load` restores them, and
`get_inference_policy` gives the deterministic (or sampling) policy that
`scripts/play.py` rolls out.

Data parallel (the env's `mesh`, parallel/mesh.py; JAX runner.py:73-105,
:255-305): the env is this rank's shard of `env.num_envs_global` envs (a
global count that does not divide is refused by
`parallel.multihost.local_env_count`, where it is an input); the parameters
are broadcast from rank 0 once; each rank's generator is seeded `seed +
rank`, so the ranks draw different actions.  The rollout issues no
collective: after it, one all-reduce each for the advantage statistics
(`ppo.compute_gae`) and for the episode statistics and terrain level (JAX
:157-163, :195-210); the update all-reduces each minibatch's gradients.
fps counts global env steps; only the primary rank prints and writes
TensorBoard; `save` is collective.
"""
from __future__ import annotations

import os
import time
from collections import deque
from contextlib import nullcontext
from typing import Optional

import torch

from legged_gym_custom_tpu_torch.models.networks import ActorCriticNetworks
from legged_gym_custom_tpu_torch.parallel.mesh import all_reduce_sum_, shard_params
from legged_gym_custom_tpu_torch.utils import checkpoint as checkpoint_lib
from . import ppo as ppo_lib
from .ppo import PPOConfig, Transition


class _EpisodeWindow:
    """Mean reward / episode length over the most recent ~`target_episodes`
    finished episodes, from per-iteration (rew_sum, len_sum, count) aggregates
    (the reference keeps a deque of the last 100 episodes,
    on_policy_runner.py:130-131,163-171)."""

    def __init__(self, target_episodes: int = 100, max_iters: int = 200):
        self.target = target_episodes
        self.entries = deque(maxlen=max_iters)

    def push(self, rew_sum: float, len_sum: float, count: int):
        if count > 0:
            self.entries.append((rew_sum, len_sum, count))

    def means(self):
        """Returns (mean_reward, mean_length, have_any)."""
        rew = length = n = 0.0
        for rs, ls, c in reversed(self.entries):
            rew += rs
            length += ls
            n += c
            if n >= self.target:
                break
        if n == 0:
            return 0.0, 0.0, False
        return rew / n, length / n, True


class OnPolicyRunner:
    def __init__(self, env, train_cfg, log_dir: Optional[str] = None):
        self.env = env
        self.device = env.device
        self.cfg = train_cfg.runner
        self.alg_cfg = train_cfg.algorithm
        self.policy_cfg = train_cfg.policy
        self.log_dir = log_dir
        self.writer = None
        self.mesh = mesh = env.mesh
        self.is_primary = mesh is None or mesh.is_primary

        seed = getattr(train_cfg, "seed", 1)
        rank = mesh.rank if mesh is not None else 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed + rank)
        init_gen = torch.Generator().manual_seed(seed)
        ecfg = env.cfg.env
        self.nets = ActorCriticNetworks(
            self.policy_cfg,
            num_proprio=ecfg.num_proprio,
            num_privileged_obs=ecfg.num_privileged_obs,
            num_critic_obs=ecfg.num_critic_obs,
            num_estimated_obs=ecfg.num_estimated_obs,
            num_scan_obs=ecfg.num_scan_obs,
            num_actions=ecfg.num_actions,
            history_buffer_length=ecfg.history_buffer_length,
            generator=init_gen,
        ).to(self.device)
        shard_params(mesh, self.nets)
        self.ppo_cfg = PPOConfig.from_cfg(self.alg_cfg, resume=self.cfg.resume)
        self.train_state = ppo_lib.TrainState(self.nets, self.ppo_cfg)
        self.dagger_update_freq = self.alg_cfg.dagger_update_freq
        self.num_steps_per_env = self.cfg.num_steps_per_env
        self.save_interval = self.cfg.save_interval

        self.tot_timesteps = 0
        self.tot_time = 0.0
        self.current_learning_iteration = 0
        self.env_state = None
        self.obs = None
        self.collection_time = 0.0
        self.learn_time = 0.0
        B = env.num_envs
        self._cur_rew = torch.zeros(B, device=self.device)
        self._cur_len = torch.zeros(B, dtype=torch.long, device=self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _collect(self, adaptation_mode: bool):
        """Rollout + GAE (the reference's 'collection' half,
        on_policy_runner.py:149-181)."""
        env, nets, cfg = self.env, self.nets, self.ppo_cfg
        B = env.num_envs
        ep = torch.zeros((B, len(env.episode_sum_names)), device=self.device)
        fin_rew = torch.zeros(B, device=self.device)
        fin_len = torch.zeros(B, dtype=torch.long, device=self.device)
        fin_count = torch.zeros(B, dtype=torch.long, device=self.device)
        steps = []
        obs = self.obs
        for _ in range(self.num_steps_per_env):
            actions, log_prob, mu, sigma, values = ppo_lib.policy_act(
                nets, obs, self.generator, adaptation_mode)
            self.env_state, next_obs, rewards, dones, info = env.step(self.env_state, actions)
            # time-out bootstrap (reference ppo.py:165-166)
            rewards_b = rewards + cfg.gamma * values * info["time_outs"].float()
            steps.append(Transition(
                obs=obs.obs, privileged=obs.privileged, critic=obs.critic,
                estimated=obs.estimated, scan=obs.scan, actions=actions,
                rewards=rewards_b, dones=dones, values=values, log_probs=log_prob,
                mu=mu, sigma=sigma,
            ))
            self._cur_rew += rewards  # raw rewards, not bootstrapped
            self._cur_len += 1
            ep += info["episode_contrib"]
            fin_rew += torch.where(dones, self._cur_rew, 0.0)
            fin_len += torch.where(dones, self._cur_len, 0)
            fin_count += dones.long()
            self._cur_rew = torch.where(dones, 0.0, self._cur_rew)
            self._cur_len = torch.where(dones, 0, self._cur_len)
            obs = next_obs
        self.obs = obs
        traj = Transition(*[torch.stack(x) for x in zip(*steps)])
        last_values = nets.value(obs.critic)
        returns, advantages = ppo_lib.compute_gae(traj, last_values, cfg.gamma, cfg.lam,
                                                  mesh=self.mesh)
        # episode means, weighted by the episodes that finished this iteration
        ep_sum, fin_rew_sum = ep.sum(dim=0), fin_rew.sum()
        fin_len_sum, n_resets = fin_len.sum().float(), fin_count.sum().float()
        curriculum = env.cfg.terrain.curriculum
        if self.mesh is not None and self.mesh.distributed:
            # the one cross-rank reduction of the episode statistics
            level_sum = self.env_state.terrain_levels.float().sum().reshape(1)
            all_reduce_sum_(self.mesh, [ep_sum, fin_rew_sum, fin_len_sum, n_resets, level_sum])
            terrain_level = level_sum[0] / env.num_envs_global
        elif curriculum:
            terrain_level = self.env_state.terrain_levels.float().mean()
        denom = torch.clamp(n_resets, min=1.0)
        logs = dict(
            episode=ep_sum / denom / env.max_episode_length_s,
            fin_rew_sum=fin_rew_sum,
            fin_len_sum=fin_len_sum,
            fin_count=n_resets,
        )
        if curriculum:
            # curriculum telemetry from the post-rollout state (reference
            # runner.py:208-211)
            logs["terrain_level"] = terrain_level
        return traj, returns, advantages, logs

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _phase(self, name: str):
        """Record the collectives of the block under `name` (comm_budget)."""
        return self.mesh.comm.in_phase(name) if self.mesh is not None else nullcontext()

    def run_iteration(self, adaptation_mode: bool):
        """One collection + update; returns (metrics, logs) as host floats."""
        t0 = time.time()
        with self._phase("collect"):
            traj, returns, advantages, logs = self._collect(adaptation_mode)
        self._sync()
        t1 = time.time()
        self.collection_time = t1 - t0
        with self._phase("update"):
            if adaptation_mode:
                metrics = ppo_lib.dagger_update(self.ppo_cfg, self.train_state, traj,
                                                self.generator, mesh=self.mesh)
            else:
                metrics = ppo_lib.ppo_update(self.ppo_cfg, self.train_state, traj, returns,
                                             advantages, self.generator, mesh=self.mesh)
        metrics["mean_std"] = self.nets.std.detach().mean()
        self._sync()
        self.learn_time = time.time() - t1
        metrics = {k: float(v) for k, v in metrics.items()}
        episode = dict(zip(self.env.episode_sum_names, logs.pop("episode").tolist()))
        logs = {k: float(v) for k, v in logs.items()}
        logs["episode"] = {"rew_" + k: v for k, v in episode.items()}
        if "terrain_level" in logs:
            logs["episode"]["terrain_level"] = logs.pop("terrain_level")
        return metrics, logs

    # ------------------------------------------------------------------
    def learn(self, num_learning_iterations: int, init_at_random_ep_len: bool = False):
        if self.log_dir is not None and self.writer is None and self.is_primary:
            os.makedirs(self.log_dir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # tensorboard is optional; the console block stays
                SummaryWriter = None
            if SummaryWriter is not None:
                self.writer = SummaryWriter(log_dir=self.log_dir, flush_secs=10)

        if self.env_state is None:
            self.env_state, self.obs = self.env.reset_all(
                self.generator, init_at_random_ep_len=init_at_random_ep_len)

        ep_window = _EpisodeWindow(target_episodes=100)
        tot_iter = self.current_learning_iteration + num_learning_iterations
        history = []
        for it in range(self.current_learning_iteration, tot_iter):
            start = time.time()
            use_adaptation = it % self.dagger_update_freq == 0
            metrics, logs = self.run_iteration(use_adaptation)
            iter_time = time.time() - start
            ep_window.push(logs["fin_rew_sum"], logs["fin_len_sum"], int(logs["fin_count"]))
            steps = self.num_steps_per_env * self.env.num_envs_global
            self.tot_timesteps += steps
            self.tot_time += iter_time
            fps = steps / iter_time
            if self.is_primary:
                self._log(it, tot_iter, metrics, logs, fps, ep_window)
            history.append(dict(
                iteration=it, update="dagger" if use_adaptation else "ppo",
                env_steps_per_s=fps, collection_s=self.collection_time,
                learning_s=self.learn_time, **metrics,
                **{k: v for k, v in logs["episode"].items() if k == "terrain_level"},
            ))
            self.current_learning_iteration = it + 1
            if it % self.save_interval == 0 and self.log_dir is not None:
                self.save(os.path.join(self.log_dir, f"model_{it}.pt"))
        if self.log_dir is not None:
            self.save(os.path.join(self.log_dir, f"model_{tot_iter}.pt"))
        return history

    # ------------------------------------------------------------------
    def _log(self, it, tot_iter, m, logs, fps, ep_window, width=80, pad=35):
        mean_reward, mean_len, have_eps = ep_window.means()
        if self.writer is not None:
            for key, val in logs["episode"].items():
                self.writer.add_scalar("Episode/" + key, val, it)
            self.writer.add_scalar("Loss/value_function", m.get("value_loss", 0.0), it)
            self.writer.add_scalar("Loss/surrogate", m.get("surrogate_loss", 0.0), it)
            self.writer.add_scalar("Loss/regularization", m.get("reg_loss", 0.0), it)
            self.writer.add_scalar("Loss/regularization coef", m.get("reg_coef", 0.0), it)
            self.writer.add_scalar("Loss/adaptation", m.get("adaptation_loss", 0.0), it)
            self.writer.add_scalar("Loss/estimator", m.get("est_loss", 0.0), it)
            self.writer.add_scalar("Loss/learning_rate", m.get("learning_rate", 0.0), it)
            self.writer.add_scalar("Policy/mean_noise_std", m.get("mean_std", 0.0), it)
            self.writer.add_scalar("Perf/total_fps", fps, it)
            self.writer.add_scalar("Perf/collection time", self.collection_time, it)
            self.writer.add_scalar("Perf/learning_time", self.learn_time, it)
            if have_eps:
                self.writer.add_scalar("Train/mean_reward", mean_reward, it)
                self.writer.add_scalar("Train/mean_episode_length", mean_len, it)
        lines = [
            "#" * width,
            f" Learning iteration {it}/{tot_iter} ".center(width),
            f"{'Computation:':>{pad}} {fps:.0f} steps/s (collection: "
            f"{self.collection_time:.3f}s, learning {self.learn_time:.3f}s)",
            f"{'Value function loss:':>{pad}} {m.get('value_loss', 0.0):.4f}",
            f"{'Surrogate loss:':>{pad}} {m.get('surrogate_loss', 0.0):.4f}",
            f"{'Adaptation loss:':>{pad}} {m.get('adaptation_loss', 0.0):.4f}",
            f"{'Regularization loss:':>{pad}} {m.get('reg_loss', 0.0):.4f}",
            f"{'Estimator loss:':>{pad}} {m.get('est_loss', 0.0):.4f}",
            f"{'Mean action noise std:':>{pad}} {m.get('mean_std', 0.0):.2f}",
        ]
        if have_eps:
            lines.append(f"{'Mean reward:':>{pad}} {mean_reward:.2f}")
            lines.append(f"{'Mean episode length:':>{pad}} {mean_len:.2f}")
        if "terrain_level" in logs["episode"]:
            lines.append(f"{'Mean terrain level:':>{pad}} {logs['episode']['terrain_level']:.3f}")
        lines.append(f"{'Total timesteps:':>{pad}} {self.tot_timesteps}")
        lines.append(f"{'Total time:':>{pad}} {self.tot_time:.2f}s")
        print("\n".join(lines), flush=True)

    # ------------------------------------------------------------------
    def save(self, path, infos=None):
        """Checkpoint the parameters, ALL THREE optimizer states and the
        iteration (the reference saves only the main optimizer,
        on_policy_runner.py:283-288).  With a mesh every rank calls it: the
        primary writes, then all pass a barrier."""
        checkpoint_lib.save_checkpoint(path, self.train_state, self.current_learning_iteration,
                                       infos, mesh=self.mesh)

    def load(self, path, load_optimizer=True):
        """Restore a checkpoint written by `save`: the parameters and, with
        `load_optimizer`, the three optimizer states, the learning rate and
        the update count; always the iteration.  Returns the saved `infos`."""
        payload = checkpoint_lib.load_checkpoint(path, map_location=self.device)
        ts = self.train_state
        self.nets.load_state_dict(payload["model_state_dict"])
        if load_optimizer:
            ts.opt_policy.load_state_dict(payload["optimizer_policy"])
            ts.opt_adapt.load_state_dict(payload["optimizer_adapt"])
            ts.opt_est.load_state_dict(payload["optimizer_est"])
            ts.learning_rate = float(payload["learning_rate"])
            ts.total_updates = float(payload["total_updates"])
        self.current_learning_iteration = payload["iter"]
        return payload.get("infos")

    def get_inference_policy(self, stochastic: bool = False):
        """Deterministic (or sampling) policy over the 5 obs streams
        (reference on_policy_runner.py:299-309): the estimator, then
        `action_mean`, with the adaptation encoder by default.

        stochastic=True returns a function with an extra `generator`
        argument (a `torch.Generator` on the policy's device) that samples
        mean + std * N(0, 1), the rollout-time behaviour.
        """
        nets = self.nets

        @torch.no_grad()
        def act_inference(obs5, adaptation_mode: bool = True):
            estimated = nets.estimate(obs5.obs)
            return nets.action_mean(obs5.obs, obs5.privileged, estimated, obs5.scan,
                                    adaptation_mode)

        if not stochastic:
            return act_inference

        @torch.no_grad()
        def act_sample(obs5, generator: torch.Generator, adaptation_mode: bool = True):
            mean = act_inference(obs5, adaptation_mode)
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
            return mean + nets.std * noise

        return act_sample
