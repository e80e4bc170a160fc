"""Behaviour-clone teacher-assisted jump trajectories into the policy mean,
torch port of legged_gym_custom_tpu/scripts/jump_distill.py.

Second half of the jump-teacher pipeline (`jump_teacher.py` collects the
dataset): regress the deterministic actor mean (the full inference path —
actor MLP + adaptation-latent encoder + scan encoder + estimator input,
exactly `OnPolicyRunner.get_inference_policy`) onto the executed actions of
assisted rollouts that crossed gaps.  Non-teacher steps carry the policy's
own actions, so they act as a trust region: the only behaviour that moves
is the jump window.

Every parameter of the networks goes to one Adam (optax.adam's defaults:
betas 0.9 / 0.999, eps 1e-8, bias-corrected), as the reference's
`tx.init(params0)`.  The loss reaches them through the adaptation path
only, so the privileged encoder, the critic and the action std get no
gradient and stay as they were: the reference's fault, kept (ROADMAP
Queue C).  The dataset moves to the device once; the batch indices are
drawn there.

The distilled checkpoint keeps the optimizer states of the source
checkpoint (`OnPolicyRunner.save` of the loaded runner), so a subsequent
PPO stage (`scripts.train --task go2_parkour_cliff --resume --load_run
<run>`) continues from it.

Run:
  python -m legged_gym_custom_tpu_torch.scripts.jump_distill \
      --dataset logs/jump_dataset.npz \
      --ckpt logs/go2_parkour/<run>/model_<it>.pt \
      --out logs/go2_parkour/distill/model_<it>.pt

Runs on the GPU unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from legged_gym_custom_tpu_torch import DEFAULT_DEVICE


def get_args(argv=None):
    ap = argparse.ArgumentParser("jump_distill")
    ap.add_argument("--dataset", default="logs/jump_dataset.npz")
    ap.add_argument("--ckpt", required=True, help="the source port checkpoint (.pt)")
    ap.add_argument("--task", default="go2_parkour_cliff")
    ap.add_argument("--out", default="logs/go2_parkour/distill/model_0.pt")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--teach_weight", type=float, default=4.0,
                    help="loss weight on teacher-override steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def _draw_indices(gen, batch, N):
    """One step's batch: `batch` dataset rows drawn uniformly with
    replacement."""
    return torch.randint(0, N, (batch,), generator=gen, device=gen.device)


def main(argv=None):
    """Distill and save; returns (the runner holding the distilled
    networks, the loss of every step)."""
    args = get_args(argv)

    from legged_gym_custom_tpu_torch.envs import task_registry
    from legged_gym_custom_tpu_torch.rl.runner import OnPolicyRunner

    ds = np.load(args.dataset)
    N = ds["obs"].shape[0]
    print(f"dataset: {N} samples, {int(ds['teach'].sum())} teacher steps, "
          f"widths {sorted(set(ds['width'].tolist()))}")

    env_cfg, train_cfg = task_registry.get_cfgs(args.task)
    env_cfg.env.num_envs = 8
    env_cfg.terrain.num_rows = 1
    env_cfg.terrain.num_cols = 1
    env_cfg.terrain.curriculum = False
    env, _ = task_registry.make_env(name=args.task, args=None, env_cfg=env_cfg,
                                    device=args.device)
    runner = OnPolicyRunner(env, train_cfg, log_dir=None)
    runner.load(args.ckpt)
    nets = runner.nets
    dev = runner.device

    T = lambda k: torch.as_tensor(ds[k], device=dev)
    obs_a, priv_a, scan_a, act_a = T("obs"), T("priv"), T("scan"), T("act")
    w_a = torch.where(T("teach"), args.teach_weight, 1.0)
    w_a = w_a / w_a.mean()

    opt = torch.optim.Adam(nets.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)

    def loss_fn(idx):
        obs, priv, scan = obs_a[idx], priv_a[idx], scan_a[idx]
        est = nets.estimate(obs)
        mean = nets.action_mean(obs, priv, est, scan, True)
        per = torch.mean((mean - act_a[idx]) ** 2, dim=-1)
        return torch.mean(per * w_a[idx])

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    losses = []
    for i in range(args.steps):
        idx = _draw_indices(gen, args.batch, N)
        opt.zero_grad(set_to_none=False)
        loss = loss_fn(idx)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if i % 200 == 0 or i == args.steps - 1:
            print(f"step {i}: bc_loss {float(losses[-1]):.5f}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    runner.save(args.out)
    print(f"saved distilled checkpoint -> {args.out}")
    return runner, [float(x) for x in losses]


if __name__ == "__main__":
    main()
