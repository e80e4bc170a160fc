"""Scripted jump-teacher, torch port of
legged_gym_custom_tpu/scripts/jump_teacher.py: break the >= 0.2 m
gap-commitment cliff.

The deterministic parkour policy walks INTO gap edges, and its stochastic
behaviour emits no successful launched jump at >= 0.2 m, so PPO has no
success signal to amplify.  This tool manufactures that signal: a scripted
open-loop crouch-extend-tuck-land primitive is injected when the robot
reaches a gap edge, the policy handles approach and landing, and the
successful assisted trajectories become a behaviour-cloning dataset
(`jump_distill.py`) that moves the deterministic mean onto the jump.

A per-env phase machine (approach -> crouch -> extend -> tuck -> land ->
policy) keyed on the course layout (the gap near edges, measured from the
generated heightfield) runs between env steps.  Here it is kept as tensors
on the env's device: a step copies nothing to the host but one boolean,
whether any env is still alive (the reference's early end, :314).  Only the
debug rows every 50 steps and the final statistics come back.  Every env
step is one launch of the fused kernel's heightfield variant (K3) on the
card.  The POLICY never sees the course layout: its observations are
unchanged (scandots + proprio), so the cloned behaviour is
perception-conditioned.

Modes:
  probe    batched jump-parameter grid search: each env runs a different
           (crouch, extend, tuck, trigger) combo over a single-width gap
           course; prints the top combos by gaps crossed.
  collect  roll N episodes at the chosen parameters over a width range,
           save (obs, privileged, scan, executed_action) for every step of
           every env that crossed >= min_cross gaps, to an .npz dataset.

Run:
  python -m legged_gym_custom_tpu_torch.scripts.jump_teacher --mode probe \
      --ckpt logs/go2_parkour/<run>/model_<it>.pt --gap_width 0.25
  python -m legged_gym_custom_tpu_torch.scripts.jump_teacher --mode collect \
      --ckpt logs/go2_parkour/<run>/model_<it>.pt \
      --widths 0.20,0.25,0.30 --out logs/jump_dataset.npz

Runs on the GPU unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import itertools
import json

import numpy as np
import torch

from legged_gym_custom_tpu_torch import DEFAULT_DEVICE

# phase machine states
POLICY, CROUCH, EXTEND, TUCK, LAND = 0, 1, 2, 3, 4

# joint order: [FL, FR, RL, RR] x [hip, thigh, calf] (physics/urdf.py
# dof_names; verified against the parsed go2.urdf)
HIP = np.array([0, 3, 6, 9])
THIGH = np.array([1, 4, 7, 10])
CALF = np.array([2, 5, 8, 11])


def teacher_action(phase, params, B):
    """Scripted action (action units: target = default + 0.25*a) per phase.

    crouch: fold thigh+calf (load the legs); extend: drive calf toward
    full extension with a thigh push (launch); tuck: refold for edge
    clearance.  Rear thighs get the extension push scaled by
    `extend_rear_gain` (the rear legs are the last to leave the ground in
    a bound).
    """
    a = np.zeros((B, 12), np.float32)
    c = phase == CROUCH
    a[np.ix_(c, THIGH)] = params["crouch_thigh"][c, None]
    a[np.ix_(c, CALF)] = -params["crouch_calf"][c, None]
    e = phase == EXTEND
    a[np.ix_(e, THIGH[:2])] = params["extend_thigh"][e, None]
    a[np.ix_(e, THIGH[2:])] = (
        params["extend_thigh"][e, None] * params["extend_rear_gain"][e, None]
    )
    a[np.ix_(e, CALF)] = params["extend_calf"][e, None]
    t = phase == TUCK
    a[np.ix_(t, THIGH)] = params["tuck_thigh"][t, None]
    a[np.ix_(t, CALF)] = -params["tuck_calf"][t, None]
    # land: reach forward-down with slightly extended calves so the PD
    # catches the impact on the feet, not a tucked shin/base
    ld = phase == LAND
    a[np.ix_(ld, THIGH)] = params["land_thigh"][ld, None]
    a[np.ix_(ld, CALF)] = params["land_calf"][ld, None]
    return a


DEFAULT_PARAMS = dict(
    crouch_steps=2, crouch_thigh=0.5, crouch_calf=0.8,
    extend_steps=4, extend_thigh=-1.2, extend_rear_gain=1.4,
    extend_calf=2.6, tuck_steps=4, tuck_thigh=1.0, tuck_calf=1.2,
    land_steps=6, land_thigh=0.2, land_calf=0.6,
    trigger_d=0.35, trigger_min_vx=0.8,
)


def param_grid():
    """Probe grid; vectorized over the env batch.

    First probe round learned: (a) the commit-stage policy brakes from
    ~4.5 m, so late triggers (<0.45 m) never fire — trigger early while
    there is still speed; (b) a crouch longer than ~4 steps bleeds the
    approach momentum; (c) tuck-landings die on base contact — hence the
    LAND phase.  The grid spans both signs of the thigh push because the
    hip-pitch convention decides which way the extension impulse tilts.
    """
    grid = dict(
        crouch_steps=[1, 3], crouch_thigh=[0.5], crouch_calf=[0.8],
        extend_steps=[3, 5], extend_thigh=[-1.2, 0.0, 1.2],
        extend_rear_gain=[1.0, 1.5], extend_calf=[2.4, 3.0],
        tuck_steps=[4], tuck_thigh=[1.0], tuck_calf=[1.2],
        land_steps=[6], land_thigh=[0.2], land_calf=[0.6],
        trigger_d=[0.25, 0.4, 0.55], trigger_min_vx=[0.8],
    )
    keys = list(grid)
    combos = list(itertools.product(*(grid[k] for k in keys)))
    return keys, combos


def build_env(task, num_envs, width, n_gaps=6, device=DEFAULT_DEVICE):
    """Single-width plain-gap course (6 gaps at x = 5, 8.5, ...)."""
    from legged_gym_custom_tpu_torch.envs import task_registry
    from legged_gym_custom_tpu_torch.physics.heightfield import height_bilinear

    env_cfg, train_cfg = task_registry.get_cfgs(task)
    env_cfg.env.num_envs = num_envs
    env_cfg.terrain.num_rows = 1
    env_cfg.terrain.num_cols = 1
    env_cfg.terrain.curriculum = False
    xs = [5.0 + 3.5 * k for k in range(n_gaps)]
    env_cfg.terrain.parkour_kwargs = dict(
        env_cfg.terrain.parkour_kwargs,
        x_positions=xs,
        y_positions=[0.0] * n_gaps,
        obstacle_heights=[-2.0] * n_gaps,
        obstacle_lengths=[width] * n_gaps,
    )
    env_cfg.init_state.rand_x_offsets = None
    env_cfg.init_state.rand_vx_range = None
    if hasattr(env_cfg, "termination"):
        env_cfg.termination.stall_time_s = 0.0
    env_cfg.noise.add_noise = False
    for k in [
        "randomize_friction", "push_robots", "randomize_base_mass",
        "randomize_center_of_mass", "randomize_kp_kd",
    ]:
        setattr(env_cfg.domain_rand, k, False)
    env, _ = task_registry.make_env(name=task, args=None, env_cfg=env_cfg, device=device)
    # measure the TRUE gap near-edges from the generated heightfield: the
    # generator centers each obstacle on x_position (and bilinear sampling
    # smooths the lip), so the config coordinates are ~width/2 + one cell
    # early.  Timed off the config coordinates, the launch fires with the
    # front feet already over the void.
    state0, _ = env.reset_all(torch.Generator(device=env.device).manual_seed(0))
    ox, oy = state0.env_origins[0, :2].cpu().numpy()
    xq = np.arange(3.0, xs[-1] + 3.0, 0.02, dtype=np.float32)
    hq = height_bilinear(
        env.hf, torch.as_tensor(ox + xq, device=env.device),
        torch.full(xq.shape, float(oy), dtype=torch.float32, device=env.device),
    ).cpu().numpy()
    drop = (hq[1:] < -0.5) & (hq[:-1] >= -0.5)
    near = xq[1:][drop].astype(np.float32)
    if len(near) != n_gaps:
        # the reference's fallback, with its fault: the config x are the
        # obstacles' centres, not their near edges (ROADMAP Queue C)
        print(f"# WARNING: measured {len(near)} gap edges, expected "
              f"{n_gaps}; falling back to config coords")
        near = np.asarray(xs, np.float32)
    else:
        print(f"# measured gap near-edges: {np.round(near, 2).tolist()} "
              f"(config said {xs})")
    return env, train_cfg, env_cfg, near


def _policy_noise(gen, shape):
    """The `--sigma` action noise of one step: standard normals from the
    rollout's own generator (seeded `seed + 1`, as the reference's key)."""
    return torch.randn(shape, generator=gen, device=gen.device)


def rollout(env, train_cfg, ckpt, near_edges, widths_per_env, params, steps,
            command_vx=1.2, seed=0, collect=False, stochastic_sigma=0.0,
            blank_d=0.0):
    """Assisted rollout.  Returns per-env stats (+ dataset if collect) as
    numpy arrays, and `steps`, the env steps run."""
    from legged_gym_custom_tpu_torch.rl.runner import OnPolicyRunner

    runner = OnPolicyRunner(env, train_cfg, log_dir=None)
    runner.load(ckpt, load_optimizer=False)
    policy = runner.get_inference_policy()

    dev = env.device
    state, obs = env.reset_all(torch.Generator(device=dev).manual_seed(seed))
    B = env.num_envs
    cmd = torch.tensor([command_vx, 0.0, 0.0, 0.0], dtype=torch.float32,
                       device=dev).expand(B, 4)

    far_edges = near_edges[None, :] + widths_per_env[:, None]  # (B, G)

    T = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    near = T(near_edges.astype(np.float32))
    # the scripted action of every phase for every env: teacher_action's
    # rows, looked up by phase at each step (row POLICY is zeros)
    table = T(np.stack([teacher_action(np.full(B, p), params, B)
                        for p in (POLICY, CROUCH, EXTEND, TUCK, LAND)]))
    min_vx = params.get("trigger_min_vx")
    if min_vx is None:
        min_vx = np.full(B, 0.1, np.float32)
    trigger_d, min_vx = T(params["trigger_d"]), T(min_vx)
    limit = {p: T(params[k + "_steps_arr"]) for p, k in
             ((CROUCH, "crouch"), (EXTEND, "extend"), (TUCK, "tuck"), (LAND, "land"))}
    rows = torch.arange(B, device=dev)

    phase = torch.zeros(B, dtype=torch.int32, device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    best_x = torch.zeros(B, dtype=torch.float32, device=dev)
    air_run = torch.zeros(B, dtype=torch.int32, device=dev)
    max_air = torch.zeros(B, dtype=torch.int32, device=dev)
    n_assists = torch.zeros(B, dtype=torch.int32, device=dev)

    buf = {"obs": [], "priv": [], "scan": [], "act": [], "env": [],
           "teach": []} if collect else None
    noise_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    n_trig = torch.zeros(B, dtype=torch.int32, device=dev)
    debug_rows = []
    steps_run = 0

    for i in range(steps):
        state = state.replace(commands=cmd)

        rel_x = state.physics.base_pos[:, 0] - state.env_origins[:, 0]
        vx = state.physics.lin_vel[:, 0]
        ahead = near[None, :] - rel_x[:, None]  # (B, G)
        ahead = torch.where(ahead > -0.05, ahead, torch.inf)
        d_next = ahead.min(dim=1).values

        # fake-scan injection (the reference's SCAN-replay trick, deploy
        # controller FSM): within blank_scan_d of an uncrossed gap, feed the
        # POLICY flat-ground scandots so it keeps approach speed instead of
        # braking at the perceived edge.  The RECORDED obs (BC dataset)
        # keep the true scan — the clone learns jump-on-perceived-gap.
        obs_feed = obs
        if blank_d > 0.0:
            in_window = (d_next < blank_d) & (phase == POLICY)
            # the per-env MINIMUM scan value is the ground reading under
            # the robot (gap dots read higher after the -2 m drop is
            # clipped) — broadcasting it paints the whole footprint as
            # level ground at the robot's own height, independent of the
            # terrain row's global z offset
            flat = obs.scan.min(dim=1, keepdim=True).values
            obs_feed = obs._replace(scan=torch.where(in_window[:, None], flat, obs.scan))

        pol_act = policy(obs_feed, adaptation_mode=True)
        if stochastic_sigma > 0.0:
            pol_act = pol_act + stochastic_sigma * _policy_noise(noise_gen, pol_act.shape)

        # trigger: next uncrossed gap's near edge within trigger_d ahead,
        # moving forward, currently under policy control
        stance = state.last_contacts.any(dim=1)
        trig = (
            (phase == POLICY)
            & (d_next < trigger_d)
            & (vx > min_vx)
            & stance          # launch from stance, not mid-bound flight
            & alive
        )
        phase = torch.where(trig, CROUCH, phase)
        count = torch.where(trig, 0, count)
        n_trig += trig.int()
        if i % 50 == 0:
            a_np = alive.cpu().numpy()
            rel_np, vx_np = rel_x.cpu().numpy(), vx.cpu().numpy()
            debug_rows.append(dict(
                step=i, rel_x_p50=float(np.percentile(rel_np[a_np], 50))
                if a_np.any() else None,
                vx_p50=float(np.percentile(vx_np[a_np], 50)) if a_np.any()
                else None,
                n_alive=int(a_np.sum()), trig_total=int(n_trig.sum()),
                in_teacher=int((phase != POLICY).sum()),
            ))

        ta = table[phase.long(), rows]
        override = phase != POLICY
        actions = torch.where(override[:, None], ta, pol_act).float()

        if collect:
            buf["obs"].append(obs.obs)
            buf["priv"].append(obs.privileged)
            buf["scan"].append(obs.scan)
            buf["act"].append(actions)
            buf["env"].append(alive.clone())   # alive BEFORE the step
            buf["teach"].append(override)

        state, obs, rew, d, info = env.step(state, actions)
        steps_run += 1

        # phase machine advance, one phase after the other as the reference
        count = count + override.int()
        for cur, nxt in ((CROUCH, EXTEND), (EXTEND, TUCK), (TUCK, LAND), (LAND, POLICY)):
            adv = (phase == cur) & (count >= limit[cur])
            phase = torch.where(adv, nxt, phase)
            if cur == LAND:
                n_assists += (adv & alive).int()
            else:
                count = torch.where(adv, 0, count)
        phase = torch.where(d, POLICY, phase)

        rel = state.max_x - state.env_origins[:, 0]
        best_x = torch.where(alive, torch.maximum(best_x, rel), best_x)
        contact = state.last_contacts.any(dim=1)
        airborne = (~contact) & alive
        air_run = torch.where(airborne, air_run + 1, 0)
        max_air = torch.maximum(max_air, air_run)
        alive &= ~d
        if not bool(alive.any()):
            break

    np_ = lambda t: t.cpu().numpy()
    best_x = np_(best_x)
    gaps_crossed = (best_x[:, None] > far_edges + 0.05).sum(axis=1)
    out = dict(best_x=best_x, gaps=gaps_crossed, alive=np_(alive),
               max_air=np_(max_air), assists=np_(n_assists), n_trig=np_(n_trig),
               debug=debug_rows, steps=steps_run)
    if collect:
        out["buf"] = {k: [np_(x) for x in torch.stack(v).unbind(0)] if v else []
                      for k, v in buf.items()}
        out["buf"]["env"] = [np.where(m)[0] for m in out["buf"]["env"]]
    return out


def expand_params(keys, combo_rows, B):
    """Per-env parameter arrays from a list of combos (cycled over B)."""
    p = {}
    rows = [combo_rows[i % len(combo_rows)] for i in range(B)]
    for j, k in enumerate(keys):
        p[k] = np.array([r[j] for r in rows], np.float32)
    for k in ["crouch_steps", "extend_steps", "tuck_steps", "land_steps"]:
        p[k + "_arr"] = p[k].astype(np.int32)
    return p


def scalar_params(d, B):
    keys = list(d)
    return expand_params(keys, [tuple(d[k] for k in keys)], B)


def get_args(argv=None):
    ap = argparse.ArgumentParser("jump_teacher")
    ap.add_argument("--mode", choices=["probe", "collect"], required=True)
    ap.add_argument("--task", default="go2_parkour_cliff")
    ap.add_argument("--ckpt", required=True,
                    help="a port checkpoint (.pt), e.g. the go2_parkour_cliff stage's")
    ap.add_argument("--gap_width", type=float, default=0.25)
    ap.add_argument("--widths", default="0.20,0.25,0.30")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--num_envs", type=int, default=0)
    ap.add_argument("--command_vx", type=float, default=1.2)
    ap.add_argument("--min_cross", type=int, default=1)
    ap.add_argument("--sigma", type=float, default=0.0,
                    help="extra gaussian action noise during collect")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--params", default=None,
                    help="json dict overriding DEFAULT_PARAMS (collect mode)")
    ap.add_argument("--out", default="logs/jump_dataset.npz")
    ap.add_argument("--blank_scan_d", type=float, default=1.8,
                    help="feed flat scandots to the policy within this "
                         "distance of an uncrossed gap (0 disables)")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def main(argv=None):
    """The reference's CLI; returns the probe's rollout result, or the
    collected dataset (a dict of arrays)."""
    args = get_args(argv)

    if args.mode == "probe":
        keys, combos = param_grid()
        B = args.num_envs or len(combos)
        env, train_cfg, env_cfg, near = build_env(
            args.task, B, args.gap_width, device=args.device
        )
        widths = np.full(B, args.gap_width, np.float32)
        params = expand_params(keys, combos, B)
        r = rollout(env, train_cfg, args.ckpt, near, widths, params,
                    args.steps, args.command_vx, args.seed,
                    blank_d=args.blank_scan_d)
        order = np.argsort(-(r["gaps"] * 100 + r["best_x"]))
        print(f"# probe: width={args.gap_width} B={B} combos={len(combos)}")
        for i in order[:15]:
            combo = {k: float(params[k][i]) for k in keys}
            print(json.dumps(dict(
                gaps=int(r["gaps"][i]), best_x=round(float(r["best_x"][i]), 2),
                alive=bool(r["alive"][i]), max_air=int(r["max_air"][i]),
                assists=int(r["assists"][i]), **combo)))
        n_cross = int((r["gaps"] >= 1).sum())
        print(f"# combos crossing >=1 gap: {n_cross}/{B}; "
              f">=3 gaps: {int((r['gaps'] >= 3).sum())}/{B}; "
              f"total triggers: {int(r['n_trig'].sum())}")
        for row in r["debug"]:
            print("# dbg", json.dumps(row))
        return r

    # collect: one rollout per width, keep only envs that crossed
    widths_list = [float(w) for w in args.widths.split(",")]
    p = dict(DEFAULT_PARAMS)
    if args.params:
        p.update(json.loads(args.params))
    B = args.num_envs or 256
    obs_l, priv_l, scan_l, act_l, teach_l, w_l = [], [], [], [], [], []
    for wi, w in enumerate(widths_list):
        env, train_cfg, env_cfg, near = build_env(args.task, B, w, device=args.device)
        widths = np.full(B, w, np.float32)
        params = scalar_params(p, B)
        r = rollout(env, train_cfg, args.ckpt, near, widths, params,
                    args.steps, args.command_vx, args.seed + wi,
                    collect=True, stochastic_sigma=args.sigma,
                    blank_d=args.blank_scan_d)
        # the reference's per-env gate, with its fault: an env that crossed
        # and then died keeps every step up to its death (ROADMAP Queue C)
        ok = r["gaps"] >= args.min_cross
        print(f"# width {w}: {int(ok.sum())}/{B} envs crossed "
              f">={args.min_cross} gaps (p50 {np.percentile(r['gaps'], 50)},"
              f" max {int(r['gaps'].max())})")
        buf = r["buf"]
        for t in range(len(buf["obs"])):
            envs_t = buf["env"][t]
            sel = envs_t[ok[envs_t]]
            if sel.size == 0:
                continue
            obs_l.append(buf["obs"][t][sel])
            priv_l.append(buf["priv"][t][sel])
            scan_l.append(buf["scan"][t][sel])
            act_l.append(buf["act"][t][sel])
            teach_l.append(buf["teach"][t][sel])
            w_l.append(widths[sel])
        del env, r, buf
    # the reference's bare concatenation: an empty dataset raises its
    # ValueError (ROADMAP Queue C)
    ds = dict(
        obs=np.concatenate(obs_l), priv=np.concatenate(priv_l),
        scan=np.concatenate(scan_l), act=np.concatenate(act_l),
        teach=np.concatenate(teach_l), width=np.concatenate(w_l),
    )
    import os

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, **ds)
    print(f"# saved {ds['obs'].shape[0]} samples "
          f"({int(ds['teach'].sum())} teacher steps) -> {args.out}")
    return ds


if __name__ == "__main__":
    main()
