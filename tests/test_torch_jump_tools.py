"""Parity of the port's jump-teacher pipeline with the JAX reference on the
CPU, on the synthetic Go2-shaped URDF at 8 envs.

  (a) `teacher_action`, `param_grid`, `expand_params`, `scalar_params`:
      exact;
  (b) `build_env`'s measured gap near edges at three widths (to 1e-6), and
      the fallback to the config x when the count disagrees (the
      reference's fault, kept);
  (c) `rollout`, 8 envs x 30 steps from injected spawns, triggers forced
      (trigger_d 100, trigger_min_vx -100) and the scan blanked within
      1.8 m: counts, phase decisions and the dataset buffers exact, best_x
      to 2e-3, observations and actions to OBS_TOL; with `--sigma` the
      reference's normals injected;
  (d) `main --mode collect` end to end, and its empty-dataset ValueError;
  (e) `jump_distill`: 5 Adam steps from one set of weights in both
      checkpoint formats on a seeded dataset with the reference's batch
      indices injected; the privileged encoder untouched in both (the
      reference's fault, kept); the written `.pt` keeps the source's
      optimizer states and `scripts.train --resume` continues from it.

Both registries' `make_env` build the task on the synthetic URDF with the
spawns, commands and origins injected (as tests/test_torch_parkour_stages.py
does), so that the two packages start from the same states.
"""
import contextlib
import io
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from legged_gym_custom_tpu.envs import task_registry as jtask_registry
from legged_gym_custom_tpu.physics.engine import PhysicsState as JPS
from legged_gym_custom_tpu.rl.runner import OnPolicyRunner as JRunner
from legged_gym_custom_tpu.scripts import jump_distill as jjump_distill
from legged_gym_custom_tpu.scripts import jump_teacher as jjump_teacher
from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch.envs import task_registry
from legged_gym_custom_tpu_torch.models.networks import params_from_flax
from legged_gym_custom_tpu_torch.physics.engine import PhysicsState
from legged_gym_custom_tpu_torch.rl.runner import OnPolicyRunner
from legged_gym_custom_tpu_torch.scripts import jump_distill, jump_teacher
from legged_gym_custom_tpu_torch.scripts import train as train_script

TASK = "go2_parkour_cliff"
B = 8
STEPS = 30
# float32 physics over a few control steps, through the obs scales (as
# tests/test_torch_parkour_env.py)
OBS_TOL = dict(atol=2e-3, rtol=1e-3)
# spawn offsets from base_init (2, 0, 0.5) + origin: env 5 past the first gap
# (x 7.4 > its far edge 4.84 + 0.3 + 0.05), env 4 just before its near edge
SPAWN = np.array([[0.0, 0.0], [1.0, 0.5], [2.0, -0.5], [2.5, 1.0], [2.8, -1.0], [5.4, 0.2],
                  [1.5, 0.0], [0.6, -0.2]])
FORCED = {"trigger_d": 100.0, "trigger_min_vx": -100.0}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny, so one thread is faster than many, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inject(env, side):
    """Every reset at SPAWN, moving forward at 1 m/s, under a 1.2 m/s
    command, on the course's one origin."""
    quat = np.tile([1.0, 0.0, 0.0, 0.0], (B, 1)).astype(np.float32)
    lin = np.zeros((B, 3), np.float32)
    lin[:, 0] = 1.0
    cmds = np.tile([1.2, 0.0, 0.0, 0.0], (B, 1)).astype(np.float32)
    xyz = np.concatenate([SPAWN, np.zeros((B, 1))], axis=1).astype(np.float32)
    if side == "jax":
        A, W, Z, ps, itype = jnp.asarray, jnp.where, jnp.zeros, JPS, np.int32
    else:
        A, W, Z, ps, itype = torch.as_tensor, torch.where, torch.zeros, PhysicsState, np.int64
    levels = A(np.zeros(B, itype))
    env._initial_origins = lambda g: (levels, levels, env.terrain_origins[levels, levels])
    env._sample_reset_physics = lambda state, g, origins: ps(
        base_pos=env.base_init["pos"] + origins + A(xyz), base_quat=A(quat), lin_vel=A(lin),
        ang_vel=Z((B, 3)), dof_pos=env.default_dof_pos + Z((B, 12)), dof_vel=Z((B, 12)))
    env._resample_commands = lambda state, g, mask: W(mask[:, None], A(cmds), state.commands)


@pytest.fixture
def injected(monkeypatch):
    """Both registries build the synthetic robot with the injected draws."""
    for reg, side in ((jtask_registry, "jax"), (task_registry, "torch")):
        def make_env(name, args=None, env_cfg=None, reg=reg, side=side, **device):
            env = reg.task_classes[name](env_cfg, SYNTHETIC_GO2_URDF, name="go2", terrain_seed=3,
                                         **device)
            if env.num_envs == B:
                _inject(env, side)
            return env, env_cfg
        monkeypatch.setattr(reg, "make_env", make_env)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One set of random weights as a JAX runner checkpoint and, carried by
    `params_from_flax`, as a port checkpoint: (JAX path, port path)."""
    d = tmp_path_factory.mktemp("jump_ckpt")
    envs = []
    for reg, extra in ((jtask_registry, {}), (task_registry, {"device": "cpu"})):
        cfg, _ = reg.get_cfgs(TASK)
        cfg.env.num_envs = B
        cfg.terrain.num_rows = cfg.terrain.num_cols = 1
        envs.append(reg.task_classes[TASK](cfg, SYNTHETIC_GO2_URDF, name="go2", terrain_seed=3,
                                           **extra))
    runner_j = JRunner(envs[0], jtask_registry.get_cfgs(TASK)[1], log_dir=None, use_mesh=False)
    runner_t = OnPolicyRunner(envs[1], task_registry.get_cfgs(TASK)[1], log_dir=None)
    runner_t.nets.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                                runner_j.train_state.params)))
    # moments in the port's three optimizers (a step at learning rate 0 leaves
    # the parameters as they are), so that keeping them is visible
    gen = torch.Generator().manual_seed(2)
    ts = runner_t.train_state
    for opt in (ts.opt_policy, ts.opt_adapt, ts.opt_est):
        lrs = [g["lr"] for g in opt.param_groups]
        for g in opt.param_groups:
            g["lr"] = 0.0
            for p in g["params"]:
                p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
        for g, lr in zip(opt.param_groups, lrs):
            g["lr"] = lr
        opt.zero_grad(set_to_none=True)
    runner_j.save(str(d / "jax_model"))
    runner_t.save(str(d / "model_9.pt"))
    return str(d / "jax_model"), str(d / "model_9.pt")


def _forced_params(B_=B):
    """Mixed combos of the probe grid with the triggers forced."""
    keys, combos = jump_teacher.param_grid()
    p = jump_teacher.expand_params(keys, combos[::17], B_)
    p["trigger_d"][:] = FORCED["trigger_d"]
    p["trigger_min_vx"][:] = FORCED["trigger_min_vx"]
    return p


# ---------------------------------------------------------------- (a) numpy

@pytest.mark.parametrize("seed", range(4))
def test_teacher_action_matches_reference(seed):
    rng = np.random.default_rng(seed)
    keys, combos = jump_teacher.param_grid()
    Bn = 64
    rows = [combos[i] for i in rng.integers(0, len(combos), Bn)]
    params = jump_teacher.expand_params(keys, rows, Bn)
    for k, v in params.items():
        if v.dtype == np.float32:
            params[k] = v + rng.normal(size=v.shape).astype(np.float32)
    phase = rng.integers(0, 5, Bn)
    got = jump_teacher.teacher_action(phase, params, Bn)
    np.testing.assert_array_equal(got, jjump_teacher.teacher_action(phase, params, Bn))
    assert got.dtype == np.float32 and (got[phase == jump_teacher.POLICY] == 0).all()


def test_param_grid_and_constants_match_reference():
    keys, combos = jump_teacher.param_grid()
    assert (keys, combos) == jjump_teacher.param_grid()
    assert len(combos) == 144
    assert jump_teacher.DEFAULT_PARAMS == jjump_teacher.DEFAULT_PARAMS
    for name in ("POLICY", "CROUCH", "EXTEND", "TUCK", "LAND"):
        assert getattr(jump_teacher, name) == getattr(jjump_teacher, name)
    for name in ("HIP", "THIGH", "CALF"):
        np.testing.assert_array_equal(getattr(jump_teacher, name), getattr(jjump_teacher, name))


@pytest.mark.parametrize("Bn", [144, 200, 7])
def test_expand_and_scalar_params_match_reference(Bn):
    keys, combos = jump_teacher.param_grid()
    for got, ref in ((jump_teacher.expand_params(keys, combos, Bn),
                      jjump_teacher.expand_params(keys, combos, Bn)),
                     (jump_teacher.scalar_params(jump_teacher.DEFAULT_PARAMS, Bn),
                      jjump_teacher.scalar_params(jjump_teacher.DEFAULT_PARAMS, Bn))):
        assert list(got) == list(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].shape == (Bn,), k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_rollout_phase_table_is_teacher_action():
    """The rollout looks the scripted action up by phase from a table of
    teacher_action rows; that lookup is teacher_action itself."""
    rng = np.random.default_rng(5)
    params = _forced_params(32)
    phase = rng.integers(0, 5, 32)
    table = np.stack([jump_teacher.teacher_action(np.full(32, p), params, 32) for p in range(5)])
    np.testing.assert_array_equal(table[phase, np.arange(32)],
                                  jump_teacher.teacher_action(phase, params, 32))


# ---------------------------------------------------------------- (b) build_env

@pytest.mark.parametrize("width", [0.20, 0.25, 0.30])
def test_build_env_measures_the_same_near_edges(width, injected, capsys):
    near_j = jjump_teacher.build_env(TASK, B, width)[3]
    near_t = jump_teacher.build_env(TASK, B, width, device="cpu")[3]
    assert len(near_t) == len(near_j) == 6
    np.testing.assert_allclose(near_t, near_j, atol=1e-6, rtol=0)
    # the generator centres each gap on its config x: the near edge is early
    xs = 5.0 + 3.5 * np.arange(6)
    assert ((xs - near_t) > width / 2 - 0.03).all() and "WARNING" not in capsys.readouterr().out


def test_build_env_fallback_keeps_the_uncentred_config_x(injected, capsys):
    """jump_teacher.py:169: with a count the course does not have (8 gaps on
    a 28 m course keep 7), both fall back to the config x, the obstacles'
    centres (the reference's fault: those are not the near edges)."""
    near_j = jjump_teacher.build_env(TASK, B, 0.3, n_gaps=8)[3]
    printed_j = capsys.readouterr().out
    near_t = jump_teacher.build_env(TASK, B, 0.3, n_gaps=8, device="cpu")[3]
    printed_t = capsys.readouterr().out
    xs = np.asarray([5.0 + 3.5 * k for k in range(8)], np.float32)
    np.testing.assert_array_equal(near_j, xs)
    np.testing.assert_array_equal(near_t, xs)
    for printed in (printed_j, printed_t):
        assert "WARNING: measured 7 gap edges, expected 8; falling back to config coords" \
            in printed


# ---------------------------------------------------------------- (c) rollout

def _both_rollouts(checkpoints, width=0.3, steps=STEPS, sigma=0.0):
    ckpt_j, ckpt_t = checkpoints
    env_j, cfg_j, _, near_j = jjump_teacher.build_env(TASK, B, width)
    env_t, cfg_t, _, near_t = jump_teacher.build_env(TASK, B, width, device="cpu")
    widths = np.full(B, width, np.float32)
    kw = dict(collect=True, stochastic_sigma=sigma, blank_d=1.8)
    ref = jjump_teacher.rollout(env_j, cfg_j, ckpt_j, near_j, widths, _forced_params(), steps,
                                **kw)
    got = jump_teacher.rollout(env_t, cfg_t, ckpt_t, near_t, widths, _forced_params(), steps,
                               **kw)
    return ref, got


def _assert_rollouts_match(ref, got, act_tol=OBS_TOL):
    for k in ("gaps", "alive", "max_air", "assists", "n_trig"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(got["best_x"], ref["best_x"], atol=2e-3, rtol=0)
    bj, bt = ref["buf"], got["buf"]
    assert len(bt["obs"]) == len(bj["obs"]) == got["steps"]
    for t in range(len(bj["obs"])):
        for k in ("teach", "env"):
            np.testing.assert_array_equal(bt[k][t], np.asarray(bj[k][t]), err_msg=f"{k} {t}")
        for k, tol in (("obs", OBS_TOL), ("priv", OBS_TOL), ("scan", OBS_TOL), ("act", act_tol)):
            np.testing.assert_allclose(bt[k][t], np.asarray(bj[k][t]), err_msg=f"{k} {t}", **tol)


def test_rollout_matches_reference(checkpoints, injected):
    ref, got = _both_rollouts(checkpoints)
    _assert_rollouts_match(ref, got)
    assert got["debug"] == [dict(row, rel_x_p50=pytest.approx(row["rel_x_p50"], abs=2e-3))
                            for row in ref["debug"]]
    # the phase machine ran: triggers, teacher steps, full assists, flights
    teach = np.stack(got["buf"]["teach"])
    assert got["n_trig"].sum() >= B and teach.any() and got["assists"].sum() > 0
    assert got["max_air"].max() > 3
    # env 5 spawned past the first gap crossed it and then died; env 4, at the
    # near edge, fell in.  buf["env"] lists the envs alive BEFORE each step,
    # so env 5 is in every row up to and including the step it died on: the
    # per-env gate of main (jump_teacher.py:406) keeps them all (the
    # reference's fault, kept)
    assert got["gaps"][5] == 1 and not got["alive"][5] and not got["alive"][4]
    rows_5 = [t for t, envs in enumerate(got["buf"]["env"]) if 5 in envs]
    assert rows_5 == list(range(len(rows_5))) and len(rows_5) < got["steps"]


def test_rollout_with_sigma_takes_the_injected_noise(checkpoints, injected, monkeypatch):
    """--sigma: the reference draws jax.random.normal from PRNGKey(seed + 1),
    split once a step (jump_teacher.py:241-246); the port's split-off draw
    is fed those normals.  On step 0 both see the same observation, so the
    noisy actions agree to 1e-6; later steps to OBS_TOL."""
    steps, sigma = 12, 0.5
    key, draws = jax.random.PRNGKey(1), []
    for _ in range(steps):
        key, k = jax.random.split(key)
        draws.append(torch.as_tensor(np.asarray(jax.random.normal(k, (B, 12)))))
    calls = []

    def noise(gen, shape):
        calls.append(shape)
        return draws[len(calls) - 1]

    monkeypatch.setattr(jump_teacher, "_policy_noise", noise)
    ref, got = _both_rollouts(checkpoints, steps=steps, sigma=sigma)
    assert len(calls) == got["steps"] == steps
    np.testing.assert_allclose(got["buf"]["act"][0], np.asarray(ref["buf"]["act"][0]),
                               atol=1e-6, rtol=0)
    assert np.abs(got["buf"]["act"][0]).max() > 0.2   # the noise is in
    _assert_rollouts_match(ref, got)


# ---------------------------------------------------------------- (d) main

def _jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    return module.main()


def test_main_collect_writes_the_reference_dataset(checkpoints, injected, tmp_path,
                                                   monkeypatch):
    ckpt_j, ckpt_t = checkpoints
    argv = ["--mode", "collect", "--task", TASK, "--num_envs", str(B), "--steps", "20",
            "--widths", "0.20,0.30", "--min_cross", "0", "--params", str(FORCED).replace("'", '"')]
    _jax_main(jjump_teacher, argv + ["--ckpt", ckpt_j, "--out", str(tmp_path / "j.npz")],
              monkeypatch)
    jump_teacher.main(argv + ["--ckpt", ckpt_t, "--out", str(tmp_path / "t.npz"),
                              "--device", "cpu"])
    ref, got = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(got.files) == sorted(ref.files) == ["act", "obs", "priv", "scan", "teach",
                                                      "width"]
    for k in ref.files:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
    for k in ("teach", "width"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("obs", "priv", "scan", "act"):
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **OBS_TOL)
    assert got["teach"].sum() > 0 and sorted(set(got["width"].tolist())) == [
        np.float32(0.2), np.float32(0.3)]


def test_main_collect_with_no_crossing_raises_the_bare_value_error(checkpoints, injected,
                                                                   tmp_path, monkeypatch):
    """jump_teacher.py:423: no env crossed --min_cross gaps, so the bare
    np.concatenate of empty lists raises in both (the reference's fault)."""
    ckpt_j, ckpt_t = checkpoints
    argv = ["--mode", "collect", "--task", TASK, "--num_envs", str(B), "--steps", "3",
            "--widths", "0.30", "--min_cross", "5"]
    with pytest.raises(ValueError, match="need at least one array to concatenate"):
        _jax_main(jjump_teacher, argv + ["--ckpt", ckpt_j, "--out", str(tmp_path / "j.npz")],
                  monkeypatch)
    with pytest.raises(ValueError, match="need at least one array to concatenate"):
        jump_teacher.main(argv + ["--ckpt", ckpt_t, "--out", str(tmp_path / "t.npz"),
                                  "--device", "cpu"])
    assert not (tmp_path / "j.npz").exists() and not (tmp_path / "t.npz").exists()


def test_entry_points_default_to_the_card():
    for module, argv in ((jump_teacher, ["--mode", "probe", "--ckpt", "x.pt"]),
                         (jump_distill, ["--ckpt", "x.pt"])):
        assert module.get_args(argv).device == "cuda"


# ---------------------------------------------------------------- (e) distill

N_DS, BATCH, DISTILL_STEPS, LR = 300, 64, 5, 3e-4
# The distilled parameters agree at rtol 1e-4 / atol 1e-6, all but a few
# entries of the 1.0M, and those within 5 % of the farthest Adam can move a
# parameter in these steps (lr x steps = 1.5e-3).  Adam divides each
# gradient by its running RMS, so an entry whose gradient sums to nearly 0
# on some step takes an O(lr) step whose sign follows float32 rounding in
# either package: on this dataset 5 entries differ by more than 1e-6 + 1e-4
# |p|, the largest by 5.2e-5 (an actor weight moved 6.55e-4 in JAX, 6.03e-4
# here).  A wrong beta, learning rate, eps or bias correction moves
# thousands of entries by 1e-4 or more.
DISTILL_TOL = dict(rtol=1e-4, atol=1e-6)
DISTILL_FLIPS, DISTILL_FLIP_ATOL = 10, 0.05 * LR * DISTILL_STEPS


def _dataset(path, env):
    rng = np.random.default_rng(4)
    e = env.cfg.env
    n_obs = e.num_proprio * (1 + e.history_buffer_length)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    np.savez_compressed(path, obs=f(N_DS, n_obs), priv=f(N_DS, e.num_privileged_obs),
                        scan=f(N_DS, e.num_scan_obs), act=f(N_DS, 12),
                        teach=rng.uniform(size=N_DS) < 0.3,
                        width=np.full(N_DS, 0.25, np.float32))


@pytest.fixture(scope="module")
def distilled(checkpoints, tmp_path_factory):
    """Both distill mains on one dataset, the reference's batch indices fed
    to the port: (JAX params after the steps, JAX printed output, port
    runner, port losses, port printed output, paths)."""
    mp = pytest.MonkeyPatch()
    d = tmp_path_factory.mktemp("distill")
    ckpt_j, ckpt_t = checkpoints
    for reg, side in ((jtask_registry, "jax"), (task_registry, "torch")):
        mp.setattr(reg, "make_env", lambda name, args=None, env_cfg=None, reg=reg, **dev: (
            reg.task_classes[name](env_cfg, SYNTHETIC_GO2_URDF, name="go2", terrain_seed=3,
                                   **dev), env_cfg))
    cfg, _ = task_registry.get_cfgs(TASK)
    cfg.env.num_envs = 8
    cfg.terrain.num_rows = cfg.terrain.num_cols = 1
    _dataset(d / "ds.npz", task_registry.make_env(TASK, env_cfg=cfg, device="cpu")[0])
    argv = ["--dataset", str(d / "ds.npz"), "--task", TASK, "--steps", str(DISTILL_STEPS),
            "--batch", str(BATCH), "--lr", str(LR)]
    saved = {}
    mp.setattr(JRunner, "save", lambda self, path, infos=None: saved.update(
        params=jax.tree.map(np.asarray, self.train_state.params), path=path))
    mp.setattr(sys, "argv", ["jump_distill"] + argv + ["--ckpt", ckpt_j, "--out",
                                                       str(d / "jax_out")])
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        jjump_distill.main()
    jax_out = printed.getvalue()
    key, idx = jax.random.PRNGKey(0), []
    for _ in range(DISTILL_STEPS):
        key, k = jax.random.split(key)
        idx.append(torch.as_tensor(np.asarray(jax.random.randint(k, (BATCH,), 0, N_DS))))
    mp.setattr(jump_distill, "_draw_indices", lambda gen, batch, N: idx.pop(0))
    out = str(d / "logs" / "distill_run" / "model_9.pt")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        runner, losses = jump_distill.main(argv + ["--ckpt", ckpt_t, "--out", out,
                                                   "--device", "cpu"])
    mp.undo()
    return saved["params"], jax_out, runner, losses, printed.getvalue(), ckpt_t, out


def _printed_losses(text):
    return {int(l.split()[1][:-1]): float(l.split()[-1]) for l in text.splitlines()
            if l.startswith("step ")}


def test_distill_matches_reference(distilled):
    params_j, jax_out, runner, losses, port_out, _, _ = distilled
    ref = _printed_losses(jax_out)
    assert list(ref) == [0, DISTILL_STEPS - 1] == list(_printed_losses(port_out))
    for i, v in ref.items():   # printed to 5 decimals
        assert losses[i] == pytest.approx(v, rel=1e-4, abs=1e-5), i
    assert losses[-1] < losses[0]
    want = params_from_flax(params_j)
    got = runner.nets.state_dict()
    assert set(got) == set(want)
    outside = 0
    for name, value in want.items():
        g, w = got[name].numpy(), np.asarray(value)
        err = np.abs(g - w)
        outside += int((err > DISTILL_TOL["atol"] + DISTILL_TOL["rtol"] * np.abs(w)).sum())
        assert err.max() <= DISTILL_FLIP_ATOL, name
    assert outside <= DISTILL_FLIPS


def test_distill_leaves_the_privileged_encoder_as_it_was(distilled):
    """jump_distill.py:76/:82: the loss reaches the networks through the
    adaptation path only, so the privileged encoder (PPO's latent) gets no
    gradient and its weights are unchanged in both packages (the reference's
    fault, kept); the actor, the adaptation encoder and the estimator move."""
    params_j, _, runner, _, _, ckpt_t, _ = distilled
    source = torch.load(ckpt_t, weights_only=True)["model_state_dict"]
    after_j = params_from_flax(params_j)
    after_t = runner.nets.state_dict()
    for name in source:
        unchanged_t = torch.equal(after_t[name], source[name])
        unchanged_j = np.array_equal(np.asarray(after_j[name]), source[name].numpy())
        assert unchanged_t == unchanged_j, name
        frozen = name.startswith(("priv_encoder.", "critic.")) or name == "std"
        assert unchanged_t == frozen, name


def test_distilled_checkpoint_keeps_the_optimizers_and_resumes(distilled, tmp_path, capsys):
    """The written .pt carries the source's three optimizer states, learning
    rate, update count and iteration; `scripts.train --resume --load_run`
    loads it and trains the next iteration on the CPU."""
    _, _, _, _, _, ckpt_t, out = distilled
    src, dst = (torch.load(p, weights_only=True) for p in (ckpt_t, out))
    for k in ("optimizer_policy", "optimizer_adapt", "optimizer_est"):
        assert src[k]["param_groups"] == dst[k]["param_groups"], k
        assert src[k]["state"].keys() == dst[k]["state"].keys() and src[k]["state"], k
        for i, st in src[k]["state"].items():
            for name, value in st.items():
                assert torch.equal(value, dst[k]["state"][i][name]), (k, i, name)
    for k in ("learning_rate", "total_updates", "iter"):
        assert src[k] == dst[k], k
    assert not torch.equal(src["model_state_dict"]["actor.layers.0.weight"],
                           dst["model_state_dict"]["actor.layers.0.weight"])
    root = os.path.dirname(os.path.dirname(out))
    args = train_script.get_args(["--task", TASK, "--resume", "--load_run", "distill_run",
                                  "--num_envs", "8", "--max_iterations", "1", "--device", "cpu"])
    runner, history = train_script.train(args, log_root=root)
    assert f"Loading model from: {out}" in capsys.readouterr().out
    assert [h["iteration"] for h in history] == [src["iter"]]
    assert np.isfinite([v for k, v in history[0].items() if k.endswith("loss")]).all()
