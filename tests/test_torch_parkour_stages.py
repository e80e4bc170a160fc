"""Parity of the PyTorch port's go2_parkour stage ladder with the JAX
reference on the CPU, on the synthetic Go2-shaped URDF at a few envs.

  (a) the six stage configs, env and train, attribute by attribute, and the
      registered task names;
  (b) the stages' terrains, bit-equal (the finetune composite course, the
      gap-commit course, the cliff's 10-row width ladder);
  (c) the spawn curriculum: the port's reset assembly fed the JAX draws
      (recomputed from the reference's key split) against JAX
      `_sample_reset_physics`, and the port's own draws against the bounds
      of tests/test_env.py:148-182;
  (d) progress tracking and the stall termination on a go2_parkour_commit
      env stepped beside the JAX env, with injected draws;
  (e) the `progress`, `contact_forces` / `feet_contact_forces` and
      `min_height` reward terms;
  (f) the command curriculum, on gated and ungated steps;
  (g) go2_parkour -> finetune -> finetune2 trained for 1 iteration each,
      each resuming the last through its config;
  (h) eval_parkour (both courses) and export_bundle on that checkpoint.
"""
import contextlib
import io
import json
import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from legged_gym_custom_tpu.envs import task_registry as jtask_registry
from legged_gym_custom_tpu.envs import rewards as jrew
from legged_gym_custom_tpu.physics.engine import DomainRandParams as JDR
from legged_gym_custom_tpu.physics.engine import PhysicsState as JPS
from legged_gym_custom_tpu.rl.ppo import PPOConfig as JPPOConfig
from legged_gym_custom_tpu.rl.runner import OnPolicyRunner as JRunner
from legged_gym_custom_tpu.scripts import eval_parkour as jeval_parkour
from legged_gym_custom_tpu.terrain import Terrain as JTerrain
from legged_gym_custom_tpu_torch import LEGGED_GYM_TORCH_ROOT_DIR, SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch.deploy import NumpyAdaptationEncoder, NumpyMLP, load_policy_bundle
from legged_gym_custom_tpu_torch.envs import rewards as rew
from legged_gym_custom_tpu_torch.envs import task_registry
from legged_gym_custom_tpu_torch.envs.base_env import ResetDraws
from legged_gym_custom_tpu_torch.models.networks import params_from_flax
from legged_gym_custom_tpu_torch.physics.engine import DomainRandParams, PhysicsState
from legged_gym_custom_tpu_torch.rl.runner import OnPolicyRunner
from legged_gym_custom_tpu_torch.scripts import eval_parkour, export_bundle
from legged_gym_custom_tpu_torch.scripts import train as train_script
from legged_gym_custom_tpu_torch.terrain import Terrain

STAGES = ("go2_parkour_finetune", "go2_parkour_finetune2", "go2_parkour_bootcamp",
          "go2_parkour_commit", "go2_parkour_gap_commit", "go2_parkour_cliff")
SPAWN_STAGES = ("go2_parkour_bootcamp", "go2_parkour_commit", "go2_parkour_gap_commit")
# float32 physics over a few control steps, through the obs scales and reward
# terms (as tests/test_torch_parkour_env.py)
OBS_TOL = dict(atol=2e-3, rtol=1e-3)
REW_TOL = dict(atol=1e-4, rtol=1e-3)
SPAWN_TOL = dict(atol=1e-6, rtol=0)
EVAL_KEYS = os.path.join(LEGGED_GYM_TORCH_ROOT_DIR, "trained", "go2_parkour_tpu_r5")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny, so one thread is faster than many, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               err_msg=what, **tol)


def _envs(task, B, rows=1, cols=1, **edit):
    """The JAX and the port env of `task` at B envs on rows x cols courses,
    with observation noise and pushes off and raw reward sums; `edit` maps
    "section.attribute" to a value set on both configs."""
    envs = []
    for reg, extra in ((jtask_registry, {}), (task_registry, {"device": "cpu"})):
        cfg, _ = reg.get_cfgs(task)
        cfg.env.num_envs = B
        cfg.terrain.num_rows, cfg.terrain.num_cols = rows, cols
        cfg.noise.add_noise = False
        cfg.domain_rand.push_robots = False
        cfg.rewards.only_positive_rewards = False
        for key, value in edit.items():
            section, attr = key.split(".")
            setattr(getattr(cfg, section), attr, value)
        envs.append(reg.task_classes[task](cfg, SYNTHETIC_GO2_URDF, name="go2", terrain_seed=3,
                                           **extra))
    return envs


# ---------------------------------------------------------------- (a) configs

def _cfg_tree(obj):
    """A config instance as nested dicts of its attributes."""
    out = {}
    for k in dir(obj):
        if k.startswith("__"):
            continue
        v = getattr(obj, k)
        if callable(v) and not isinstance(v, type):
            continue   # BaseConfig.init_member_classes
        out[k] = _cfg_tree(v) if type(v).__module__.startswith("legged_gym_custom_tpu") else v
    return out


def _diff(a, b, path=""):
    if isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), f"{path}: {sorted(set(a) ^ set(b))}"
        for k in a:
            _diff(a[k], b[k], f"{path}.{k}")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def test_registered_tasks_match_reference():
    """The port registers every task the JAX package does: the go2 family
    and (since the other robots' slice) anymal_c_rough / _flat, cassie, g1."""
    assert sorted(task_registry.task_classes) == sorted(jtask_registry.task_classes)


@pytest.mark.parametrize("task", STAGES)
def test_stage_config_matches_reference(task):
    env_t, train_t = task_registry.get_cfgs(task)
    env_j, train_j = jtask_registry.get_cfgs(task)
    tree_t, tree_j = _cfg_tree(env_t), _cfg_tree(env_j)
    # the deliberate differences: the port ships its own synthetic URDF, and
    # its sim block adds the choice of engine on the card (kernel by default)
    assert tree_t["asset"].pop("file").endswith("go2_synthetic.urdf")
    tree_j["asset"].pop("file")
    assert tree_t["sim"].pop("fused_kernel") is True
    _diff(tree_t, tree_j, task)
    _diff(_cfg_tree(train_t), _cfg_tree(train_j), task + " train")
    assert train_t.runner.resume and train_t.runner.experiment_name == "go2_parkour"


# ---------------------------------------------------------------- (b) terrain

@pytest.mark.parametrize("task", ["go2_parkour_finetune", "go2_parkour_gap_commit",
                                  "go2_parkour_cliff"])
def test_stage_terrain_copy_is_bit_equal(task):
    cfg_t, cfg_j = task_registry.get_cfgs(task)[0], jtask_registry.get_cfgs(task)[0]
    for cfg in (cfg_t, cfg_j):
        cfg.terrain.num_cols = 2    # the rows stay: 12, and the cliff's 10
    tt = Terrain(cfg_t.terrain, 8, np.random.default_rng(5))
    jt = JTerrain(cfg_j.terrain, 8, np.random.default_rng(5))
    np.testing.assert_array_equal(tt.height_field_raw, jt.height_field_raw)
    np.testing.assert_array_equal(tt.env_origins, jt.env_origins)
    raw = tt.height_field_raw
    assert raw.shape == (cfg_t.terrain.num_rows * 280 + 500, 2 * 100 + 500)
    assert raw.min() == -400   # 2 m deep gaps at 5 mm per unit
    if task == "go2_parkour_finetune":
        assert raw.max() == 70   # the highest composite platform, +0.35 m
    if task == "go2_parkour_cliff":
        # one gap width per row, in whole cells of 0.1 m on either side of the
        # gap's centre (terrain/primitives.py:225-227): the 0.15 m row has no
        # gaps at all, and every other row 0.2 m ones
        line = raw[250:-250, 250 + 50]
        cells = [int(np.sum(line[r * 280:(r + 1) * 280] == -400)) // 7 for r in range(10)]
        assert cells == [2 * (round(w / 0.1) // 2) for w in cfg_t.terrain.parkour_row_widths]
        assert cells == [0] + [2] * 9


# ---------------------------------------------------------------- (c) spawn

def _jax_reset_draws(env_j, key, B):
    """The draws of JAX `_sample_reset_physics`, from its own key split
    (legged_gym_custom_tpu/envs/base_env.py:530-555)."""
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    init = env_j.cfg.init_state
    u = lambda k, shape, lo, hi: np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))
    x_slot = x_jitter = vx = None
    if init.rand_x_offsets:
        x_slot = np.asarray(jax.random.choice(k4, jnp.asarray(init.rand_x_offsets, jnp.float32),
                                              (B,)))
        x_jitter = u(k5, (B,), *init.rand_x_jitter)
    if init.rand_vx_range is not None:
        vx = u(k6, (B,), *init.rand_vx_range)
    T = lambda a: None if a is None else torch.as_tensor(np.array(a))
    return ResetDraws(T(u(k1, (B, 12), 0.0, 0.9)), T(u(k3, (B, 6), -0.5, 0.5)),
                      T(u(k2, (B, 2), -1.0, 1.0)), T(x_slot), T(x_jitter), T(vx))


@pytest.mark.parametrize("task", SPAWN_STAGES)
def test_spawn_assembly_matches_reference(task):
    B = 64
    env_j, env_t = _envs(task, B, rows=2, cols=2)
    levels = np.random.default_rng(0).integers(0, 2, B)
    types = np.arange(B) % 2
    origins = np.asarray(env_j.terrain_origins)[levels, types]
    np.testing.assert_array_equal(env_t.terrain_origins.numpy(), np.asarray(env_j.terrain_origins))
    key = jax.random.PRNGKey(11)
    ref = env_j._sample_reset_physics(None, key, jnp.asarray(origins))
    got = env_t._assemble_reset(_jax_reset_draws(env_j, key, B), torch.as_tensor(origins))
    for name, g, r in zip(PhysicsState._fields, got, ref):
        _close(g, r, SPAWN_TOL, f"{task} {name}")
    assert float(got.lin_vel[:, 0].min()) >= 0.8   # the drawn vx is replaced


def test_spawn_curriculum_distribution():
    """The port's own draws under the bounds of tests/test_env.py:148-182."""
    cfg, _ = task_registry.get_cfgs("go2_parkour_bootcamp")
    cfg.env.num_envs = 64
    cfg.terrain.num_rows = cfg.terrain.num_cols = 1
    cfg.terrain.curriculum = False
    env, _ = task_registry.make_env("go2_parkour_bootcamp", env_cfg=cfg, device="cpu")
    state, _ = env.reset_all(torch.Generator().manual_seed(3))
    rel = (state.physics.base_pos[:, 0] - state.env_origins[:, 0]).numpy() \
        - float(env.base_init["pos"][0])
    vx = state.physics.lin_vel[:, 0].numpy()
    offs = np.asarray(cfg.init_state.rand_x_offsets)
    lo_j, hi_j = cfg.init_state.rand_x_jitter
    assert (rel >= offs.min() + lo_j - 1.01).all() and (rel <= offs.max() + hi_j + 1.01).all()
    assigned = np.argmin(np.abs(rel[:, None] - offs[None, :]), axis=1)
    assert len(np.unique(assigned)) >= 3
    assert vx.mean() > 0.5 and vx.max() > 1.0


# ---------------------------------------------------------------- (d) stall

B_STALL = 8
# spawn offsets from base_init (2, 0, 0.5) + origin: all on the start
# platform or the flat before the first composite (x = 6.0)
FIRST = np.array([[0.0, 0.0], [0.5, 0.5], [1.0, -0.5], [0.3, 1.0],
                  [0.8, -1.0], [0.2, 0.2], [1.2, 0.0], [0.6, -0.2]])
AGAIN = FIRST + np.array([1.5, 0.0])   # respawns land 1.5 m further on


def _stall_draws():
    rng = np.random.default_rng(1)
    f = lambda a: np.asarray(a, np.float32)
    dr = dict(friction=f(rng.uniform(0.5, 1.0, B_STALL)), added_mass=f(rng.uniform(0, 1, B_STALL)),
              com_offset=f(rng.uniform(-0.02, 0.02, (B_STALL, 3))),
              kp_mult=f(rng.uniform(0.9, 1.1, (B_STALL, 12))),
              kd_mult=f(rng.uniform(0.9, 1.1, (B_STALL, 12))))
    quat = np.tile([1.0, 0.0, 0.0, 0.0], (B_STALL, 1))
    quat[7] = [0.0, 1.0, 0.0, 0.0]   # upside down: dies every step, never by the stall
    lin = np.zeros((B_STALL, 3))
    lin[1, 0] = 1.5                  # moves at first: progress holds its stall clock at 0
    cmds = np.tile([0.8, 0.0, 0.0, 0.0], (B_STALL, 1))
    cmds[2] = 0.0                    # no command: never stalls
    return dr, f(quat), f(lin), f(cmds)


def _inject(env, side, dr, quat, lin, cmds, first=FIRST, again=AGAIN):
    """Replace the env's random draws by the given ones (the domain
    randomization only where `dr` is given): the first reset at `first`,
    every later one at `again` (a JAX step samples its reset while tracing,
    after reset_all's)."""
    if side == "jax":
        A, W, Z = jnp.asarray, jnp.where, jnp.zeros
        if dr is not None:
            env._sample_dr = lambda key: JDR(**{k: A(v) for k, v in dr.items()})
        ps, levels = JPS, A(np.zeros(B_STALL, np.int32))
        types = A(np.zeros(B_STALL, np.int32))
    else:
        A, W, Z = torch.as_tensor, torch.where, torch.zeros
        if dr is not None:
            env._sample_dr = lambda gen: DomainRandParams(**{k: A(v) for k, v in dr.items()})
        ps, levels = PhysicsState, A(np.zeros(B_STALL, np.int64))
        types = levels
    env._initial_origins = lambda g: (levels, types, env.terrain_origins[levels, types])
    calls = []

    def reset_physics(state, g, origins):
        off = first if not calls else again
        calls.append(1)
        xyz = np.concatenate([off, np.zeros((B_STALL, 1))], axis=1).astype(np.float32)
        return ps(base_pos=env.base_init["pos"] + origins + A(xyz), base_quat=A(quat),
                  lin_vel=A(lin), ang_vel=Z((B_STALL, 3)), dof_pos=env.default_dof_pos + Z(
                      (B_STALL, 12)), dof_vel=Z((B_STALL, 12)))

    env._sample_reset_physics = reset_physics
    env._resample_commands = lambda state, g, mask: W(mask[:, None], A(cmds), state.commands)


def test_commit_stall_and_progress_match_reference():
    env_j, env_t = _envs("go2_parkour_commit", B_STALL, **{"termination.stall_time_s": 0.24})
    assert env_t.stall_time_s == env_j.stall_time_s == pytest.approx(0.24)
    assert "progress" in env_t.reward_names and env_t.reward_names == env_j.reward_names
    draws = _stall_draws()
    _inject(env_j, "jax", *draws)
    _inject(env_t, "torch", *draws)
    st_j, _ = env_j.reset_all(jax.random.PRNGKey(0))
    st_t, _ = env_t.reset_all(torch.Generator().manual_seed(0))
    k = env_t.episode_sum_names.index("progress")
    step_j = jax.jit(env_j.step)
    zero = np.zeros((B_STALL, 12), np.float32)
    stalls = 0
    for i in range(20):
        prev_stall = st_t.stall_time.clone()
        st_j, _, _, done_j, info_j = step_j(st_j, jnp.asarray(zero))
        st_t, _, _, done_t, info_t = env_t.step(st_t, torch.as_tensor(zero))
        _close(st_t.max_x, st_j.max_x, OBS_TOL, f"step {i} max_x")
        _close(st_t.stall_time, st_j.stall_time, dict(atol=1e-6, rtol=0), f"step {i} stall_time")
        _close(st_t.episode_sums[:, k], st_j.episode_sums[:, k], REW_TOL, f"step {i} progress")
        _close(info_t["episode_contrib"][:, k], info_j["episode_contrib"][:, k], REW_TOL,
               f"step {i} progress contrib")
        np.testing.assert_array_equal(done_t.numpy(), np.asarray(done_j))
        np.testing.assert_array_equal(info_t["time_outs"].numpy(), np.asarray(info_j["time_outs"]))
        assert not bool(info_t["time_outs"].any())
        stalled = done_t & (prev_stall + env_t.dt > env_t.stall_time_s)
        stalls += int(stalled.sum())
        # a respawned env restarts its tracking at its new x
        d = done_t.numpy()
        np.testing.assert_array_equal(st_t.max_x.numpy()[d], st_t.physics.base_pos[:, 0].numpy()[d])
        assert (st_t.stall_time.numpy()[d] == 0.0).all()
    assert stalls == 5     # the five envs that stand under a command, once each
    # the moving env and the one without a command never stall
    assert float(st_t.stall_time[1]) == float(st_t.stall_time[2]) == 0.0
    assert float(st_t.episode_sums[1, k]) > 0.0


# ---------------------------------------------------------------- (e) rewards

def _reward_ctxs(env_t, B=16):
    rng = np.random.default_rng(4)
    n_links = env_t.model.n_links
    f = lambda *s: np.asarray(rng.normal(size=s), np.float32)
    vals = dict(
        base_pos=np.stack([f(B), f(B), rng.uniform(0.0, 0.5, B).astype(np.float32)], 1),
        base_lin_vel=f(B, 3), base_ang_vel=f(B, 3), world_lin_vel=f(B, 3),
        projected_gravity=f(B, 3), roll=f(B), pitch=f(B), yaw=f(B), heading=f(B),
        commands=np.asarray(rng.uniform(-0.3, 1.0, (B, 4)), np.float32),
        dof_pos=f(B, 12), dof_vel=f(B, 12), last_dof_vel=f(B, 12), torques=f(B, 12),
        last_torques=f(B, 12), actions=f(B, 12), last_actions=f(B, 12),
        link_forces=f(B, n_links, 3) * 80.0, feet_pos=f(B, 4, 3), feet_vel=f(B, 4, 3),
        last_contact_heights=f(B, 4), contact_filt=rng.random((B, 4)) < 0.5,
        feet_air_time=np.abs(f(B, 4)), first_contact=rng.random((B, 4)) < 0.5,
        phases=np.asarray(rng.random((B, 4)), np.float32), measured_heights=f(B, 132),
        jump_flags=np.asarray(rng.random(B) < 0.5, np.float32),
        reset_buf=rng.random(B) < 0.3, time_out_buf=rng.random(B) < 0.1,
        progress=np.asarray(rng.uniform(0.0, 2.0, B), np.float32),
    )
    vals["commands"][:4, :3] = 0.0   # no command: no progress paid
    ctx_t = rew.RewardCtx(**{k: torch.as_tensor(vals[k]) for k in rew.RewardCtx._fields})
    ctx_j = jrew.RewardCtx(**{k: jnp.asarray(vals[k]) for k in jrew.RewardCtx._fields})
    return ctx_t, ctx_j


def test_stage_reward_terms_match_reference():
    env_j, env_t = _envs("go2_parkour_commit", 2)
    ctx_t, ctx_j = _reward_ctxs(env_t)
    assert env_t.reward_statics.max_contact_force == 75.0
    for name in ("progress", "contact_forces", "feet_contact_forces", "min_height"):
        got = rew.REWARD_REGISTRY[name](ctx_t, env_t.reward_statics)
        ref = jrew.REWARD_REGISTRY[name](ctx_j, env_j.reward_statics)
        _close(got, ref, REW_TOL, name)
        assert float(got.abs().sum()) > 0, name


# ---------------------------------------------------------------- (f) command curriculum

@pytest.fixture(scope="module")
def curriculum_envs():
    return _envs("go2", 16, **{"commands.curriculum": True})


@pytest.mark.parametrize("case", ["gated", "gated_poor", "not_gated", "gated_forward_only"])
def test_command_curriculum_matches_reference(curriculum_envs, case):
    env_j, env_t = curriculum_envs
    reverse = 0.5 if case == "gated_forward_only" else -1.0
    for env in (env_j, env_t):
        env.cfg.commands.max_reverse_vel = reverse
    rng = np.random.default_rng(6)
    B, n = 16, len(env_t.episode_sum_names)
    k = env_t.episode_sum_names.index("tracking_lin_vel")
    sums = np.asarray(rng.uniform(0.0, 1.0, (B, n)), np.float32)
    full = env_t.max_episode_length * next(s for nm, _, s in env_t.reward_terms
                                           if nm == "tracking_lin_vel")
    sums[:, k] = full * (0.5 if case == "gated_poor" else 0.95)
    reset = rng.random(B) < 0.5
    step = env_t.max_episode_length * 3 + (1 if case == "not_gated" else 0)
    cr = np.asarray([[0.6, 1.2], [-0.5, 0.5], [-1.0, 1.0], [-3.14, 3.14]], np.float32)
    st = lambda A: types.SimpleNamespace(common_step=step, episode_sums=A(sums),
                                         command_ranges=A(cr))
    got = env_t._update_command_curriculum(st(torch.as_tensor), torch.as_tensor(reset))
    ref = env_j._update_command_curriculum(st(jnp.asarray), jnp.asarray(reset))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    widened = not np.array_equal(got.numpy(), cr)
    assert widened == (case in ("gated", "gated_forward_only")), case


# ---------------------------------------------------------------- (g) the ladder

LADDER = ("go2_parkour", "go2_parkour_finetune", "go2_parkour_finetune2")


def _stage_cfg(task):
    cfg, _ = task_registry.get_cfgs(task)
    cfg.terrain.num_cols = 2   # the rows stay
    return cfg


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    """go2_parkour for 1 iteration, then finetune and finetune2 for 1 each, at
    8 envs; the stages resume through their configs (no --resume), each from
    the newest run, which is the last stage's (run names s0 < s1 < s2)."""
    root = str(tmp_path_factory.mktemp("logs"))
    out = []
    for i, task in enumerate(LADDER):
        args = train_script.get_args(["--task", task, "--num_envs", "8", "--seed", "2",
                                      "--max_iterations", "1", "--device", "cpu",
                                      "--run_name", f"s{i}"])
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            runner, history = train_script.train(args, log_root=root, env_cfg=_stage_cfg(task))
        out.append((runner, history, text.getvalue()))
    return root, out


def test_ladder_resumes_each_stage(ladder):
    root, stages = ladder
    runs = sorted(os.listdir(root))
    assert [r.rsplit("_", 1)[1] for r in runs] == ["s0", "s1", "s2"]
    for i, (task, (runner, history, text)) in enumerate(zip(LADDER, stages)):
        assert [h["iteration"] for h in history] == [i]
        assert all(np.isfinite(v) for h in history for kk, v in h.items() if kk.endswith("loss"))
        _, train_j = jtask_registry.get_cfgs(task)
        ref = JPPOConfig.from_cfg(train_j.algorithm, resume=train_j.runner.resume)
        assert runner.ppo_cfg.entropy_coef == ref.entropy_coef
        if i == 0:
            assert "Loading model from" not in text and history[0]["update"] == "dagger"
            continue
        prev = os.path.join(root, runs[i - 1], f"model_{i}.pt")
        assert f"Loading model from: {prev}" in text
        assert history[0]["update"] == "ppo"
        assert history[0]["reg_coef"] == pytest.approx(0.1, abs=1e-6)   # the resume schedule
        assert runner.train_state.total_updates == i + 1
    assert stages[2][0].ppo_cfg.entropy_coef == 0.0
    assert stages[2][0].env.reward_statics.jump_zone_fwd_gate == 0.3


# ---------------------------------------------------------------- (h) eval and export

def test_eval_far_edges_keep_the_reference_formula():
    """eval_parkour counts a gap crossed past x + length + 0.05 m, as the
    reference does (eval_parkour.py:82).  The terrain's gaps are centred on
    x: on the gap-commit course each ends at x + length / 2 (whole cells),
    so the reference's count asks for length / 2 more ground than the gap
    takes.  The port keeps the formula; the reference is the side at fault."""
    cfg, _ = task_registry.get_cfgs("go2_parkour_gap_commit")
    pk = cfg.terrain.parkour_kwargs
    far, is_gap = eval_parkour.course_edges(pk)
    np.testing.assert_array_equal(far, np.asarray(pk["x_positions"]) + pk["obstacle_lengths"])
    assert is_gap.all()
    cfg.terrain.num_rows = cfg.terrain.num_cols = 1
    line = Terrain(cfg.terrain, 1, np.random.default_rng(0)).height_field_raw[250:-250, 300]
    ends = np.nonzero(np.diff((line == -400).astype(int)) == -1)[0] + 1   # first cell after a gap
    cells = [round(w / 0.1) // 2 for w in pk["obstacle_lengths"]]
    np.testing.assert_allclose(ends * 0.1, [round(x / 0.1) * 0.1 + c * 0.1 for x, c in
                                            zip(pk["x_positions"], cells) if c], atol=1e-9)
    assert (far[[c > 0 for c in cells]] - ends * 0.1 > 0.05).all()


@pytest.mark.parametrize("course", ["gaps", "finetune"])
def test_eval_parkour_on_the_ladder_checkpoint(ladder, course, capsys):
    root, _ = ladder
    argv = ["--task", "go2_parkour_finetune2", "--num_envs", "8", "--steps", "20",
            "--course", course, "--device", "cpu"]
    result = eval_parkour.main(eval_parkour.get_args(argv), log_root=root)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
    name = "eval_gaps015.json" if course == "gaps" else "eval_composite_commit_stage.json"
    with open(os.path.join(EVAL_KEYS, name)) as f:
        assert list(result) == list(json.load(f))
    assert result["checkpoint"].endswith("model_3.pt") and result["course"] == course
    assert all(np.isfinite(v) for v in result.values() if isinstance(v, (int, float)))
    assert result["best_x_max"] > 0.0


# the stall test's spawns, with env 6 set down past the first gap of either
# course (x = 2 + 5.4: beyond 5.0 + 0.3 + 0.05 and the first composite's
# 7.1 + 0.05, before the gaps course's second gap at 8.5)
EVAL_FIRST = np.where(np.arange(B_STALL)[:, None] == 6, [5.4, 0.0], FIRST)


@pytest.fixture(scope="module")
def eval_checkpoints(tmp_path_factory):
    """One set of random weights as a JAX runner checkpoint and, carried by
    `params_from_flax`, as a port checkpoint: (JAX path, port path)."""
    d = tmp_path_factory.mktemp("eval_ckpt")
    env_j, env_t = _envs("go2_parkour_commit", B_STALL)
    runner_j = JRunner(env_j, jtask_registry.get_cfgs("go2_parkour_commit")[1], log_dir=None,
                       use_mesh=False)
    runner_t = OnPolicyRunner(env_t, task_registry.get_cfgs("go2_parkour_commit")[1],
                              log_dir=None)
    runner_t.nets.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                                runner_j.train_state.params)))
    runner_j.save(str(d / "jax_model"))
    runner_t.save(str(d / "model.pt"))
    return str(d / "jax_model"), str(d / "model.pt")


@pytest.mark.parametrize("course", ["gaps", "finetune"])
def test_eval_parkour_matches_the_reference_tool(eval_checkpoints, course, monkeypatch):
    """Both tools on the same weights, course and spawns (the stall test's
    injected draws, domain randomization left off as the tools set it): the
    counts are equal, the course x to the tools' 0.01 m rounding."""
    _, quat, lin, cmds = _stall_draws()
    for reg, side in ((jtask_registry, "jax"), (task_registry, "torch")):
        def make_env(name, args=None, env_cfg=None, reg=reg, side=side, **device):
            env = reg.task_classes[name](env_cfg, SYNTHETIC_GO2_URDF, name="go2", terrain_seed=3,
                                         **device)
            _inject(env, side, None, quat, lin, cmds, first=EVAL_FIRST)
            return env, env_cfg
        monkeypatch.setattr(reg, "make_env", make_env)
    argv = ["--task", "go2_parkour_commit", "--num_envs", str(B_STALL), "--steps", "20",
            "--course", course]
    ckpt_j, ckpt_t = eval_checkpoints
    ref = jeval_parkour.main(jeval_parkour.get_args(argv + ["--ckpt_path", ckpt_j]))
    got = eval_parkour.main(eval_parkour.get_args(argv + ["--ckpt_path", ckpt_t,
                                                          "--device", "cpu"]))
    assert list(got) == list(ref)
    assert got.pop("checkpoint") == ckpt_t and ref.pop("checkpoint") == ckpt_j
    for key in ref:
        if key.startswith("best_x"):
            assert got[key] == pytest.approx(ref[key], abs=0.01 + 1e-9), key
        else:
            assert got[key] == ref[key], key
    # env 7 (upside down) dies on its first step, env 6 spawns past the first
    # gap, and every env that stands drops from its spawn height in flight
    assert ref["survived_frac"] == 0.875 and ref["best_x_max"] > 7.4
    assert ref["gaps_crossed_max"] == (1 if course == "gaps" else 2)
    assert ref.get("composites_crossed_max", 1) == 1 and ref["flight_runs_p50"] == 1.0


def test_export_bundle_loads_into_the_numpy_runtime(ladder, tmp_path):
    root, stages = ladder
    runner = stages[2][0]
    out = str(tmp_path / "cliff_bundle.npz")
    args = export_bundle.get_args(["--task", "go2_parkour_finetune2", "--out", out,
                                   "--device", "cpu"])
    assert export_bundle.main(args, log_root=root).endswith("model_3.pt")
    bundle = load_policy_bundle(out)
    policy, estimator = NumpyMLP(bundle["policy"]), NumpyMLP(bundle["estimator"])
    scan_encoder, adaptation = NumpyMLP(bundle["scan_encoder"]), NumpyAdaptationEncoder(
        bundle["adaptation_module"])
    obs = runner.obs
    o, s = obs.obs[0].numpy(), obs.scan[0].numpy()
    nets = runner.nets
    hist = o[: -nets.num_proprio].reshape(nets.history_buffer_length, nets.num_proprio)
    act = policy(np.concatenate([o, adaptation(hist), scan_encoder(s), estimator(o)]))
    ref = runner.get_inference_policy()(obs)[0].numpy()
    np.testing.assert_allclose(act, ref, rtol=0, atol=1e-4)
