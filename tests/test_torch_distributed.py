"""The port's data-parallel training on gloo ranks of the CPU: the update of
2 ranks against the JAX package's `shard_map` update over 2 virtual
devices, against one process on the whole batch, the global advantage
normalization, each rank's slice of the env, `shard_env_state`, the comm
budget against the compiled HLO of the JAX update, and world size 1.

Every multi-process case runs its ranks through `spawn_ranks` with a
process-group timeout of TIMEOUT seconds; ranks still running then are
killed and the case fails.  The rank functions are in tests/torch_dist_ranks.py.
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_gym_custom_tpu.envs import task_registry as jtask_registry
from legged_gym_custom_tpu.envs.base_env import Obs as JObs
from legged_gym_custom_tpu.parallel import mesh as jmesh
from legged_gym_custom_tpu.parallel import multihost as jmultihost
from legged_gym_custom_tpu.rl import ppo as jppo
from legged_gym_custom_tpu.rl.runner import OnPolicyRunner as JRunner
from legged_gym_custom_tpu.scripts.comm_budget import summarize
from legged_gym_custom_tpu_torch.envs import task_registry
from legged_gym_custom_tpu_torch.models.networks import params_from_flax
from legged_gym_custom_tpu_torch.parallel import mesh as tmesh
from legged_gym_custom_tpu_torch.parallel import multihost
from legged_gym_custom_tpu_torch.rl import ppo as tppo
from legged_gym_custom_tpu_torch.rl.runner import OnPolicyRunner
from legged_gym_custom_tpu_torch.scripts import comm_budget
import torch_dist_ranks as ranks

TIMEOUT = 120.0
WORLD = 2
T, B = 4, 16                     # global batch; each rank holds B / 2 envs
DIMS = dict(num_proprio=6, num_privileged_obs=5, num_critic_obs=78, num_estimated_obs=3,
            num_scan_obs=4, num_actions=3, history_buffer_length=10)
POLICY = dict(init_noise_std=1.0, actor_hidden_dims=[32, 16], critic_hidden_dims=[32, 16],
              priv_encoder_hidden_dims=[16, 8], scan_encoder_hidden_dims=[16, 8],
              estimator_hidden_dims=[16, 8], use_history=True, latent_encoder_output_dim=8,
              scan_encoder_output_dim=8, activation="elu")
# Parameters after 20 Adam steps from the same start agree at rtol 1e-4 /
# atol 1e-6, all but a few entries, each within 5 % of the farthest Adam can
# move one in these steps (lr x steps): an entry whose gradient sums to
# nearly 0 takes an O(lr) step whose sign follows float32 rounding (as in
# tests/test_torch_jump_tools.py's distill).  A wrong reduction (a sum for a
# mean, a local KL, the clip before the all-reduce) moves most entries.
UPDATE_TOL = dict(rtol=1e-4, atol=1e-6)
FLIPS, FLIP_SHARE = 10, 0.05
# two ranks against one process on the union of their minibatches: the same
# float32 arithmetic but for the order of the minibatch mean's sums
ONE_PROCESS_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_runner():
    """JAX's runner over a 2-device mesh of the conftest's virtual CPU
    devices, on go2's training config with narrow networks.  Only the
    update is run, so the env is a stand-in with the dims."""
    _, train_cfg = jtask_registry.get_cfgs("go2")
    train_cfg.policy = types.SimpleNamespace(**POLICY)
    env = types.SimpleNamespace(cfg=types.SimpleNamespace(env=types.SimpleNamespace(**DIMS)),
                                num_envs=B)
    return JRunner(env, train_cfg, log_dir=None,
                   mesh=jmesh.make_mesh(devices=jax.devices()[:WORLD]))


def _traj(nets, params, seed=2):
    """A (T, B) rollout whose actions come from the JAX policy."""
    rng = np.random.default_rng(seed)
    n_obs = DIMS["num_proprio"] * (1 + DIMS["history_buffer_length"])
    f = lambda *s: rng.normal(size=(T, B) + s).astype(np.float32)
    o = dict(obs=f(n_obs), privileged=f(DIMS["num_privileged_obs"]),
             critic=f(DIMS["num_critic_obs"]), estimated=f(DIMS["num_estimated_obs"]),
             scan=f(DIMS["num_scan_obs"]))
    acts, logp, mu, sigma, values = jax.vmap(
        lambda ob, k: jppo.policy_act(nets, params, JObs(**ob), k, False)
    )(o, jax.random.split(jax.random.PRNGKey(3), T))
    return jppo.Transition(
        obs=o["obs"], privileged=o["privileged"], critic=o["critic"],
        estimated=o["estimated"], scan=o["scan"], actions=np.asarray(acts),
        rewards=rng.normal(size=(T, B)).astype(np.float32), dones=rng.uniform(size=(T, B)) < 0.2,
        values=np.asarray(values), log_probs=np.asarray(logp), mu=np.asarray(mu),
        sigma=np.asarray(sigma))


@pytest.fixture(scope="module")
def sharded_updates():
    """JAX's `_update[False]` and `[True]` over 2 devices, and the same
    updates on 2 gloo ranks fed each device's permutation (`fold_in(key,
    i)`, ppo.py:228-229, :376-377) and the same flax parameters."""
    runner = _jax_runner()
    ts_np = jax.tree.map(np.asarray, runner.train_state)   # the update donates its input
    traj = jax.tree.map(np.asarray, _traj(runner.nets, runner.train_state.params))
    ret, adv = jax.tree.map(np.asarray, jppo.compute_gae(
        jax.tree.map(jnp.asarray, traj), jnp.zeros(B), 0.99, 0.95))
    key = jax.random.PRNGKey(5)
    perms = [np.asarray(jax.random.permutation(jax.random.fold_in(key, i), T * B // WORLD))
             for i in range(WORLD)]
    spec = dict(dims=DIMS, policy=POLICY, ppo=runner.ppo_cfg._asdict(),
                params={k: v.numpy() for k, v in params_from_flax(ts_np.params).items()})
    out = {"spec": spec, "traj": traj, "ret": ret, "adv": adv, "perms": perms,
           "lr0": float(ts_np.learning_rate)}
    for name, dagger in (("ppo", False), ("dagger", True)):
        ts2, m = runner._update[dagger](jax.tree.map(jnp.asarray, ts_np), traj, ret, adv, key)
        out[name + "_jax"] = (params_from_flax(jax.tree.map(np.asarray, ts2.params)),
                              {k: float(v) for k, v in m.items()}, float(ts2.learning_rate),
                              float(ts2.total_updates))
        out[name + "_ranks"] = multihost.spawn_ranks(
            ranks.update, WORLD, (spec, tuple(traj), ret, adv, perms, dagger), timeout=TIMEOUT)
    return out


def _assert_params_close(got, ref, lr, steps, tol=UPDATE_TOL):
    flips = 0
    for name, value in ref.items():
        r = value.numpy()
        err = np.abs(got[name] - r)
        bad = err > tol["atol"] + tol["rtol"] * np.abs(r)
        flips += int(bad.sum())
        assert np.all(err[bad] <= FLIP_SHARE * lr * steps), (name, float(err.max()))
    assert flips <= FLIPS, flips


def _ranks_bit_equal(results):
    sd0 = results[0][0]
    for sd, *_ in results[1:]:
        for name, v in sd.items():
            assert np.array_equal(v.view(np.uint32), sd0[name].view(np.uint32)), name


def _steps_of_1_5(lr, lr0):
    """The net count of x1.5 (up) and /1.5 (down) adaptive-KL steps."""
    return round(math.log(lr / lr0) / math.log(1.5))


def test_ppo_update_on_two_ranks_matches_jax_shard_map(sharded_updates):
    s = sharded_updates
    params_j, m_j, lr_j, upd_j = s["ppo_jax"]
    results = s["ppo_ranks"]
    _ranks_bit_equal(results)
    sd, m_t, lr_t, upd_t, comm = results[0]
    steps = s["spec"]["ppo"]["num_learning_epochs"] * s["spec"]["ppo"]["num_mini_batches"]
    _assert_params_close(sd, params_j, max(lr_t, lr_j, s["lr0"]), steps)
    for k in ("value_loss", "surrogate_loss", "reg_loss", "est_loss", "kl_mean"):
        np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-4, atol=1e-6, err_msg=k)
    # the adaptive-KL learning rate: the same steps up and down, on both
    # ranks, and the same value but for float32 rounding of JAX's
    assert all(r[2] == lr_t for r in results)
    assert _steps_of_1_5(lr_t, s["lr0"]) == _steps_of_1_5(lr_j, s["lr0"])
    assert lr_t != s["lr0"]            # the KL moved it in these steps
    assert np.float32(lr_t) == pytest.approx(lr_j, rel=1e-6)
    assert upd_t == upd_j == 1.0
    # one all-reduce a minibatch round
    assert comm["update"]["all-reduce"][0] == steps


def test_dagger_update_on_two_ranks_matches_jax_shard_map(sharded_updates):
    s = sharded_updates
    params_j, m_j, _, upd_j = s["dagger_jax"]
    results = s["dagger_ranks"]
    _ranks_bit_equal(results)
    sd, m_t, _, upd_t, _ = results[0]
    steps = s["spec"]["ppo"]["num_learning_epochs"] * s["spec"]["ppo"]["num_mini_batches"]
    _assert_params_close(sd, params_j, s["lr0"], steps)
    np.testing.assert_allclose(m_t["adaptation_loss"], m_j["adaptation_loss"], rtol=1e-5)
    assert upd_t == upd_j == 1.0


def _union_perm(perms, mb):
    """The one-process permutation whose k-th minibatch is the union of the
    ranks' k-th minibatches, in global (T, B) flat indices."""
    b = B // WORLD
    rounds = []
    for k in range(len(perms[0]) // mb):
        for r, p in enumerate(perms):
            j = p[k * mb:(k + 1) * mb]
            rounds.append((j // b) * B + r * b + j % b)
    return torch.as_tensor(np.concatenate(rounds))


@pytest.mark.parametrize("dagger", [False, True], ids=["ppo", "dagger"])
def test_two_ranks_equal_one_process_on_the_union_of_their_minibatches(sharded_updates, dagger):
    """The mean over ranks of each rank's minibatch mean is the mean over the
    union: two ranks on shards of one batch take the step one process takes
    on the whole batch with the union minibatches."""
    s = sharded_updates
    spec = s["spec"]
    nets = ranks._nets(spec)
    cfg = tppo.PPOConfig(**spec["ppo"])
    ts = tppo.TrainState(nets, cfg)
    traj = tppo.Transition(*[torch.as_tensor(np.asarray(x)) for x in s["traj"]])
    perm = _union_perm(s["perms"], T * B // WORLD // cfg.num_mini_batches)
    if dagger:
        tppo.dagger_update(cfg, ts, traj, perm=perm)
    else:
        tppo.ppo_update(cfg, ts, traj, torch.as_tensor(s["ret"]), torch.as_tensor(s["adv"]),
                        perm=perm)
    sd, _, lr_t, *_ = s["dagger_ranks" if dagger else "ppo_ranks"][0]
    for name, v in nets.state_dict().items():
        np.testing.assert_allclose(sd[name], v.numpy(), err_msg=name, **ONE_PROCESS_TOL)
    assert ts.learning_rate == lr_t


def test_advantage_normalization_is_global():
    """The ranks' advantages, concatenated, equal `compute_gae` on the whole
    batch: the mean and variance are the global batch's.  The shards' own
    statistics differ (rank 1's rewards are shifted), so a local
    normalization would not."""
    rng = np.random.default_rng(7)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    rewards[:, B // 2:] += 2.0
    f = lambda *s: rng.normal(size=(T, B) + s).astype(np.float32)
    traj = tppo.Transition(obs=f(2), privileged=f(2), critic=f(2), estimated=f(2), scan=f(2),
                           actions=f(3), rewards=rewards, dones=rng.uniform(size=(T, B)) < 0.2,
                           values=f(), log_probs=f(), mu=f(3), sigma=f(3))
    last = rng.normal(size=B).astype(np.float32)
    out = multihost.spawn_ranks(ranks.gae, WORLD, (tuple(traj), last), timeout=TIMEOUT)
    whole = tppo.Transition(*[torch.as_tensor(np.asarray(x)) for x in traj])
    ret, adv = tppo.compute_gae(whole, torch.as_tensor(last), 0.99, 0.95)
    np.testing.assert_allclose(np.concatenate([o[0] for o in out], axis=1), ret.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([o[1] for o in out], axis=1), adv.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert out[0][2]["setup"]["all-reduce"] == [1, 24]   # sum, sum of squares, count in f64
    half = tppo.Transition(*[x[:, B // 2:] for x in whole])
    _, adv_local = tppo.compute_gae(half, torch.as_tensor(last[B // 2:]), 0.99, 0.95)
    assert float((adv_local - adv[:, B // 2:]).abs().max()) > 0.1


def _go2_envs(task, num_envs=B, **cfg_attrs):
    """The one-process env at `num_envs` and the two ranks' envs at half."""
    out = []
    for mesh in (None, *(tmesh.DataMesh(rank=r, world_size=WORLD) for r in range(WORLD))):
        cfg, _ = task_registry.get_cfgs(task)
        cfg.env.num_envs = num_envs if mesh is None else num_envs // WORLD
        out.append(task_registry.task_classes[task](cfg, cfg.asset.file, name=task,
                                                    device="cpu", terrain_seed=3, mesh=mesh))
    return out


def test_rank_envs_are_slices_of_the_one_process_plane_grid():
    full, *parts = _go2_envs("go2")
    gen = lambda: torch.Generator().manual_seed(0)
    origins = full._initial_origins(gen())[2]
    assert [p.env_offset for p in parts] == [0, B // 2]
    assert all(p.num_envs_global == B for p in parts)
    assert torch.equal(torch.cat([p._initial_origins(gen())[2] for p in parts]), origins)
    # not the grid each rank would lay out from its own count
    alone = _go2_envs("go2", num_envs=B // 2)[0]._initial_origins(gen())[2]
    assert not torch.equal(alone, origins[B // 2:])


def test_rank_envs_are_slices_of_the_one_process_terrain():
    full, *parts = _go2_envs("go2_parkour")
    assert full.cfg.terrain.mesh_type == "trimesh"
    assert torch.equal(torch.cat([p.terrain_types for p in parts]), full.terrain_types)
    assert len(set(full.terrain_types.tolist())) > len(set(parts[0].terrain_types.tolist()))
    levels = torch.randint(0, full.cfg.terrain.num_rows, (B,),
                           generator=torch.Generator().manual_seed(1))
    origins = full.terrain_origins[levels, full.terrain_types]
    for r, p in enumerate(parts):
        assert torch.equal(p.terrain_origins, full.terrain_origins)
        sl = slice(p.env_offset, p.env_offset + p.num_envs)
        assert torch.equal(p.terrain_origins[levels[sl], p.terrain_types], origins[sl])


def test_shard_env_state_follows_the_jax_rule():
    """Sliced and replicated leaves as JAX's `shard_env_state` places them
    over 2 devices (mesh.py:38-49): a leaf whose leading dim divides by the
    world size is split, in order; every other leaf is whole on each rank."""
    rng = np.random.default_rng(0)
    shapes = dict(batch=(16, 3), ranges=(4, 2), odd=(3,), scalar=(), one=(1, 5), pair=(2,),
                  six=(6, 2, 2))
    tree = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    devices = jax.devices()[:WORLD]
    placed = jmesh.shard_env_state(jmesh.make_mesh(devices=devices), tree)
    for rank in range(WORLD):
        mesh = tmesh.DataMesh(rank=rank, world_size=WORLD)
        ours = tmesh.shard_env_state(mesh, {k: torch.as_tensor(v) for k, v in tree.items()})
        for k, x in placed.items():
            shard = next(s.data for s in x.addressable_shards if s.device == devices[rank])
            assert tmesh.is_sharded(mesh, torch.as_tensor(tree[k])) == \
                (not x.sharding.is_fully_replicated), k
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(shard), err_msg=k)
    # named tuples, dataclasses and non-tensor leaves keep their structure
    mesh = tmesh.DataMesh(rank=1, world_size=WORLD)
    ph = tppo.Transition(*[torch.arange(4.0)] * 12)
    out = tmesh.shard_env_state(mesh, {"t": ph, "n": 3})
    assert isinstance(out["t"], tppo.Transition) and out["n"] == 3
    assert torch.equal(out["t"].obs, torch.tensor([2.0, 3.0]))


def test_local_env_count_asserts_as_jax_does(monkeypatch):
    got, backend, world = multihost.spawn_ranks(ranks.local_counts, WORLD, ([16, 15],),
                                                timeout=TIMEOUT)[1]
    assert (backend, world) == ("gloo", WORLD)
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    with pytest.raises(AssertionError) as e:
        jmultihost.local_env_count(15)
    assert got == [jmultihost.local_env_count(16), ("AssertionError", e.value.args[0])]
    assert got == [8, ("AssertionError", (15, 2))]


def test_backend_rule():
    assert multihost.choose_backend(["h:cpu", "h:cpu"]) == "gloo"
    assert multihost.choose_backend(["GPU-a", "GPU-a"]) == "gloo"     # ranks share a card
    assert multihost.choose_backend(["GPU-a", "h:cpu"]) == "gloo"
    assert multihost.choose_backend(["GPU-a", "GPU-b"]) == "nccl"
    assert multihost.choose_backend(["GPU-a"]) == "nccl"


def _jax_update_hlo_bytes(dagger):
    """What JAX's comm_budget finds in the compiled HLO of go2's update on
    a 2-device mesh: (bytes of one update, collective counts)."""
    env_cfg, train_cfg = jtask_registry.get_cfgs("go2")
    e = env_cfg.env
    runner = JRunner(types.SimpleNamespace(cfg=env_cfg, num_envs=B), train_cfg, log_dir=None,
                     mesh=jmesh.make_mesh(devices=jax.devices()[:WORLD]))
    z = lambda *s: jnp.zeros((2, B) + s, jnp.float32)
    traj = jppo.Transition(
        obs=z(e.num_proprio * (1 + e.history_buffer_length)), privileged=z(e.num_privileged_obs),
        critic=z(e.num_critic_obs), estimated=z(e.num_estimated_obs), scan=z(e.num_scan_obs),
        actions=z(e.num_actions), rewards=z(), dones=jnp.zeros((2, B), bool), values=z(),
        log_probs=z(), mu=z(e.num_actions), sigma=z(e.num_actions) + 1.0)
    hlo = runner._update[dagger].lower(runner.train_state, traj, z(), z(),
                                       jax.random.PRNGKey(0)).compile().as_text()
    alg = train_cfg.algorithm
    rounds = alg.num_learning_epochs * alg.num_mini_batches
    s = summarize(hlo, rounds)
    return s["total_bytes_per_step"], s["counts"], rounds


@pytest.fixture(scope="module")
def budgets():
    return {steps: comm_budget.run("go2", num_envs=B, num_steps_per_env=steps,
                                   timeout=TIMEOUT) for steps in (2, 4)}


@pytest.mark.parametrize("dagger", [False, True], ids=["ppo", "dagger"])
def test_update_collective_bytes_equal_the_jax_hlo(budgets, dagger):
    ours = budgets[2]["update_dagger" if dagger else "update"]
    ref_bytes, ref_counts, rounds = _jax_update_hlo_bytes(dagger)
    assert budgets[2]["update_minibatch_rounds"] == rounds
    per_round, ref_per_round = ours["total_bytes_per_step"] / rounds, ref_bytes / rounds
    assert per_round == ref_per_round, (
        f"port {per_round} bytes a minibatch round, JAX HLO {ref_per_round}: "
        f"{per_round - ref_per_round:+} bytes ({(per_round - ref_per_round) / 4:+} float32)")
    assert ours["counts"] == ref_counts == {"all-reduce": rounds}


def test_collection_issues_no_collective_inside_the_rollout(budgets):
    """Two all-reduces after the rollout (advantage statistics, episode
    statistics), whatever the rollout's length."""
    a, b = budgets[2], budgets[4]
    assert (a["rollout_T"], b["rollout_T"]) == (2, 4)
    assert a["collect"]["counts"] == b["collect"]["counts"] == {"all-reduce": 2}
    assert a["collect"]["total_bytes_per_step"] == b["collect"]["total_bytes_per_step"]
    assert a["backend"] == "gloo"


def test_helpers_issue_nothing_at_world_size_one():
    mesh = tmesh.make_mesh(devices="cpu")
    assert (mesh.world_size, mesh.rank, mesh.backend) == (1, 0, None)
    x = torch.arange(4.0)
    nets = torch.nn.Linear(2, 2)
    before = {k: v.clone() for k, v in nets.state_dict().items()}
    assert tmesh.all_reduce_sum_(mesh, [x])[0] is x and tmesh.all_reduce_mean_(mesh, [x])[0] is x
    tmesh.shard_params(mesh, nets)
    tmesh.barrier(mesh)
    assert torch.equal(x, torch.arange(4.0))
    assert all(torch.equal(v, before[k]) for k, v in nets.state_dict().items())
    assert tmesh.shard_env_state(mesh, {"x": x})["x"] is x
    assert mesh.comm.entries == {}
    # no process group: one process, the CPU as asked
    assert multihost.init_distributed(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert multihost.is_primary() and multihost.local_env_count(7) == 7


def _train(mesh, iterations=2):
    cfg, train_cfg = task_registry.get_cfgs("go2")
    cfg.env.num_envs = 8
    train_cfg.runner.num_steps_per_env = 2
    env = task_registry.task_classes["go2"](cfg, cfg.asset.file, name="go2", device="cpu",
                                            mesh=mesh)
    runner = OnPolicyRunner(env, train_cfg, log_dir=None)
    history = runner.learn(iterations)
    return runner, history


def test_single_process_runner_unchanged_by_a_world_of_one():
    (r0, h0), (r1, h1) = _train(None), _train(tmesh.make_mesh(devices="cpu"))
    drop = ("env_steps_per_s", "collection_s", "learning_s")
    assert [{k: v for k, v in h.items() if k not in drop} for h in h0] == \
        [{k: v for k, v in h.items() if k not in drop} for h in h1]
    for (name, a), b in zip(r0.nets.state_dict().items(), r1.nets.state_dict().values()):
        assert torch.equal(a, b), name
    assert r1.mesh.comm.entries == {}


def test_runner_takes_the_mesh_of_its_env():
    """Each rank's runner reads the mesh of its env (the two cannot
    disagree), rank 0 is the primary, the parameters are rank 0's on every
    rank, and rank r's generator is seeded seed + r."""
    got = multihost.spawn_ranks(ranks.runner_on_rank, WORLD, timeout=TIMEOUT)
    seed = getattr(task_registry.get_cfgs("go2")[1], "seed", 1)
    assert [g[:2] for g in got] == [(True, True), (True, False)]
    for r, (_, _, draw, _) in enumerate(got):
        np.testing.assert_array_equal(
            draw, torch.rand(4, generator=torch.Generator().manual_seed(seed + r)).numpy())
    assert not np.array_equal(got[0][2], got[1][2])
    np.testing.assert_array_equal(got[0][3], got[1][3])


@pytest.mark.parametrize("reset_envs, widen", [([1, 2, 9, 10], True), ([1, 2, 3, 9], False)],
                         ids=["widen", "hold"])
def test_command_curriculum_reduces_over_ranks(reset_envs, widen):
    """The command curriculum's mean over the resetting envs is a sum and a
    count over all ranks (JAX base_env.py:632-634): on the gated step each
    rank's command ranges equal the one-process env's, where each rank alone
    would decide otherwise (rank 0's resetting envs track badly, rank 1's
    well), through one all-reduce on that step and none on the step before."""
    n = ranks.CURRICULUM_ENVS
    v = np.where(np.arange(n) < n // WORLD, 0.1, 2.0).astype(np.float32)
    full, _ = ranks.go2_env(num_envs=n, **ranks.CURRICULUM)
    start = ranks.curriculum_start(full, reset_envs, v)
    ref = ranks.curriculum_steps(full, start)
    cr0 = start.command_ranges.numpy()
    assert not ref[0][1].any() and np.array_equal(ref[1][1], np.isin(np.arange(n), reset_envs))
    np.testing.assert_array_equal(ref[0][0], cr0)
    assert (not np.array_equal(ref[1][0], cr0)) == widen
    got = multihost.spawn_ranks(ranks.command_curriculum, WORLD, (reset_envs, v),
                                timeout=TIMEOUT)
    for r, steps in enumerate(got):
        sl = slice(r * n // WORLD, (r + 1) * n // WORLD)
        for (cr, dones, _), (ref_cr, ref_dones, _) in zip(steps, ref):
            np.testing.assert_array_equal(cr, ref_cr)
            np.testing.assert_array_equal(dones, ref_dones[sl])
        assert steps[0][2]["counts"] == {}
        assert steps[1][2] == {"total_bytes": 16, "counts": {"all-reduce": 1},
                               "bytes": {"all-reduce": 16}}
    # the case has power: one rank's envs alone give another decision
    alone = []
    for r in range(WORLD):
        env, _ = ranks.go2_env(num_envs=n // WORLD, **ranks.CURRICULUM)
        state = ranks.rank_slice(start, r, WORLD, n)
        alone.append(not np.array_equal(ranks.curriculum_steps(env, state)[1][0], cr0))
    assert alone == [False, True]
