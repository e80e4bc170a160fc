"""Rank functions of the port's data-parallel tests, for
`parallel.multihost.spawn_ranks`: each runs in its own process on a gloo
rank of the CPU and imports neither JAX nor the JAX package, so a spawned
rank starts in a few seconds.  Each takes the rank's mesh and picklable
inputs (numpy arrays, dicts) and returns picklable results."""
import contextlib
import types

import numpy as np
import torch

from legged_gym_custom_tpu_torch.envs import task_registry
from legged_gym_custom_tpu_torch.models.networks import ActorCriticNetworks
from legged_gym_custom_tpu_torch.parallel import mesh as tmesh
from legged_gym_custom_tpu_torch.parallel import multihost
from legged_gym_custom_tpu_torch.rl import ppo as tppo
from legged_gym_custom_tpu_torch.rl.runner import OnPolicyRunner

CURRICULUM_ENVS = 16   # the global batch of the command-curriculum case
# the command curriculum on, with room above go2's lin_vel_x range of [-1, 1]
CURRICULUM = dict(curriculum=True, max_forward_vel=2.0, max_reverse_vel=-2.0)


def _nets(spec):
    nets = ActorCriticNetworks(types.SimpleNamespace(**spec["policy"]), **spec["dims"])
    nets.load_state_dict({k: torch.as_tensor(v) for k, v in spec["params"].items()})
    return nets


def _shard(mesh, x):
    """This rank's (T, B / n, ...) columns of a (T, B, ...) array."""
    n = x.shape[1] // mesh.world_size
    return torch.as_tensor(np.ascontiguousarray(x[:, mesh.rank * n:(mesh.rank + 1) * n]))


def update(mesh, spec, traj, returns, advantages, perms, dagger):
    """One PPO (or DAgger) update on this rank's shard with its permutation;
    returns (state_dict, metrics, learning rate, total updates, collectives)."""
    nets = _nets(spec)
    cfg = tppo.PPOConfig(**spec["ppo"])
    ts = tppo.TrainState(nets, cfg)
    tr = tppo.Transition(*[_shard(mesh, x) for x in traj])
    perm = torch.as_tensor(perms[mesh.rank])
    with mesh.comm.in_phase("update"):
        if dagger:
            m = tppo.dagger_update(cfg, ts, tr, perm=perm, mesh=mesh)
        else:
            m = tppo.ppo_update(cfg, ts, tr, _shard(mesh, returns), _shard(mesh, advantages),
                                perm=perm, mesh=mesh)
    return ({k: v.numpy() for k, v in nets.state_dict().items()},
            {k: float(v) for k, v in m.items()}, ts.learning_rate, ts.total_updates,
            mesh.comm.entries)


def gae(mesh, traj, last_values):
    """`compute_gae` on this rank's shard over the mesh."""
    tr = tppo.Transition(*[_shard(mesh, x) for x in traj])
    n = last_values.shape[0] // mesh.world_size
    last = torch.as_tensor(last_values[mesh.rank * n:(mesh.rank + 1) * n])
    ret, adv = tppo.compute_gae(tr, last, 0.99, 0.95, mesh=mesh)
    return ret.numpy(), adv.numpy(), mesh.comm.entries


def local_counts(mesh, totals):
    """`local_env_count` of each total: the count, or the assertion's args."""
    out = []
    for total in totals:
        try:
            out.append(multihost.local_env_count(total))
        except AssertionError as e:
            out.append(("AssertionError", e.args[0]))
    return out, mesh.backend, mesh.world_size


def go2_env(mesh=None, num_envs=8, **commands):
    """go2 on the CPU at `num_envs` global envs (this rank's share with a
    mesh), its `commands` config overridden."""
    cfg, train_cfg = task_registry.get_cfgs("go2")
    cfg.env.num_envs = num_envs if mesh is None else num_envs // mesh.world_size
    for k, v in commands.items():
        setattr(cfg.commands, k, v)
    return task_registry.task_classes["go2"](cfg, cfg.asset.file, name="go2", device="cpu",
                                             mesh=mesh), train_cfg


def runner_on_rank(mesh):
    """The runner of a go2 env on this rank: (its mesh is the env's, primary,
    the generator's first draw, the flat parameters)."""
    env, train_cfg = go2_env(mesh)
    runner = OnPolicyRunner(env, train_cfg, log_dir=None)
    flat = torch.cat([t.detach().reshape(-1) for t in runner.nets.state_dict().values()])
    return (runner.mesh is env.mesh, runner.is_primary,
            torch.rand(4, generator=runner.generator).numpy(), flat.numpy())


def curriculum_start(env, reset_envs, v):
    """The one-process go2 state two steps before a step gated for the
    command curriculum (common_step % max_episode_length == 0): each env's
    tracking_lin_vel episode sum is `v` x the term's scale x the episode
    length (mean over the resetting envs above 0.8: widen), and the envs of
    `reset_envs` time out on the gated step."""
    state, _ = env.reset_all(torch.Generator().manual_seed(0))
    L = env.max_episode_length
    idx = env.episode_sum_names.index("tracking_lin_vel")
    scale = next(s for n, _, s in env.reward_terms if n == "tracking_lin_vel")
    sums = state.episode_sums.clone()
    sums[:, idx] = torch.as_tensor(v) * scale * L
    mask = torch.zeros(env.num_envs, dtype=torch.bool)
    mask[list(reset_envs)] = True
    return state.replace(common_step=L - 2, episode_sums=sums,
                         episode_length=torch.where(mask, L - 1, 0))


def rank_slice(state, rank, world_size, num_envs):
    """Rank `rank`'s envs of a one-process state; the replicated leaves
    (command ranges) whole."""
    n = num_envs // world_size
    cut = lambda x: x[rank * n:(rank + 1) * n] if x.dim() and x.shape[0] == num_envs else x
    return tmesh._tree_map(cut, state)


def curriculum_steps(env, state, comm=None):
    """Two zero-action steps (the second gated): per step (command ranges,
    dones, the collectives the step issued)."""
    out = []
    for i in range(2):
        phase = f"step{i}"
        with comm.in_phase(phase) if comm is not None else contextlib.nullcontext():
            state, _, _, dones, _ = env.step(state, torch.zeros(env.num_envs, env.num_actions))
        out.append((state.command_ranges.numpy(), dones.numpy(),
                    comm.summary(phase) if comm is not None else None))
    return out


def command_curriculum(mesh, reset_envs, v):
    """This rank's two steps from its slice of the one-process start."""
    full, _ = go2_env(num_envs=CURRICULUM_ENVS, **CURRICULUM)
    state = rank_slice(curriculum_start(full, reset_envs, v), mesh.rank, mesh.world_size,
                       CURRICULUM_ENVS)
    env, _ = go2_env(mesh, num_envs=CURRICULUM_ENVS, **CURRICULUM)
    return curriculum_steps(env, state, mesh.comm)


def _params_sha(nets) -> str:
    import hashlib

    flat = torch.cat([t.detach().reshape(-1).float().cpu() for t in nets.state_dict().values()])
    return hashlib.sha256(flat.numpy().tobytes()).hexdigest()


def train_script_on_rank(mesh, runs, log_root, parkour=False):
    """`scripts.train.train` on this rank for each argv of `runs`, in turn,
    into `log_root`; a run of task `go2_stage` trains go2 with a config
    that sets `runner.resume`, as the parkour stages do.  Records the seeds
    `set_seed` gave, this rank's calls of `get_load_path` and what each
    `runner.load` loaded (path, parameters' checksum, iteration).  Returns
    per run: the env's share, its plane grid of origins (`_initial_origins`
    of a generator seeded 0), the run directory, the iterations trained and
    the parameters' checksum; with `parkour`, an unseeded go2_parkour env's
    terrain checksum and types built after the runs.  One torch thread a
    rank: the eager CPU step's small ops only lose to more threads when
    other processes share the cores."""
    import hashlib
    import importlib

    torch.set_num_threads(1)

    from legged_gym_custom_tpu_torch.envs.go2_config import Go2Cfg, Go2CfgPPO
    from legged_gym_custom_tpu_torch.envs.go2_env import Go2Env
    from legged_gym_custom_tpu_torch.scripts import train as train_script

    # the module: `utils.task_registry` as an attribute is the registry
    registry_lib = importlib.import_module("legged_gym_custom_tpu_torch.utils.task_registry")

    class StageCfgPPO(Go2CfgPPO):
        class runner(Go2CfgPPO.runner):
            resume = True

    task_registry.register("go2_stage", Go2Env, Go2Cfg, StageCfgPPO)
    seeds, listed, loads = [], [], []
    set_seed, get_load_path = registry_lib.set_seed, registry_lib.get_load_path

    def record_seed(seed):
        seeds.append(set_seed(seed))
        return seeds[-1]

    def record_listing(*a, **kw):
        listed.append(get_load_path(*a, **kw))
        return listed[-1]

    registry_lib.set_seed, registry_lib.get_load_path = record_seed, record_listing
    load = OnPolicyRunner.load

    def record_load(self, path, *a, **kw):
        out = load(self, path, *a, **kw)
        loads.append((path, _params_sha(self.nets), self.current_learning_iteration))
        return out

    OnPolicyRunner.load = record_load
    out = []
    for argv in runs:
        runner, history = train_script.train(train_script.get_args(argv), log_root=log_root)
        env = runner.env
        out.append({"num_envs": env.num_envs, "env_offset": env.env_offset,
                    "mesh_is_env_mesh": runner.mesh is env.mesh and env.mesh.rank == mesh.rank,
                    "origins": env._initial_origins(torch.Generator().manual_seed(0))[2].numpy(),
                    "log_dir": runner.log_dir, "iterations": [h["iteration"] for h in history],
                    "params_sha256": _params_sha(runner.nets)})
    result = {"runs": out, "seeds": seeds, "listed": listed, "loads": loads}
    if parkour:
        env, _ = task_registry.make_env("go2_parkour", args=train_script.get_args(
            ["--task", "go2_parkour", "--num_envs", "16", "--device", "cpu"]), device="cpu",
            mesh=mesh)
        result["parkour"] = {
            "terrain_sha256": hashlib.sha256(env.hf.data.numpy().tobytes()).hexdigest(),
            "terrain_types": env.terrain_types.numpy(), "env_offset": env.env_offset}
    return result
