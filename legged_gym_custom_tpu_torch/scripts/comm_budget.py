"""The collectives of one training iteration across ranks, torch port of
legged_gym_custom_tpu/scripts/comm_budget.py.

The JAX tool reads them from the compiled HLO of the sharded phases.  The
port has no HLO: every collective of the training path goes through a
helper of `parallel/mesh.py`, which records its kind and bytes by phase.
This tool runs one collection, one PPO update and one DAgger update of
`--task` at world size 2 (gloo ranks on the CPU, `--num_envs` global) and
prints what the helpers recorded, under the JAX tool's keys: per phase
`total_bytes_per_step` (bytes over all its collectives) and `counts`, with
`rollout_T` and `update_minibatch_rounds`.  The rollout itself issues no
collective, so the collection's count does not grow with T.

Run: python -m legged_gym_custom_tpu_torch.scripts.comm_budget [--task go2]
         [--num_envs 16] [--num_steps_per_env T] [--out file.json]
"""
from __future__ import annotations

import argparse
import json

PHASES = ("collect", "update", "update_dagger")


def _rank(mesh, task: str, num_envs: int, num_steps_per_env):
    from legged_gym_custom_tpu_torch.envs import task_registry
    from legged_gym_custom_tpu_torch.rl import ppo as ppo_lib
    from legged_gym_custom_tpu_torch.rl.runner import OnPolicyRunner

    env_cfg, train_cfg = task_registry.get_cfgs(task)
    env_cfg.env.num_envs = num_envs // mesh.world_size
    if num_steps_per_env is not None:
        train_cfg.runner.num_steps_per_env = num_steps_per_env
    env = task_registry.task_classes[task](env_cfg, env_cfg.asset.file, name=task,
                                           device=mesh.device, mesh=mesh)
    runner = OnPolicyRunner(env, train_cfg, log_dir=None)
    runner.env_state, runner.obs = env.reset_all(runner.generator)
    mesh.comm.reset()
    with runner._phase("collect"):
        traj, returns, advantages, _ = runner._collect(False)
    with runner._phase("update"):
        ppo_lib.ppo_update(runner.ppo_cfg, runner.train_state, traj, returns, advantages,
                           runner.generator, mesh=mesh)
    with runner._phase("update_dagger"):
        ppo_lib.dagger_update(runner.ppo_cfg, runner.train_state, traj, runner.generator,
                              mesh=mesh)
    cfg = runner.ppo_cfg
    return {"comm": mesh.comm, "backend": mesh.backend,
            "rollout_T": runner.num_steps_per_env,
            "update_minibatch_rounds": cfg.num_learning_epochs * cfg.num_mini_batches}


def run(task: str = "go2", num_envs: int = 16, num_steps_per_env=None, world_size: int = 2,
        timeout: float = 600.0) -> dict:
    from legged_gym_custom_tpu_torch.parallel.multihost import spawn_ranks

    ranks = spawn_ranks(_rank, world_size, (task, num_envs, num_steps_per_env), device="cpu",
                        timeout=timeout)
    if any(r["comm"].entries != ranks[0]["comm"].entries for r in ranks):
        raise RuntimeError("comm_budget: the ranks issued different collectives")
    r0 = ranks[0]
    result = {"task": task, "num_envs": num_envs, "world_size": world_size,
              "backend": r0["backend"], "rollout_T": r0["rollout_T"],
              "update_minibatch_rounds": r0["update_minibatch_rounds"]}
    for phase in PHASES:
        s = r0["comm"].summary(phase)
        result[phase] = {"total_bytes_per_step": s.pop("total_bytes"), **s}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="go2")
    ap.add_argument("--num_envs", type=int, default=16)
    ap.add_argument("--num_steps_per_env", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    result = run(args.task, args.num_envs, args.num_steps_per_env)
    print(json.dumps({k: result[k] for k in
                      ("collect", "update", "rollout_T", "update_minibatch_rounds")}, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
