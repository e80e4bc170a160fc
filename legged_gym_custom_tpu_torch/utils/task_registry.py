"""Task registry, torch port of legged_gym_custom_tpu/utils/task_registry.py.

Maps task name -> (env class, env cfg class, train cfg class) and builds
envs/runners with CLI overrides applied; with `runner.resume` the runner
loads the checkpoint `get_load_path` picks.

With a mesh (parallel/mesh.py) the env count of the config is the global
one and each rank builds its share; the primary rank draws the seed, names
the run directory and resolves the checkpoint to resume, and broadcasts
each, so every rank builds the same terrain, writes into one directory and
loads one file (a rank that listed the log root itself could find the
primary's new, empty run directory as the newest run).
"""
from __future__ import annotations

import os
from datetime import datetime
from typing import Dict

from legged_gym_custom_tpu_torch.parallel.mesh import broadcast_object
from .config import set_seed


class TaskRegistry:
    def __init__(self):
        self.task_classes: Dict[str, type] = {}
        self.env_cfgs: Dict[str, type] = {}
        self.train_cfgs: Dict[str, type] = {}

    def register(self, name: str, task_class, env_cfg, train_cfg) -> None:
        self.task_classes[name] = task_class
        self.env_cfgs[name] = env_cfg
        self.train_cfgs[name] = train_cfg

    def get_task_class(self, name: str):
        return self.task_classes[name]

    def get_cfgs(self, name: str):
        """Fresh instantiated cfg pair for the task."""
        return self.env_cfgs[name](), self.train_cfgs[name]()

    def make_env(self, name: str, args=None, env_cfg=None, device="cuda", mesh=None):
        """Build the env object on `device` (reference :35-72).  With `mesh`
        the config's `env.num_envs` is the global count: it becomes this
        rank's share (`multihost.local_env_count`), and every rank takes the
        primary's seed."""
        if name not in self.task_classes:
            raise ValueError(f"Task with name: {name} was not registered")
        task_class = self.get_task_class(name)
        if env_cfg is None:
            env_cfg, _ = self.get_cfgs(name)
        if args is not None:
            update_cfg_from_args(env_cfg, None, args)
        seed = set_seed(getattr(args, "seed", None) if args else None)
        if mesh is not None:
            from legged_gym_custom_tpu_torch.parallel.multihost import local_env_count

            env_cfg.env.num_envs = local_env_count(env_cfg.env.num_envs)
            seed = set_seed(broadcast_object(mesh, seed))
        env = task_class(env_cfg, env_cfg.asset.file, name=name, device=device,
                         terrain_seed=seed, mesh=mesh)
        return env, env_cfg

    def make_alg_runner(self, env, name=None, args=None, train_cfg=None, log_root="default"):
        """Build the OnPolicyRunner on the env's device (reference :74-125)."""
        from legged_gym_custom_tpu_torch import LEGGED_GYM_TORCH_ROOT_DIR
        from legged_gym_custom_tpu_torch.rl.runner import OnPolicyRunner

        if train_cfg is None:
            if name is None:
                raise ValueError("Either 'name' or 'train_cfg' must be not None")
            _, train_cfg = self.get_cfgs(name)
        if args is not None:
            update_cfg_from_args(None, train_cfg, args)
        if log_root == "default":
            log_root = os.path.join(LEGGED_GYM_TORCH_ROOT_DIR, "logs",
                                    train_cfg.runner.experiment_name)
        mesh = env.mesh
        log_dir = resume_path = None
        if train_cfg.runner.resume and log_root is None:
            raise ValueError("resume needs a log_root to look for runs in")
        if mesh is None or mesh.is_primary:
            if log_root is not None:
                log_dir = os.path.join(log_root, datetime.now().strftime("%b%d_%H-%M-%S")
                                       + "_" + train_cfg.runner.run_name)
            if train_cfg.runner.resume:
                resume_path = get_load_path(log_root, load_run=train_cfg.runner.load_run,
                                            checkpoint=train_cfg.runner.checkpoint)
        log_dir, resume_path = broadcast_object(mesh, (log_dir, resume_path))
        runner = OnPolicyRunner(env, train_cfg, log_dir=log_dir)
        if resume_path is not None:
            if runner.is_primary:
                print(f"Loading model from: {resume_path}", flush=True)
            runner.load(resume_path)
        return runner, train_cfg


def get_load_path(root, load_run=-1, checkpoint=-1):
    """Latest-run / latest-checkpoint resolution (reference helpers.py:103-125):
    the last run directory of `root` by name, skipping `exported`, and in it
    the highest `model_*` (this package's checkpoints end in `.pt`)."""
    try:
        runs = sorted(os.listdir(root))
        if "exported" in runs:
            runs.remove("exported")
        last_run = os.path.join(root, runs[-1])
    except Exception:
        raise ValueError(f"No runs in this directory: {root}")
    load_run = last_run if load_run == -1 else os.path.join(root, load_run)
    if checkpoint == -1:
        models = [f for f in os.listdir(load_run) if "model" in f and not f.endswith(".tmp")]
        models.sort(key=lambda m: f"{m:0>15}")
        model = models[-1]
    else:
        model = f"model_{checkpoint}.pt"
    return os.path.join(load_run, model)


def update_cfg_from_args(env_cfg, cfg_train, args):
    """CLI override whitelist (reference helpers.py:127-150)."""
    if env_cfg is not None:
        if getattr(args, "num_envs", None) is not None:
            env_cfg.env.num_envs = args.num_envs
    if cfg_train is not None:
        if getattr(args, "seed", None) is not None:
            cfg_train.seed = args.seed
        if getattr(args, "max_iterations", None) is not None:
            cfg_train.runner.max_iterations = args.max_iterations
        if getattr(args, "resume", False):
            cfg_train.runner.resume = args.resume
        if getattr(args, "experiment_name", None) is not None:
            cfg_train.runner.experiment_name = args.experiment_name
        if getattr(args, "run_name", None) is not None:
            cfg_train.runner.run_name = args.run_name
        if getattr(args, "load_run", None) is not None:
            cfg_train.runner.load_run = args.load_run
        if getattr(args, "checkpoint", None) is not None:
            cfg_train.runner.checkpoint = args.checkpoint


task_registry = TaskRegistry()
