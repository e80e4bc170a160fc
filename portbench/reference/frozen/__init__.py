"""A frozen copy of the plain PyTorch modules of `legged_gym_custom_tpu_torch`
(the env, its eager physics, the terrain generator, the networks, the PPO /
DAgger update, MPPI and the kernel's operation count), with the package's
name rewritten to this one's.  It is the benchmark's plain reference: it
imports nothing of the program, steps the eager engine where the program
launches its fused kernel, and a later change to the program does not change
it.  Edits against the copied files: `envs/base_env.py` never chooses the
kernel; `envs/__init__.py` holds the port's registrations as one table,
`TASKS` (task name -> env class, env config, train config), in place of the
task registry; `ops/fused_step.py` keeps only the plain half; `rl/ppo.py`'s
updates stop after `max_steps` optimizer steps and report each step to
`record`; `parallel/mesh.py` is a stand-in for one process.  The other
copies (the ANYmal, Cassie and G1 envs and configs, `models/actuator_net.py`,
the synthetic URDFs under `resources/robots/`) are unedited but for the
package's name."""
import os

import torch

LEGGED_GYM_RESOURCES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "resources")


def resolve_device(device="cuda") -> torch.device:
    return torch.device(device)
