"""legged_gym_custom_tpu_torch — the PyTorch/CUDA port of legged_gym_custom_tpu.

The JAX package beside it (`legged_gym_custom_tpu/`) is the reference; this
package mirrors its layout and names so each counterpart is found by path:

  scripts/   CLI entry points (train with --resume, play)
  utils/     config DSL, task registry, checkpoint, play-time logger
  deploy/    .npz policy-bundle export and the numpy policy runtime
  rl/        PPO + ROA + DAgger runner
  models/    torch.nn actor-critic and encoders
  envs/      batched legged-robot env (go2, go2_stiction, go2_parkour)
  physics/   batched Featherstone + penalty-contact engine, (C, B) layout
  ops/       hand-written CUDA kernels for Hopper (sm_90a)

It imports torch and numpy only, never jax/flax/optax nor the JAX package:
modules it needs from there are copied, with the source file named.

Entry points run on the card unless the caller passes device="cpu"; with no
GPU and no explicit "cpu" they raise (`resolve_device`).
"""

__version__ = "0.1.0"

import os

import torch

LEGGED_GYM_TORCH_ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Robot assets (legged_gym_custom_tpu/__init__.py:30).  The reference
# resources tree is not part of this repository, so the default is the
# package's own resources directory, which ships the synthetic Go2-shaped
# URDF; point LEGGED_GYM_RESOURCES at a tree holding the real assets.
LEGGED_GYM_RESOURCES_DIR = os.environ.get(
    "LEGGED_GYM_RESOURCES",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "resources"),
)
SYNTHETIC_GO2_URDF = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "resources", "robots", "go2", "urdf", "go2_synthetic.urdf",
)

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises instead of drifting to the CPU when no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
