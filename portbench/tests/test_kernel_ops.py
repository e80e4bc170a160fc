"""The frozen operation count equals the port's for the cells' specs."""
import argparse

import pytest

from portbench.reference import kernel_ops


@pytest.mark.parametrize("task", ["go2", "go2_parkour"])
def test_frozen_count_equals_the_ports(task):
    from legged_gym_custom_tpu_torch.envs import task_registry
    from legged_gym_custom_tpu_torch.ops import roofline

    env_cfg, _ = task_registry.get_cfgs(task)
    env_cfg.env.num_envs = 8
    env, _ = task_registry.make_env(task, args=argparse.Namespace(seed=3), env_cfg=env_cfg,
                                    device="cpu")
    spec = env.fused_spec
    assert kernel_ops.count_kernel_ops(spec) == roofline.count_kernel_ops(spec)
    assert kernel_ops.kernel_bytes_per_env(spec) == roofline.kernel_bytes_per_env(spec)
    assert bool(spec.hf_K) == (task == "go2_parkour")
