"""The 17 reward terms of the other robots, port against the JAX package, on
the CPU: each term on one seeded `RewardCtx` with the statics of a robot
that scales it (Go2 for the calf and limit terms, which ANYmal's links do
not name; G1 for its humanoid terms; Cassie for `no_fly`), at rtol 1e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from legged_gym_custom_tpu.envs import rewards as jrew
from legged_gym_custom_tpu_torch.envs import rewards as rew
from legged_gym_custom_tpu_torch.envs import task_registry

B = 16
TERMS = {
    "go2": ("calf_collision", "calf_pos", "dof_pos_limits", "dof_vel", "dof_vel_limits",
            "feet_air_time", "stand_still", "stumble_calves", "torque_limits", "tracking_pitch",
            "tracking_roll"),
    "g1": ("alive", "contact", "contact_no_vel", "feet_swing_height", "forward_vel"),
    "cassie": ("no_fly",),
}
CASES = [(task, term) for task, terms in TERMS.items() for term in terms]


@pytest.fixture(scope="module")
def statics():
    """(port statics, JAX statics, n_links, n_feet) by task, from the port's
    env on its synthetic URDF."""
    out = {}
    for task in TERMS:
        cfg, _ = task_registry.get_cfgs(task)
        cfg.env.num_envs = 2
        env, _ = task_registry.make_env(task, env_cfg=cfg, device="cpu")
        s = env.reward_statics
        js = jrew.RewardStatics(**{k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v
                                   for k, v in s._asdict().items()})
        out[task] = (s, js, env.model.n_links, env.n_feet)
    return out


def _ctxs(n_links, n_feet, n_phases, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: np.asarray(rng.normal(size=s), np.float32)
    vals = dict(
        base_pos=np.stack([f(B), f(B), rng.uniform(0.0, 0.8, B).astype(np.float32)], 1),
        base_lin_vel=f(B, 3), base_ang_vel=f(B, 3), world_lin_vel=f(B, 3),
        projected_gravity=f(B, 3), roll=f(B) * 0.3, pitch=f(B) * 0.3, yaw=f(B), heading=f(B),
        commands=np.asarray(rng.uniform(-0.3, 1.0, (B, 4)), np.float32),
        dof_pos=f(B, 12) * 1.5, dof_vel=f(B, 12) * 20.0, last_dof_vel=f(B, 12),
        torques=f(B, 12) * 40.0, last_torques=f(B, 12), actions=f(B, 12), last_actions=f(B, 12),
        link_forces=f(B, n_links, 3) * 5.0 * (rng.random((B, n_links, 1)) < 0.5),
        feet_pos=np.abs(f(B, n_feet, 3)) * 0.1, feet_vel=f(B, n_feet, 3), last_contact_heights=f(B, n_feet),
        contact_filt=rng.random((B, n_feet)) < 0.5, feet_air_time=np.abs(f(B, n_feet)),
        first_contact=rng.random((B, n_feet)) < 0.5,
        phases=np.asarray(rng.random((B, n_phases)), np.float32), measured_heights=f(B, 132),
        jump_flags=np.asarray(rng.random(B) < 0.5, np.float32),
        reset_buf=rng.random(B) < 0.3, time_out_buf=rng.random(B) < 0.1,
        progress=np.asarray(rng.uniform(0.0, 2.0, B), np.float32),
    )
    vals["commands"][:4, :3] = 0.0      # standing commands: stand_still, feet_air_time gates
    ctx_t = rew.RewardCtx(**{k: torch.as_tensor(vals[k]) for k in rew.RewardCtx._fields})
    ctx_j = jrew.RewardCtx(**{k: jnp.asarray(vals[k]) for k in jrew.RewardCtx._fields})
    return ctx_t, ctx_j


def test_every_jax_term_is_in_the_port():
    assert set(rew.REWARD_REGISTRY) == set(jrew.REWARD_REGISTRY)
    assert len({t for _, t in CASES}) == 17


@pytest.mark.parametrize("task,term", CASES)
def test_term_matches_reference(statics, task, term):
    s, js, n_links, n_feet = statics[task]
    n_phases = 2 if task == "g1" else 4
    ctx_t, ctx_j = _ctxs(n_links, n_feet, n_phases, seed=len(term))
    got = rew.REWARD_REGISTRY[term](ctx_t, s)
    ref = jrew.REWARD_REGISTRY[term](ctx_j, js)
    assert tuple(got.shape) == (B,) and got.dtype == torch.float32
    # atol: XLA on the CPU flushes float32 subnormals to zero, torch keeps them
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=float(np.finfo(np.float32).tiny), err_msg=term)
    assert len(np.unique(got.numpy())) > 1 or term == "alive", f"{term} is constant here"
