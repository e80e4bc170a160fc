"""The recurrent actor-critic and the trajectory split, port against the JAX
package on the CPU: `Memory` (LSTM and GRU) and `ActorCriticRecurrent` on the
JAX parameters carried by `params_from_flax_recurrent`, over 6 steps of
carried state, at the forward tolerance of tests/test_torch_rl.py; the
trajectory split and its inverse exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_custom_tpu.models.recurrent import ActorCriticRecurrent as JACR
from legged_gym_custom_tpu.models.recurrent import Memory as JMemory
from legged_gym_custom_tpu.rl import traj_utils as jtraj
from legged_gym_custom_tpu_torch.models.recurrent import (ActorCriticRecurrent, Memory,
                                                          params_from_flax_recurrent)
from legged_gym_custom_tpu_torch.rl import traj_utils

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
B, NUM_OBS, NUM_CRITIC, NUM_ACT, HIDDEN = 4, 10, 13, 3, 16


def _nets(rnn_type):
    kw = dict(num_obs=NUM_OBS, num_critic_obs=NUM_CRITIC, num_actions=NUM_ACT,
              actor_hidden_dims=(32, 16), critic_hidden_dims=(24,), rnn_hidden_size=HIDDEN,
              rnn_type=rnn_type)
    net_j = JACR(**kw)
    key = jax.random.PRNGKey(3)
    carry = JMemory(HIDDEN, rnn_type).initialize_carry(key, (B,))
    params = net_j.init(key, jnp.ones((B, NUM_OBS)), jnp.ones((B, NUM_CRITIC)), carry, carry)
    # non-zero biases, so that a bias on the wrong side shows
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 * jnp.arange(x.size).reshape(x.shape) / x.size
        if path[-1].key == "bias" else x, params)
    net_t = ActorCriticRecurrent(**kw)
    net_t.load_state_dict(params_from_flax_recurrent(jax.tree.map(np.asarray, params)))
    return net_j, params, net_t, carry


def _leaves(carry):
    return carry if isinstance(carry, tuple) else (carry,)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_actor_critic_recurrent_matches_reference(rnn_type):
    net_j, params, net_t, carry_j = _nets(rnn_type)
    carry_t = net_t.memory_a.initialize_carry((B,))
    for a, b in zip(_leaves(carry_t), jax.tree.leaves(carry_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ca_j = cc_j = carry_j
    ca_t = cc_t = carry_t
    rng = np.random.default_rng(0)
    apply = jax.jit(net_j.apply)
    for step in range(6):
        obs = rng.normal(size=(B, NUM_OBS)).astype(np.float32)
        cobs = rng.normal(size=(B, NUM_CRITIC)).astype(np.float32)
        mean_j, value_j, ca_j, cc_j = apply(params, obs, cobs, ca_j, cc_j)
        with torch.no_grad():
            mean_t, value_t, ca_t, cc_t = net_t(torch.as_tensor(obs), torch.as_tensor(cobs),
                                                ca_t, cc_t)
        np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), err_msg=f"{step}", **FWD_TOL)
        np.testing.assert_allclose(value_t.numpy(), np.asarray(value_j), **FWD_TOL)
        for a, b in zip((*_leaves(ca_t), *_leaves(cc_t)), (*jax.tree.leaves(ca_j),
                                                           *jax.tree.leaves(cc_j))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD_TOL)
    assert float(np.abs(np.asarray(jax.tree.leaves(ca_j)[0])).max()) > 1e-3


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_memory_carries_history(rnn_type):
    """Two prefixes, then the same observation: the actions differ (the
    property tests/test_recurrent.py holds of the JAX memory)."""
    _, _, net_t, _ = _nets(rnn_type)
    final = torch.full((B, NUM_OBS), 0.3)

    def run(sign):
        ca = net_t.memory_a.initialize_carry((B,))
        with torch.no_grad():
            for t in range(5):
                _, ca = net_t.act(torch.full((B, NUM_OBS), sign * 0.1 * (t + 1)), ca)
            return net_t.act(final, ca)[0]

    assert float((run(1.0) - run(-1.0)).abs().max()) > 1e-4
    assert isinstance(net_t.memory_a, Memory)


@pytest.mark.parametrize("trailing", [(), (3,)])
def test_split_and_unpad_match_reference(trailing):
    rng = np.random.default_rng(1)
    T, n_env = 7, 5
    x = rng.normal(size=(T, n_env, *trailing)).astype(np.float32)
    dones = rng.random((T, n_env)) < 0.3
    dones[:, 0] = False                       # one env with a single full trajectory
    dones[-1, 1] = True                       # one that ends on the last step
    pad_j, mask_j = jtraj.split_and_pad_trajectories(x, dones)
    pad_t, mask_t = traj_utils.split_and_pad_trajectories(torch.as_tensor(x),
                                                          torch.as_tensor(dones))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(pad_t.numpy(), np.asarray(pad_j))
    flat_j = jtraj.unpad_trajectories(pad_j, mask_j)
    flat_t = traj_utils.unpad_trajectories(pad_t, mask_t)
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    assert flat_t.shape[0] == T * n_env
