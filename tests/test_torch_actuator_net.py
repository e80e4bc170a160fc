"""The ANYmal SEA actuator network in the port against the JAX package and
against the TorchScript module itself, on the CPU.

The reference's anydrive_v3_lstm.pt is not in the repository; a TorchScript
of its shape with seeded weights (tests/torch_actuator_net.py) is written to
`tmp_path` and loaded on both sides.  The calling convention is that of
tests/test_tasks.py:67-110: 12 dofs, 25 steps of random (position error,
velocity), hidden and cell carried from step to step.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from legged_gym_custom_tpu.models.actuator_net import load_actuator_net as jload
from legged_gym_custom_tpu.physics.actuator import lstm_actuator as jlstm
from legged_gym_custom_tpu_torch.models.actuator_net import (load_actuator_net,
                                                             lstm_weights_from_numpy)
from legged_gym_custom_tpu_torch.physics.actuator import lstm_actuator
import torch_actuator_net

N, T = 12, 25
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def net_path(tmp_path_factory):
    return torch_actuator_net.write_sea_net(str(tmp_path_factory.mktemp("sea") / "sea.pt"))


def _inputs(t, rng):
    return ((rng.standard_normal(N) * 0.5).astype(np.float32),
            (rng.standard_normal(N) * 3.0).astype(np.float32))


def test_port_matches_jax_and_torchscript_over_25_steps(net_path):
    module = torch.jit.load(net_path)
    weights = load_actuator_net(net_path)
    weights_j = jload(net_path)
    rng = np.random.default_rng(0)
    h_s = c_s = torch.zeros(2, N, 8)
    h_t = c_t = torch.zeros(2, N, 8)
    h_j = c_j = jnp.zeros((2, N, 8))
    for t in range(T):
        pos_err, vel = _inputs(t, rng)
        with torch.no_grad():
            inp = torch.from_numpy(np.stack([pos_err, vel], axis=-1)).unsqueeze(1)
            tq_s, (h_s, c_s) = module(inp, (h_s, c_s))
            tq_t, h_t, c_t = lstm_actuator(weights, torch.from_numpy(pos_err),
                                           torch.from_numpy(vel), h_t, c_t)
        tq_j, h_j, c_j = jlstm(weights_j, jnp.asarray(pos_err), jnp.asarray(vel), h_j, c_j)
        for what, got, ref in (("torques", tq_t, np.asarray(tq_j)), ("hidden", h_t, h_j),
                               ("cell", c_t, c_j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=f"{what} {t}", **TOL)
        np.testing.assert_allclose(tq_t.numpy(), tq_s.numpy().reshape(-1), err_msg=f"{t}", **TOL)
        np.testing.assert_allclose(h_t.numpy(), h_s.numpy(), **TOL)
        np.testing.assert_allclose(c_t.numpy(), c_s.numpy(), **TOL)
    assert float(tq_t.abs().max()) > 1.0    # the stand-in gives torques, not zeros


def test_batched_soa_layout_matches_per_env(net_path):
    """(ndof, B) inputs and (layers, ndof, hidden, B) state, as the env's
    (C, B) layout gives them, equal B separate calls."""
    weights = load_actuator_net(net_path)
    rng = np.random.default_rng(1)
    B = 5
    pos_err = torch.as_tensor(rng.standard_normal((N, B)), dtype=torch.float32)
    vel = torch.as_tensor(rng.standard_normal((N, B)) * 3, dtype=torch.float32)
    h = torch.as_tensor(rng.standard_normal((2, N, 8, B)) * 0.3, dtype=torch.float32)
    c = torch.as_tensor(rng.standard_normal((2, N, 8, B)) * 0.3, dtype=torch.float32)
    tq, h2, c2 = lstm_actuator(weights, pos_err, vel, h, c)
    for b in range(B):
        tq_b, h_b, c_b = lstm_actuator(weights, pos_err[:, b], vel[:, b], h[..., b], c[..., b])
        for got, ref in ((tq[:, b], tq_b), (h2[..., b], h_b), (c2[..., b], c_b)):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_weights_carried_from_numpy_equal_the_loaded_ones(net_path):
    """`lstm_weights_from_numpy` on the JAX package's LSTMWeights (as numpy)
    gives the loader's weights exactly, and the same torques."""
    weights_j = jload(net_path)
    carried = lstm_weights_from_numpy(
        *[[np.asarray(w) for w in getattr(weights_j, f)] for f in ("w_ih", "w_hh", "b_ih", "b_hh")],
        np.asarray(weights_j.w_out), np.asarray(weights_j.b_out),
        np.asarray(weights_j.in_scale), np.asarray(weights_j.out_scale))
    loaded = load_actuator_net(net_path)
    for a, b in zip(carried, loaded):
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        for x, y in pairs:
            torch.testing.assert_close(torch.as_tensor(x), torch.as_tensor(y), rtol=0, atol=0)
    assert len(loaded.w_ih) == 2 and tuple(loaded.w_ih[0].shape) == (32, 2)
    assert tuple(loaded.w_out.shape) == (1, 8)
    np.testing.assert_array_equal(loaded.in_scale.numpy(), np.float32(torch_actuator_net.IN_SCALE))
    assert float(loaded.out_scale) == torch_actuator_net.OUT_SCALE


def test_missing_file_raises_naming_the_config_field(tmp_path):
    with pytest.raises(FileNotFoundError, match="control.actuator_net_file"):
        load_actuator_net(str(tmp_path / "absent.pt"))
