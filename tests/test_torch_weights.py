"""Weights across, at go2_parkour's widths (actor 512-256-128, scan encoder
128-64 -> 32, estimator 256-128), on the CPU.

  * a JAX parameter tree carried by `params_from_flax` gives the port's
    modules the JAX modules' outputs;
  * the trained go2_parkour policy bundle (trained/go2_parkour_tpu_r5) loaded
    by `params_from_bundle` gives the action of the numpy deploy runtime
    (legged_gym_custom_tpu/deploy/controller.py), the check
    tests/test_deploy.py:47 makes for JAX.
"""
import os

import numpy as np

import jax
import jax.numpy as jnp
import torch

from legged_gym_custom_tpu.deploy.controller import NumpyAdaptationEncoder, NumpyMLP
from legged_gym_custom_tpu.deploy.export import load_policy_bundle
from legged_gym_custom_tpu.envs.go2_parkour_config import Go2ParkourCfgPPO as JParkourPPO
from legged_gym_custom_tpu.models.networks import ActorCriticNetworks as JNets
from legged_gym_custom_tpu_torch.envs import Go2ParkourCfg, Go2ParkourCfgPPO
from legged_gym_custom_tpu_torch.models.networks import (
    ActorCriticNetworks,
    params_from_bundle,
    params_from_flax,
)

BUNDLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "trained", "go2_parkour_tpu_r5", "policy_bundle.npz")
# float32 forward passes of the same weights through 4-5 layers of width
# <= 627: only the summation order differs (tests/test_deploy.py's tolerance)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)


def _dims():
    e = Go2ParkourCfg().env
    return dict(num_proprio=e.num_proprio, num_privileged_obs=e.num_privileged_obs,
                num_critic_obs=e.num_critic_obs, num_estimated_obs=e.num_estimated_obs,
                num_scan_obs=e.num_scan_obs, num_actions=e.num_actions,
                history_buffer_length=e.history_buffer_length)


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    d = _dims()
    f = lambda *s: rng.normal(size=(n,) + s).astype(np.float32)
    return (f(d["num_proprio"] * (1 + d["history_buffer_length"])), f(d["num_privileged_obs"]),
            f(d["num_scan_obs"]), f(d["num_critic_obs"]))


def test_flax_params_carry_across_at_go2_parkour_widths():
    nets_j = JNets(JParkourPPO.policy, **_dims())
    params = nets_j.init_params(jax.random.PRNGKey(3))
    nets_t = ActorCriticNetworks(Go2ParkourCfgPPO().policy, **_dims())
    nets_t.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    assert nets_t.scan_encoder.layers[-1].out_features == 32
    assert [l.out_features for l in nets_t.estimator.mlp.layers] == [256, 128, 3]
    obs, priv, scan, critic = _inputs(0, 16)
    J = jnp.asarray
    T = torch.as_tensor
    est_j = nets_j.estimate(params, J(obs))
    with torch.no_grad():
        est_t = nets_t.estimate(T(obs))
        np.testing.assert_allclose(est_t.numpy(), np.asarray(est_j), **FWD_TOL)
        for adaptation in (False, True):
            mu_j = nets_j.action_mean(params, J(obs), J(priv), est_j, J(scan),
                                      adaptation_mode=adaptation)
            mu_t = nets_t.action_mean(T(obs), T(priv), est_t, T(scan), adaptation_mode=adaptation)
            np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), **FWD_TOL)
        np.testing.assert_allclose(nets_t.value(T(critic)).numpy(),
                                   np.asarray(nets_j.value(params, J(critic))), **FWD_TOL)


def test_trained_parkour_bundle_matches_numpy_runtime():
    nets = ActorCriticNetworks(Go2ParkourCfgPPO().policy, **_dims())
    missing, unexpected = nets.load_state_dict(params_from_bundle(BUNDLE), strict=False)
    assert not unexpected
    assert all(k.startswith(("critic.", "priv_encoder.")) for k in missing), missing

    bundle = load_policy_bundle(BUNDLE)
    policy, estimator = NumpyMLP(bundle["policy"]), NumpyMLP(bundle["estimator"])
    scan_enc = NumpyMLP(bundle["scan_encoder"])
    adapt = NumpyAdaptationEncoder(bundle["adaptation_module"])
    np.testing.assert_array_equal(nets.std.detach().numpy(), bundle["std"])

    obs, priv, scan, _ = _inputs(1, 8)
    T = torch.as_tensor
    with torch.no_grad():
        est_t = nets.estimate(T(obs))
        act_t = nets.action_mean(T(obs), T(priv), est_t, T(scan), adaptation_mode=True)
    for b in range(obs.shape[0]):
        est_np = estimator(obs[b])
        lat_np = adapt(obs[b, :520].reshape(10, 52))
        act_np = policy(np.concatenate([obs[b], lat_np, scan_enc(scan[b]), est_np]))
        np.testing.assert_allclose(est_t[b].numpy(), est_np, **FWD_TOL)
        np.testing.assert_allclose(act_t[b].numpy(), act_np, **FWD_TOL)
