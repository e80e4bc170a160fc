"""The port's deploy side on the CPU: the inference policy, the `.npz` policy
bundle it exports and the copied numpy runtime, against the JAX package.

  * `OnPolicyRunner.get_inference_policy` against JAX `nets.action_mean`
    with the parameters carried by `params_from_flax`;
  * `export_policy_bundle` writes, key for key and array for array, the
    bundle the JAX `export_policy_bundle` writes from the same parameters;
  * bundle -> `params_from_bundle` -> `export_policy_bundle` is the identity
    on the trained go2_parkour and go2_stiction bundles;
  * the copied `NumpyMLP` / `NumpyAdaptationEncoder` give the torch modules'
    outputs, and are the JAX package's runtime line for line.
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from legged_gym_custom_tpu.deploy import controller as jcontroller
from legged_gym_custom_tpu.deploy.export import export_policy_bundle as jexport
from legged_gym_custom_tpu.envs.go2_config import Go2StictionCfgPPO as JStictionPPO
from legged_gym_custom_tpu.models.networks import ActorCriticNetworks as JNets
from legged_gym_custom_tpu_torch.deploy import (NumpyAdaptationEncoder, NumpyMLP,
                                                export_policy_bundle, load_policy_bundle)
from legged_gym_custom_tpu_torch.deploy import controller as tcontroller
from legged_gym_custom_tpu_torch.envs import Obs, task_registry
from legged_gym_custom_tpu_torch.models.networks import (ActorCriticNetworks, params_from_bundle,
                                                         params_from_flax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = [os.path.join(ROOT, "trained", d, "policy_bundle.npz")
           for d in ("go2_parkour_tpu_r5", "go2_stiction_r5")]
# float32 forward passes of the same weights through 4-5 layers of width
# <= 627: only the summation order differs
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny, so one thread is faster than many, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dims(cfg):
    e = cfg.env
    return dict(num_proprio=e.num_proprio, num_privileged_obs=e.num_privileged_obs,
                num_critic_obs=e.num_critic_obs, num_estimated_obs=e.num_estimated_obs,
                num_scan_obs=e.num_scan_obs, num_actions=e.num_actions,
                history_buffer_length=e.history_buffer_length)


@pytest.fixture(scope="module")
def stiction():
    """A go2_stiction runner on the CPU (2 envs, no log directory) whose
    networks hold a JAX parameter tree; returns (runner, JAX nets, params)."""
    env_cfg, train_cfg = task_registry.get_cfgs("go2_stiction")
    env_cfg.env.num_envs = 2
    env, _ = task_registry.make_env("go2_stiction", env_cfg=env_cfg, device="cpu")
    runner, _ = task_registry.make_alg_runner(env, train_cfg=train_cfg, log_root=None)
    nets_j = JNets(JStictionPPO.policy, **_dims(env_cfg))
    params = nets_j.init_params(jax.random.PRNGKey(5))
    # a std that is not all ones, so the bundle's `std` says something
    params = dict(params, std=jnp.linspace(0.5, 1.5, 12))
    runner.nets.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return runner, nets_j, params


def _obs5(seed, n, cfg_env):
    rng = np.random.default_rng(seed)
    f = lambda w: rng.normal(size=(n, w)).astype(np.float32)
    return Obs(obs=f(cfg_env.num_observations), privileged=f(cfg_env.num_privileged_obs),
               critic=f(cfg_env.num_critic_obs), estimated=f(cfg_env.num_estimated_obs),
               scan=f(cfg_env.num_scan_obs))


def test_inference_policy_matches_reference(stiction):
    """Deterministic: the estimator, then `action_mean` with the adaptation
    encoder by default (or the privileged encoder); sampling: mean + std *
    the generator's normals."""
    runner, nets_j, params = stiction
    obs_np = _obs5(0, 16, runner.env.cfg.env)
    obs_t = Obs(*map(torch.as_tensor, obs_np))
    J = jnp.asarray
    policy = runner.get_inference_policy()
    est_j = nets_j.estimate(params, J(obs_np.obs))
    for kwargs, adaptation in (({}, True), (dict(adaptation_mode=False), False)):
        ref = nets_j.action_mean(params, J(obs_np.obs), J(obs_np.privileged), est_j,
                                 J(obs_np.scan), adaptation_mode=adaptation)
        got = policy(obs_t, **kwargs)
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    torch.testing.assert_close(policy(obs_t), policy(obs_t), rtol=0, atol=0)

    sample = runner.get_inference_policy(stochastic=True)
    a = sample(obs_t, torch.Generator().manual_seed(3))
    b = sample(obs_t, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    noise = torch.randn(a.shape, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, policy(obs_t) + runner.nets.std.detach() * noise,
                               rtol=0, atol=1e-6)


def test_exported_bundle_equals_the_reference_export(stiction, tmp_path):
    runner, nets_j, params = stiction
    meta = dict(num_proprio=52, period=0.45)
    path_j = jexport(nets_j, params, str(tmp_path / "jax"), cfg_meta=meta)
    path_t = export_policy_bundle(runner.nets, str(tmp_path / "torch"), cfg_meta=meta)
    assert os.path.basename(path_t) == "policy_bundle.npz"
    ref, got = np.load(path_j), np.load(path_t)
    assert got.files == ref.files
    for key in ref.files:
        assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert got["adaptation_module/0/convkernel"].shape == (4, 30, 20)
    assert got["policy/0/kernel"].shape == (572 + 20 + 32 + 3, 512)
    named = export_policy_bundle(runner.nets, str(tmp_path / "torch"), filename="other.npz")
    assert os.path.basename(named) == "other.npz" and "meta/period" not in np.load(named).files


@pytest.mark.parametrize("bundle", TRAINED, ids=["go2_parkour_tpu_r5", "go2_stiction_r5"])
def test_trained_bundle_round_trips_through_the_port(bundle, tmp_path):
    """bundle -> params_from_bundle -> modules -> export_policy_bundle gives
    back the file's keys and arrays bit for bit."""
    cfg, train_cfg = task_registry.get_cfgs("go2_parkour")
    nets = ActorCriticNetworks(train_cfg.policy, **_dims(cfg))
    nets.load_state_dict(params_from_bundle(bundle), strict=False)
    ref = np.load(bundle)
    meta = {k.split("/", 1)[1]: ref[k] for k in ref.files if k.startswith("meta/")}
    got = np.load(export_policy_bundle(nets, str(tmp_path), cfg_meta=meta))
    assert got.files == ref.files
    for key in ref.files:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    # and once more through the port: the identity
    nets2 = ActorCriticNetworks(train_cfg.policy, **_dims(cfg))
    nets2.load_state_dict(params_from_bundle(str(tmp_path / "policy_bundle.npz")), strict=False)
    for name in ("actor", "estimator", "scan_encoder", "adapt_encoder"):
        for (k, a), (_, b) in zip(getattr(nets, name).state_dict().items(),
                                  getattr(nets2, name).state_dict().items()):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f"{name}.{k}")


def test_numpy_runtime_matches_the_torch_modules(stiction, tmp_path):
    runner, _, _ = stiction
    nets = runner.nets
    bundle = load_policy_bundle(export_policy_bundle(nets, str(tmp_path)))
    ref_bundle = jcontroller.load_policy_bundle(str(tmp_path / "policy_bundle.npz"))
    assert sorted(bundle) == sorted(ref_bundle)
    np.testing.assert_array_equal(bundle["std"], nets.std.detach().numpy())
    policy, estimator = NumpyMLP(bundle["policy"]), NumpyMLP(bundle["estimator"])
    scan_encoder = NumpyMLP(bundle["scan_encoder"])
    adaptation = NumpyAdaptationEncoder(bundle["adaptation_module"])
    ref_adaptation = jcontroller.NumpyAdaptationEncoder(ref_bundle["adaptation_module"])
    obs = _obs5(1, 8, runner.env.cfg.env)
    T = torch.as_tensor
    with torch.no_grad():
        est_t = nets.estimate(T(obs.obs))
        lat_t = nets.adapt_encoder(nets.history_part(T(obs.obs)))
        scan_t = nets.scan_encoder(T(obs.scan))
    act_t = runner.get_inference_policy()(Obs(*map(T, obs)))
    for b in range(8):
        hist = obs.obs[b, :520].reshape(10, 52)
        lat = adaptation(hist)
        np.testing.assert_array_equal(lat, ref_adaptation(hist))   # the copy is the original
        np.testing.assert_allclose(lat, lat_t[b].numpy(), rtol=0, atol=ATOL)
        np.testing.assert_allclose(estimator(obs.obs[b]), est_t[b].numpy(), rtol=0, atol=ATOL)
        np.testing.assert_allclose(scan_encoder(obs.scan[b]), scan_t[b].numpy(), rtol=0, atol=ATOL)
        act = policy(np.concatenate([obs.obs[b], lat, scan_encoder(obs.scan[b]),
                                     estimator(obs.obs[b])]))
        np.testing.assert_allclose(act, act_t[b].numpy(), rtol=0, atol=ATOL)


def test_scan_trace_round_trips_through_the_copied_parser(tmp_path):
    """`ScanCapture` (scripts/play.py) writes what the copied
    `parse_scan_trace` reads, as the reference's pair does."""
    from legged_gym_custom_tpu_torch.scripts.play import ScanCapture

    path = str(tmp_path / "SCAN_test.txt")
    capture = ScanCapture(path)
    rng = np.random.default_rng(2)
    frames = rng.uniform(-1, 1, (3, 132)).astype(np.float32)
    capture.update(False, 0.0, frames[0])        # flag not raised yet: nothing written
    for f in frames:
        capture.update(True, 0.25, f)
    capture.update(False, 0.5, frames[0])        # flag dropped: complete
    capture.update(True, 0.75, frames[0])        # ignored afterwards
    assert capture.complete
    for parse in (tcontroller.parse_scan_trace, jcontroller.parse_scan_trace):
        sync, got = parse(path)
        assert sync == 0.25 and len(got) == 3
        np.testing.assert_allclose(np.asarray(got, np.float32), frames, rtol=0, atol=1e-6)
