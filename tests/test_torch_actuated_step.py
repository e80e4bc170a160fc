"""The control step of a stateful actuator (the ANYmal SEA LSTM), port against
the JAX package, and the port's tick-wise kernel path against its eager loop,
on the CPU.

* `physics.actuated_control_step` on CPU tensors (the eager loop) against JAX
  `engine.control_step(..., actuator_state, torque_fn)`, its XLA path
  (engine.py:301-380), on the anydrive-shaped network of
  tests/torch_actuator_net.py, on the ANYmal plane and on a heightfield, at
  the tolerances of tests/test_torch_physics.py.
* `physics.tickwise_control_step`, the path the card runs: one launch of the
  one-tick 'T' spec per decimation tick, here with CPU tensors so that each
  tick runs the kernel's plain version.  It must cut the terrain window once
  per control step, not once per tick, and give the eager loop's control
  step: on the plane to float32 rounding (atol 1e-5, rtol 1e-5); on the
  heightfield at the tolerances of the heightfield kernel against the engine
  (tests/test_torch_hf_step.py), because the plain kernel's four window taps
  and the engine's surface sampling round differently (with the PD law and
  no actuator the two differ by as much: 2.6e-5 on ang_vel and 8.4e-4 on
  dof_vel on these batches).  With a torque function that ignores the state,
  the tick-wise path must equal one launch of the 4-tick 'T' spec to 1e-6 on
  both terrains: the same plain arithmetic, split at the ticks.
* The tick-wise path with the SEA network the benchmark draws from a seed
  (input and output scale 1, `scripts/tickwise_witness.py`) against the
  benchmark's frozen reference (`portbench/reference/frozen/`, its own
  eager engine and ANYmal env on the same terrain and network file), over
  several control steps with the program's recurrent state carried forward;
  the reference follows each step from the program's state, as the
  benchmark's check does.
"""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from legged_gym_custom_tpu import physics as jphys
from legged_gym_custom_tpu.envs.anymal_config import AnymalCFlatCfg as JFlatCfg
from legged_gym_custom_tpu.envs.anymal_config import AnymalCRoughCfg as JRoughCfg
from legged_gym_custom_tpu.envs.anymal_env import AnymalEnv as JAnymalEnv
from legged_gym_custom_tpu_torch import physics as tphys
from legged_gym_custom_tpu_torch.envs import AnymalCFlatCfg, AnymalCRoughCfg, AnymalEnv
from legged_gym_custom_tpu_torch.ops import fused_step
from legged_gym_custom_tpu_torch.physics import patch
from test_torch_hf_step import TOL as HF_TOL
from test_torch_physics import STATE, TOL
import torch_actuator_net
import torch_tree_model as tree_model

B = 16
TICK_TOL = dict(atol=1e-5, rtol=1e-5)
SPLIT_TOL = dict(atol=1e-6, rtol=1e-6)
OUTPUTS = STATE + ("link_forces", "link_pos", "link_vel", "torques")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net_path(tmp_path_factory):
    return torch_actuator_net.write_sea_net(str(tmp_path_factory.mktemp("sea") / "sea.pt"))


def _cfg(cfg_cls, net_path):
    cfg = cfg_cls()
    cfg.env.num_envs = B
    cfg.terrain.num_rows, cfg.terrain.num_cols = 3, 2
    cfg.control.actuator_net_file = net_path
    return cfg


@pytest.fixture(scope="module", params=["flat", "rough"])
def envs(request, net_path):
    """(JAX env, port env) of anymal_c_flat or anymal_c_rough on the
    synthetic URDF, terrain from one seed."""
    j_cls, t_cls = {"flat": (JFlatCfg, AnymalCFlatCfg), "rough": (JRoughCfg, AnymalCRoughCfg)}[
        request.param]
    cfg_t = _cfg(t_cls, net_path)
    env_t = AnymalEnv(cfg_t, cfg_t.asset.file, name="anymal", device="cpu", terrain_seed=4)
    env_j = JAnymalEnv(_cfg(j_cls, net_path), cfg_t.asset.file, name="anymal", terrain_seed=4)
    return env_j, env_t


def _batch(env_t, seed):
    """A seeded (C, B) batch of the robot standing on its terrain
    (`torch_tree_model.robot_batch`, which cuts the windows too) and an LSTM
    state."""
    state, actions, dr = tree_model.robot_batch(env_t, seed, B)[:3]
    rng = np.random.default_rng(seed + 100)
    act = tuple(torch.as_tensor(rng.standard_normal((2, 12, 8, B)) * 0.3, dtype=torch.float32)
                for _ in range(2))
    return state, actions, dr, act


def _port_args(env_t, state, actions, dr):
    return (env_t.ma, env_t.hf, env_t.sim_params, env_t.pd, tphys.DomainRandParams(*dr),
            env_t.dof_limits, tphys.PhysicsState(*state), actions)


def test_eager_actuated_step_matches_reference(envs):
    env_j, env_t = envs
    state, actions, dr, act = _batch(env_t, 1)
    J = lambda t: jnp.asarray(t.numpy())
    ref_state, ref_info, ref_act = jax.jit(
        lambda s, a, d, h: jphys.control_step(env_j.ma, env_j.hf, env_j.sim_params, env_j.pd, d,
                                              env_j.dof_limits, s, a, actuator_state=h,
                                              torque_fn=env_j._torque_fn)
    )(jphys.PhysicsState(*map(J, state)), J(actions), jphys.DomainRandParams(*map(J, dr)),
      tuple(map(J, act)))
    st, info, act2 = tphys.actuated_control_step(*_port_args(env_t, state, actions, dr), act,
                                                 env_t._torque_fn)
    tol = dict(TOL, link_pos=TOL["base_pos"], link_vel=TOL["lin_vel"])
    for name, got, ref in zip(OUTPUTS, (*st, *info), (*ref_state, *ref_info)):
        atol, rtol = tol[name]
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=rtol,
                                   err_msg=name)
    for got, ref in zip(act2, ref_act):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    assert float(info.link_forces.abs().max()) > 10.0       # the feet are in contact
    assert float(info.torques.abs().max()) > 1.0


def test_tickwise_path_matches_eager_loop(envs, monkeypatch):
    """The card's path with CPU tensors: `decimation` calls of the one-tick
    'T' spec through `fused_control_step` (its plain version here), the
    window cut once, each writing the link states and the step returning the
    last tick's, against the eager loop."""
    _, env_t = envs
    state, actions, dr, act = _batch(env_t, 2)
    args = _port_args(env_t, state, actions, dr)
    st_e, info_e, act_e = tphys.actuated_control_step(*args, act, env_t._torque_fn, spec=None)

    cuts, calls, outs = [], [], []
    extract, fused = patch.extract, fused_step.fused_control_step
    monkeypatch.setattr(patch, "extract", lambda *a, **k: cuts.append(1) or extract(*a, **k))
    monkeypatch.setattr(fused_step, "fused_control_step",
                        lambda spec, *a: calls.append(spec) or outs.append(fused(spec, *a))
                        or outs[-1])
    st_k, info_k, act_k = tphys.tickwise_control_step(*args, act, env_t._torque_fn,
                                                      env_t.fused_spec)
    one = fused_step.tick_spec(env_t.fused_spec)
    # every tick's launch writes the link states; the step returns the last tick's
    assert calls == [one] * env_t.fused_spec.decimation == [one] * 4
    assert all(out[3] is not None and out[4] is not None for out in outs)
    assert info_k.link_pos is outs[-1][3] and info_k.link_vel is outs[-1][4]
    assert len(cuts) == (0 if env_t.hf.is_plane else 1)
    assert (one.decimation, one.control_type, one.action_scale) == (1, "T", 1.0)
    assert one._replace(decimation=4, control_type="P", action_scale=0.5) == env_t.fused_spec
    assert fused_step.tick_spec(env_t.fused_spec) is one      # cached: one library per variant
    if env_t.hf.is_plane:
        tol = {name: (TICK_TOL["atol"], TICK_TOL["rtol"]) for name in OUTPUTS}
    else:
        tol = dict(HF_TOL, link_pos=HF_TOL["base_pos"], link_vel=HF_TOL["lin_vel"])
    for name, got, ref in zip(OUTPUTS, (*st_k, *info_k), (*st_e, *info_e)):
        atol, rtol = tol[name]
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=atol, rtol=rtol, err_msg=name)
    for got, ref in zip(act_k, act_e):     # the LSTM sees the ticks' states
        atol, rtol = tol["dof_vel"]
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=atol, rtol=rtol)
    assert float(info_e.link_forces.abs().max()) > 10.0


def test_tickwise_path_splits_one_launch_at_the_ticks(envs):
    """A torque function that ignores the state (a fixed torque per tick,
    its state a tick count): the tick-wise path equals one plain launch of
    the 4-tick 'T' spec on the same window, and carries the state through
    every tick.  On the card the path raises where the kernel has no
    heightfield variant."""
    _, env_t = envs
    state, actions, dr, _ = _batch(env_t, 3)
    tau = (actions * 30.0).contiguous()      # beyond the effort limits: clipped

    def torque_fn(a, q, qd, ticks):
        return tau, ticks + 1

    ticks = torch.zeros(B)
    st_k, info_k, ticks = tphys.tickwise_control_step(
        *_port_args(env_t, state, actions, dr), ticks, torque_fn, env_t.fused_spec)
    assert bool((ticks == 4).all())
    spec4 = fused_step.tick_spec(env_t.fused_spec)._replace(decimation=4)
    window = None
    if not env_t.hf.is_plane:
        window = fused_step.patch_inputs(patch.extract(env_t.hf, state[0][0], state[0][1],
                                                       spec4.hf_K))
    st_1, lf_1, tau_1, lpos, lvel = fused_step.plain_control_step(spec4, state, tau, dr, window)
    for name, got, ref in zip(OUTPUTS, (*st_k, *info_k), (*st_1, lf_1, lpos, lvel, tau_1)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), err_msg=name, **SPLIT_TOL)
    tlim = env_t.pd.torque_limits[:, None]
    torch.testing.assert_close(info_k.torques, torch.maximum(torch.minimum(tau, tlim), -tlim))
    if not env_t.hf.is_plane:
        params = env_t.sim_params._replace(patch_halfwidth=0.0)
        with pytest.raises(NotImplementedError, match="patch"):
            tphys.engine._check_kernel_terrain(env_t.hf, params)


RUN_STEPS = 3
# each env's largest gap over the leaf's RMS in the reference (the
# benchmark's per-env gap): the plain kernel's window taps and the eager
# engine's surface sampling round differently on the trimesh's slopes, and
# the LSTM carries a tick's rounding into its state (at most 4.2e-4 here;
# the LSTM state not carried from tick to tick reads 2.0)
FOLLOW_GAP = 5e-3


@pytest.fixture(scope="module")
def seeded_rough(tmp_path_factory):
    """anymal_c_rough at B envs on 3 x 2 trimesh tiles with the seeded SEA
    network: the port's env and the frozen reference's, on one terrain seed
    and one network file."""
    from legged_gym_custom_tpu_torch.scripts import tickwise_witness
    from portbench.reference.frozen.envs import TASKS

    path = tickwise_witness.write_sea_network(
        tickwise_witness.seeded_sea_weights(2**31 + 3, "cpu"),
        str(tmp_path_factory.mktemp("seeded") / "sea.pt"))

    def make(env_cls, cfg_cls):
        cfg = _cfg(cfg_cls, path)
        random.seed(4)
        np.random.seed(4)
        return env_cls(cfg, cfg.asset.file, name="anymal_c_rough", device="cpu", terrain_seed=4)

    ref_env, ref_cfg, _ = TASKS["anymal_c_rough"]
    return make(AnymalEnv, AnymalCRoughCfg), make(ref_env, ref_cfg)


def _rel_gap(got, ref):
    """The largest over the envs (batch last) of each env's largest gap over
    the leaf's RMS."""
    got, ref = got.double(), ref.double()
    scale = torch.sqrt(torch.mean(ref * ref)).clamp(min=1e-6)
    return float((got - ref).abs().reshape(-1, ref.shape[-1]).amax() / scale)


def test_tickwise_path_follows_the_frozen_reference(seeded_rough):
    """RUN_STEPS control steps of the tick-wise path (its plain version on
    these CPU tensors), the LSTM state starting at zero as after a reset and
    carried forward by the program; at each step the frozen reference's
    eager control step from the program's state and LSTM state gives the
    same state, link outputs and LSTM state."""
    from portbench.reference.frozen import physics as fphys

    env, ref = seeded_rough
    assert torch.equal(env.hf.data, ref.hf.data)
    assert not env.hf.is_plane and env.fused_spec.hf_K == 24
    state, actions, dr, _ = _batch(env, 5)
    act = tuple(torch.zeros(2, 12, 8, B) for _ in range(2))
    rng = np.random.default_rng(5)
    worst = {}
    for k in range(RUN_STEPS):
        st, info, act_next = tphys.tickwise_control_step(
            *_port_args(env, state, actions, dr), act, env._torque_fn, env.fused_spec)
        r_st, r_info, r_act = fphys.eager_actuated_control_step(
            ref.ma, ref.hf, ref.sim_params, ref.pd, fphys.DomainRandParams(*dr), ref.dof_limits,
            fphys.PhysicsState(*state), actions, act, ref._torque_fn)
        names = OUTPUTS + ("hidden", "cell")
        for name, got, want in zip(names, (*st, *info, *act_next), (*r_st, *r_info, *r_act)):
            worst[name] = max(worst.get(name, 0.0), _rel_gap(got, want))
        state, act = tuple(st), act_next
        actions = torch.as_tensor(rng.standard_normal((12, B)), dtype=torch.float32)
    assert all(v <= FOLLOW_GAP for v in worst.values()), worst
    assert float(act[0].abs().max()) > 0.05        # the carried state is not zero
    assert float(info.link_forces.abs().max()) > 10.0
