"""Parity of the PyTorch port's heightfield control step with the JAX
reference, on the CPU: the plain version of K3 (the heightfield variant of
the fused kernel) against the JAX kernel body, and the eager engine against
JAX `engine.control_step` with the kernel off.

The table is bumpy (+-4 cm) with a 0.4 m wide, 2 m deep gap across it; base
positions straddle both gap edges, so feet and shins meet the vertical walls
and their near-horizontal normals.  Tolerances are those of
tests/test_fused_step.py:185-193 (dof_vel atol 2e-2 on a heightfield).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from legged_gym_custom_tpu import physics as jphys
from legged_gym_custom_tpu.ops import fused_step as jfused
from legged_gym_custom_tpu.physics import patch as jpatch
from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch import physics as tphys
from legged_gym_custom_tpu_torch.ops import fused_step as tfused
from legged_gym_custom_tpu_torch.physics import patch as tpatch
from test_torch_physics import GO2_DEFAULT, STATE, TINY_URDF, _both, _plant, _rand_batch

# (atol, rtol) per output, tests/test_fused_step.py:185-193
TOL = dict(base_pos=(1e-4, 1e-4), base_quat=(1e-4, 1e-4), lin_vel=(1e-3, 1e-3),
           ang_vel=(1e-3, 1e-3), dof_pos=(1e-4, 1e-4), dof_vel=(2e-2, 1e-3),
           torques=(1e-2, 1e-3), link_forces=(0.05, 1e-3))
# the link states: those of the base's position and linear velocity
TOL.update(link_pos=TOL["base_pos"], link_vel=TOL["lin_vel"])
B = 32
K = 24   # SimParams.patch_halfwidth 1.2 m at 0.1 m cells


def _close(name, got, ref):
    atol, rtol = TOL[name]
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=rtol,
                               err_msg=name)


@pytest.fixture(scope="module", params=["tiny", "go2_synthetic"])
def robot(request, tmp_path_factory):
    if request.param == "tiny":
        path = tmp_path_factory.mktemp("urdf") / "tiny.urdf"
        path.write_text(TINY_URDF)
        return str(path), np.zeros(1)
    return SYNTHETIC_GO2_URDF, GO2_DEFAULT


def _terrain():
    """(JAX, torch) heightfields of a bumpy 6.4 m table with a gap at
    world x in [1.8, 2.2)."""
    rng = np.random.default_rng(11)
    raw = (rng.normal(size=(64, 64)) * 8).astype(np.int16)
    raw[28:32, :] = -400
    return jphys.from_raw(raw, 0.1, 0.005, 1.0), tphys.from_raw(raw, 0.1, 0.005, 1.0)


def _batch(seed, default_pos):
    state, dr, actions = _rand_batch(seed, B, default_pos)
    rng = np.random.default_rng(seed + 100)
    state[0] = np.stack([rng.uniform(1.3, 2.7, B), rng.uniform(1.0, 3.0, B),
                         state[0][2] + 0.05]).astype(np.float32)
    return state, dr, actions


def test_plain_k3_matches_reference_components(robot):
    """The port's plain K3 (`plain_control_step` with terrain) against the
    JAX kernel body (`control_step_components(..., terrain=...)`, called with
    plain arrays as tests/test_fused_step.py:72-107 does)."""
    urdf, default_pos = robot
    ndof = len(default_pos)
    (ma_j, pd_j, dl_j), (ma_t, pd_t, dl_t) = _both(urdf, default_pos)
    hf_j, hf_t = _terrain()
    state, dr, actions = _batch(7, default_pos)
    spec_j = jfused.build_spec(ma_j, _plant(ndof, True), pd_j, dl_j, hf_K=K, hf_hs=0.1)
    spec_t = tfused.build_spec(ma_t, _plant(ndof, False), pd_t, dl_t, hf_K=K, hf_hs=0.1)
    assert (spec_t.hf_K, spec_t.hf_hs) == (spec_j.hf_K, spec_j.hf_hs)

    lp_j = jpatch.extract(hf_j, jnp.asarray(state[0][0]), jnp.asarray(state[0][1]), K)
    lp_t = tpatch.extract(hf_t, torch.as_tensor(state[0][0]), torch.as_tensor(state[0][1]), K)
    terrain_t = tfused.patch_inputs(lp_t)
    xoff_j = lp_j.x0.astype(jnp.float32) * 0.1 - lp_j.border_offset   # fused_step.py:978
    yoff_j = lp_j.y0.astype(jnp.float32) * 0.1 - lp_j.border_offset
    # the offsets pick the cells: they must be bit-equal
    np.testing.assert_array_equal(terrain_t[1].numpy(), np.asarray(xoff_j))
    np.testing.assert_array_equal(terrain_t[2].numpy(), np.asarray(yoff_j))
    terrain_j = dict(patch=jnp.moveaxis(lp_j.data, 0, -1), xoff=xoff_j, yoff=yoff_j)

    split = lambda a: [a[i] for i in range(a.shape[0])]
    keys = ("pos", "quat", "lin", "ang", "q", "qd")
    sj, aj, dj = [jnp.asarray(x) for x in state], jnp.asarray(actions), [jnp.asarray(x) for x in dr]
    st_j, lf_j, tau_j = jfused.control_step_components(
        spec_j, dict(zip(keys, map(split, sj))), split(aj), dj[0], dj[1], split(dj[2]),
        split(dj[3]), split(dj[4]), terrain=terrain_j)
    out_state, lf_t, tau_t, lpos_t, lvel_t = tfused.plain_control_step(
        spec_t, tuple(map(torch.as_tensor, state)), torch.as_tensor(actions),
        tuple(map(torch.as_tensor, dr)), terrain_t)
    for name, k, got in zip(STATE, keys, out_state):
        _close(name, got, np.stack(st_j[k]))
    _close("link_forces", lf_t, np.asarray(lf_j))
    _close("torques", tau_t, np.stack(tau_j))
    # the plain version's last outward pass against JAX `link_states` of
    # the JAX kernel body's output state
    lpos_j, lvel_j = jphys.link_states(ma_j, jphys.PhysicsState(*[jnp.stack(st_j[k])
                                                                  for k in keys]))
    _close("link_pos", lpos_t, lpos_j)
    _close("link_vel", lvel_t, lvel_j)
    assert float(np.abs(np.asarray(lf_j)).max()) > 1.0   # the terrain was touched


def test_eager_heightfield_control_step_matches_reference(robot, monkeypatch):
    """One eager `control_step` on the heightfield (per-env windows, surface
    held through each tick) against JAX `engine.control_step` with the
    kernel off."""
    monkeypatch.setenv("LGC_FUSED_KERNEL", "0")
    urdf, default_pos = robot
    ndof = len(default_pos)
    (ma_j, pd_j, dl_j), (ma_t, pd_t, dl_t) = _both(urdf, default_pos)
    hf_j, hf_t = _terrain()
    state, dr, actions = _batch(8, default_pos)
    ref_state, ref_info, _ = jax.jit(
        lambda s, a, d: jphys.control_step(ma_j, hf_j, _plant(ndof, True), pd_j, d, dl_j, s, a)
    )(jphys.PhysicsState(*state), actions, jphys.DomainRandParams(*dr))
    T = torch.as_tensor
    params = _plant(ndof, False)
    assert tphys.patch_K(hf_t, params) == K
    st, info = tphys.control_step(ma_t, hf_t, params, pd_t, tphys.DomainRandParams(*map(T, dr)),
                                  dl_t, tphys.PhysicsState(*map(T, state)), T(actions))
    for name, a, b in zip(STATE, ref_state, st):
        _close(name, b, a)
    _close("link_forces", info.link_forces, ref_info.link_forces)
    _close("torques", info.torques, ref_info.torques)
    _close("base_pos", info.link_pos, ref_info.link_pos)
    _close("lin_vel", info.link_vel, ref_info.link_vel)


def test_wrapper_runs_plain_k3_on_cpu_and_counts_no_launch():
    (_, _, _), (ma_t, pd_t, dl_t) = _both(SYNTHETIC_GO2_URDF, GO2_DEFAULT)
    spec = tfused.build_spec(ma_t, _plant(12, False), pd_t, dl_t, hf_K=K, hf_hs=0.1)
    _, hf_t = _terrain()
    state, dr, actions = _batch(9, GO2_DEFAULT)
    T = torch.as_tensor
    lp = tpatch.extract(hf_t, T(state[0][0]), T(state[0][1]), K)
    terrain = tfused.patch_inputs(lp)
    args = (spec, tuple(map(T, state)), T(actions), tuple(map(T, dr)), terrain)
    before = (tfused.fused_control_step.launches, tfused.fused_control_step.hf_launches)
    out = tfused.fused_control_step(*args)
    ref = tfused.plain_control_step(*args)
    assert (tfused.fused_control_step.launches,
            tfused.fused_control_step.hf_launches) == before
    for a, b in zip((*out[0], *out[1:]), (*ref[0], *ref[1:])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):   # a window of the wrong size
        tfused.fused_control_step(spec, *args[1:4], (terrain[0][:, :8, :8].contiguous(),
                                                      *terrain[1:]))
    header = tfused.spec_header(spec)
    assert "#define LGC_HF_K 24" in header
    assert "#define LGC_HF_GMAX 2.299900055e+01f" in header
