"""The port's roofline accounting (ops/roofline.py) and kernel receipt
(scripts/check_fused_gpu.py) against the JAX package's on the CPU.

  * `kernel_bytes_per_env` equal on K1, K3 and the tests' tree spec;
  * `roofline_report` equal, the counts and peaks injected in both;
  * `count_kernel_ops` against the reference's jaxpr count on one tick of
    the Go2 plant (4 substeps; a control step repeats it 4 times): the
    transcendentals those of the reference and of the sphere entries the
    lane plan pads, the flops at a stated ratio (the port counts the step
    that walks the kernel's lane plan, which folds products and sums with a
    constant 0 or 1 at trace time as nvcc folds the baked-in constants,
    forms a butterfly sum and the base's 6x6 solve once, carries inertias as
    3x3 blocks, and reads four window cells where the reference contracts
    one-hot rows of the window);
  * the measurement kernels' wrappers: on CPU tensors their plain versions,
    against the closed form; the rates refuse the CPU;
  * `check_fused_gpu`: `ks_stat`, the terrain table, `closed_loop_stats` of
    the plain version against the reference's XLA path with the actions
    injected, and the CLI's refusal of the CPU.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from legged_gym_custom_tpu import physics as jphys
from legged_gym_custom_tpu.ops import fused_step as jfused
from legged_gym_custom_tpu.ops import roofline as jroofline
from legged_gym_custom_tpu.scripts import check_fused_tpu as jcheck
from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch.ops import fused_step as tfused
from legged_gym_custom_tpu_torch.ops import roofline
from legged_gym_custom_tpu_torch.scripts import check_fused_gpu
from test_torch_physics import GO2_DEFAULT, _both, _plant
import torch_tree_model as tree_model

OBS_TOL = dict(atol=2e-3, rtol=1e-3)
# flops of the port's count over the reference's on one tick of the Go2
# plant (measured on this spec; the reference counts constant products,
# dense 6x6 inertias and one-hot window contractions that the port's kernel
# does not do)
FLOP_RATIO = {0: 0.360, 24: 0.205}
FLOP_RATIO_REL = 0.02
# the lane plan gives each of the four legs' lanes a base sphere entry; the
# three that no geom fills are computed all the same (a sqrt a substep each,
# and on a heightfield a surface normal's sqrt each once a tick)
PADDED_ENTRIES = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(K, urdf=SYNTHETIC_GO2_URDF, angles=GO2_DEFAULT, decimation=4):
    """(JAX, port) FusedSpec of one URDF on the go2 plant."""
    (ma_j, pd_j, dl_j), (ma_t, pd_t, dl_t) = _both(urdf, angles)
    n = len(angles)
    hs = 0.1 if K else 0.0
    return (jfused.build_spec(ma_j, _plant(n, True)._replace(decimation=decimation), pd_j, dl_j,
                              hf_K=K, hf_hs=hs),
            tfused.build_spec(ma_t, _plant(n, False)._replace(decimation=decimation), pd_t,
                              dl_t, hf_K=K, hf_hs=hs))


@pytest.mark.parametrize("which", ["K1", "K3", "tree"])
def test_kernel_bytes_per_env_match_reference(which):
    if which == "tree":
        spec_j, spec_t = _specs(8, tree_model.TEST_TREE_URDF, tree_model.DEFAULT_ANGLES)
    else:
        spec_j, spec_t = _specs(24 if which == "K3" else 0)
    assert roofline.kernel_bytes_per_env(spec_t) == jroofline.kernel_bytes_per_env(spec_j)
    ndof, nl = len(spec_t.parent) - 1, spec_t.n_links
    n = 2 * (13 + 2 * ndof) + (5 + 2 * ndof) + ndof + 3 * nl + ndof
    assert roofline.kernel_bytes_per_env(spec_t) == 4 * (n + (spec_t.hf_K ** 2 + 2
                                                             if spec_t.hf_K else 0))


@pytest.mark.parametrize("batch, achieved_ms", [(4096, 0.094), (1024, 0.002), (65536, 0.59)])
def test_roofline_report_matches_reference(batch, achieved_ms, monkeypatch):
    spec_j, spec_t = _specs(24)
    counts = {"flops": 162442, "transcendentals": 1380, "other_prims": 999}
    monkeypatch.setattr(jroofline, "count_kernel_ops", lambda spec: dict(counts))
    monkeypatch.setattr(roofline, "count_kernel_ops", lambda spec: dict(counts))
    peaks = {"fma_gflops": 51234.5, "trans_gops": 1432.1, "hbm_gbps": 2987.6}
    got = roofline.roofline_report(spec_t, achieved_ms, batch, peaks=peaks)
    ref = jroofline.roofline_report(spec_j, achieved_ms, batch, peaks={
        "vpu_gflops": peaks["fma_gflops"], "trans_gops": peaks["trans_gops"],
        "hbm_gbps": peaks["hbm_gbps"]})
    assert list(got) == list(ref)
    assert got["measured_peaks"] == {"fma_gflops": 51234.5, "trans_gops": 1432.1,
                                     "hbm_gbps": 2987.6}
    ref["measured_peaks"] = {"fma_gflops": ref["measured_peaks"].pop("vpu_gflops"),
                             **ref["measured_peaks"]}
    assert got == ref
    assert 0.0 < got["roofline_pct"] and got["bound"] in ("compute", "memory")


@pytest.mark.parametrize("K", [0, 24])
def test_count_kernel_ops_against_reference(K):
    """One decimation tick (4 substeps) of K1 and of K3 in both counts."""
    spec_j, spec_t = _specs(K, decimation=1)
    ref = jroofline.count_kernel_ops(spec_j)
    got = roofline.count_kernel_ops(spec_t)
    substeps = 4
    assert ref["transcendentals"] > 0
    assert got["transcendentals"] == ref["transcendentals"] + PADDED_ENTRIES * (substeps + (K > 0))
    assert got["flops"] / ref["flops"] == pytest.approx(FLOP_RATIO[K], rel=FLOP_RATIO_REL)
    # a control step is decimation ticks (the body inertias once)
    full = roofline.count_kernel_ops(_specs(K)[1])
    assert full["transcendentals"] == 4 * got["transcendentals"]
    assert 3.9 * got["flops"] < full["flops"] < 4.0 * got["flops"]


def test_measurement_wrappers_on_cpu_are_the_closed_form():
    x = torch.arange(1024, dtype=torch.float32) * 0.5 - 256.0
    iters = 4
    # c <- c * 1 + 0.5, iters x FMA_INNER times on halves: exact in float32
    np.testing.assert_array_equal(roofline.fma_chain(x, 1.0, 0.5, iters).numpy(),
                                  (x + 0.5 * iters * roofline.FMA_INNER).numpy())
    # c <- tanh(c) from (0, 1]: the chain in float64, which tells the steps
    u = torch.arange(1, 1025, dtype=torch.float32) / 1024
    ref = u.double().numpy()
    for _ in range(8 * roofline.TANH_INNER):
        ref = np.tanh(ref)
    np.testing.assert_allclose(roofline.tanh_chain(u, 0.0, 8).numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(roofline.stream_add(x).numpy(), (x + 1.0).numpy())
    assert roofline.launch_counts() == {"fma_chain": 0, "tanh_chain": 0, "stream_add": 0}
    with pytest.raises(ValueError):
        roofline.fma_chain(torch.zeros((2, 2)), 1.0, 0.5, 1)


def test_measured_peaks_need_the_card():
    for measure in (roofline.measure_fma_peak_gflops, roofline.measure_trans_rate_gops,
                    roofline.measure_hbm_bw_gbps):
        with pytest.raises(RuntimeError, match="CUDA"):
            measure(device="cpu")


# ---------------------------------------------------------------- check_fused_gpu

@pytest.mark.parametrize("seed", [0, 1])
def test_ks_stat_matches_reference(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=300), rng.normal(0.1, 1.2, size=211)
    assert check_fused_gpu.ks_stat(a, b) == jcheck.ks_stat(a, b)
    assert check_fused_gpu.ks_stat(a, a) == 0.0


def test_build_terrain_table_is_the_reference_table():
    p = check_fused_gpu.build(4, terrain=True, full_plant=True, device="cpu")
    rng = np.random.default_rng(7)
    raw = (rng.normal(size=(128, 128)) * 8).astype(np.int16)
    ref = jphys.from_raw(raw, 0.1, 0.005, 1.0)
    np.testing.assert_array_equal(p.hf.data.numpy(), np.asarray(ref.data))
    assert (p.hf.horizontal_scale, p.hf.border_offset) == (ref.horizontal_scale,
                                                           ref.border_offset)
    assert p.spec.hf_K == 24 and p.spec.substeps == 4
    assert float(p.state.base_pos[:2].min()) >= 4.0 and float(p.state.base_pos[:2].max()) <= 8.0


def _jax_plant(p, terrain, full_plant):
    """The reference's plant (check_fused_tpu.py:36-97) on the synthetic URDF
    and the port's drawn batch."""
    model = jphys.load_urdf(SYNTHETIC_GO2_URDF, "go2")
    ma = jphys.model_arrays(model)
    pd = jphys.PDParams(p_gains=jnp.full(12, 40.0), d_gains=jnp.full(12, 1.0),
                        default_dof_pos=jnp.asarray(check_fused_gpu.DEFAULT_ANGLES, jnp.float32),
                        torque_limits=jnp.asarray(model.dof_effort_limits, jnp.float32),
                        action_scale=0.25)
    dof_limits = (jnp.asarray(model.dof_pos_limits[:, 0], jnp.float32),
                  jnp.asarray(model.dof_pos_limits[:, 1], jnp.float32),
                  jnp.asarray(model.dof_vel_limits, jnp.float32))
    J = lambda t: jnp.asarray(t.numpy())
    state = jphys.PhysicsState(*[J(t) for t in p.state])
    dr = jphys.DomainRandParams(*[J(t) for t in p.dr])
    if terrain:
        raw = (np.random.default_rng(7).normal(size=(128, 128)) * 8).astype(np.int16)
        hf = jphys.from_raw(raw, 0.1, 0.005, 1.0)
    else:
        hf = jphys.plane()
    params = jphys.SimParams()
    if full_plant:
        params = jphys.SimParams(
            substeps=4, contact=jphys.ContactParams(stiffness=40000.0, damping=250.0,
                                                    friction_vel=250.0, terrain_friction=1.0),
            dof_damping=jnp.full(12, 0.1), dof_armature=jnp.full(12, 0.01),
            dof_frictionloss=jnp.full(12, 0.2))
    return ma, hf, params, pd, dr, dof_limits, state


@pytest.mark.parametrize("terrain", [True, False])
def test_closed_loop_stats_of_the_plain_version_match_reference_xla(terrain, monkeypatch):
    """4 envs x 5 steps under the reference's smoothed action sequence
    (PRNGKey(123), injected): the port's plain version against the
    reference's XLA control step."""
    B, steps = 4, 5
    monkeypatch.setenv("LGC_FUSED_KERNEL", "0")
    p = check_fused_gpu.build(B, terrain=terrain, full_plant=True, device="cpu")
    ma, hf, params, pd, dr, dof_limits, state = _jax_plant(p, terrain, True)
    xla = jax.jit(lambda s, a: jphys.control_step(ma, hf, params, pd, dr, dof_limits, s, a)[:2])
    ref = jcheck.closed_loop_stats(xla, state, steps, B, jax.random.PRNGKey(123))
    key, draws = jax.random.PRNGKey(123), []
    for _ in range(steps):
        key, k = jax.random.split(key)
        draws.append(torch.as_tensor(np.array(jax.random.normal(k, (12, B)))))
    monkeypatch.setattr(check_fused_gpu, "_action_noise", lambda gen, shape: draws.pop(0))
    got = check_fused_gpu.closed_loop_stats(lambda s, a: check_fused_gpu.plain_step(p, s, a),
                                            p.state, steps, B, torch.Generator())
    assert list(got) == list(ref) == ["dof_vel_rms", "base_z", "contact_fz"]
    for k in ref:
        assert got[k].shape == ref[k].shape == (B * steps,), k
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **OBS_TOL)
    assert ref["contact_fz"].max() > 10.0   # the feet touch


def test_check_fused_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit) as e:
        check_fused_gpu.main(["--device", "cpu", "--batch", "4"])
    assert e.value.code != 0 and "GPU" in str(e.value.code)
    with pytest.raises(SystemExit):
        check_fused_gpu.roofline_bench(batch=4, device="cpu")
    assert check_fused_gpu.get_args([]).device == "cuda"
