"""The CUDA source of the fused control step, built for the host and run.

`ops/csrc/fused_step.cu` cannot run without a card, but its arithmetic and
indexing can: g++ compiles it against `tests/cuda_host_shim/cuda_runtime.h`,
which makes a block a set of OS threads that meet at one barrier (the warp
shuffles and `__syncthreads` are that barrier) and a launch a loop over
blocks (the source's one `<<<...>>>` launch is rewritten into a call of the
shim's `lgc_emulate`).  The generated header is the real one, so what runs is the kernel's
own lane plan, tables, shuffles, masked slots and ragged last block, at 32
threads a block.  Each case holds its outputs against `plain_control_step`
on the same seeded inputs with the tolerances of tests/test_fused_step.py
:126-135 (plane) and :185-193 (heightfield).  This says nothing about speed,
registers or what nvcc accepts: `chip_smoke.py` and test_torch_kernels.py do,
on the card.  No JAX here: the plain version's parity with JAX is held by
test_torch_physics.py, test_torch_hf_step.py and test_torch_k2_step.py.
"""
import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch.ops import fused_step
from test_torch_physics import GO2_DEFAULT
import torch_tree_model as tree_model

SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_host_shim")
TOL = dict(base_pos=(1e-4, 1e-4), base_quat=(1e-4, 1e-4), lin_vel=(1e-3, 1e-3),
           ang_vel=(1e-3, 1e-3), dof_pos=(1e-4, 1e-4), dof_vel=(1e-2, 1e-3),
           link_forces=(0.05, 1e-3), torques=(1e-2, 1e-3))
HF_TOL = dict(TOL, dof_vel=(2e-2, 1e-3))
K, HS = 8, 0.1
# model, spec options, layout of the build, envs (8, 4, 2 a block at G = 4, 8, 16: the
# last one ragged)
CASES = {
    "go2-plane-P-tanh": ("go2", dict(), dict(), 19),
    "go2-plane-P-stiction-pairs": ("go2", dict(implicit_stiction=True),
                                   dict(lanes_per_branch=2), 7),
    "go2-hf-T-stiction": ("go2", dict(hf_K=K, hf_hs=HS, control_type="T",
                                      implicit_stiction=True), dict(), 11),
    "go2-hf-P-tanh-pairs": ("go2", dict(hf_K=K, hf_hs=HS), dict(lanes_per_branch=2), 5),
    "tree-plane-P-tanh": ("tree", dict(), dict(), 13),
    "tree-hf-T-stiction": ("tree", dict(hf_K=K, hf_hs=HS, control_type="T",
                                        implicit_stiction=True), dict(), 9),
    # the split inward pass on trees the rule gives pairs: Go2 (G = 16, the
    # build chip_smoke.py times against the pair) and the test tree, whose
    # parents differ by lane (G = 16, an empty group of four)
    "go2-plane-P-tanh-deep": ("go2", dict(), dict(lanes_per_branch=4), 7),
    "tree-hf-T-stiction-deep": ("tree", dict(hf_K=K, hf_hs=HS, control_type="T",
                                             implicit_stiction=True),
                                dict(lanes_per_branch=4), 5),
    # the other robots' builds: ANYmal's one-tick 'T' spec (plane and
    # heightfield), the bipeds at a pair of lanes a leg (G = 4) and in the
    # layout for deep chains, four lanes a leg splitting the inward pass by
    # block (G = 8)
    "anymal-plane-T-one-tick-pairs": ("anymal_c_flat", dict(control_type="T", one_tick=True),
                                      dict(lanes_per_branch=2), 6),
    "anymal-hf-T-one-tick": ("anymal_c_flat", dict(hf_K=K, hf_hs=HS, control_type="T",
                                                   one_tick=True), dict(), 5),
    "cassie-hf-P-tanh-pairs": ("cassie", dict(hf_K=K, hf_hs=HS), dict(lanes_per_branch=2), 11),
    "g1-plane-P-tanh-pairs": ("g1", dict(), dict(lanes_per_branch=2), 13),
    "cassie-hf-P-tanh-deep": ("cassie", dict(hf_K=K, hf_hs=HS), dict(lanes_per_branch=4), 11),
    "g1-plane-P-tanh-deep": ("g1", dict(), dict(lanes_per_branch=4), 13),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(spec, layout, out_dir):
    """g++ build of the kernel source for the host; a `FusedKernel`."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    header, lib = os.path.join(out_dir, "spec.h"), os.path.join(out_dir, "fused_step_host.so")
    with open(header, "w") as f:
        f.write(fused_step.spec_header(spec, **layout))
    with open(fused_step.KERNEL_SOURCE) as f:
        source, launches = re.subn(
            r"(\w+)<<<(.*?)>>>\(",
            lambda m: f"lgc_emulate({m.group(1)}, {', '.join(m.group(2).split(',')[:2])}, ",
            f.read())
    assert launches == 1
    host_source = os.path.join(out_dir, "fused_step_host.cpp")
    with open(host_source, "w") as f:
        f.write(source)
    done = subprocess.run(
        [gxx, "-x", "c++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-DLGC_BLOCK=32",
         "-I", SHIM, "-include", header, "-o", lib, host_source],
        capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    handle = ctypes.CDLL(lib)
    handle.lgc_fused_control_step.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int,
                                                                       ctypes.c_void_p]
    handle.lgc_fused_control_step.restype = ctypes.c_int
    return handle


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_source_on_the_host_matches_plain_version(case, tmp_path):
    model, options, layout, B = CASES[case]
    base_z = (0.15, 0.35)
    if model == "go2":
        urdf, angles = SYNTHETIC_GO2_URDF, GO2_DEFAULT
    elif model == "tree":
        urdf, angles = tree_model.TEST_TREE_URDF, tree_model.DEFAULT_ANGLES
    else:
        urdf, angles, base_z = tree_model.robot_urdf_and_angles(model)
    options = dict(options)
    one_tick = options.pop("one_tick", False)
    spec = tree_model.plant_spec(urdf, angles, **options)
    if one_tick:
        spec = fused_step.tick_spec(spec)
    handle = _build(spec, layout, str(tmp_path))
    state, actions, dr = tree_model.model_batch(5, B, angles, base_z=base_z)
    terrain = tree_model.tree_terrain(6, state, K, HS) if spec.hf_K else None
    ndof = len(spec.parent) - 1
    if spec.fl_dqd:      # a quarter of the joints at rest, for the clamp to hold
        rest = torch.rand(actions.shape, generator=torch.Generator().manual_seed(7)) < 0.25
        state = (*state[:5], torch.where(rest, torch.zeros_like(state[5]), state[5]))
        if spec.control_type == "P":
            hold = (state[4] - torch.tensor(spec.default_dof_pos)[:, None]) / spec.action_scale
            actions = torch.where(rest, hold, actions)
    empty = lambda c: torch.full((c, B), float("nan"))
    outs = (empty(3), empty(4), empty(3), empty(3), empty(ndof), empty(ndof),
            empty(3 * spec.n_links), empty(ndof))
    window = [t.data_ptr() for t in terrain] if terrain else [None] * 3
    err = handle.lgc_fused_control_step(*[t.data_ptr() for t in (*state, actions, *dr)], *window,
                                        *[t.data_ptr() for t in outs], B, None)
    assert err == 0
    ref = fused_step.plain_control_step(spec, state, actions, dr, terrain)
    got = (*outs[:6], outs[6].view(spec.n_links, 3, B), outs[7])
    tol = HF_TOL if spec.hf_K else TOL
    for name, a, b in zip(tol, got, (*ref[0], ref[1], ref[2])):
        assert torch.isfinite(a).all(), name      # every env below B was stored
        atol, rtol = tol[name]
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol, msg=lambda m: f"{name}: {m}")
    if spec.fl_dqd:      # the joints held at exactly zero velocity, if any, are the same set
        assert int(((got[5] == 0) != (ref[0][5] == 0)).sum()) <= 0.01 * got[5].numel()
