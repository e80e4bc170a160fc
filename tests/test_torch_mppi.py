"""Parity of the port's MPPI (legged_gym_custom_tpu_torch/mpc/mppi.py) with
the JAX reference on the CPU, and the port's counterparts of
tests/test_mppi.py at CPU sizes.

Both solvers sit on the flat go2 env built from the synthetic Go2-shaped
URDF (observation noise and pushes off), and on a 6 m x 4 m pit course
(tests/test_mppi.py:128-135) swapped into a shallow copy of that env.  All
inputs are seeded numpy; the noise of a whole solve is JAX's own draw, fed to
the port's `solve_with_noise`.  The full-length closed loops run on the card
(chip_smoke.py, phase 8).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from legged_gym_custom_tpu import physics as jphys
from legged_gym_custom_tpu.envs.go2_config import Go2Cfg as JGo2Cfg
from legged_gym_custom_tpu.envs.go2_env import Go2Env as JGo2Env
from legged_gym_custom_tpu.mpc import mppi as jmppi
from legged_gym_custom_tpu_torch import SYNTHETIC_GO2_URDF
from legged_gym_custom_tpu_torch import physics as phys
from legged_gym_custom_tpu_torch.envs import Go2Cfg, Go2Env
from legged_gym_custom_tpu_torch.mpc import MPPI, MPPIConfig, MPCState, stage_cost

B, K, H = 2, 4, 3
COST_TOL = dict(rtol=1e-5, atol=1e-5)
# float32 physics parity (tests/test_torch_env.py:31) carried over 3 steps
ROLLOUT_TOL = dict(rtol=1e-3, atol=1e-2)
UPDATE_TOL = dict(rtol=1e-5, atol=1e-6)
CFG = MPPIConfig(horizon=H, num_samples=K)
# go2's default joint angles (go2_config.py), the standing pose
DEFAULT_ANGLES = np.array([0.1, 0.8, -1.5, -0.1, 0.8, -1.5, 0.1, 1.0, -1.5, -0.1, 1.0, -1.5])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny, so one thread is faster than many, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cfg_cls):
    cfg = cfg_cls()
    cfg.env.num_envs = B
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    return cfg


def _pit_raw():
    """6 m x 4 m at 0.1 m cells, flat, with a 1 m deep pit across x in
    [2.0, 2.6) (tests/test_mppi.py:128-131)."""
    raw = np.zeros((60, 40), np.int16)
    raw[20:26, :] = int(-1.0 / 0.005)
    return raw


def _on(env, hf):
    """A shallow copy of `env` over the terrain `hf`, as tests/test_mppi.py:133-135."""
    out = type(env).__new__(type(env))
    out.__dict__.update(env.__dict__)
    out.hf = hf
    return out


@pytest.fixture(scope="module")
def envs():
    env_j = JGo2Env(_cfg(JGo2Cfg), SYNTHETIC_GO2_URDF, name="go2")
    env_t = Go2Env(_cfg(Go2Cfg), SYNTHETIC_GO2_URDF, name="go2", device="cpu")
    return {
        "plane": (env_j, env_t),
        "pit": (_on(env_j, jphys.from_raw(_pit_raw(), 0.1, 0.005, 0.0)),
                _on(env_t, phys.from_raw(_pit_raw(), 0.1, 0.005, 0.0))),
    }


def _rollout_inputs(seed, n, terrain):
    """A seeded SoA physics state, DR and commands for n rollouts; on the pit
    course the bases stand within 0.4 m of the pit's near edge."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    x = rng.uniform(1.6, 2.1, n) if terrain == "pit" else rng.uniform(-1.0, 1.0, n)
    quat = rng.normal(size=(4, n)) * 0.05 + np.array([1.0, 0, 0, 0])[:, None]
    quat /= np.linalg.norm(quat, axis=0, keepdims=True)
    ph = [f(np.stack([x, rng.uniform(1.5, 2.5, n), rng.uniform(0.28, 0.34, n)])), f(quat),
          f(rng.normal(size=(3, n)) * 0.2), f(rng.normal(size=(3, n)) * 0.2),
          f(DEFAULT_ANGLES[:, None] + rng.normal(size=(12, n)) * 0.1), f(rng.normal(size=(12, n)))]
    dr = [f(rng.uniform(0.5, 1.2, n)), f(rng.uniform(0.0, 2.0, n)),
          f(rng.uniform(-0.05, 0.05, (3, n))), f(rng.uniform(0.9, 1.1, (12, n))),
          f(rng.uniform(0.9, 1.1, (12, n)))]
    cmds = f(np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.5, 0.5, n),
                       rng.uniform(-1, 1, n), np.zeros(n)]))
    return ph, dr, cmds


def _both(arrays, jcls, tcls):
    return (jcls(*[jnp.asarray(a) for a in arrays]), tcls(*[torch.as_tensor(a) for a in arrays]))


def _close(got, ref, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               err_msg=what, **tol)


# --------------------------------------------------------------------------
# stage_cost on injected inputs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("terrain", ["plane", "pit"])
def test_stage_cost_matches_reference(envs, terrain):
    """The thresholded terms see values well away from their thresholds
    (feet z-forces 0, 0.5, 2 or 30 N against 1 N; penalized links at 0.02,
    0.05, 0.2 or 5 N against 0.1 N), so both sides take the same branches."""
    env_j, env_t = envs[terrain]
    mpc_j, mpc_t = jmppi.MPPI(env_j, CFG), MPPI(env_t, CFG)
    n = 16
    rng = np.random.default_rng(1)
    f = lambda a: np.asarray(a, np.float32)
    ph, _, cmds = _rollout_inputs(2, n, terrain)
    nl = env_t.model.n_links
    dirs = rng.normal(size=(nl, 3, n))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    forces = dirs * rng.choice([0.02, 0.05, 0.2, 5.0], size=(nl, 1, n))
    feet = list(env_t.feet_ids)
    forces[feet, 2] = rng.choice([0.0, 0.5, 2.0, 30.0], size=(len(feet), n))
    link_pos = np.stack([ph[0][0] + rng.uniform(-0.3, 0.3, (nl, n)),
                         ph[0][1] + rng.uniform(-0.2, 0.2, (nl, n)),
                         rng.uniform(-0.5, 0.12, (nl, n))], axis=1)
    info = [f(forces), f(link_pos), f(rng.normal(size=(nl, 3, n))),
            f(rng.normal(size=(12, n)) * 10.0)]
    actions, prev = f(rng.normal(size=(12, n))), f(rng.normal(size=(12, n)))
    phases = f(rng.uniform(0.0, 1.0, (4, n)))
    assert sorted(env_t.feet_ids) == sorted(np.asarray(env_j.feet_ids).tolist())

    ph_j, ph_t = _both(ph, jphys.PhysicsState, phys.PhysicsState)
    info_j, info_t = _both(info, jphys.StepInfo, phys.StepInfo)
    got = stage_cost(CFG, mpc_t.statics, env_t.hf, ph_t, info_t, torch.as_tensor(cmds),
                     torch.as_tensor(actions), torch.as_tensor(prev), torch.as_tensor(phases))
    ref = jmppi.stage_cost(CFG, mpc_j.statics, env_j.hf, ph_j, info_j, jnp.asarray(cmds),
                           jnp.asarray(actions), jnp.asarray(prev), jnp.asarray(phases))
    _close(got, ref, COST_TOL, f"stage cost on the {terrain}")
    if terrain == "pit":   # some loaded feet stand over the hole
        h = np.asarray(jphys.height_bilinear(env_j.hf, link_pos[feet, 0], link_pos[feet, 1]))
        assert ((h < -CFG.gap_depth) & (forces[feet, 2] > 1.0)).any()


# --------------------------------------------------------------------------
# rollout costs and the solve
# --------------------------------------------------------------------------


def _flip_report(env_j, env_t, ph, dr, samples):
    """Step both engines through the rollout and name every thresholded
    stage-cost term whose branch differs, with the reference's margin to the
    threshold: the diagnosis of a rollout that differs by a discrete step."""
    mpc_t = MPPI(env_t, CFG)
    feet, pen = list(env_t.feet_ids), list(env_t.penalized_ids)
    st_j, st_t = _both(ph, jphys.PhysicsState, phys.PhysicsState)
    dr_j, dr_t = _both(dr, jphys.DomainRandParams, phys.DomainRandParams)
    lines = []
    for t in range(samples.shape[0]):
        st_j, info_j, _ = jphys.control_step(env_j.ma, env_j.hf, env_j.sim_params, env_j.pd, dr_j,
                                             env_j.dof_limits, st_j, jnp.asarray(samples[t]))
        st_t, info_t = phys.control_step(env_t.ma, env_t.hf, env_t.sim_params, env_t.pd, dr_t,
                                         env_t.dof_limits, st_t, torch.as_tensor(samples[t]),
                                         spec=mpc_t.spec)
        lf_j, lf_t = np.asarray(info_j.link_forces), info_t.link_forces.numpy()
        fz_j, fz_t = lf_j[feet, 2], lf_t[feet, 2]
        for i, r in zip(*np.nonzero((fz_j > CFG.contact_force_thresh)
                                    != (fz_t > CFG.contact_force_thresh))):
            lines.append(f"step {t} rollout {r}: foot {feet[i]} contact (phase/gap terms) flipped, "
                         f"z-force {fz_j[i, r]:.6g} N vs {fz_t[i, r]:.6g} N, margin "
                         f"{fz_j[i, r] - CFG.contact_force_thresh:+.3e} N to 1 N")
        m_j, m_t = np.linalg.norm(lf_j[pen], axis=1), np.linalg.norm(lf_t[pen], axis=1)
        for i, r in zip(*np.nonzero((m_j > 0.1) != (m_t > 0.1))):
            lines.append(f"step {t} rollout {r}: link {pen[i]} collision flipped, |f| "
                         f"{m_j[i, r]:.6g} N vs {m_t[i, r]:.6g} N, margin {m_j[i, r] - 0.1:+.3e} N")
    return "\n".join(lines) or "no thresholded term flipped"


def _check_rollout(got, ref, what, diagnose):
    try:
        _close(got, ref, ROLLOUT_TOL, what)
    except AssertionError as err:
        raise AssertionError(f"{err}\n{diagnose()}") from None


@pytest.mark.parametrize("terrain", ["plane", "pit"])
def test_rollout_costs_match_reference(envs, terrain):
    env_j, env_t = envs[terrain]
    mpc_j, mpc_t = jmppi.MPPI(env_j, CFG), MPPI(env_t, CFG)
    assert mpc_t.spec.hf_K == (0 if terrain == "plane" else 24)
    n = B * K
    ph, dr, cmds = _rollout_inputs(3, n, terrain)
    rng = np.random.default_rng(4)
    samples = np.clip(rng.normal(size=(H, 12, n)) * 0.4, -3.14, 3.14).astype(np.float32)
    phase0 = np.float32(0.3)
    ph_j, ph_t = _both(ph, jphys.PhysicsState, phys.PhysicsState)
    dr_j, dr_t = _both(dr, jphys.DomainRandParams, phys.DomainRandParams)
    ref = mpc_j._rollout_costs(ph_j, dr_j, jnp.asarray(cmds), jnp.asarray(samples),
                               jnp.asarray(phase0))
    got = mpc_t._rollout_costs(ph_t, dr_t, torch.as_tensor(cmds), torch.as_tensor(samples),
                               torch.as_tensor(phase0))
    assert got.shape == (n,) and bool(torch.isfinite(got).all())
    _check_rollout(got, ref, f"rollout costs on the {terrain}",
                   lambda: _flip_report(env_j, env_t, ph, dr, samples))


@pytest.fixture(scope="module")
def solve_case(envs):
    """One solve on both sides from a nonzero plan at phase 0.7: JAX's whole
    solve, the costs it computed (captured from its `_rollout_costs`), its
    noise draw, and the port's solve from that noise."""
    env_j, env_t = envs["plane"]
    mpc_j, mpc_t = jmppi.MPPI(env_j, CFG), MPPI(env_t, CFG)
    ph, dr, cmds = _rollout_inputs(5, B, "plane")
    bl = lambda arrays: [np.ascontiguousarray(np.moveaxis(a, -1, 0)) for a in arrays]
    ph, dr, cmds = bl(ph), bl(dr), np.ascontiguousarray(cmds.T)
    nominal = (np.random.default_rng(6).normal(size=(B, H, 12)) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(11)

    captured = []
    rollout = mpc_j._rollout_costs
    mpc_j._rollout_costs = lambda *a: captured.append(rollout(*a)) or captured[-1]
    ph_j, ph_t = _both(ph, jphys.PhysicsState, phys.PhysicsState)
    dr_j, dr_t = _both(dr, jphys.DomainRandParams, phys.DomainRandParams)
    ms_j = jmppi.MPCState(nominal=jnp.asarray(nominal), phase=jnp.float32(0.7))
    ref = mpc_j.solve(ms_j, ph_j, dr_j, jnp.asarray(cmds), key)
    eps = np.asarray(jax.random.normal(key, (B, K, H, 12)) * CFG.noise_sigma)

    ms_t = MPCState(nominal=torch.as_tensor(nominal), phase=torch.tensor(0.7))
    got = mpc_t.solve_with_noise(ms_t, ph_t, dr_t, torch.as_tensor(cmds), torch.as_tensor(eps))
    return dict(mpc_t=mpc_t, ms_t=ms_t, eps=torch.as_tensor(eps), ref=ref, got=got,
                costs_j=np.asarray(captured[0]).reshape(B, K))


def _check_solve(got, ref, tol, what):
    (a_t, ms_t, c_t), (a_j, ms_j, c_j) = got, ref
    _close(a_t, a_j, tol, f"{what}: actions")
    _close(ms_t.nominal, ms_j.nominal, tol, f"{what}: shifted nominal")
    _close(ms_t.phase, ms_j.phase, tol, f"{what}: phase")
    _close(c_t, c_j, tol, f"{what}: expected cost")


def test_update_from_the_reference_costs_matches(solve_case):
    """The smoothing, clip, soft-min weights, weighted plan, shift and clock
    on the JAX noise and the JAX costs."""
    c = solve_case
    samples = c["mpc_t"]._samples(c["ms_t"].nominal, c["eps"])
    got = c["mpc_t"]._update(c["ms_t"], samples, torch.as_tensor(c["costs_j"]))
    _check_solve(got, c["ref"], UPDATE_TOL, "update from the JAX costs")


def test_solve_with_the_reference_noise_matches(solve_case):
    _check_solve(solve_case["got"], solve_case["ref"], ROLLOUT_TOL, "whole solve")
    assert solve_case["got"][0].shape == (B, 12)


# --------------------------------------------------------------------------
# the port's counterparts of tests/test_mppi.py:25, 41, 62, 112
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_state(envs):
    env_t = envs["plane"][1]
    state, _ = env_t.reset_all(torch.Generator().manual_seed(0))
    return state


def _standing(env, x, n):
    return phys.PhysicsState(
        base_pos=torch.tensor([x, 2.0, 0.32]).repeat(n, 1),
        base_quat=torch.tensor([1.0, 0.0, 0.0, 0.0]).repeat(n, 1),
        lin_vel=torch.zeros((n, 3)), ang_vel=torch.zeros((n, 3)),
        dof_pos=env.default_dof_pos.repeat(n, 1), dof_vel=torch.zeros((n, 12)))


def test_warm_start_shifts_plan(envs, port_state):
    """Zero noise: uniform weights, the new plan is the old one, so the state
    is its one-step shift (tests/test_mppi.py:25)."""
    env_t = envs["plane"][1]
    mpc = MPPI(env_t, MPPIConfig(horizon=H, num_samples=2, noise_sigma=0.0))
    plan = torch.arange(B * H * 12, dtype=torch.float32).reshape(B, H, 12) * 0.01
    ms = mpc.init_state(B)._replace(nominal=plan)
    s = port_state
    actions, ms2, _ = mpc.solve(ms, s.physics, s.dr, s.commands, torch.Generator().manual_seed(1))
    torch.testing.assert_close(actions, plan[:, 0], atol=1e-5, rtol=0)
    torch.testing.assert_close(ms2.nominal[:, :-1], plan[:, 1:], atol=1e-5, rtol=0)
    torch.testing.assert_close(ms2.nominal[:, -1], plan[:, -1], atol=1e-5, rtol=0)


def test_soft_min_prefers_cheap_samples(envs, port_state):
    """The soft-min expectation over perturbed plans is no worse than the
    zero plan's cost, up to sampling slack (tests/test_mppi.py:41)."""
    env_t = envs["plane"][1]
    cfg = MPPIConfig(horizon=H, num_samples=K, noise_sigma=0.3, temperature=0.1)
    mpc, zero = MPPI(env_t, cfg), MPPI(env_t, cfg._replace(noise_sigma=0.0, num_samples=1))
    s = port_state
    gen = lambda: torch.Generator().manual_seed(2)
    _, _, zero_cost = zero.solve(zero.init_state(B), s.physics, s.dr, s.commands, gen())
    _, _, cost = mpc.solve(mpc.init_state(B), s.physics, s.dr, s.commands, gen())
    assert float(torch.max(cost - zero_cost)) < 1.0


def _control_step(env, hf, dr, ph, actions):
    to_soa = lambda t: type(t)(*[x.movedim(0, -1).contiguous() for x in t])
    st, _ = phys.control_step(env.ma, hf, env.sim_params, env.pd, to_soa(dr), env.dof_limits,
                              to_soa(ph), actions.T.contiguous())
    return phys.PhysicsState(*[x.movedim(-1, 0) for x in st])


def test_mpc_keeps_standing_robot_upright(envs, port_state):
    """5 ticks of solve + control step from the standing pose under a zero
    command (tests/test_mppi.py:62 runs 100; the card runs those)."""
    env_t = envs["plane"][1]
    n = 1
    mpc = MPPI(env_t, MPPIConfig(horizon=H, num_samples=K, noise_sigma=0.25))
    ms = mpc.init_state(n)
    dr = type(port_state.dr)(*[x[:n] for x in port_state.dr])
    ph, commands = _standing(env_t, 0.0, n), torch.zeros((n, 4))
    gen = torch.Generator().manual_seed(3)
    min_z, max_tilt = 1.0, 0.0
    for _ in range(5):
        actions, ms, _ = mpc.solve(ms, ph, dr, commands, gen)
        ph = _control_step(env_t, env_t.hf, dr, ph, actions)
        min_z = min(min_z, float(ph.base_pos[:, 2].min()))
        max_tilt = max(max_tilt, float((1.0 - ph.base_quat[:, 0].abs()).max()))
    assert min_z > 0.15, f"robot collapsed: min base z {min_z:.3f}"
    assert max_tilt < 0.15, f"robot tipped: max tilt {max_tilt:.3f}"
    assert float(ms.phase) == pytest.approx(5 * env_t.dt / mpc.cfg.period % 1.0, abs=1e-6)


def test_mpc_terrain_aware_on_pit_course(envs, port_state):
    """A start at the pit's edge costs more than one on safe ground: the gap
    cost sees the course through the solver's own heightfield
    (tests/test_mppi.py:112, part (a))."""
    env_t = envs["pit"][1]
    mpc = MPPI(env_t, MPPIConfig(horizon=H, num_samples=K, noise_sigma=0.25))
    assert mpc.spec.hf_K == 24 and envs["plane"][1].fused_spec.hf_K == 0
    commands = torch.tensor([0.8, 0.0, 0.0, 0.0]).repeat(B, 1)
    dr = port_state.dr
    cost = {x: mpc.solve(mpc.init_state(B), _standing(env_t, x, B), dr, commands,
                         torch.Generator().manual_seed(7))[2] for x in (0.6, 1.9)}
    assert float(cost[1.9].mean()) > float(cost[0.6].mean()), cost
