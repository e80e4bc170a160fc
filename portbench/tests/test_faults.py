"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have: an update that returns its state
unchanged, one that leaves out half the batch and takes the mean over the
rest, one that skips each epoch's last minibatch, one that runs one epoch
of five; an env step that returns its state unchanged, one whose resetting
envs keep their state; an MPPI answer altered where it is produced.  (No
cell runs across chips, so no exchange can be left out.)  The look for a
chip is skipped; the cells run at a tiny size on the CPU."""
import pytest
import torch

from portbench import harness
from portbench.tests import tiny

# Episodes of five steps, so that the tiny cell's sampled steps hold resets.
SHORT_EPISODES = {"env.episode_length_s": 0.1}


@pytest.fixture
def broken(monkeypatch):
    from legged_gym_custom_tpu_torch.envs import base_env
    from legged_gym_custom_tpu_torch.mpc import mppi
    from legged_gym_custom_tpu_torch.rl import ppo

    def update_unchanged(cfg, ts, traj, *a, **k):
        for o in (ts.opt_policy, ts.opt_est, ts.opt_adapt):
            monkeypatch.setattr(o, "step", lambda *x, **y: None)
        return ORIG["ppo_update"](cfg, ts, traj, *a, **k)

    def update_half(cfg, ts, traj, returns, adv, *a, **k):
        B = traj.rewards.shape[1] // 2
        return ORIG["ppo_update"](cfg, ts, type(traj)(*[x[:, :B] for x in traj]),
                                  returns[:, :B], adv[:, :B], *a, **k)

    def update_last_minibatch_dropped(cfg, ts, traj, *a, **k):
        calls = {"n": 0}
        for o in (ts.opt_policy, ts.opt_est):
            def step(*x, _step=o.step, _count=o is ts.opt_est, **y):
                skip = calls["n"] % cfg.num_mini_batches == cfg.num_mini_batches - 1
                calls["n"] += _count
                return None if skip else _step(*x, **y)
            monkeypatch.setattr(o, "step", step)
        return ORIG["ppo_update"](cfg, ts, traj, *a, **k)

    def update_one_epoch(cfg, ts, traj, *a, **k):
        return ORIG["ppo_update"](cfg._replace(num_learning_epochs=1), ts, traj, *a, **k)

    def step_unchanged(self, state, actions):
        new_state, *rest = ORIG["step"](self, state, actions)
        return (new_state.replace(physics=state.physics), *rest)

    def step_reset_skipped(self, state, actions):
        new_state, obs, rew, done, info = ORIG["step"](self, state, actions)
        keep = lambda old, new: torch.where(done.view((-1,) + (1,) * (new.dim() - 1)), old, new)
        physics = type(state.physics)(*[keep(o, n) for o, n in zip(state.physics,
                                                                   new_state.physics)])
        return new_state.replace(physics=physics), obs, rew, done, info

    def plan_altered(self, ms, samples, costs):
        a, new, c = ORIG["_update"](self, ms, samples, costs)
        return a, new._replace(nominal=new.nominal + 0.01), c

    ORIG = {"ppo_update": ppo.ppo_update, "step": base_env.LeggedEnv.step,
            "_update": mppi.MPPI._update}
    patch = lambda mod, name, fn: lambda: monkeypatch.setattr(mod, name, fn)
    return {
        "update_unchanged": patch(ppo, "ppo_update", update_unchanged),
        "half_batch": patch(ppo, "ppo_update", update_half),
        "last_minibatch_dropped": patch(ppo, "ppo_update", update_last_minibatch_dropped),
        "one_epoch": patch(ppo, "ppo_update", update_one_epoch),
        "env_step_unchanged": patch(base_env.LeggedEnv, "step", step_unchanged),
        "reset_skipped": patch(base_env.LeggedEnv, "step", step_reset_skipped),
        "plan_altered": patch(mppi.MPPI, "_update", plan_altered),
    }


@pytest.mark.parametrize("fault,cell", [("update_unchanged", "go2_train"),
                                        ("half_batch", "go2_train"),
                                        ("last_minibatch_dropped", "go2_train"),
                                        ("one_epoch", "go2_train"),
                                        ("env_step_unchanged", "go2_train"),
                                        ("reset_skipped", "go2_train"),
                                        ("plan_altered", "go2_mppi_b8")])
def test_a_broken_path_is_not_correct(broken, fault, cell):
    torch.set_num_threads(2)
    broken[fault]()
    extra = SHORT_EPISODES if fault == "reset_skipped" else {}
    _, readings, _ = tiny.run(cell, seconds=2.5 if cell == "go2_mppi_b8" else 0.5, extra=extra)
    assert not tiny.judged(cell, readings["program"]), readings["program"]


def test_the_update_faults_fail_by_their_numbers(broken):
    """Dropping a minibatch is seen by the steps counted and by the whole
    update's change, which the first three steps' numbers do not reach."""
    torch.set_num_threads(2)
    broken["last_minibatch_dropped"]()
    _, readings, _ = tiny.run("go2_train")
    limits = harness.load_workload("go2_train")["limits"]
    p = readings["program"]
    assert p["update_steps"] == 5 and p["update_change"] > limits["update_change"], p
    assert all(p[k] <= limits[k] for k in ("loss", "grad", "change")), p


def test_resets_are_compared(broken):
    """Sound, the short episodes' resets agree with the reference; with the
    resetting envs left at their state, only the reset envs' number fails."""
    torch.set_num_threads(2)
    _, sound, _ = tiny.run("go2_train", extra=SHORT_EPISODES)
    assert tiny.judged("go2_train", sound["program"]), sound["program"]
    broken["reset_skipped"]()
    _, readings, _ = tiny.run("go2_train", extra=SHORT_EPISODES)
    limits = harness.load_workload("go2_train")["limits"]
    p = readings["program"]
    assert p["env_reset_median"] > limits["env_reset_median"], p
    assert p["env_done_mismatch"] <= limits["env_done_mismatch"], p


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["go2_train", "go2_parkour_train", "go2_mppi_b8"])
def test_the_control_fails_on_the_card(card, cell, monkeypatch):
    """At the cell's own size, the reference in TF32 in the program's place
    fails the cell's limits, and the program passes them. (At the tiny
    size TF32 does not separate: its MPPI plan read 8.5e-5 there.)"""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    workload = harness.load_workload(cell)
    config = harness.load_json("configs", workload["config"])
    driver = harness.load_module("drivers", workload["driver"]).Driver(config, workload, 11, card)
    driver.window(14.0 if workload["driver"] == "mpc" else 0.0)   # MPPI samples its window
    driver.release()
    readings = driver.check(control=True)
    assert tiny.judged(cell, readings["program"]), readings["program"]
    assert not tiny.judged(cell, readings["control"]), readings["control"]
