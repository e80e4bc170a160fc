"""The plain reference agrees with the port at a tiny size on the CPU, and
a lower-precision answer fails the comparison."""
import pytest
import torch

from portbench.reference import train_ref
from portbench.tests import tiny


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype) if x.is_floating_point() else x


@pytest.fixture(scope="module")
def train_cell():
    torch.set_num_threads(2)
    return tiny.run("go2_train")


@pytest.fixture(scope="module")
def mpc_cell():
    torch.set_num_threads(2)
    return tiny.run("go2_mppi_b8", seconds=2.5)


def test_training_reference_agrees_with_the_port(train_cell):
    win, readings, driver = train_cell
    assert win["attempted"] >= 1 and win["failed"] == 0
    assert len(driver.record.env_steps) == 3 and [u["kind"] for u in driver.record.updates] == \
        ["dagger", "ppo"]
    assert [u["prog"].steps for u in driver.record.updates] == [20, 20]
    assert tiny.judged("go2_train", readings["program"]), readings["program"]


def test_training_check_fails_a_bfloat16_answer(train_cell):
    """The program's recorded answers rounded to bfloat16 (below the cell's
    float32): the env step's outputs and the update's losses, gradients and
    changes."""
    _, readings, driver = train_cell
    env = train_ref.make_env(driver.task, driver.overrides, driver.seeds.terrain, "cpu")
    rec = driver.record.env_steps[0]
    s, o, r, d = rec["out"]
    low = dict(rec, out=({**s, "physics": {k: _bf16(v) for k, v in s["physics"].items()}},
                         {k: _bf16(v) for k, v in o.items()}, _bf16(r), d))
    env_nums = train_ref.env_numbers([train_ref.env_step_gaps(env, low)])
    u = driver.record.updates[1]
    p = u["prog"]
    ref, _ = train_ref.run_update(u, driver.task, driver.overrides, "cpu")
    upd = train_ref.update_numbers(p._replace(
        losses=[float(torch.tensor(x).to(torch.bfloat16)) for x in p.losses],
        first={k: _bf16(v) for k, v in p.first.items()},
        change={k: _bf16(v) for k, v in p.change.items()},
        whole={k: _bf16(v) for k, v in p.whole.items()}), ref)
    assert not tiny.judged("go2_train", dict(readings["program"], **env_nums))
    assert not tiny.judged("go2_train", dict(readings["program"], **upd))


def test_mpc_reference_agrees_and_fails_a_bfloat16_plan(mpc_cell):
    win, readings, driver = mpc_cell
    assert win["attempted"] >= 2 and len(driver.recs) >= 1, win
    assert tiny.judged("go2_mppi_b8", readings["program"]), readings["program"]
    from portbench.reference import mpc_ref

    env = train_ref.make_env(driver.task, driver.overrides, driver.seeds.terrain, "cpu")
    recs = [dict(r, **driver.state_snapshot) for r in driver.recs]
    low = mpc_ref.numbers(env, driver.mppi_cfg, recs, prog_override=lambda m, r: (
        _bf16(r["out"]["nominal"]), _bf16(r["out"]["cost"])))
    assert not tiny.judged("go2_mppi_b8", low), low
