"""PPO update (`rl/ppo.py::ppo_update`): the device events issued inside
the program's `lgc.update.ppo` spans, over their number; the DAgger
updates (`lgc.update.dagger`) are left out."""
from portbench import spans


def read(run):
    return spans.launches(run.trace, "lgc.update.ppo", per="lgc.update.ppo")
