"""PPO update (`rl/ppo.py::ppo_update`): the host's runtime calls that wait
on the device (`portbench/spans.py::SYNCS`) started inside the program's
`lgc.update.ppo` spans, over their number."""
from portbench import spans


def read(run):
    return spans.syncs(run.trace, "lgc.update.ppo")
