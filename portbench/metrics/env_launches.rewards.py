"""Env step, `lgc.env.rewards` phase (`envs/base_env.py::step`): the reward
terms, the termination reward and the episode sums. The device events issued
inside the program's `lgc.env.rewards` spans, over the number of
`lgc.env.step` spans (`portbench/spans.py`)."""
from portbench import spans


def read(run):
    return spans.launches(run.trace, "lgc.env.rewards", per="lgc.env.step")
