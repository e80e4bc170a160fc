"""Env step, `lgc.env.obs` phase (`envs/base_env.py::step`): the
observations (`_compute_observations`) and their clamps. The device events
issued inside the program's `lgc.env.obs` spans, over the number of
`lgc.env.step` spans (`portbench/spans.py`)."""
from portbench import spans


def read(run):
    return spans.launches(run.trace, "lgc.env.obs", per="lgc.env.step")
