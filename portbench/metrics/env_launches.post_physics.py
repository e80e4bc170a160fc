"""Env step, `lgc.env.post_physics` phase (`envs/base_env.py::step`):
derived quantities, feet, commands, heights and scandots, push, progress and
termination. The device events issued inside the program's
`lgc.env.post_physics` spans, over the number of `lgc.env.step` spans
(`portbench/spans.py`)."""
from portbench import spans


def read(run):
    return spans.launches(run.trace, "lgc.env.post_physics", per="lgc.env.step")
