"""Env step, `lgc.env.physics` phase (`envs/base_env.py::step`): the action
clamp, the (C, B) layout copies and the physics call (`_vstep`). The device
events issued inside the program's `lgc.env.physics` spans, over the number
of `lgc.env.step` spans (`portbench/spans.py`)."""
from portbench import spans


def read(run):
    return spans.launches(run.trace, "lgc.env.physics", per="lgc.env.step")
