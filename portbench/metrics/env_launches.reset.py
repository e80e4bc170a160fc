"""Env step, `lgc.env.reset` phase (`envs/base_env.py::step`): the
curricula, the reset draws and the masked writes of the envs that reset. The
device events issued inside the program's `lgc.env.reset` spans, over the
number of `lgc.env.step` spans (`portbench/spans.py`)."""
from portbench import spans


def read(run):
    return spans.launches(run.trace, "lgc.env.reset", per="lgc.env.step")
