"""Env step (`envs/base_env.py::step`): the host's runtime calls that wait
on the device (`portbench/spans.py::SYNCS`) started inside the program's
`lgc.env.step` spans, over their number."""
from portbench import spans


def read(run):
    return spans.syncs(run.trace, "lgc.env.step")
