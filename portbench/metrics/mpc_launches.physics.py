"""MPPI solve, physics (`physics/engine.py::control_step`, the fused kernel
and the eager link states): the device events issued inside the program's
`lgc.physics` spans that lie inside its `lgc.mppi.solve` spans, over the
number of solves."""
from portbench import spans


def read(run):
    return spans.launches(run.trace, "lgc.physics", per="lgc.mppi.solve",
                          within="lgc.mppi.solve")
