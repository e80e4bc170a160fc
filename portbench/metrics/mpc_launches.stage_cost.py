"""MPPI solve, stage costs (`mpc/mppi.py::stage_cost`): the device events
issued inside the program's `lgc.mppi.stage_cost` spans, over the number of
`lgc.mppi.solve` spans."""
from portbench import spans


def read(run):
    return spans.launches(run.trace, "lgc.mppi.stage_cost", per="lgc.mppi.solve",
                          within="lgc.mppi.solve")
