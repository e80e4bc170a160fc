"""Actuator network (`physics/engine.py`'s `torque_fn` calls: the ANYmal SEA
LSTM of `physics/actuator.py::lstm_actuator`, once a decimation tick): the
device events issued inside the program's `lgc.actuator` spans within env
steps, over the number of `lgc.env.step` spans (`portbench/spans.py`).  A
program that marks no such span, or an env without an actuator network,
reads None."""
from portbench import spans


def read(run):
    return spans.launches(run.trace, "lgc.actuator", per="lgc.env.step", within="lgc.env.step")
