"""Actuator network (`physics/engine.py`'s `torque_fn` calls, the ANYmal SEA
LSTM): the device time, in ms, of the events issued inside the program's
`lgc.actuator` spans within env steps (each device event matched to the
host runtime call that issued it by CUPTI's correlation id, as
`env_step_launches` matches them), over the number of `lgc.env.step` spans.
None where the program marks no such span."""
from portbench import spans


def read(run):
    t = run.trace
    if t is None:
        return None
    wins, steps = spans.windows(t, "lgc.actuator", within="lgc.env.step"), \
        spans.windows(t, "lgc.env.step")
    if not wins or not steps:
        return None
    ns = sum(e - b for (_, b, e), h in zip(t.device, t.launched)
             if h is not None and spans._find(wins, h) is not None)
    return ns / 1e6 / len(steps)
