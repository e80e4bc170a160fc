"""Device, MPPI cells: the share of the traced window (whole solves) in
which no operation ran on the card."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
