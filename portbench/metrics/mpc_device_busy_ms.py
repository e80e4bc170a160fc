"""MPPI solve layer (`mpc/mppi.py`): the card's busy time a solve, the sum
of the durations of the device events that start within each harness
`pb.solve` span (a copy of the arithmetic of `mpc/bench.py::
solve_device_times`), averaged over the traced solves, in ms."""


def read(run):
    solves = [s for s in run.trace.per_span("pb.solve") if s] if run.trace else []
    if not solves:
        return None
    return sum(sum(e - b for _, b, e in s) for s in solves) / len(solves) / 1e6
