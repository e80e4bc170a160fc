"""MPPI solve layer (`mpc/mppi.py`): the device events (kernels, copies,
sets) a solve, counted within each harness `pb.solve` span and averaged
over the traced solves."""


def read(run):
    solves = [s for s in run.trace.per_span("pb.solve") if s] if run.trace else []
    if not solves:
        return None
    return sum(len(s) for s in solves) / len(solves)
