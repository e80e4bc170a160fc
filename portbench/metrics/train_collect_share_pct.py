"""Runner layer (`rl/runner.py`): the share of the window's iteration time
that the collection took (rollout and GAE), from the runner's own
`collection_time`, which it takes between two synchronisations."""


def read(run):
    its = (run.window or {}).get("iterations")
    if not its:
        return None
    return 100.0 * sum(i[1] for i in its) / sum(i[0] for i in its)
