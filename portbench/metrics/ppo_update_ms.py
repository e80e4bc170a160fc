"""PPO / DAgger update layer (`rl/ppo.py`): the runner's `learn_time`
summed over the window's iterations, over their count, in ms."""


def read(run):
    its = (run.window or {}).get("iterations")
    if not its:
        return None
    return 1e3 * sum(i[2] for i in its) / len(its)
