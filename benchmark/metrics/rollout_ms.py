"""The rollout's seconds per iteration (``learn_step``'s synchronized
``rollout_s``: the replays of the captured step and env 0's record copy),
mean over the window's iterations, ms."""


def read(run):
    return sum(it.rollout_s for it in run.iters) / len(run.iters) * 1e3
