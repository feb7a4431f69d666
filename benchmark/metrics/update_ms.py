"""The learning half's seconds per iteration (``learn_step``'s
synchronized ``update_s``: the captured parts' replays), mean over the
window's iterations, ms."""


def read(run):
    return sum(it.update_s for it in run.iters) / len(run.iters) * 1e3
