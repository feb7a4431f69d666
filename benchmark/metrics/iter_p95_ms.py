"""The 95th percentile of the wall time of every iteration in the window
(statistics.quantiles, inclusive), ms."""

import statistics


def read(run):
    walls = [it.wall_s for it in run.iters]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=20, method="inclusive")[18] * 1e3
