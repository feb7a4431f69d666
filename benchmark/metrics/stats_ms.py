"""The iteration's boundary: the benchmark's clock around ``learn_step``
less its ``rollout_s`` and ``update_s`` (the statistics' reductions and
their readback), mean over the window's iterations, ms."""


def read(run):
    return sum(it.wall_s - it.rollout_s - it.update_s
               for it in run.iters) / len(run.iters) * 1e3
