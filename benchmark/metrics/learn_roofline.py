"""The least time of an iteration's learning half (``counts/ppo.py::
learn_iteration``: GAE, the minibatch gradients and Adam steps) over the
measured update time per iteration, %."""

from benchmark.counts import ppo as C


def read(run):
    per_iter = sum(it.update_s for it in run.iters) / len(run.iters)
    return C.least_s(*C.learn_iteration(run.sizes)) / per_iter * 100
