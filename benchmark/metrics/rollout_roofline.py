"""The least time of a rollout step's work (``counts/ppo.py::
rollout_step``) over the measured rollout time per step, %."""

from benchmark.counts import ppo as C


def read(run):
    per_step = sum(it.rollout_s for it in run.iters) / (
        len(run.iters) * run.sizes["steps"])
    return C.least_s(*C.rollout_step(run.sizes)) / per_step * 100
