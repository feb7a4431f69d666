"""Env-steps of the iterations completed in the window over the window's
time, which ends at an iteration's end."""


def read(run):
    return len(run.iters) * run.steps_per_iter / run.window_s
