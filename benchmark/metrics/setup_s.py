"""Process start to the window's start: building or loading the kernels,
the weights and env state from the seed, the captures, the warm-up
iterations."""


def read(run):
    return run.setup_s
