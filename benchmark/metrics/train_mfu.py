"""The counted float32 operations of the window's iterations (each rollout
step's and the learning half's, ``counts/ppo.py``) over the window times
the H100's float32 peak outside the tensor cores (the port computes in full
float32), %."""

from benchmark.counts import ppo as C


def read(run):
    ops = (run.sizes["steps"] * C.rollout_step(run.sizes)[0]
           + C.learn_iteration(run.sizes)[0])
    return len(run.iters) * ops / (run.window_s * C.H100_F32_FLOPS) * 100
