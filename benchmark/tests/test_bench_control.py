"""The low-precision control on the card: the reference computed with TF32
in the program's place fails the cell's limits, and the program's own
set-up passes them, at a size that a test run holds (256 envs).  The
control at the cells' own sizes is read by ``benchmark/readings.py``."""

import gc

import pytest
import torch

from benchmark import check, harness

CELLS = ("nv3-train-2048", "nv3-train-8192")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [11, 3_000_000_021, 4_100_000_007])
def test_the_control_fails_and_the_program_passes(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _, workload, config = harness.cell(name)
    workload = dict(workload, num_envs=256)
    su = harness.set_up(name, config, workload, seed, "cuda",
                        lambda line: None)
    su.recorder.release()
    su.learn.release()
    su = su._replace(env=None, ppo=None, step=None)
    gc.collect()
    limits = workload["limits"]
    ref = harness.reference(su, config, 256, seed, "cuda")
    program = harness.compare(su, config, 256, ref)
    control = harness.compare(su, config, 256, ref, harness.reference(
        su, config, 256, seed, "cuda", control=True))
    assert check.judge(program, limits), program
    assert not check.judge(control, limits), control
