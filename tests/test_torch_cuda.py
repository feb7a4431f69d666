"""Tests of the port that need an NVIDIA card: the PGS CUDA kernel against
its plain PyTorch version in the cases that ``chip_smoke.py`` does not run
(float32 random systems, nv above one warp).  They skip where
torch.cuda.is_available() is false.  The file imports no JAX, so it also
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from nightmare_rl_tpu_torch.ops import pgs as P


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _random_system(N, nefc, nv, ns_offset, seed):
    g = torch.Generator().manual_seed(seed)
    J = torch.randn(N, nefc, nv, generator=g, dtype=torch.float64)
    G = torch.randn(N, nv, nv, generator=g, dtype=torch.float64)
    U = J @ (G @ G.transpose(1, 2) + 0.1 * torch.eye(nv, dtype=torch.float64))
    b = torch.randn(N, nefc, generator=g, dtype=torch.float64) * 5
    R = torch.randn(N, nefc, generator=g, dtype=torch.float64).abs() + 0.01
    lo = torch.zeros(N, nefc, dtype=torch.float64)
    hi = torch.full((N, nefc), math.inf, dtype=torch.float64)
    lo[:, :ns_offset] = -2.0
    hi[:, :ns_offset] = 2.0
    return [J, U, b, R, lo, hi]


@pytest.mark.cuda
@pytest.mark.parametrize("ns_offset", [0, 4])
def test_kernel_matches_reference_float32(cuda, ns_offset):
    """Main-path solver shapes in float32: kernel and plain version differ by
    560 dependent row steps of float32 rounding (tolerance 1e-3 of
    max|f|)."""
    args = [x.to(cuda, torch.float32)
            for x in _random_system(256, 112, 24, ns_offset, 5)]
    before = P.pgs.launches
    out = P.pgs(*args, 3, 4, ns_offset)
    assert P.pgs.launches == before + 1
    ref = P.pgs_reference(*args, 3, 4, ns_offset)
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err <= 1e-3, err


@pytest.mark.cuda
def test_kernel_takes_nv_above_one_warp(cuda):
    """nv > 32: lanes own strided columns."""
    args = [x.to(cuda) for x in _random_system(64, 40, 45, 2, 6)]
    out = P.pgs(*args, 3, 4, 2)
    ref = P.pgs_reference(*args, 3, 4, 2)
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-10
