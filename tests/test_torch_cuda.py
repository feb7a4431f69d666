"""Tests of the port that need an NVIDIA card: the PGS CUDA kernel against
its plain PyTorch version in cases beside those of ``chip_smoke.py``
(float32 random systems, float32 panels that take the plain-load path, a
NaN in b, infinite bounds, the occupancy of the main path's geometry).
Float64 cases hold the kernel to 1e-10 of max|f|, float32 random systems
to 1e-3 (a chain of 560 dependent row steps in float32 rounding on random,
often ill-conditioned systems).  They skip where torch.cuda.is_available()
is false.  The file imports no JAX, so it also runs on a machine that has
only PyTorch:

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
    """Main-path solver shapes in float32 (tolerance: module docstring)."""
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


def _rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
def test_kernel_plain_load_panels_float32(cuda):
    """nefc * nv * 4 bytes not a multiple of 16: the panels are staged by
    plain loads instead of bulk copies; N=7 leaves one group of the last
    block idle."""
    args = [x.to(cuda, torch.float32) for x in _random_system(7, 21, 11, 2, 8)]
    out = P.pgs(*args, 3, 4, 2)
    assert _rel_err(out, P.pgs_reference(*args, 3, 4, 2)) <= 1e-3


@pytest.mark.cuda
def test_kernel_passes_nan_through(cuda):
    """A NaN in b spreads through the clips of its own env, as in the plain
    version, and leaves the other envs alone."""
    args = [x.to(cuda) for x in _random_system(8, 112, 24, 4, 9)]
    args[2][3, 50] = math.nan
    out = P.pgs(*args, 3, 4, 4)
    ref = P.pgs_reference(*args, 3, 4, 4)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert bool(torch.isnan(out[3]).any())
    keep = torch.arange(8, device=cuda) != 3
    assert _rel_err(out[keep], ref[keep]) <= 1e-10


@pytest.mark.cuda
def test_kernel_takes_infinite_bounds(cuda):
    """Rows unbounded on both sides (lo = -inf, hi = inf) are never clipped."""
    args = [x.to(cuda) for x in _random_system(16, 112, 24, 4, 10)]
    args[4][:, :4] = -math.inf
    args[5][:, :4] = math.inf
    out = P.pgs(*args, 3, 4, 4)
    ref = P.pgs_reference(*args, 3, 4, 4)
    assert bool(torch.isfinite(out).all())
    assert _rel_err(out, ref) <= 1e-10


@pytest.mark.cuda
def test_main_path_geometry_is_resident(cuda):
    """The float32 main-path geometry holds at least 8 envs on an SM: two
    blocks of 4 envs, each staging its J and U panels."""
    geo = P.launch_geometry(112, 24, 4, 0, 4)
    assert P.envs_per_sm(geo, 24, torch.float32) >= 8


@pytest.mark.cuda
def test_profile_pgs_reports_the_phases(cuda):
    """tools/profile_pgs.py times the prologue, a row step and a pair step."""
    from nightmare_rl_tpu_torch.tools import profile_pgs

    res = profile_pgs.main(["-e", "300"])
    assert res["wave_envs"] == 300 and res["lanes_per_env"] == 8
    assert res["wave_prologue_us"] > 0
    assert res["row_step_ns"] > 0 and res["pair_step_ns"] > 0
