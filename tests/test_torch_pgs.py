"""The port's PGS solve (nightmare_rl_tpu_torch/ops/pgs.py) against the JAX
package's: the plain version against ``_scan_core`` under vmap and against
the Pallas kernel ``pgs_solve`` in interpret mode, at the hexapod's solver
shapes (nefc=112, nv=24), with and without dof rows before the contact
block.  Float64 on the CPU; the two sides differ only in summation order,
so the tolerance is 1e-12 relative to max|f|."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nightmare_rl_tpu.ops import pgs as jpgs
from nightmare_rl_tpu_torch.ops import pgs as tpgs

TOL = 1e-12
ITERS, NOSLIP = 3, 4


def _random_problem(seed, N, nefc, nv, ns_offset):
    """Random constraint systems in the solver's (J, U = J M⁻¹) form with
    box rows before ns_offset and inactive facet pairs (numpy, float64)."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(N, nefc, nv))
    G = rng.normal(size=(N, nv, nv))
    U = J @ (G @ G.transpose(0, 2, 1) + np.eye(nv) * 0.1)
    b = rng.normal(size=(N, nefc)) * 5
    R = np.abs(rng.normal(size=(N, nefc))) + 0.01
    lo = np.zeros((N, nefc))
    hi = np.full((N, nefc), np.inf)
    lo[:, :ns_offset] = -2.0
    hi[:, :ns_offset] = 2.0
    inact = np.repeat(rng.random((N, (nefc - ns_offset) // 2)) < 0.3, 2, axis=1)
    hi[:, ns_offset:ns_offset + inact.shape[1]] = np.where(
        inact, 0.0, hi[:, ns_offset:ns_offset + inact.shape[1]])
    return J, U, b, R, lo, hi


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in args]


def _close(out, ref):
    ref = np.asarray(ref)
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert err <= TOL, err


CASES = [pytest.param(0, id="contacts_only"), pytest.param(4, id="dof_rows")]


@pytest.mark.parametrize("ns_offset", CASES)
def test_reference_matches_scan_core(ns_offset):
    args = _random_problem(1 + ns_offset, 4, 112, 24, ns_offset)
    ref = jax.vmap(lambda j, u, b, r, l, h: jpgs._scan_core(
        j, u, b, r, l, h, ITERS, NOSLIP, ns_offset))(*map(jnp.asarray, args))
    out = tpgs.pgs_reference(*_torch(args), ITERS, NOSLIP, ns_offset)
    _close(out, ref)


@pytest.mark.parametrize("ns_offset", CASES)
def test_reference_matches_pallas_kernel_interpret(ns_offset):
    args = _random_problem(7 + ns_offset, 4, 112, 24, ns_offset)
    ref = jpgs.pgs_solve(*map(jnp.asarray, args), iterations=ITERS,
                         noslip=NOSLIP, ns_offset=ns_offset, block_envs=4,
                         interpret=True)
    out = tpgs.pgs_reference(*_torch(args), ITERS, NOSLIP, ns_offset)
    _close(out, ref)
    if ns_offset:
        # friction rows respect their box bounds
        assert float(out[:, :ns_offset].abs().max()) <= 2.0 + 1e-12


def test_odd_contact_block_leaves_last_row_out_of_noslip():
    """nefc - ns_offset odd: the pair count is a floor division, as in JAX."""
    args = _random_problem(3, 3, 21, 10, 2)
    ref = jax.vmap(lambda j, u, b, r, l, h: jpgs._scan_core(
        j, u, b, r, l, h, ITERS, NOSLIP, 2))(*map(jnp.asarray, args))
    _close(tpgs.pgs_reference(*_torch(args), ITERS, NOSLIP, 2), ref)


def test_wrapper_takes_plain_version_on_cpu():
    args = _torch(_random_problem(2, 3, 16, 12, 0))
    before = tpgs.pgs.launches
    out = tpgs.pgs(*args, ITERS, NOSLIP, 0)
    assert torch.equal(out, tpgs.pgs_reference(*args, ITERS, NOSLIP, 0))
    assert tpgs.pgs.launches == before  # the kernel was not launched


@pytest.mark.parametrize("bad", ["shape", "dtype", "contiguity", "ns_offset"])
def test_wrapper_rejects_bad_operands(bad):
    J, U, b, R, lo, hi = _torch(_random_problem(4, 2, 8, 6, 0))
    ns = 0
    if bad == "shape":
        b = b[:, :-1]
    elif bad == "dtype":
        R = R.float()
    elif bad == "contiguity":
        J = J.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        ns = 9
    with pytest.raises(ValueError):
        tpgs.pgs(J, U, b, R, lo, hi, ITERS, NOSLIP, ns)


GEOMETRY_CASES = [
    pytest.param(112, 24, 4, 0, 4, id="main_path_float32"),
    pytest.param(112, 24, 4, 0, 8, id="main_path_float64"),
    pytest.param(21, 11, 4, 2, 4, id="odd_panel_float32"),
    pytest.param(21, 11, 4, 2, 8, id="odd_panel_float64"),
    pytest.param(40, 45, 4, 2, 8, id="nv_above_32"),
    pytest.param(112, 100, 0, 0, 8, id="one_env_per_block"),
]


@pytest.mark.parametrize("nefc,nv,noslip,ns_offset,itemsize", GEOMETRY_CASES)
def test_launch_geometry_fits_the_kernel(nefc, nv, noslip, ns_offset, itemsize):
    """The layout the wrapper hands the kernel: 16-byte panels, room for the
    row and pair records and f, groups of a warp on different banks, one
    block within the H100's shared memory."""
    g = tpgs.launch_geometry(nefc, nv, noslip, ns_offset, itemsize)
    assert g.lanes == (8 if nv <= 24 else 32)
    assert g.lanes * 4 >= nv            # at most 3 (8 lanes) or 4 columns a lane
    assert 1 <= g.envs_per_block <= 32 // g.lanes
    assert g.panel >= nefc * nv and g.panel * itemsize % 16 == 0
    npairs = (nefc - ns_offset) // 2 if noslip else 0
    slack = g.lanes * (3 if g.lanes == 8 else 4) - nv   # columns past nv
    assert g.env_stride >= 2 * g.panel + 7 * nefc + 3 * npairs + slack
    assert g.env_stride * itemsize % 16 == 0
    if g.envs_per_block > 1:
        assert g.env_stride % 32 == g.lanes
    assert g.smem_bytes == g.envs_per_block * g.env_stride * itemsize
    assert g.smem_bytes <= tpgs.MAX_SMEM


def test_launch_geometry_of_the_main_path():
    """nefc=112, nv=24 in float32: 4 envs of 8 lanes per warp-sized block,
    and two such blocks fit in one SM's 228 KB."""
    g = tpgs.launch_geometry(112, 24, 4, 0, 4)
    assert (g.lanes, g.envs_per_block) == (8, 4)
    assert 2 * (g.smem_bytes + 1024) <= 228 * 1024


@pytest.mark.parametrize("nefc,nv,dtype", [(120, 128, torch.float64),
                                           (40, 129, torch.float32)])
def test_wrapper_refuses_shapes_the_kernel_does_not_take(nefc, nv, dtype):
    """Panels too large for shared memory, or nv above 128, are refused on
    every device, so the CPU and the card take the same shapes."""
    J = torch.zeros(1, nefc, nv, dtype=dtype)
    v = torch.zeros(1, nefc, dtype=dtype)
    with pytest.raises(ValueError):
        tpgs.pgs(J, J, v, v, v, v, ITERS, NOSLIP, 0)


def test_profile_pgs_refuses_to_run_without_a_card(monkeypatch):
    """The kernel's profiler measures the card or nothing: no CPU fallback."""
    from nightmare_rl_tpu_torch.tools import profile_pgs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        profile_pgs.main(["-e", "8"])
