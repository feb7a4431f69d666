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
