# A frozen copy of the port's ops/pgs.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
"""Plain versions of the port's ``ops/pgs.py``."""

from __future__ import annotations
import torch
from benchmark.reference.plain.physics import arrow


def pgs_reference(J, U, b, R, lo, hi, iterations: int, noslip: int,
                  ns_offset: int) -> torch.Tensor:
    """J, U: (N, nefc, nv); b, R, lo, hi: (N, nefc) → f (N, nefc)."""
    N, nefc, nv = J.shape
    diag = torch.sum(J * U, dim=-1)
    inv_d = 1.0 / torch.clamp_min(diag + R, 1e-12)
    # f as per-row columns, so a row's old value is never overwritten in place
    f = [b.new_zeros(N) for _ in range(nefc)]
    w = b.new_zeros(N, nv)
    for _ in range(iterations):
        for r in range(nefc):
            g = torch.sum(J[:, r] * w, dim=-1) + b[:, r] + R[:, r] * f[r]
            new = torch.clamp(f[r] - g * inv_d[:, r], lo[:, r], hi[:, r])
            w = w + U[:, r] * (new - f[r])[:, None]
            f[r] = new

    npairs = (nefc - ns_offset) // 2
    if noslip > 0 and npairs > 0:
        idx = ns_offset + 2 * torch.arange(npairs, device=J.device)
        Aij = torch.sum(J[:, idx] * U[:, idx + 1], dim=-1)
        for _ in range(noslip):
            for p in range(npairs):
                i, j = ns_offset + 2 * p, ns_offset + 2 * p + 1
                s = f[i] + f[j]
                g = torch.sum((J[:, i] - J[:, j]) * w, dim=-1) + b[:, i] - b[:, j]
                h = diag[:, i] + diag[:, j] - 2.0 * Aij[:, p]
                y = 0.5 * (f[i] - f[j]) - g / torch.clamp_min(h, 1e-12)
                y = torch.clamp(y, -0.5 * s, 0.5 * s)
                ok = hi[:, i] > 0
                fi = torch.where(ok, 0.5 * s + y, f[i])
                fj = torch.where(ok, 0.5 * s - y, f[j])
                w = (w + U[:, i] * (fi - f[i])[:, None]
                     + U[:, j] * (fj - f[j])[:, None])
                f[i], f[j] = fi, fj
    return torch.stack(f, dim=1)


def _slot_columns(leg1: torch.Tensor, leg2: torch.Tensor, nbranch: int,
                  s: int, nbase: int) -> torch.Tensor:
    """(N, nefc, 2s+nbase) column of the flat slot state
    u = [ul (nbranch·s) | ub (nbase)] that each panel value of a row
    multiplies: leg1's slot, leg2's slot, the base."""
    dev = leg1.device
    ar = torch.arange(s, device=dev)
    base = nbranch * s + torch.arange(nbase, device=dev)
    return torch.cat([s * leg1.long()[..., None] + ar,
                      s * leg2.long()[..., None] + ar,
                      base.expand(leg1.shape + (nbase,))], dim=-1)


def pgs_legs_reference(Gp, leg1, leg2, b, R, lo, hi, nbranch: int, s: int,
                       nbase: int, iterations: int, noslip: int,
                       ns_offset: int):
    """The leg-sparse PGS, a batched transcription of the JAX package's
    ``_scan_core_legs``.  Gp: (N, nefc, 2s+nbase) row panels of G in
    [leg1 | leg2 | base] slot layout (``physics/solver.py::leg_panels``);
    leg1, leg2: (N, nefc) branch ids, per env (top-K contact selection makes
    them dynamic); b, R, lo, hi: (N, nefc) → (f (N, nefc), u): u is the
    final slot state (N, nbranch·s + nbase), Gᵀf as the sweeps accumulated
    it.

    The slots live in one flat state u = [ul | ub]: a row gathers its 2s+nb
    values, and scatter-adds its change back.  A row whose two slots name
    the same leg (a plane contact, whose slot-2 panel is zero) accumulates
    both, as ``.at[l1].add`` then ``.at[l2].add`` do; a noslip pair takes
    row i's slot ids for both of its rows.  Each row's dot product is one
    sum over its 2s+nb products, where the JAX core adds three dots: the two
    agree to float64 round-off."""
    N, nefc = b.shape
    diag = torch.sum(Gp * Gp, dim=-1)
    inv_d = 1.0 / torch.clamp_min(diag + R, 1e-12)
    cols = _slot_columns(leg1, leg2, nbranch, s, nbase)
    f = [b.new_zeros(N) for _ in range(nefc)]
    u = b.new_zeros(N, nbranch * s + nbase)
    for _ in range(iterations):
        for r in range(nefc):
            g, c = Gp[:, r], cols[:, r]
            val = torch.sum(g * u.gather(1, c), dim=-1) + b[:, r] + R[:, r] * f[r]
            new = torch.clamp(f[r] - val * inv_d[:, r], lo[:, r], hi[:, r])
            u.scatter_add_(1, c, g * (new - f[r])[:, None])
            f[r] = new

    npairs = (nefc - ns_offset) // 2
    if noslip > 0 and npairs > 0:
        # ± facets of one contact share their slots: A[i, j] = G[i]·G[j] is
        # an aligned panel dot
        idx = ns_offset + 2 * torch.arange(npairs, device=b.device)
        Aij = torch.sum(Gp[:, idx] * Gp[:, idx + 1], dim=-1)
        for _ in range(noslip):
            for p in range(npairs):
                i, j = ns_offset + 2 * p, ns_offset + 2 * p + 1
                c = cols[:, i]
                g = (torch.sum((Gp[:, i] - Gp[:, j]) * u.gather(1, c), dim=-1)
                     + b[:, i] - b[:, j])
                h = diag[:, i] + diag[:, j] - 2.0 * Aij[:, p]
                tot = f[i] + f[j]
                y = 0.5 * (f[i] - f[j]) - g / torch.clamp_min(h, 1e-12)
                y = torch.clamp(y, -0.5 * tot, 0.5 * tot)
                ok = hi[:, i] > 0
                fi = torch.where(ok, 0.5 * tot + y, f[i])
                fj = torch.where(ok, 0.5 * tot - y, f[j])
                u.scatter_add_(1, c, Gp[:, i] * (fi - f[i])[:, None]
                               + Gp[:, j] * (fj - f[j])[:, None])
                f[i], f[j] = fi, fj
    return torch.stack(f, dim=1), u


def dtype_key(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def choose_mode(legs_available: bool, nefc: int, nv: int, iterations: int,
                noslip: int, ns_offset: int, lay_shape,
                dtype_name: str = "float32", device="cpu") -> str:
    """The legs form wherever the model has a block-arrow layout (the two
    forms are the same algebra), else the dense one."""
    return "legs" if legs_available else "scan"


def pgs(J, U, b, R, lo, hi, iterations: int, noslip: int,
        ns_offset: int = 0) -> torch.Tensor:
    return pgs_reference(J, U, b, R, lo, hi, iterations, noslip, ns_offset)


def pgs_legs(lay, fac, J, lm, b, R, lo, hi, iterations: int, noslip: int,
             ns_offset: int = 0):
    from benchmark.reference.plain.physics.solver import leg_panels

    f, u = pgs_legs_reference(
        leg_panels(lay, fac, J, lm), lm.leg1, lm.leg2, b, R, lo, hi,
        lay.nbranch, lay.branch_size, lay.nbase, iterations, noslip,
        ns_offset)
    return f, arrow.solve_lt(lay, fac, u)
