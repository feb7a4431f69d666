"""Block-arrow mass-matrix factorization for legged kinematic trees (port of
``nightmare_rl_tpu/physics/arrow.py``, with the three small-matrix routines
of ``nightmare_rl_tpu/ops/linalg.py`` that it needs).

Free-floating base + B independent serial legs make M block-arrow sparse:

    M = [[ B6   C^T ]      B6: 6x6 base block
         [ C    D   ]]     D:  block-diag of per-leg s x s chains
                           C:  (B, s, 6) leg<->base coupling

Factor:  Ld = chol(D_b) per leg, W_b = Ld_b^{-1} C_b, Ls = chol(S) with the
Schur complement S = B6 - sum_b W_b^T W_b.  Every routine works on the
trailing matrix axes and broadcasts over leading ones (envs, legs).  The
unrolled triangular loops keep the JAX package's arithmetic order, so the
two agree to float64 round-off.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from nightmare_rl_tpu_torch.physics import system as S


class ArrowLayout(NamedTuple):
    nv: int
    nbase: int        # base dof count (6: free joint)
    nbranch: int      # B
    branch_size: int  # s; branch b owns dofs [nbase + b*s, nbase + (b+1)*s)


def layout(sys: S.System) -> Optional[ArrowLayout]:
    """Detect the free-root + equal independent branches structure from the
    System's static topology; None when the model has none."""
    roots = [b for b in range(1, sys.nbody) if sys.body_parent[b] == 0]
    if len(roots) != 1:
        return None
    rb = roots[0]
    if sys.body_jntnum[rb] != 1:
        return None
    j0 = sys.body_jntadr[rb]
    if sys.jnt_type[j0] != S.FREE or sys.jnt_dofadr[j0] != 0:
        return None

    children = [[] for _ in range(sys.nbody)]
    for b in range(1, sys.nbody):
        children[sys.body_parent[b]].append(b)

    branches = []
    for c in children[rb]:
        dofs = []
        stack = [c]
        while stack:
            b = stack.pop()
            for k in range(sys.body_jntnum[b]):
                j = sys.body_jntadr[b] + k
                if sys.jnt_type[j] not in (S.HINGE, S.SLIDE):
                    return None
                dofs.append(sys.jnt_dofadr[j])
            stack.extend(children[b])
        if dofs:
            dofs.sort()
            if dofs != list(range(dofs[0], dofs[0] + len(dofs))):
                return None
            branches.append(dofs)
    if not branches:
        return None
    branches.sort(key=lambda d: d[0])
    s = len(branches[0])
    if any(len(d) != s for d in branches):
        return None
    flat = [d for br in branches for d in br]
    if flat != list(range(6, sys.nv)):
        return None
    return ArrowLayout(sys.nv, 6, len(branches), s)


class ArrowFac(NamedTuple):
    Ld: torch.Tensor  # (N, B, s, s) chol of per-branch diagonal blocks
    W: torch.Tensor   # (N, B, s, 6) = Ld^{-1} C
    Ls: torch.Tensor  # (N, 6, 6) chol of the base Schur complement
    C: torch.Tensor   # (N, B, s, 6) leg-base coupling rows of M


def _chol(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor by unrolled outer-product elimination."""
    n = M.shape[-1]
    idx = torch.arange(n, device=M.device)
    A = M
    cols = []
    for j in range(n):
        d = torch.sqrt(A[..., j, j])
        c = A[..., :, j] / d[..., None]
        c = c * (idx >= j)              # zero the strictly-upper part
        cols.append(c)
        # rank-1 downdate; rows/cols < j are stale but never read again
        A = A - c[..., :, None] * c[..., None, :]
    return torch.stack(cols, dim=-1)


def _tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Inverse of a lower-triangular matrix by forward substitution."""
    n = L.shape[-1]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    rows = []
    for i in range(n):
        acc = eye[i].expand(L.shape[:-2] + (n,))
        for k in range(i):
            acc = acc - L[..., i, k, None] * rows[k]
        rows.append(acc / L[..., i, i, None])
    return torch.stack(rows, dim=-2)


def _spd_inv_from_chol(L: torch.Tensor) -> torch.Tensor:
    """M⁻¹ = L⁻ᵀ L⁻¹ from the Cholesky factor."""
    Li = _tri_inv(L)
    return torch.einsum("...ki,...kj->...ij", Li, Li)


def _solve_tril(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X = L^{-1} B by unrolled forward substitution.
    L (..., n, n) lower-triangular, B (..., n, k)."""
    n = L.shape[-1]
    rows = []
    for i in range(n):
        acc = B[..., i, :]
        for k in range(i):
            acc = acc - L[..., i, k, None] * rows[k]
        rows.append(acc / L[..., i, i, None])
    return torch.stack(rows, dim=-2)


def _solve_triu(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X = L^{-T} B by unrolled back substitution."""
    n = L.shape[-1]
    rows: list = [None] * n
    for i in reversed(range(n)):
        acc = B[..., i, :]
        for k in range(i + 1, n):
            acc = acc - L[..., k, i, None] * rows[k]
        rows[i] = acc / L[..., i, i, None]
    return torch.stack(rows, dim=-2)


def factor(lay: ArrowLayout, M: torch.Tensor) -> ArrowFac:
    """Block-arrow factor of a batch of mass matrices M (N, nv, nv)."""
    nb, B, s = lay.nbase, lay.nbranch, lay.branch_size
    N = M.shape[0]
    D = torch.stack([M[:, nb + b * s:nb + (b + 1) * s, nb + b * s:nb + (b + 1) * s]
                     for b in range(B)], dim=1)
    C = M[:, nb:, :nb].reshape(N, B, s, nb)
    Ld = _chol(D)
    W = _solve_tril(Ld, C)
    Ssc = M[:, :nb, :nb] - torch.einsum("nbsi,nbsj->nij", W, W)
    Ls = _chol(Ssc)
    return ArrowFac(Ld, W, Ls, C)


def solve_vec(lay: ArrowLayout, fac: ArrowFac, b: torch.Tensor) -> torch.Tensor:
    """x = M^{-1} b for one right-hand side per env, b (N, nv)."""
    nb, B, s = lay.nbase, lay.nbranch, lay.branch_size
    N = b.shape[0]
    b0 = b[:, :nb]
    bl = b[:, nb:].reshape(N, B, s)
    y = _solve_triu(fac.Ld, _solve_tril(fac.Ld, bl[..., None]))[..., 0]
    r0 = b0 - torch.einsum("nbsk,nbs->nk", fac.C, y)
    x0 = _solve_triu(fac.Ls, _solve_tril(fac.Ls, r0[..., None]))[..., 0]
    xl = y - _solve_triu(fac.Ld, fac.W @ x0[:, None, :, None])[..., 0]
    return torch.cat([x0, xl.reshape(N, B * s)], dim=-1)


def solve_lt(lay: ArrowLayout, fac: ArrowFac, u: torch.Tensor) -> torch.Tensor:
    """x = L⁻ᵀ u for the no-fill factor L = [[blkdiag(Ld_b), 0], [W_bᵀ…, Ls]]
    of M, u (N, nv) in the factor's order [legs | base]; x in dof order
    [base | legs].  With u = Gᵀf, the leg-sparse PGS's slot state
    (``ops/pgs.py``), x = M⁻¹ Jᵀ f: half of ``solve_vec``'s work."""
    nb, B, s = lay.nbase, lay.nbranch, lay.branch_size
    N = u.shape[0]
    xb = _solve_triu(fac.Ls, u[:, B * s:, None])                # (N, nb, 1)
    xl = _solve_triu(fac.Ld, u[:, :B * s].reshape(N, B, s, 1)
                     - fac.W @ xb[:, None])
    return torch.cat([xb[..., 0], xl.reshape(N, B * s)], dim=-1)


def inv(lay: ArrowLayout, fac: ArrowFac) -> torch.Tensor:
    """Explicit M^{-1} (N, nv, nv) assembled from the factor blocks:

        Minv = [[ Sinv        -(E Sinv)^T ]
                [ -E Sinv   Dinv + E Sinv E^T ]],   E = D^{-1} C.
    """
    nb, B, s = lay.nbase, lay.nbranch, lay.branch_size
    N = fac.Ls.shape[0]
    Sinv = _spd_inv_from_chol(fac.Ls)                       # (N,6,6)
    E = _solve_triu(fac.Ld, fac.W)                          # (N,B,s,6)
    G = E @ Sinv[:, None]                                   # (N,B,s,6)
    Dinv = _spd_inv_from_chol(fac.Ld)                       # (N,B,s,s)
    cross = torch.einsum("nbsk,nctk->nbsct", G, E)          # (N,B,s,B,s)
    for b in range(B):
        cross[:, b, :, b, :] += Dinv[:, b]
    bl = -G.reshape(N, B * s, nb)                           # legs-base
    top = torch.cat([Sinv, bl.transpose(-1, -2)], dim=-1)
    bot = torch.cat([bl, cross.reshape(N, B * s, B * s)], dim=-1)
    return torch.cat([top, bot], dim=-2)
