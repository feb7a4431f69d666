"""Cholesky factor, solve and inverse of small batched SPD matrices (the
part of ``nightmare_rl_tpu/ops/linalg.py`` and ``jax.scipy.linalg.cho_solve``
that the dense mass-matrix branch and the Newton Hessian need, (N, n, n)).

``torch.linalg.cholesky`` checks its ``info`` with a device-to-host copy on
every call, so ``chol`` uses ``cholesky_ex``, which does not.  Where a matrix
is not SPD, ``cholesky_ex`` returns a finite partial factor; the JAX
package's unrolled factor takes the square root of a negative pivot and gives
NaN, which the step's validity reset then catches.  ``chol`` therefore sets
the factor of every such matrix to NaN.
"""

from __future__ import annotations

import torch


def chol(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor L of SPD ``M`` (..., n, n); NaN for every
    matrix whose factorization meets a pivot that is not positive."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info > 0)[..., None, None], torch.nan, L)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = (L Lᵀ)⁻¹ b for one right-hand side per matrix, b (..., n): two
    batched triangular solves, as ``jax.scipy.linalg.cho_solve`` forms it.
    (``torch.cholesky_solve`` goes to MAGMA for a batch on the card, which
    allocates device memory on every call and so cannot be captured in a
    CUDA graph.)"""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                         upper=True)[..., 0]


def spd_inv_from_chol(L: torch.Tensor) -> torch.Tensor:
    """M⁻¹ = L⁻ᵀ L⁻¹ from the lower Cholesky factor L (..., n, n) of M, as
    the JAX package forms it: one batched triangular solve against the
    identity (no error check, so no host sync) and one matmul."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    Li = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return Li.transpose(-1, -2) @ Li
