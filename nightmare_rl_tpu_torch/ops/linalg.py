"""Cholesky factor and solve of small batched SPD matrices (the part of
``nightmare_rl_tpu/ops/linalg.py`` and ``jax.scipy.linalg.cho_solve`` that
the Newton solver needs for its Hessian, (N, nv, nv)).

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
    """x = (L Lᵀ)⁻¹ b for one right-hand side per matrix, b (..., n)."""
    return torch.cholesky_solve(b[..., None], L)[..., 0]
