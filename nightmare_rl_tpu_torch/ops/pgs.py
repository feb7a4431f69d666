"""Constraint-solver core: box-bounded projected Gauss-Seidel + noslip.

Port of ``nightmare_rl_tpu/ops/pgs.py``.  The solve is matrix-free: it
carries w = M⁻¹Jᵀf and never forms the Delassus matrix A = J M⁻¹ Jᵀ,

    A[r]·f  = J[r]·w                      (row evaluation, nv MACs)
    f[r] += Δ  ⇒  w += U[r]·Δ             (rank-1 update, U = J M⁻¹)

Two implementations of one contract (fixed ascending row order, per-row
bounds [lo, hi], noslip pair updates with frozen pair sums from ns_offset):

- ``pgs_reference``: plain PyTorch, a batched transcription of the JAX
  package's ``_scan_core`` (loops over sweeps and rows, vectorised over
  envs);
- the CUDA kernel in ``csrc/pgs.cu`` (one warp per env), which replaces the
  JAX package's Pallas kernel ``_kernel`` / ``pgs_solve``.

``pgs`` dispatches on the device of its tensors: CPU tensors go to the
plain version, CUDA tensors to the kernel.  Its ``launches`` attribute
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nightmare_rl_tpu_torch.ops import build


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


_CTYPES = {torch.float32: "pgs_f32", torch.float64: "pgs_f64"}


@functools.lru_cache(maxsize=None)
def _kernel_fn(dtype: torch.dtype):
    fn = getattr(build.load("pgs"), _CTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(J, U, b, R, lo, hi, ns_offset: int) -> None:
    if J.dim() != 3:
        raise ValueError(f"J must be (N, nefc, nv), got {tuple(J.shape)}")
    N, nefc, nv = J.shape
    if U.shape != J.shape:
        raise ValueError(f"U {tuple(U.shape)} does not match J {tuple(J.shape)}")
    for name, x in (("b", b), ("R", R), ("lo", lo), ("hi", hi)):
        if x.shape != (N, nefc):
            raise ValueError(f"{name} must be {(N, nefc)}, got {tuple(x.shape)}")
    for x in (J, U, b, R, lo, hi):
        if x.device != J.device or x.dtype != J.dtype:
            raise ValueError("pgs operands must share one device and dtype")
        if not x.is_contiguous():
            raise ValueError("pgs operands must be contiguous")
    if J.dtype not in _CTYPES:
        raise ValueError(f"pgs takes float32 or float64, got {J.dtype}")
    if not 0 <= ns_offset <= nefc:
        raise ValueError(f"ns_offset {ns_offset} outside [0, {nefc}]")
    if nv > 128:
        raise ValueError(f"the pgs kernel takes nv <= 128, got {nv}")


def pgs(J, U, b, R, lo, hi, iterations: int, noslip: int,
        ns_offset: int = 0) -> torch.Tensor:
    """Batched PGS solve: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Shapes as in ``pgs_reference``."""
    _check(J, U, b, R, lo, hi, ns_offset)
    if J.device.type == "cpu":
        return pgs_reference(J, U, b, R, lo, hi, iterations, noslip, ns_offset)
    if J.device.type != "cuda":
        raise ValueError(f"pgs runs on cpu or cuda, not {J.device}")
    N, nefc, nv = J.shape
    f = torch.empty_like(b)
    if N == 0:
        return f
    fn = _kernel_fn(J.dtype)
    stream = torch.cuda.current_stream(J.device).cuda_stream
    with torch.cuda.device(J.device):
        err = fn(J.data_ptr(), U.data_ptr(), b.data_ptr(), R.data_ptr(),
                 lo.data_ptr(), hi.data_ptr(), f.data_ptr(), N, nefc, nv,
                 iterations, noslip, ns_offset, stream)
    if err != 0:
        raise RuntimeError(f"pgs kernel launch failed: cudaError_t {err}")
    pgs.launches += 1
    return f


pgs.launches = 0
