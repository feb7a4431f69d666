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
- the CUDA kernel in ``csrc/pgs.cu`` (8 or 32 lanes per env, J and U staged
  in shared memory), which replaces the JAX package's Pallas kernel
  ``_kernel`` / ``pgs_solve``.

``pgs`` dispatches on the device of its tensors: CPU tensors go to the
plain version, CUDA tensors to the kernel.  Its ``launches`` attribute
counts kernel launches.  ``launch_geometry`` decides how the kernel lays
envs out on the card; a shape whose panels do not fit in one SM's shared
memory is refused on every device.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
# dynamic shared memory one block may take on an H100 (227 KB opt-in limit,
# less the kernel's static mbarrier)
MAX_SMEM = 227 * 1024 - 16
_ROW_REC, _PAIR_REC = 6, 3   # per-row and per-pair records in csrc/pgs.cu


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How the kernel lays one shape out: ``lanes`` of a warp per env, one
    warp per block holding ``envs_per_block`` envs, each env taking
    ``env_stride`` elements of shared memory (J and U panels of ``panel``
    elements each, the row and pair records, f, and slack for the columns
    that a lane reads past nv)."""

    lanes: int
    envs_per_block: int
    panel: int
    env_stride: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def launch_geometry(nefc: int, nv: int, noslip: int, ns_offset: int,
                    itemsize: int) -> Geometry:
    """The kernel's launch geometry for one shape; raises ValueError where
    one env's panels do not fit in a block's shared memory."""
    lanes = 8 if nv <= 24 else 32
    cols = 3 if lanes == 8 else 4       # columns a lane owns at most
    per16 = 16 // itemsize              # panels start on 16-byte boundaries
    panel = -(-nefc * nv // per16) * per16
    npairs = (nefc - ns_offset) // 2 if noslip > 0 else 0
    raw = (2 * panel + (_ROW_REC + 1) * nefc + _PAIR_REC * npairs
           + lanes * cols - nv)
    # the envs of one warp start `lanes` words apart modulo the 32 banks
    env_stride = -(-raw // 32) * 32 + lanes % 32
    envs = min(32 // lanes, MAX_SMEM // (env_stride * itemsize))
    if envs < 1:
        raise ValueError(
            f"the pgs kernel stages J and U in shared memory: nefc={nefc}, "
            f"nv={nv} needs {env_stride * itemsize} bytes per env, more than "
            f"{MAX_SMEM}")
    return Geometry(lanes, envs, panel, env_stride, envs * env_stride * itemsize)


@functools.lru_cache(maxsize=None)
def _kernel_fn(dtype: torch.dtype):
    fn = getattr(build.load("pgs"), _CTYPES[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def envs_per_sm(geometry: Geometry, nv: int, dtype: torch.dtype) -> int:
    """Envs that one SM of the current card holds at once with this
    geometry (CUDA occupancy query; needs the card)."""
    fn = build.load("pgs").pgs_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(geometry.lanes, nv, torch.finfo(dtype).bits // 8,
             geometry.smem_bytes, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"pgs occupancy query failed: cudaError_t {err}")
    return blocks.value * geometry.envs_per_block


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
    N, nefc, nv = J.shape
    geo = launch_geometry(nefc, nv, noslip, ns_offset, J.element_size())
    if J.device.type == "cpu":
        return pgs_reference(J, U, b, R, lo, hi, iterations, noslip, ns_offset)
    if J.device.type != "cuda":
        raise ValueError(f"pgs runs on cpu or cuda, not {J.device}")
    f = torch.empty_like(b)
    if N == 0:
        return f
    fn = _kernel_fn(J.dtype)
    stream = torch.cuda.current_stream(J.device).cuda_stream
    with torch.cuda.device(J.device):
        err = fn(J.data_ptr(), U.data_ptr(), b.data_ptr(), R.data_ptr(),
                 lo.data_ptr(), hi.data_ptr(), f.data_ptr(), N, nefc, nv,
                 iterations, noslip, ns_offset, geo.lanes,
                 geo.envs_per_block, geo.panel, geo.env_stride,
                 geo.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"pgs kernel launch failed: cudaError_t {err}")
    pgs.launches += 1
    return f


pgs.launches = 0
