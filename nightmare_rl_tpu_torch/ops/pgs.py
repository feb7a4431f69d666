"""Constraint-solver core: box-bounded projected Gauss-Seidel + noslip.

Port of ``nightmare_rl_tpu/ops/pgs.py``.  Two forms of one solve, both
matrix-free (the Delassus matrix A = J M⁻¹ Jᵀ is never formed):

- the dense form carries w = M⁻¹Jᵀf,

      A[r]·f  = J[r]·w                      (row evaluation, nv MACs)
      f[r] += Δ  ⇒  w += U[r]·Δ             (rank-1 update, U = J M⁻¹);

- the leg-block-sparse form (models with a block-arrow mass matrix) carries
  u = Gᵀf with G = J L⁻ᵀ from the block-arrow factor L of M, so that
  A = G Gᵀ.  Every row of G touches at most two legs and the base, and u is
  kept as per-leg slots ``ul`` (B, s) and the base slot ``ub`` (nb,).  It
  needs neither U nor M⁻¹.

Each form has a plain PyTorch version and a CUDA kernel with one contract
(fixed ascending row order, per-row bounds [lo, hi], noslip pair updates
with frozen pair sums from ns_offset):

- ``pgs_reference``: a batched transcription of the JAX package's
  ``_scan_core``; its kernel ``csrc/pgs.cu`` (8 or 32 lanes per env, J and U
  staged in shared memory) replaces the JAX package's Pallas kernel
  ``_kernel`` / ``pgs_solve``;
- ``pgs_legs_reference``: a batched transcription of ``_scan_core_legs``,
  fed by ``physics/solver.py::leg_panels``; its kernel ``csrc/pgs_legs.cu``
  builds the G panels on chip from J and the factor blocks, then sweeps.

``pgs`` and ``pgs_legs`` dispatch on the device of their tensors: CPU
tensors go to the plain version, CUDA tensors to the kernel.  Their
``launches`` attributes count kernel launches.  ``launch_geometry`` and
``legs_geometry`` decide how a kernel lays envs out on the card; a shape
or layout that a kernel does not take is refused on every device.

``choose_mode`` picks the form a solve runs, as the JAX package's does:
``NIGHTMARE_PGS=legs|scan|kernel`` forces one; otherwise the CPU takes the
leg-sparse form wherever the model has the layout, and the card takes the
verdict of a timing probe, kept in memory and in a JSON file.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import os
import tempfile
import time

import numpy as np
import torch

from nightmare_rl_tpu_torch.ops import build
from nightmare_rl_tpu_torch.physics import arrow
from nightmare_rl_tpu_torch.utils.device import full_float32


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


# ---------------------------------------------------------------------------
# the leg-block-sparse form
# ---------------------------------------------------------------------------


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


LEG_LANES = 8                 # lanes per env in csrc/pgs_legs.cu
_LEG_SLOT = (3, 6)            # (branch_size, nbase) that the kernel takes
# one lane per leg and nbase / branch_size lanes for the base
_LEG_MAX_BRANCH = LEG_LANES - _LEG_SLOT[1] // _LEG_SLOT[0]
_LEG_CTYPES = {torch.float32: "pgs_legs_f32", torch.float64: "pgs_legs_f64"}


@dataclasses.dataclass(frozen=True)
class LegGeometry:
    """How the legs kernel lays one shape out: ``LEG_LANES`` lanes per env,
    one warp per block holding ``envs_per_block`` envs, each env taking
    ``env_stride`` elements of shared memory (its G panel, the row and pair
    records, f, its factor blocks, the slot ids and masks, and the lists of
    the rows and pairs it sweeps)."""

    envs_per_block: int
    env_stride: int
    smem_bytes: int


def legs_layout_ok(lay_shape) -> bool:
    """Whether the legs kernel takes a block-arrow layout (nbranch,
    branch_size, nbase): legs of 3 dofs, a 6-dof base, at most 6 legs."""
    if lay_shape is None:
        return False
    nbranch, s, nbase = lay_shape
    return (s, nbase) == _LEG_SLOT and 1 <= nbranch <= _LEG_MAX_BRANCH


@functools.lru_cache(maxsize=None)
def legs_geometry(nefc: int, nbranch: int, s: int, nbase: int, noslip: int,
                  ns_offset: int, itemsize: int) -> LegGeometry:
    """The legs kernel's launch geometry for one shape; raises ValueError for
    a layout the kernel does not take or an env that does not fit in a
    block's shared memory."""
    if not legs_layout_ok((nbranch, s, nbase)):
        raise ValueError(
            f"the legs kernel takes legs of {_LEG_SLOT[0]} dofs, a "
            f"{_LEG_SLOT[1]}-dof base and 1 to {_LEG_MAX_BRANCH} legs, not "
            f"nbranch={nbranch}, branch_size={s}, nbase={nbase} "
            f"(NIGHTMARE_PGS=scan or kernel solves in the dense form)")
    npairs = (nefc - ns_offset) // 2 if noslip > 0 else 0
    # panels with two rows of zeros, records with one, pair records with one
    # zero pair, f, the factor blocks; then the int32 slot ids, the 16-bit
    # row and pair lists and the byte slot masks
    ints = 4 * (nefc + 2) + 2 * (nefc + npairs) + nefc
    raw = ((2 * s + nbase) * (nefc + 2) + _ROW_REC * (nefc + 1)
           + _PAIR_REC * (npairs + 1) + nefc + 2
           + nbranch * s * (s + nbase) + nbase * nbase + -(-ints // itemsize))
    # the envs of one warp start one word apart modulo the 32 banks: the
    # prologue's lanes build rows 12 words apart (banks 0, 4, ..., 28), so
    # the 4 envs' rows fall on all 32 banks
    env_stride = -(-raw // 32) * 32 + 1
    envs = min(32 // LEG_LANES, MAX_SMEM // (env_stride * itemsize))
    if envs < 1:
        raise ValueError(f"the legs kernel needs {env_stride * itemsize} bytes "
                         f"of shared memory per env at nefc={nefc}, more than "
                         f"{MAX_SMEM}")
    return LegGeometry(envs, env_stride, envs * env_stride * itemsize)


@functools.lru_cache(maxsize=None)
def _legs_fn(dtype: torch.dtype):
    fn = getattr(build.load("pgs_legs"), _LEG_CTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def legs_envs_per_sm(geometry: LegGeometry, dtype: torch.dtype) -> int:
    """Envs that one SM of the current card holds at once with this
    geometry (CUDA occupancy query; needs the card)."""
    fn = build.load("pgs_legs").pgs_legs_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(torch.finfo(dtype).bits // 8, geometry.smem_bytes,
             ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"pgs_legs occupancy query failed: cudaError_t {err}")
    return blocks.value * geometry.envs_per_block


def _check_legs(lay, fac, J, lm, b, R, lo, hi, ns_offset: int) -> None:
    if J.dim() != 3:
        raise ValueError(f"J must be (N, nefc, nv), got {tuple(J.shape)}")
    N, nefc, nv = J.shape
    B, s, nb = lay.nbranch, lay.branch_size, lay.nbase
    if nv != lay.nv or nv != nb + B * s:
        raise ValueError(f"J has nv={nv}, the layout {tuple(lay)}")
    shapes = (("Ld", fac.Ld, (N, B, s, s)), ("W", fac.W, (N, B, s, nb)),
              ("Ls", fac.Ls, (N, nb, nb)), ("leg1", lm.leg1, (N, nefc)),
              ("leg2", lm.leg2, (N, nefc)), ("has1", lm.has1, (N, nefc)),
              ("has2", lm.has2, (N, nefc)), ("b", b, (N, nefc)),
              ("R", R, (N, nefc)), ("lo", lo, (N, nefc)), ("hi", hi, (N, nefc)))
    for name, x, shape in shapes:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.device != J.device or not x.is_contiguous():
            raise ValueError("pgs_legs operands must share one device and be "
                             "contiguous")
    for x in (fac.Ld, fac.W, fac.Ls, b, R, lo, hi):
        if x.dtype != J.dtype:
            raise ValueError("pgs_legs float operands must share one dtype")
    if lm.leg1.dtype != torch.int32 or lm.leg2.dtype != torch.int32:
        raise ValueError("leg ids must be int32")
    if lm.has1.dtype != torch.bool or lm.has2.dtype != torch.bool:
        raise ValueError("slot masks must be bool")
    if J.dtype not in _LEG_CTYPES:
        raise ValueError(f"pgs_legs takes float32 or float64, got {J.dtype}")
    if not 0 <= ns_offset <= nefc:
        raise ValueError(f"ns_offset {ns_offset} outside [0, {nefc}]")


def pgs_legs(lay, fac, J, lm, b, R, lo, hi, iterations: int, noslip: int,
             ns_offset: int = 0):
    """Batched leg-sparse PGS solve from the block-arrow factor ``fac`` of
    layout ``lay`` (``physics/arrow.py``) and the slot assignment ``lm``
    (``physics/solver.py::LegMeta``): the CUDA kernel for CUDA tensors (it
    builds the G panels itself), ``leg_panels`` + ``pgs_legs_reference``
    for CPU tensors.  J: (N, nefc, nv); b, R, lo, hi: (N, nefc) → (f,
    dqacc): f (N, nefc), and dqacc = M⁻¹ Jᵀ f (N, nv) = L⁻ᵀ u from the
    final slot state u = Gᵀf (the kernel's epilogue; ``arrow.solve_lt``),
    the change of qacc, for which the caller then needs no solve of its
    own."""
    _check_legs(lay, fac, J, lm, b, R, lo, hi, ns_offset)
    N, nefc, nv = J.shape
    geo = legs_geometry(nefc, lay.nbranch, lay.branch_size, lay.nbase, noslip,
                        ns_offset, J.element_size())
    if J.device.type == "cpu":
        # physics/solver.py imports this module
        from nightmare_rl_tpu_torch.physics.solver import leg_panels

        for ids in (lm.leg1, lm.leg2):
            if ids.numel() and not 0 <= int(ids.min()) <= int(ids.max()) < lay.nbranch:
                raise ValueError(f"leg ids outside [0, {lay.nbranch})")
        f, u = pgs_legs_reference(
            leg_panels(lay, fac, J, lm), lm.leg1, lm.leg2, b, R, lo, hi,
            lay.nbranch, lay.branch_size, lay.nbase, iterations, noslip,
            ns_offset)
        return f, arrow.solve_lt(lay, fac, u)
    if J.device.type != "cuda":
        raise ValueError(f"pgs_legs runs on cpu or cuda, not {J.device}")
    f = torch.empty_like(b)
    dq = J.new_empty(N, nv)
    if N == 0:
        return f, dq
    fn = _legs_fn(J.dtype)
    stream = torch.cuda.current_stream(J.device).cuda_stream
    with torch.cuda.device(J.device):
        err = fn(J.data_ptr(), fac.Ld.data_ptr(), fac.W.data_ptr(),
                 fac.Ls.data_ptr(), lm.leg1.data_ptr(), lm.leg2.data_ptr(),
                 lm.has1.data_ptr(), lm.has2.data_ptr(), b.data_ptr(),
                 R.data_ptr(), lo.data_ptr(), hi.data_ptr(), f.data_ptr(),
                 dq.data_ptr(), N, nefc, nv, lay.nbranch,
                 iterations, noslip, ns_offset, geo.envs_per_block,
                 geo.env_stride, geo.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"pgs_legs kernel launch failed: cudaError_t {err}")
    pgs_legs.launches += 1
    return f, dq


pgs_legs.launches = 0


# ---------------------------------------------------------------------------
# the solver-form dispatch
# ---------------------------------------------------------------------------

_MODE_CACHE: dict = {}
# the latest probe's verdict and candidate times (read by chip_smoke.py and
# the profilers)
last_probe: dict = {}


def dtype_key(dtype: torch.dtype) -> str:
    """"float32" for torch.float32: the dtype part of the dispatch key."""
    return str(dtype).replace("torch.", "")


def _probe_cache_path() -> str:
    """NIGHTMARE_PROBE_CACHE (empty: no file), by default a file in the
    temporary directory."""
    return os.environ.get(
        "NIGHTMARE_PROBE_CACHE",
        os.path.join(tempfile.gettempdir(), "nightmare_pgs_probe_torch.json"))


def _backend_fingerprint(device: torch.device) -> str:
    if device.type == "cuda":
        return (f"cuda/{torch.cuda.get_device_name(device)}/torch"
                f"{torch.__version__}/cu{torch.version.cuda}")
    return f"{device.type}/torch{torch.__version__}"


def _probe_cache_load(path: str) -> dict:
    if not path:
        return {}
    try:
        with open(path) as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def _probe_cache_store(path: str, key_s: str, mode: str) -> None:
    """Adds one verdict to the JSON file; the file is replaced atomically,
    so concurrent writers never leave it torn."""
    if not path:
        return
    data = _probe_cache_load(path)
    data[key_s] = mode
    tmp = f"{path}.{os.getpid()}"
    try:
        with open(tmp, "w") as fh:
            json.dump(data, fh)
        os.replace(tmp, path)
    except OSError:
        pass


def _probe_problem(rng, N, nefc, nv, lay_shape, ns_offset, dtype, device):
    """Random constraint system shaped like the real one, with a random
    block-arrow factor, so that each candidate is timed with its own
    precompute (the JAX package's ``_probe_problem``, the same draws)."""
    J = rng.normal(size=(N, nefc, nv))
    b = rng.normal(size=(N, nefc)) * 5
    R = np.abs(rng.normal(size=(N, nefc))) + 0.01
    lo = np.zeros((N, nefc))
    hi = np.full((N, nefc), 3e38)
    lo[:, :ns_offset] = -2.0
    hi[:, :ns_offset] = 2.0
    if lay_shape is None:
        B, s, nb = max(1, (nv - 6) // 3), 3, 6
        if nb + B * s != nv:
            B, s, nb = 1, nv - 6 if nv > 6 else 1, 6 if nv > 6 else nv - 1
    else:
        B, s, nb = lay_shape
    Ld = np.tril(rng.normal(size=(N, B, s, s)))
    ii = np.arange(s)
    Ld[:, :, ii, ii] = np.abs(Ld[:, :, ii, ii]) + 1.0
    W = rng.normal(size=(N, B, s, nb)) * 0.3
    Ls = np.tril(rng.normal(size=(N, nb, nb)))
    jj = np.arange(nb)
    Ls[:, jj, jj] = np.abs(Ls[:, jj, jj]) + 1.0
    C = Ld @ W
    l1 = rng.integers(0, B, size=nefc)
    l2 = (l1 + 1) % max(B, 1)
    out = [torch.as_tensor(x, dtype=dtype, device=device).contiguous()
           for x in (J, b, R, lo, hi, Ld, W, Ls, C)]
    return out + [torch.as_tensor(x, dtype=torch.int32, device=device)
                  for x in (l1, l2)]


def _probed_mode(nefc: int, nv: int, iterations: int, noslip: int,
                 ns_offset: int, lay_shape, legs_available: bool,
                 dtype_name: str, device, N: int = 2048) -> str:
    """Times each candidate form on ``device`` at the real problem shapes
    and N envs (``choose_mode`` passes NIGHTMARE_PROBE_N, by default 2048, a
    training batch), each with what ``physics/solver.py::solve`` runs for it
    after the assembly: the dense form M⁻¹ from the factor, U = J M⁻¹, the
    PGS kernel (the plain version on the CPU) and qacc's change M⁻¹ Jᵀ f;
    the legs form its kernel, which builds the panels and gives qacc's
    change itself, and Jᵀ f.  The legs form's slot assignment in
    ``assemble`` is not timed.  A time is the wall clock of one call up to
    ``torch.cuda.synchronize()``, the least of the repetitions after the
    first: what a step pays, launches included.  Returns the fastest form's
    name; a layout the legs kernel refuses raises, as its solve would."""
    from nightmare_rl_tpu_torch.physics import solver  # it imports this module

    device = torch.device(device)
    dtype = getattr(torch, dtype_name)
    if lay_shape is not None:
        B, s, nb = lay_shape
    else:
        B, s, nb = max(1, (nv - 6) // 3), 3, 6
    has_lay = nb + B * s == nv
    J, b, R, lo, hi, Ld, W, Ls, C, l1, l2 = _probe_problem(
        np.random.default_rng(0), N, nefc, nv, (B, s, nb) if has_lay else None,
        ns_offset, dtype, device)
    dense = "kernel" if device.type == "cuda" else "scan"
    sweeps = (iterations, noslip, ns_offset)

    def solve_dense(Minv):
        f = pgs(J, J @ Minv, b, R, lo, hi, *sweeps)
        return Minv @ torch.einsum("nkv,nk->nv", J, f)[..., None]

    if has_lay:
        lay = arrow.ArrowLayout(nv, nb, B, s)
        fac = arrow.ArrowFac(Ld, W, Ls, C)
        cands = {dense: lambda: solve_dense(arrow.inv(lay, fac))}
        if legs_available:
            ones = torch.ones(N, nefc, dtype=torch.bool, device=device)
            lm = solver.LegMeta(l1.expand(N, -1).contiguous(),
                                l2.expand(N, -1).contiguous(), ones, ones)

            def solve_legs():
                f, dq = pgs_legs(lay, fac, J, lm, b, R, lo, hi, *sweeps)
                return dq, torch.einsum("nkv,nk->nv", J, f)

            cands["legs"] = solve_legs
    else:
        X = torch.as_tensor(np.random.default_rng(1).normal(size=(nv, nv)),
                            dtype=dtype, device=device)
        Minv = X @ X.T + 0.1 * torch.eye(nv, dtype=dtype, device=device)
        cands = {dense: lambda: solve_dense(Minv)}

    timings = {}
    with full_float32():
        for name, fn in cands.items():
            times = []
            for _ in range(4):
                t0 = time.perf_counter()
                fn()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                times.append(time.perf_counter() - t0)
            timings[name] = min(times[1:])  # the first pays the build
    best = min(timings, key=timings.get)
    detail = ", ".join(f"{n}={t * 1e3:.3f}ms" for n, t in timings.items())
    print(f"pgs probe: selected '{best}' ({detail}; nefc={nefc}, nv={nv}, "
          f"N={N}, {device})")
    last_probe.clear()
    last_probe.update(mode=best, N=N, ms={n: t * 1e3 for n, t in timings.items()})
    return best


def choose_mode(legs_available: bool, nefc: int, nv: int, iterations: int,
                noslip: int, ns_offset: int, lay_shape,
                dtype_name: str = "float32", device="cpu") -> str:
    """The form a solve runs, as the JAX package's ``choose_mode`` picks it:

    - ``NIGHTMARE_PGS=legs|scan|kernel`` forces a form; ``legs`` where the
      legs form is not available gives ``scan``;
    - on the CPU the default is ``legs`` when available, else ``scan``;
    - on the card it is the verdict of ``_probed_mode``, kept in memory and
      in the JSON file ``NIGHTMARE_PROBE_CACHE`` under a key that holds the
      card, torch and CUDA versions and NIGHTMARE_PROBE_N;
      ``NIGHTMARE_PROBE=reprobe`` measures again.  Without the legs form
      there is nothing to choose: ``kernel``.

    ``legs_available`` means, as in the JAX package, that the model has a
    block-arrow layout (and the solve its slot assignment), whatever the
    layout: one that the legs kernel does not take is refused by
    ``pgs_legs`` and by the probe, on every device, not solved quietly in
    the dense form.

    On the card ``scan`` and ``kernel`` both name the dense form, the
    ``csrc/pgs.cu`` kernel; on the CPU both name its plain version.  The JAX
    package runs the probe only outside a jit trace (``_trace_state_clean``);
    in the port the env's constructor (``prewarm``) and a captured step's
    eager warm-up (``utils/graph.py``) run the dispatch before a CUDA graph
    is captured: a probe inside a capture would synchronize and fail it."""
    mode = os.environ.get("NIGHTMARE_PGS")
    if mode in ("legs", "scan", "kernel"):
        return "scan" if mode == "legs" and not legs_available else mode
    device = torch.device(device)
    if device.type != "cuda":
        return "legs" if legs_available else "scan"
    if not legs_available:
        return "kernel"
    key = (nefc, nv, iterations, noslip, ns_offset, lay_shape, legs_available,
           dtype_name)
    if key in _MODE_CACHE:
        return _MODE_CACHE[key]
    path = _probe_cache_path()
    probe_n = int(os.environ.get("NIGHTMARE_PROBE_N", "2048"))
    key_s = f"{_backend_fingerprint(device)}|N{probe_n}|{key}"
    if os.environ.get("NIGHTMARE_PROBE") != "reprobe":
        cached = _probe_cache_load(path).get(key_s)
        if cached in ("legs", "scan", "kernel"):
            _MODE_CACHE[key] = cached
            return cached
    mode = _probed_mode(*key, device, probe_n)
    _MODE_CACHE[key] = mode
    _probe_cache_store(path, key_s, mode)
    return mode
