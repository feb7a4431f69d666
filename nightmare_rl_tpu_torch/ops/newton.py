"""The Newton/elliptic constraint solve as one CUDA kernel per call.

``newton_solve`` computes what ``physics/newton.py::solve`` computes (the
port of the JAX package's compiled ``nightmare_rl_tpu/physics/newton.py::
solve``), with the same arguments and the same ``NewtonOut``: CPU tensors
go to that plain version, CUDA tensors to the kernel ``csrc/newton.cu``
(one warp per env, the whole fixed-budget solve in one launch; its per-env
arithmetic is ``csrc/newton_env.cuh``).  A shape the kernel does not take
(condim above 6, an env whose workspace does not fit in a block's shared
memory) is refused on every device; on the card a failed build or launch
raises.  ``newton_solve.launches`` counts kernel launches.

The kernel reads the rows in efc order.  The cone groups' static layout
(the rows outside the cones, each contact's first row, condim and the
offset of its friction coefficients) is one int32 tensor made once per
shape and device; per call the groups' mu, activity and friction
coefficients are concatenated over the groups.

``host_solve`` runs the same per-env arithmetic on the CPU through the
host driver ``csrc/newton_host.cpp`` (built with g++), for the tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from nightmare_rl_tpu_torch.ops import build
from nightmare_rl_tpu_torch.physics import newton
from nightmare_rl_tpu_torch.physics.newton import NewtonEfc, NewtonOut

MAX_DIM = 6                   # largest condim the kernel takes
MAX_SMEM = 227 * 1024         # dynamic shared memory of one block on an H100
ENVS_PER_BLOCK = 4            # warps (one env each) per block, at most
_CTYPES = {torch.float32: "newton_f32", torch.float64: "newton_f64"}
_HOST = {torch.float32: "newton_host_f32", torch.float64: "newton_host_f64"}


def env_elems(nefc: int, nv: int, nc: int, nmus: int) -> int:
    """Elements of one env's shared-memory workspace
    (``csrc/newton_env.cuh::env_elems``)."""
    e = (nefc * nv + nv * nv + 8 * nefc + 6 * nc + 3 * nmus + 6 * nv
         + 3 * nefc + 3 * nc)
    return (e + 3) & ~3


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How the kernel lays a shape out: ``envs_per_block`` warps of one env
    each per block, each env taking ``env_elems`` elements of shared
    memory."""

    envs_per_block: int
    env_elems: int
    smem_bytes: int


def _spans(efc: NewtonEfc) -> Tuple[Tuple[int, int, int], ...]:
    return tuple((g.start, g.dim, g.mus.shape[-2]) for g in efc.cones)


@functools.lru_cache(maxsize=None)
def geometry(nefc: int, nv: int, spans: Tuple[Tuple[int, int, int], ...],
             itemsize: int) -> Geometry:
    """The kernel's launch geometry for one shape and cone layout
    ((start, dim, n) per group); raises ValueError for a shape it does not
    take."""
    for start, d, n in spans:
        if not 1 <= d <= MAX_DIM:
            raise ValueError(f"the newton kernel takes condim 1 to {MAX_DIM}, "
                             f"not {d}")
        if start < 0 or start + d * n > nefc:
            raise ValueError(f"cone group ({start}, {d}, {n}) outside the "
                             f"{nefc} rows")
    nc = sum(n for _, _, n in spans)
    nmus = sum(n * (d - 1) for _, d, n in spans)
    elems = env_elems(nefc, nv, nc, nmus)
    envs = min(ENVS_PER_BLOCK, MAX_SMEM // (elems * itemsize))
    if envs < 1:
        raise ValueError(
            f"the newton kernel keeps one env in shared memory: nefc={nefc}, "
            f"nv={nv}, {nc} contacts need {elems * itemsize} bytes, more "
            f"than {MAX_SMEM}")
    return Geometry(envs, elems, envs * elems * itemsize)


@functools.lru_cache(maxsize=None)
def _descriptor(nefc: int, spans: Tuple[Tuple[int, int, int], ...],
                device: torch.device) -> Tuple[torch.Tensor, int, int, int]:
    """The static layout [rows outside the cones | first row | condim |
    offset into mus] (int32 on ``device``), the number of rows outside the
    cones, of contacts and of friction coefficients."""
    cone_rows, starts, dims, offs, off = set(), [], [], [], 0
    for start, d, n in spans:
        cone_rows.update(range(start, start + d * n))
        for c in range(n):
            starts.append(start + c * d)
            dims.append(d)
            offs.append(off)
            off += d - 1
    plain = [r for r in range(nefc) if r not in cone_rows]
    desc = torch.tensor(plain + starts + dims + offs, dtype=torch.int32)
    return desc.to(device), len(plain), len(starts), off


def _cones(efc: NewtonEfc, N: int, dtype: torch.dtype, device):
    """mu (N, nc), activity (N, nc) and the friction coefficients
    (N, nmus), concatenated over the cone groups."""
    if not efc.cones:
        return (torch.empty(N, 0, dtype=dtype, device=device),
                torch.empty(N, 0, dtype=torch.bool, device=device),
                torch.empty(N, 0, dtype=dtype, device=device))
    return (torch.cat([g.mu for g in efc.cones], dim=1).contiguous(),
            torch.cat([g.active for g in efc.cones], dim=1).contiguous(),
            torch.cat([g.mus.flatten(1) for g in efc.cones], dim=1).contiguous())


def _check(efc: NewtonEfc, M, qacc_smooth, x0) -> None:
    if efc.J.dim() != 3:
        raise ValueError(f"J must be (N, nefc, nv), got {tuple(efc.J.shape)}")
    N, nefc, nv = efc.J.shape
    dt, dev = efc.J.dtype, efc.J.device
    shapes = [("aref", efc.aref, (N, nefc)), ("R", efc.R, (N, nefc)),
              ("fl", efc.fl, (N, nefc)), ("quad_active", efc.quad_active,
                                          (N, nefc)),
              ("M", M, (N, nv, nv)), ("qacc_smooth", qacc_smooth, (N, nv))]
    if x0 is not None:
        shapes.append(("x0", x0, (N, nv)))
    for g in efc.cones:
        n = g.mus.shape[-2]
        shapes += [("mu", g.mu, (N, n)), ("mus", g.mus, (N, n, g.dim - 1)),
                   ("active", g.active, (N, n))]
    for name, x, shape in shapes:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError("newton operands must share one device")
        want = torch.bool if name in ("quad_active", "active") else dt
        if x.dtype != want:
            raise ValueError(f"{name} must be {want}, got {x.dtype}")
    for name, x in (("J", efc.J), ("aref", efc.aref), ("R", efc.R),
                    ("fl", efc.fl), ("quad_active", efc.quad_active),
                    ("M", M), ("qacc_smooth", qacc_smooth), ("x0", x0)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"newton operand {name} must be contiguous")
    if dt not in _CTYPES:
        raise ValueError(f"the newton kernel takes float32 or float64, got {dt}")


@functools.lru_cache(maxsize=None)
def _kernel_fn(dtype: torch.dtype):
    fn = getattr(build.load("newton"), _CTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def newton_solve(efc: NewtonEfc, M: torch.Tensor, qacc_smooth: torch.Tensor,
                 iterations: int, ls_refine: int,
                 x0: Optional[torch.Tensor] = None) -> NewtonOut:
    """The Newton solve of ``physics/newton.py::solve``: the CUDA kernel for
    CUDA tensors, that plain version for CPU tensors."""
    _check(efc, M, qacc_smooth, x0)
    N, nefc, nv = efc.J.shape
    spans = _spans(efc)
    geo = geometry(nefc, nv, spans, efc.J.element_size())
    dev = efc.J.device
    if dev.type == "cpu":
        return newton.solve(efc, M, qacc_smooth, iterations, ls_refine, x0=x0)
    if dev.type != "cuda":
        raise ValueError(f"newton_solve runs on cpu or cuda, not {dev}")
    force = torch.empty_like(efc.aref)
    qfrc = torch.empty_like(qacc_smooth)
    qacc = torch.empty_like(qacc_smooth)
    if N == 0:
        return NewtonOut(force, qfrc, qacc)
    desc, nplain, nc, nmus = _descriptor(nefc, spans, dev)
    mu, act, mus = _cones(efc, N, efc.J.dtype, dev)
    fn = _kernel_fn(efc.J.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(efc.J.data_ptr(), efc.aref.data_ptr(), efc.R.data_ptr(),
                 efc.fl.data_ptr(), efc.quad_active.data_ptr(), mu.data_ptr(),
                 act.data_ptr(), mus.data_ptr(), M.data_ptr(),
                 qacc_smooth.data_ptr(),
                 None if x0 is None else x0.data_ptr(), force.data_ptr(),
                 qfrc.data_ptr(), qacc.data_ptr(), desc.data_ptr(), N, nefc,
                 nv, nc, nplain, nmus, iterations, ls_refine,
                 geo.envs_per_block, geo.env_elems, geo.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"newton kernel launch failed: cudaError_t {err}")
    newton_solve.launches += 1
    return NewtonOut(force, qfrc, qacc)


newton_solve.launches = 0


def envs_per_sm(geo: Geometry, dtype: torch.dtype) -> int:
    """Envs one SM of the current card holds at once with this geometry
    (CUDA occupancy query; needs the card)."""
    fn = build.load("newton").newton_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(torch.finfo(dtype).bits // 8, geo.envs_per_block,
             geo.smem_bytes, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"newton occupancy query failed: cudaError_t {err}")
    return blocks.value * geo.envs_per_block


def host_solve(efc: NewtonEfc, M: torch.Tensor, qacc_smooth: torch.Tensor,
               iterations: int, ls_refine: int,
               x0: Optional[torch.Tensor] = None, team: int = 1) -> NewtonOut:
    """The kernel's per-env arithmetic (``csrc/newton_env.cuh``) on CPU
    tensors, through the host driver ``csrc/newton_host.cpp`` built with
    g++: a team of ``team`` threads (1 to 64) splits each env's loops as the
    kernel's warp lanes do, the envs in series.  For the tests; raises
    RuntimeError where g++ is missing."""
    _check(efc, M, qacc_smooth, x0)
    N, nefc, nv = efc.J.shape
    spans = _spans(efc)
    geometry(nefc, nv, spans, efc.J.element_size())
    if efc.J.device.type != "cpu":
        raise ValueError("host_solve takes CPU tensors")
    desc, nplain, nc, nmus = _descriptor(nefc, spans, efc.J.device)
    mu, act, mus = _cones(efc, N, efc.J.dtype, "cpu")
    force = torch.empty_like(efc.aref)
    qfrc = torch.empty_like(qacc_smooth)
    qacc = torch.empty_like(qacc_smooth)
    fn = getattr(build.load_host("newton_host"), _HOST[efc.J.dtype])
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
    fn.restype = ctypes.c_int
    err = fn(efc.J.data_ptr(), efc.aref.data_ptr(), efc.R.data_ptr(),
             efc.fl.data_ptr(), efc.quad_active.data_ptr(), mu.data_ptr(),
             act.data_ptr(), mus.data_ptr(), M.data_ptr(),
             qacc_smooth.data_ptr(), None if x0 is None else x0.data_ptr(),
             force.data_ptr(), qfrc.data_ptr(), qacc.data_ptr(),
             desc.data_ptr(), N, nefc, nv, nc, nplain, nmus, iterations,
             ls_refine, team)
    if err != 0:
        raise RuntimeError(f"newton host driver refused its arguments ({err})")
    return NewtonOut(force, qfrc, qacc)
