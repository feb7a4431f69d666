"""The contact solve's output stage as one CUDA kernel launch per substep.

``outputs`` computes what follows the solve in every form
(``physics/solver.py::solve_rows``; the port of the JAX package's compiled
``nightmare_rl_tpu/physics/solver.py:454-457``, ``:477-478``, ``:746-747``
and ``:757-772`` and ``nightmare_rl_tpu/physics/pipeline.py:100``):

- qfrc_constraint = Jᵀf and qacc, from what the solve's form leaves
  (``Solved``): the legs form's dq = M⁻¹Jᵀf (qacc = qacc_smooth + dq), the
  dense form's M⁻¹ (qacc = qacc_smooth + M⁻¹ qfrc; also Newton followed by
  the pyramidal noslip), or Newton's own qfrc and qacc, which pass through;
- nforce, each candidate point's normal force: every contact group's
  points set to their rows' sum (pyramid facets) or first row (elliptic
  cone), then every pair's force added to its point a, then to its point b;
- sensordata = nforce Sᵀ, the touch sensors (``sys.sensor_cpoint_matrix``).

CPU tensors go to the plain version ``plain`` (the solver's and the
pipeline's code moved here unchanged, so a CPU run is bit for bit the
earlier one's); CUDA tensors to the kernel ``csrc/solve_out.cu`` (a warp per
env; the per-env arithmetic is ``csrc/solve_out_env.cuh``), and a failed
build or launch raises.  A shape the kernel does not take (more than
``MAX_GROUPS`` contact groups, rows outside the system, an env beyond a
block's shared memory) is refused on every device.
``outputs.launches`` counts kernel launches.

No TPU kernel stands behind this one: XLA fuses the same code into the
vmapped step.  What bounds it is bytes, J above all (nightmare_v3 at 2048
envs in float32: ~24 MB, ~7 us at 3.35 TB/s); see ``csrc/solve_out.cu``.

``host_outputs`` runs the same per-env arithmetic on CPU tensors through
the host driver ``csrc/solve_out_host.cpp`` (built with g++), for the
tests.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from nightmare_rl_tpu_torch.ops import build
from nightmare_rl_tpu_torch.physics import system as S

LEGS, DENSE, NEWTON = range(3)   # solve_out_env.cuh Form
MAX_GROUPS = 4                   # solve_out_env.cuh kMaxGroups
MAX_TEAM = 64                    # solve_out_env.cuh kMaxTeam
ENVS_PER_BLOCK = 8               # solve_out.cu kMaxEnvsPerBlock
MAX_SMEM = 227 * 1024            # dynamic shared memory of one block on an H100
SM_SMEM = 228 * 1024             # shared memory of one SM
BLOCK_RESERVED = 1024            # shared memory the runtime keeps per block


class Solved(NamedTuple):
    """The solve's force and what its form leaves for the output stage."""

    form: int                            # LEGS, DENSE or NEWTON
    force: torch.Tensor                  # (N, nefc)
    J: Optional[torch.Tensor] = None     # (N, nefc, nv): LEGS, DENSE
    dq: Optional[torch.Tensor] = None    # (N, nv) M⁻¹Jᵀf: LEGS
    Minv: Optional[torch.Tensor] = None  # (N, nv, nv): DENSE
    qfrc: Optional[torch.Tensor] = None  # (N, nv): NEWTON
    qacc: Optional[torch.Tensor] = None  # (N, nv): NEWTON


class Out(NamedTuple):
    nforce: torch.Tensor           # (N, ncp)
    qfrc_constraint: torch.Tensor  # (N, nv)
    qacc: torch.Tensor             # (N, nv)
    sensordata: torch.Tensor       # (N, nsensor)


def plain(sys: S.System, groups: Sequence[Tuple[torch.Tensor, int]],
          pair_ab: Optional[Tuple[torch.Tensor, torch.Tensor]],
          ns_offset: int, solved: Solved, qacc_smooth: torch.Tensor,
          elliptic: bool) -> Out:
    """The plain version: the products, the scatter and the sensors."""
    f, form = solved.force, solved.form
    if form == LEGS:
        qfrc = torch.einsum("nkv,nk->nv", solved.J, f)
        qacc = qacc_smooth + solved.dq
    elif form == DENSE:
        qfrc = torch.einsum("nkv,nk->nv", solved.J, f)
        qacc = qacc_smooth + torch.einsum("nij,nj->ni", solved.Minv, qfrc)
    else:
        qfrc, qacc = solved.qfrc, solved.qacc
    N = qacc_smooth.shape[0]
    nforce = f.new_zeros(N, sys.ncp)
    off = ns_offset
    for idx, nf in groups:
        n = idx.shape[1]
        blk = f[:, off:off + n * nf].reshape(N, n, nf)
        nforce = nforce.scatter(1, idx, blk[..., 0] if elliptic else blk.sum(dim=-1))
        off += n * nf
    if pair_ab is not None:
        # pair normal force feeds the touch sensors of BOTH bodies; duplicate
        # indices accumulate (scatter_add, the batched index_add_)
        pa, pb = pair_ab
        blk = f[:, off:].reshape(N, -1, 3 if elliptic else 4)
        nf_pair = blk[..., 0] if elliptic else blk.sum(dim=-1)
        nforce = nforce.scatter_add(1, pa, nf_pair).scatter_add(1, pb, nf_pair)
    # touch sensors: per-contact normal force (Σ pyramid facet forces, or
    # the normal row of an elliptic cone)
    sensordata = nforce @ sys.sensor_cpoint_matrix.T
    return Out(nforce, qfrc, qacc, sensordata)


def _refuse(why: str):
    raise ValueError(f"the solve_out kernel does not take this system: {why}")


@functools.lru_cache(maxsize=None)
def _names(host: bool) -> Tuple[str, ...]:
    lib = build.load_host("solve_out_host") if host else build.load("solve_out")
    fn = lib.solve_out_param_names
    fn.restype = ctypes.c_char_p
    return tuple(k for k in fn().decode().split(",") if k)


@functools.lru_cache(maxsize=None)
def _sensors(sys: S.System, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """The sensor matrix (nsensor, ncp), contiguous on ``device`` (made once;
    never inside a captured step, whose warm-up call makes it)."""
    return sys.sensor_cpoint_matrix.to(device=device, dtype=dtype).contiguous()


def _align16(nbytes: int) -> int:
    return (nbytes + 15) & ~15


@dataclasses.dataclass(frozen=True)
class Geometry:
    """``envs_per_block`` warps of one env each per block, ``smem_bytes``
    of shared memory a block."""

    envs_per_block: int
    smem_bytes: int


def geometry(p: dict, itemsize: int) -> Geometry:
    """The launch geometry of a call's parameters (``_layout``): the envs
    per block (1 to ENVS_PER_BLOCK) that let the most envs reside on an SM,
    more per block on a tie.  A block holds the sensor matrix, then per env
    its f, its staged J (M⁻¹ in J's place for the dense form; none for
    Newton), its workspace's values and ints, each padded to 16 bytes
    (solve_out.cu ``env_bytes``)."""
    nv, nefc = p["nv"], p["nefc"]
    slots = sum(p[f"g{g}_n"] for g in range(p["ngroup"])) + p["npair"]
    jm = 0
    if p["form"] != NEWTON:
        jm = (max(nefc, nv) if p["form"] == DENSE else nefc) * nv
    work = (nv + slots + p["ncp"] + 3) & ~3
    iwork = (slots + p["npair"] + 3) & ~3
    env = (_align16(nefc * itemsize) + _align16(jm * itemsize)
           + _align16(work * itemsize) + _align16(iwork * 4))
    table = _align16(p["nsensor"] * p["ncp"] * itemsize)
    best = None
    for e in range(1, ENVS_PER_BLOCK + 1):
        smem = table + e * env
        if smem > MAX_SMEM:
            break
        resident = SM_SMEM // (smem + BLOCK_RESERVED) * e
        if best is None or resident >= best[0]:
            best = (resident, e, smem)
    if best is None:
        _refuse(f"an env takes {env} bytes of shared memory and the sensor "
                f"matrix {table}, more than {MAX_SMEM} a block")
    return Geometry(best[1], best[2])


def _layout(sys: S.System, groups, pair_ab, ns_offset: int, nefc: int,
            form: int, elliptic: bool,
            dtype: torch.dtype) -> Tuple[dict, Geometry]:
    """The kernel's parameters by name and its launch geometry, from the
    shapes alone; refuses (ValueError) what the kernel cannot compute, on
    every device."""
    if dtype not in (torch.float32, torch.float64):
        _refuse(f"dtype {dtype}")
    if form not in (LEGS, DENSE, NEWTON):
        raise ValueError(f"unknown solve form {form}")
    if len(groups) > MAX_GROUPS:
        _refuse(f"{len(groups)} contact groups, more than {MAX_GROUPS}")
    p = dict(form=form, elliptic=int(elliptic), nefc=nefc, nv=sys.nv,
             ncp=sys.ncp, nsensor=sys.nsensor, ngroup=len(groups),
             pair_off=0, npair=0, pair_nf=1)
    off = ns_offset
    for g in range(MAX_GROUPS):
        n, nf = (groups[g][0].shape[1], groups[g][1]) if g < len(groups) else (0, 1)
        p.update({f"g{g}_off": off if g < len(groups) else 0, f"g{g}_n": n,
                  f"g{g}_nf": nf, f"g{g}_stride": 0})
        off += n * nf
    if pair_ab is not None:
        p.update(pair_off=off, npair=pair_ab[0].shape[1],
                 pair_nf=3 if elliptic else 4)
        off += p["npair"] * p["pair_nf"]
    if off > nefc or (pair_ab is not None and off != nefc):
        _refuse(f"contact rows up to {off}, outside the {nefc} rows")
    return p, geometry(p, torch.finfo(dtype).bits // 8)


def _operands(sys: S.System, groups, pair_ab, ns_offset: int,
              solved: Solved, qacc_smooth: torch.Tensor, elliptic: bool):
    """The parameters by name, the launch geometry, the inputs and the
    outputs (allocated; a Newton solve's qfrc and qacc pass through),
    checked."""
    f = solved.force
    N, dt, dev = qacc_smooth.shape[0], qacc_smooth.dtype, qacc_smooth.device
    nv, ncp, nsensor = sys.nv, sys.ncp, sys.nsensor
    if f.dim() != 2:
        raise ValueError(f"force must be (N, nefc), got {tuple(f.shape)}")
    nefc = f.shape[1]
    p, geo = _layout(sys, groups, pair_ab, ns_offset, nefc, solved.form,
                     elliptic, dt)

    def chk(x, name, shape, dtype=dt):
        if x is None:
            raise ValueError(f"the {('legs', 'dense', 'newton')[solved.form]} "
                             f"form needs {name}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != dtype or x.device != dev:
            raise ValueError(f"{name} must be {dtype} on {dev}, got {x.dtype} "
                             f"on {x.device}")
        return x

    f = chk(f, "force", (N, nefc)).contiguous()
    a0 = chk(qacc_smooth, "qacc_smooth", (N, nv)).contiguous()
    J = dq = Minv = None
    if solved.form == NEWTON:
        qfrc = chk(solved.qfrc, "qfrc", (N, nv))
        qacc = chk(solved.qacc, "qacc", (N, nv))
    else:
        J = chk(solved.J, "J", (N, nefc, nv)).contiguous()
        if solved.form == LEGS:
            dq = chk(solved.dq, "dq", (N, nv)).contiguous()
        else:
            Minv = chk(solved.Minv, "Minv", (N, nv, nv)).contiguous()
        qfrc = torch.empty(N, nv, dtype=dt, device=dev)
        qacc = torch.empty(N, nv, dtype=dt, device=dev)
    idx = [None] * MAX_GROUPS
    for g, (ix, _) in enumerate(groups):
        n = ix.shape[1]
        ix = chk(ix, f"group {g}'s points", (N, n), torch.long)
        # the selected points' (N, n), or a static group's expanded (0, 1)
        if ix.stride(1) != 1 or ix.stride(0) not in (0, n):
            ix = ix.contiguous()
        p[f"g{g}_stride"] = ix.stride(0) if N > 1 else 0
        idx[g] = ix
    pa = pb = None
    if pair_ab is not None:
        npair = p["npair"]
        pa = chk(pair_ab[0], "pair a", (N, npair), torch.long).contiguous()
        pb = chk(pair_ab[1], "pair b", (N, npair), torch.long).contiguous()
    ins = [f, J, dq, Minv, a0, _sensors(sys, dt, dev)] + idx + [pa, pb]
    outs = [qfrc if solved.form != NEWTON else None,
            qacc if solved.form != NEWTON else None,
            torch.empty(N, ncp, dtype=dt, device=dev),
            torch.empty(N, nsensor, dtype=dt, device=dev)]
    return p, geo, ins, outs, Out(outs[2], qfrc, qacc, outs[3])


def _pointers(xs) -> ctypes.Array:
    return (ctypes.c_void_p * len(xs))(
        *[None if x is None else x.data_ptr() for x in xs])


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype, host: bool):
    lib = build.load_host("solve_out_host") if host else build.load("solve_out")
    suffix = "_f32" if dtype == torch.float32 else "_f64"
    fn = getattr(lib, ("solve_out_host" if host else "solve_out") + suffix)
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + ([ctypes.c_int] if host
                      else [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]))
    fn.restype = ctypes.c_int
    return fn


def _run(sys, groups, pair_ab, ns_offset, solved, qacc_smooth, elliptic,
         host: bool, team: int = 1) -> Out:
    p, geo, ins, outs, out = _operands(sys, groups, pair_ab, ns_offset,
                                       solved, qacc_smooth, elliptic)
    names = _names(host)
    params = (ctypes.c_int * len(names))(*[p[k] for k in names])
    dev = qacc_smooth.device
    if host:
        last, ctx = (team,), contextlib.nullcontext()
    else:
        last = (geo.envs_per_block, geo.smem_bytes,
                torch.cuda.current_stream(dev).cuda_stream)
        ctx = torch.cuda.device(dev)
    with ctx:
        err = _fn(qacc_smooth.dtype, host)(
            params, len(names), _pointers(ins), len(ins), _pointers(outs),
            len(outs), qacc_smooth.shape[0], *last)
    if err != 0:
        raise RuntimeError(
            f"the solve_out host driver refused its arguments ({err})" if host
            else f"solve_out kernel launch failed: cudaError_t {err}")
    return out


def outputs(sys: S.System, groups: Sequence[Tuple[torch.Tensor, int]],
            pair_ab: Optional[Tuple[torch.Tensor, torch.Tensor]],
            ns_offset: int, solved: Solved, qacc_smooth: torch.Tensor,
            elliptic: bool) -> Out:
    """The solve's outputs: the kernel for CUDA tensors, the plain version
    for CPU tensors.  ``groups`` are the contact groups' points (N, n) and
    rows per point, in row order from ``ns_offset``; ``pair_ab`` the pairs'
    points a and b (N, Kp), whose rows follow the groups'."""
    dev = qacc_smooth.device
    if dev.type == "cpu":
        _layout(sys, groups, pair_ab, ns_offset, solved.force.shape[-1],
                solved.form, elliptic, qacc_smooth.dtype)
        return plain(sys, groups, pair_ab, ns_offset, solved, qacc_smooth,
                     elliptic)
    if dev.type != "cuda":
        raise ValueError(f"outputs runs on cpu or cuda, not {dev}")
    out = _run(sys, groups, pair_ab, ns_offset, solved, qacc_smooth,
               elliptic, host=False)
    _counted.launches += 1
    return out


outputs.launches = 0
_counted = outputs  # counts on, where a caller wraps the module's name


def envs_per_sm(geo: Geometry, dtype: torch.dtype) -> int:
    """Envs one SM of the current card holds at once with this geometry
    (CUDA occupancy query; needs the card)."""
    fn = build.load("solve_out").solve_out_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(torch.finfo(dtype).bits // 8, geo.envs_per_block,
             geo.smem_bytes, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"solve_out occupancy query failed: cudaError_t "
                           f"{err}")
    return blocks.value * geo.envs_per_block


def host_outputs(sys: S.System, groups, pair_ab, ns_offset: int,
                 solved: Solved, qacc_smooth: torch.Tensor, elliptic: bool,
                 team: int = 1) -> Out:
    """The kernel's per-env arithmetic (``csrc/solve_out_env.cuh``) on CPU
    tensors, through the host driver ``csrc/solve_out_host.cpp`` built with
    g++: a team of ``team`` threads (1 to 64) splits each env's loops as the
    kernel's warp lanes do, the envs in series.  For the tests; raises
    RuntimeError where g++ is missing."""
    if not 1 <= team <= MAX_TEAM:
        raise ValueError(f"host_outputs runs teams of 1 to {MAX_TEAM}, not "
                         f"{team}")
    if qacc_smooth.device.type != "cpu":
        raise ValueError("host_outputs takes CPU tensors")
    return _run(sys, groups, pair_ab, ns_offset, solved, qacc_smooth,
                elliptic, host=True, team=team)
