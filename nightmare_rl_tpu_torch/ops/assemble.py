"""Collision and constraint-row assembly of a physics substep as one CUDA
kernel per call.

``rows`` computes what ``physics/pipeline.py::forward`` computes between
the smooth half and the constraint solve (the port of the JAX package's
compiled ``nightmare_rl_tpu/physics/pipeline.py:84-94``: collision.py's
``find_contacts`` and ``find_pair_contacts``, solver.py's ``assemble`` with
its leg slots, and b = J qacc_smooth - aref, which the solve formed
before): the candidate points, the top-K condim-3 points, the top-Kp
sphere pairs, every row of the system in the order [dof | condim-3 |
condim > 3 ascending | pairs], each row's leg slots where the legs form of
the PGS solves (``solver.legs_form``), and the Newton solve's row flags
and cone coefficients.  CPU tensors go to the plain version ``plain`` (the
port's functions, looked up at call time), CUDA tensors to the kernel
``csrc/assemble.cu`` (one warp per env; its per-env arithmetic is
``csrc/assemble_env.cuh``).  A model the kernel does not take (a condim
other than 3, 4 and 6, more than ``MAX_PAIRS`` selected pairs, a workspace
beyond a block's shared memory) is refused on every device; on the card a
failed build or launch raises.  ``rows.launches`` counts kernel launches.

No TPU kernel stands behind this one: on the TPU, XLA fuses the same code
into a few fusions of the vmapped step.  What bounds it is bytes: at
nightmare_v3's 2048 envs in float32 it reads the frames of the bodies
that carry points, their root's subtree com and the motion axes, and
writes J (22 MB of it) and the rows' vectors, ~34 MB, ~10 us at 3.35 TB/s
(chip_smoke.py's assemble-kernel phase counts a call's bytes exactly; its
operations, ~20 k per env, are ~1 us at float32's 67 TFLOP/s).

The static tables are made once per (System, layout, dtype, device) and
cached, so a captured step never builds them: one int32 tensor (the
points' bodies, roots and legs, the condim-3 points, the pair index lists,
the row owners and each row's owner and facet), one float tensor of the
model's constants (staged in shared memory per block) and one of the
pairs' friction, solref and solimp (read from global memory for the
selected pairs only).  Every offset into them and into an env's workspace
is a field of the kernel's ``Layout``, filled by the names the library
reports.

``host_rows`` runs the same per-env arithmetic on the CPU through the host
driver ``csrc/assemble_host.cpp`` (built with g++), for the tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from nightmare_rl_tpu_torch.ops import build
from nightmare_rl_tpu_torch.physics import arrow, collision, kinematics
from nightmare_rl_tpu_torch.physics import newton, solver
from nightmare_rl_tpu_torch.physics import system as S

MAX_SMEM = 227 * 1024    # dynamic shared memory of one block on an H100
SM_SMEM = 228 * 1024     # shared memory of one SM
BLOCK_RESERVED = 1024    # shared memory the runtime keeps per block
ENVS_PER_BLOCK = 8       # warps (one env each) per block, at most
MAX_PAIRS = 8            # selected pairs at most (assemble_env.cuh kMaxPairs)
MAX_TEAM = 32            # team members at most (assemble_env.cuh kMaxTeam)
SLOT_VALS = 20           # a contact slot's workspace (kSlotVals)
DOFROW_VALS = 11         # a dof row's constants (kDofRowVals)
# row owner kinds (assemble_env.cuh Kind)
FRICTION, LOWER, UPPER, POINT, PAIR = range(5)
# the kernel's outputs, in assemble_env.cuh's Out order
OUTS = ("center", "pos", "dist", "active", "sel3", "pair_sel", "pair_a",
        "pair_b", "J", "aref", "R", "lo", "hi", "b", "leg1", "leg2", "has1",
        "has2", "quad_active", "fl", "cone_mu", "cone_mus", "cone_active")


class AssembleOut(NamedTuple):
    con: collision.Contacts   # pos, dist, active, centers; no Jacobians
    sel3: Optional[torch.Tensor]      # (N, K) selected condim-3 points
    pair_sel: Optional[torch.Tensor]  # (N, Kp) selected pairs
    pair_a: Optional[torch.Tensor]    # (N, Kp) their points a and b
    pair_b: Optional[torch.Tensor]
    rows: Optional[solver.Rows]       # None where nothing constrains


def _kin(xpos, xquat, subtree_com, cdof) -> kinematics.KinOut:
    return kinematics.KinOut(xpos, xquat, None, None, None, None, subtree_com,
                             None, cdof)


def plain(sys: S.System, lay: Optional[arrow.ArrowLayout], xpos, xquat,
          subtree_com, cdof, qpos, qvel, qacc_smooth,
          legs: bool = False) -> AssembleOut:
    """The plain version: ``collision.find_contacts``,
    ``find_pair_contacts`` and ``solver.assembled_rows`` (``assemble``,
    ``_legmeta`` where ``legs``, b)."""
    kin = _kin(xpos, xquat, subtree_com, cdof)
    con = collision.find_contacts(sys, kin)
    pair = None
    if sys.max_pair_contacts > 0 and len(sys.cpair_a) > 0:
        pair = collision.find_pair_contacts(sys, kin, con)
    rows = solver.assembled_rows(sys, con, qpos, qvel, qacc_smooth, pair=pair,
                                 lay=lay, legs=legs)
    c3, _ = solver._condim_groups(sys)
    sel3 = (rows.groups[0][0] if rows is not None and
            0 < sys.max_contacts < len(c3) else None)
    con = con._replace(jac=None, jac_rot=None)
    if pair is None:
        return AssembleOut(con, sel3, None, None, None, rows)
    return AssembleOut(con, sel3, pair.sel, pair.a, pair.b, rows)


def _pack(sections: List[Tuple[str, int]]) -> Tuple[Dict[str, int], int]:
    """Offsets of consecutive sections and their total, rounded up to 4."""
    off, total = {}, 0
    for name, n in sections:
        off[name] = total
        total += n
    return off, (total + 3) & ~3


@dataclasses.dataclass(frozen=True)
class Plan:
    """A model's static layout for the kernel: the ``Layout`` fields by
    name, the int32 table's contents, the constants' sections and the
    contact groups (static points or None for the selected condim-3
    points, condim, rows per point) in row order."""

    fields: Dict[str, int]
    topo: Tuple[int, ...]
    groups: Tuple[Tuple[Optional[Tuple[int, ...]], int, int], ...]
    nmus: int
    # per dof row, in row order: its dof and its joint (None for a dof
    # friction row)
    dofrows: Tuple[Tuple[int, Optional[int]], ...]


@functools.lru_cache(maxsize=None)
def model_plan(sys: S.System, lay: Optional[arrow.ArrowLayout]) -> Plan:
    """The plan of a model (read once per System and layout); raises
    ValueError for a model the kernel does not take."""
    c3, higher = solver._condim_groups(sys)
    for d, _ in higher:
        if d not in (4, 6):
            raise ValueError(f"the assemble kernel takes condim 3, 4 and 6, "
                             f"not {d}")
    K = sys.max_contacts
    select = 0 < K < len(c3)
    npair = len(sys.cpair_a)
    Kp = (min(sys.max_pair_contacts, npair)
          if sys.max_pair_contacts > 0 and npair > 0 else 0)
    if Kp > MAX_PAIRS:
        raise ValueError(f"the assemble kernel selects at most {MAX_PAIRS} "
                         f"pairs, not {Kp}")
    use_newton = sys.solver_type in (S.SOLVER_CG, S.SOLVER_NEWTON)
    elliptic = use_newton and sys.cone == S.ELLIPTIC
    nb, nv = sys.nbody, sys.nv

    fric_dofs, lim_jnts = solver._dof_row_sources(sys)

    def dof_leg(d):
        if lay is None or d < lay.nbase:
            return 0, 0
        return (d - lay.nbase) // lay.branch_size, 1

    owners, dofrows, row = [], [], 0
    for d in fric_dofs:
        owners.append((FRICTION, row, 1, 1, d, 0) + dof_leg(d))
        dofrows.append((d, None))
        row += 1
    for kind in (LOWER, UPPER):
        for j in lim_jnts:
            d = sys.jnt_dofadr[j]
            owners.append((kind, row, 1, 1, d, sys.jnt_qposadr[j]) + dof_leg(d))
            dofrows.append((d, j))
            row += 1
    ndofrow = row
    groups = []
    if c3:
        groups.append((None if select else c3, 3,
                       3 if elliptic else 4))
    for d, pts in higher:
        groups.append((pts, d, d if elliptic else 2 * (d - 1)))
    slot, mus = 0, 0
    for pts, d, nf in groups:
        for k in range(K if pts is None else len(pts)):
            owners.append((POINT, row, nf, d, -1 if pts is None else pts[k],
                           mus, slot, 0))
            row, slot, mus = row + nf, slot + 1, mus + d - 1
    for k in range(Kp):
        nf = 3 if elliptic else 4
        owners.append((PAIR, row, nf, 3, k, mus, slot, 0))
        row, slot, mus = row + nf, slot + 1, mus + 2
    nefc = row
    row_owner = [u for u, o in enumerate(owners) for _ in range(o[2])]
    row_f = [f for o in owners for f in range(o[2])]

    root = kinematics.body_root(sys)
    leg_map = (solver._point_leg_map(sys, lay) if lay is not None
               else (-1,) * sys.ncp)
    tables = [
        ("t_cp_body", list(sys.cpoint_bodyid)),
        ("t_cp_root", [root[b] for b in sys.cpoint_bodyid]),
        ("t_cp_leg", list(leg_map)), ("t_c3", list(c3)),
        ("t_pair_a", [int(x) for x in sys.cpair_a.tolist()]),
        ("t_pair_b", [int(x) for x in sys.cpair_b.tolist()]),
        ("t_owner", [x for o in owners for x in o]),
        ("t_row_owner", row_owner), ("t_row_f", row_f)]
    t_off, _ = _pack([(k, len(v)) for k, v in tables])
    c_off, _ = _pack(_const_sections(sys, len(dofrows)))
    nslot = slot
    # the selections' sort keys (two elements each): the condim-3 points',
    # and two lists of Kp per team member (the merge's source and
    # destination)
    w_off, w_elems = _pack([
        ("w_keys", 2 * (len(c3) + 2 * MAX_TEAM * Kp)), ("w_cp", 4 * sys.ncp),
        ("w_slot", SLOT_VALS * nslot), ("w_cdof", 6 * nv), ("w_qvel", nv),
        ("w_qacc", nv)])
    i_off, i_elems = _pack([("i_slot_pt", max(nslot, 1)),
                            ("i_slot_mask", 2 * nslot)])
    fields = dict(nv=nv, nq=sys.nq, nbody=nb, ncp=sys.ncp, npair=npair,
                  nc3=len(c3), K=K if select else 0, Kp=Kp, nslot=nslot,
                  ndofrow=ndofrow, nowner=len(owners), nefc=nefc,
                  elliptic=int(elliptic),
                  ntopo=sum(len(v) for _, v in tables),
                  ncst=sum(n for _, n in _const_sections(sys, len(dofrows))),
                  w_elems=w_elems, i_elems=i_elems,
                  **t_off, **c_off, **w_off, **i_off)
    return Plan(fields, tuple(x for _, v in tables for x in v),
                tuple(groups), mus, tuple(dofrows))


def _const_sections(sys: S.System, ndofrow: int):
    return [
        ("c_cp_pos", 3 * sys.ncp), ("c_cp_radius", sys.ncp),
        ("c_cp_friction", sys.ncp), ("c_cp_frot", 3 * sys.ncp),
        ("c_cp_solref", 2 * sys.ncp), ("c_cp_solimp", 5 * sys.ncp),
        ("c_cp_iw", sys.ncp), ("c_mask", sys.nbody * sys.nv),
        ("c_dofrow", DOFROW_VALS * ndofrow), ("c_impratio", 1),
        ("c_sqrt_impratio", 1)]


def _const_values(sys: S.System, plan: Plan) -> List[torch.Tensor]:
    """The constants in ``_const_sections``' order."""
    like = sys.cpoint_pos
    rows = []
    for d, j in plan.dofrows:
        if j is None:
            rows.append(torch.cat([sys.dof_solref[d], sys.dof_solimp[d],
                                   sys.dof_invweight[d:d + 1],
                                   sys.dof_frictionloss[d:d + 1],
                                   like.new_zeros(2)]))
        else:
            rows.append(torch.cat([sys.jnt_solref[j], sys.jnt_solimp[j],
                                   sys.dof_invweight[d:d + 1],
                                   like.new_zeros(1), sys.jnt_range[j]]))
    bodyid = S.index_tensor(sys.cpoint_bodyid, like.device)
    return [sys.cpoint_pos, sys.cpoint_radius, sys.cpoint_friction,
            solver._friction_rot(sys, like), sys.cpoint_solref,
            sys.cpoint_solimp, sys.body_invweight[bodyid, 0],
            sys.body_dof_mask] + rows + [
        torch.tensor([sys.impratio, math.sqrt(sys.impratio)],
                     dtype=like.dtype)]


class Tables(NamedTuple):
    topo: torch.Tensor   # int32, on the device
    cst: torch.Tensor    # the model constants, on the device
    pcst: torch.Tensor   # (npair, 8): friction, solref, solimp per pair


@functools.lru_cache(maxsize=None)
def tables(sys: S.System, lay: Optional[arrow.ArrowLayout],
           dtype: torch.dtype, device: torch.device) -> Tables:
    """The static tables of a model on ``device`` (made once; never inside
    a captured step, whose warm-up call makes them)."""
    plan = model_plan(sys, lay)
    topo = torch.tensor(plan.topo, dtype=torch.int32).to(device)
    cst = torch.cat([v.reshape(-1).to(device=device, dtype=dtype)
                     for v in _const_values(sys, plan)])
    pcst = torch.cat([sys.cpair_friction.reshape(-1, 1),
                      sys.cpair_solref.reshape(-1, 2),
                      sys.cpair_solimp.reshape(-1, 5)], dim=1)
    return Tables(topo, cst, pcst.to(device=device, dtype=dtype).contiguous())


@dataclasses.dataclass(frozen=True)
class Geometry:
    """``envs_per_block`` warps of one env each per block, after
    ``tables`` bytes of the block's staged tables."""

    envs_per_block: int
    smem_bytes: int
    tables: int


def table_bytes(fields: Dict[str, int], itemsize: int) -> int:
    """Shared memory of a block's copy of the tables (assemble.cu
    ``table_bytes``): the constants and the topology, each padded to 16
    bytes."""
    return (-(-fields["ncst"] * itemsize // 16) * 16
            + -(-fields["ntopo"] * 4 // 16) * 16)


def geometry(fields: Dict[str, int], itemsize: int) -> Geometry:
    """The launch geometry: the envs per block (1 to ENVS_PER_BLOCK) that
    let the most envs reside on an SM at once, more per block on a tie."""
    tab = table_bytes(fields, itemsize)
    env = fields["w_elems"] * itemsize + fields["i_elems"] * 4
    best = None
    for e in range(1, ENVS_PER_BLOCK + 1):
        smem = tab + e * env
        if smem > MAX_SMEM:
            break
        resident = SM_SMEM // (smem + BLOCK_RESERVED) * e
        if best is None or resident >= best[0]:
            best = (resident, e, smem)
    if best is None:
        raise ValueError(f"the assemble kernel keeps one env in shared "
                         f"memory: {env} bytes and {tab} of tables, more "
                         f"than {MAX_SMEM}")
    return Geometry(best[1], best[2], tab)


def _uses(sys: S.System) -> Tuple[bool, bool]:
    use_newton = sys.solver_type in (S.SOLVER_CG, S.SOLVER_NEWTON)
    return use_newton, use_newton and sys.cone == S.ELLIPTIC


def _outputs(sys: S.System, plan: Plan, N: int, dtype, device,
             legs: bool) -> Dict[str, Optional[torch.Tensor]]:
    """The kernel's outputs by name (``OUTS``), None where the model or
    the call takes none."""
    f = plan.fields
    ncp, nefc, nslot = f["ncp"], f["nefc"], f["nslot"]
    use_newton, elliptic = _uses(sys)

    def empty(*shape, dt=dtype):
        return torch.empty((N,) + shape, dtype=dt, device=device)

    o = dict.fromkeys(OUTS)
    o.update(center=empty(ncp, 3), pos=empty(ncp, 3), dist=empty(ncp),
             active=empty(ncp, dt=torch.bool), J=empty(nefc, f["nv"]),
             **{k: empty(nefc) for k in ("aref", "R", "lo", "hi", "b")})
    if f["K"]:
        o["sel3"] = empty(f["K"], dt=torch.long)
    if f["Kp"]:
        for k in ("pair_sel", "pair_a", "pair_b"):
            o[k] = empty(f["Kp"], dt=torch.long)
    if legs:
        o.update(leg1=empty(nefc, dt=torch.int32),
                 leg2=empty(nefc, dt=torch.int32),
                 has1=empty(nefc, dt=torch.bool),
                 has2=empty(nefc, dt=torch.bool))
    if use_newton:
        o.update(quad_active=empty(nefc, dt=torch.bool), fl=empty(nefc))
    if elliptic:
        o.update(cone_mu=empty(nslot), cone_mus=empty(plan.nmus),
                 cone_active=empty(nslot, dt=torch.bool))
    return o


def _result(sys: S.System, plan: Plan, o: Dict[str, Optional[torch.Tensor]],
            N: int) -> AssembleOut:
    f = plan.fields
    con = collision.Contacts(o["pos"], o["dist"], o["active"], None,
                             o["center"], None)
    rows = None
    if f["nefc"]:
        use_newton, elliptic = _uses(sys)
        groups, cones = [], []
        off, s0, m0 = f["ndofrow"], 0, 0
        spans = [(pts, d, nf) for pts, d, nf in plan.groups]
        if f["Kp"]:
            spans.append(("pairs", 3, 3 if elliptic else 4))
        for pts, d, nf in spans:
            n = (f["K"] if pts is None else f["Kp"] if pts == "pairs"
                 else len(pts))
            if pts != "pairs":
                groups.append((o["sel3"] if pts is None else S.index_tensor(
                    pts, o["J"].device).expand(N, -1), nf))
            if elliptic:
                cones.append(newton.ConeGroup(
                    off, d, o["cone_mu"][:, s0:s0 + n],
                    o["cone_mus"][:, m0:m0 + n * (d - 1)].unflatten(
                        1, (n, d - 1)),
                    o["cone_active"][:, s0:s0 + n]))
            off, s0, m0 = off + n * nf, s0 + n, m0 + n * (d - 1)
        efc = solver.Efc(o["J"], o["aref"], o["R"], o["lo"], o["hi"])
        nefc = None
        if use_newton:
            nefc = newton.NewtonEfc(
                o["J"], o["aref"], o["R"], o["quad_active"], o["fl"],
                tuple(cones), (o["cone_mu"], o["cone_active"], o["cone_mus"])
                if elliptic else None)
        legmeta = None
        if o["leg1"] is not None:
            legmeta = solver.LegMeta(o["leg1"], o["leg2"], o["has1"],
                                     o["has2"])
        rows = solver.Rows(efc, o["b"], f["ndofrow"], nefc, tuple(groups),
                           (o["pair_a"], o["pair_b"]) if f["Kp"] else None,
                           legmeta)
    return AssembleOut(con, o["sel3"], o["pair_sel"], o["pair_a"],
                       o["pair_b"], rows)


def _inputs(sys: S.System, xpos, xquat, subtree_com, cdof, qpos, qvel,
            qacc_smooth) -> List[torch.Tensor]:
    """The kernel's operands: shapes, dtype and device checked,
    contiguous."""
    N, dt, dev = qvel.shape[0], qvel.dtype, qvel.device
    nb, nv = sys.nbody, sys.nv
    xs = []
    for name, x, shape in (("xpos", xpos, (N, nb, 3)),
                           ("xquat", xquat, (N, nb, 4)),
                           ("subtree_com", subtree_com, (N, nb, 3)),
                           ("cdof", cdof, (N, nv, 6)),
                           ("qpos", qpos, (N, sys.nq)),
                           ("qvel", qvel, (N, nv)),
                           ("qacc_smooth", qacc_smooth, (N, nv))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.device != dev or x.dtype != dt:
            raise ValueError("the assemble kernel's operands must share one "
                             "device and one dtype")
        xs.append(x.contiguous())
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"the assemble kernel takes float32 or float64, "
                         f"not {dt}")
    return xs


@functools.lru_cache(maxsize=None)
def layout(sys: S.System, lay: Optional[arrow.ArrowLayout],
           host: bool = False) -> ctypes.Array:
    """The model's ``Layout`` (a ctypes int array) for the card's library
    or the host driver, its fields in the order the library names them
    (``assemble_layout_names``)."""
    lib = build.load_host("assemble_host") if host else build.load("assemble")
    names = lib.assemble_layout_names
    names.restype = ctypes.c_char_p
    keys = [k for k in names().decode().split(",") if k]
    fields = model_plan(sys, lay).fields
    return (ctypes.c_int * len(keys))(*[fields[k] for k in keys])


def _pointers(xs, o) -> Tuple[ctypes.Array, ctypes.Array]:
    ins = (ctypes.c_void_p * len(xs))(*[x.data_ptr() for x in xs])
    outs = (ctypes.c_void_p * len(OUTS))(
        *[None if o[k] is None else o[k].data_ptr() for k in OUTS])
    return ins, outs


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
             + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2)


@functools.lru_cache(maxsize=None)
def _kernel_fn(dtype: torch.dtype):
    lib = build.load("assemble")
    fn = getattr(lib, "assemble_f32" if dtype == torch.float32
                 else "assemble_f64")
    fn.argtypes = _ARGTYPES + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rows(sys: S.System, lay: Optional[arrow.ArrowLayout], xpos, xquat,
         subtree_com, cdof, qpos, qvel, qacc_smooth) -> AssembleOut:
    """Collision and row assembly of a substep: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  The rows' leg slots are
    made where the solve runs the legs form (``solver.legs_form``)."""
    plan = model_plan(sys, lay)
    geo = geometry(plan.fields, qvel.element_size())
    dev = qvel.device
    legs = solver.legs_form(sys, lay, qvel.dtype, dev)
    if dev.type == "cpu":
        return plain(sys, lay, xpos, xquat, subtree_com, cdof, qpos, qvel,
                     qacc_smooth, legs=legs)
    xs = _inputs(sys, xpos, xquat, subtree_com, cdof, qpos, qvel, qacc_smooth)
    if dev.type != "cuda":
        raise ValueError(f"rows runs on cpu or cuda, not {dev}")
    N = qvel.shape[0]
    o = _outputs(sys, plan, N, qvel.dtype, dev, legs)
    if N == 0 or plan.fields["nefc"] == 0:
        return _result(sys, plan, o, N)
    tab = tables(sys, lay, qvel.dtype, dev)
    ins, outs = _pointers(xs, o)
    lt = layout(sys, lay)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel_fn(qvel.dtype)(
            lt, len(lt), tab.topo.data_ptr(), tab.cst.data_ptr(),
            tab.pcst.data_ptr(), ins, len(xs), outs, len(OUTS), N,
            geo.envs_per_block, geo.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"assemble kernel launch failed: cudaError_t {err}")
    _counted.launches += 1
    return _result(sys, plan, o, N)


rows.launches = 0
_counted = rows  # counts on, where a caller wraps the module's name


def envs_per_sm(geo: Geometry, dtype: torch.dtype) -> int:
    """Envs one SM of the current card holds at once with this geometry
    (CUDA occupancy query; needs the card)."""
    fn = build.load("assemble").assemble_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(torch.finfo(dtype).bits // 8, geo.envs_per_block,
             geo.smem_bytes, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"assemble occupancy query failed: cudaError_t "
                           f"{err}")
    return blocks.value * geo.envs_per_block


def host_rows(sys: S.System, lay: Optional[arrow.ArrowLayout], xpos, xquat,
              subtree_com, cdof, qpos, qvel, qacc_smooth, legs: bool = False,
              team: int = 1) -> AssembleOut:
    """The kernel's per-env arithmetic (``csrc/assemble_env.cuh``) on CPU
    tensors, through the host driver ``csrc/assemble_host.cpp`` built with
    g++: a team of ``team`` threads (1 to 32) splits each env's loops as
    the kernel's warp lanes do, the envs in series; the leg slots where
    ``legs``.  For the tests; raises RuntimeError where g++ is missing."""
    if not 1 <= team <= MAX_TEAM:
        raise ValueError(f"host_rows runs teams of 1 to {MAX_TEAM}, not {team}")
    plan = model_plan(sys, lay)
    geometry(plan.fields, qvel.element_size())
    xs = _inputs(sys, xpos, xquat, subtree_com, cdof, qpos, qvel, qacc_smooth)
    if qvel.device.type != "cpu":
        raise ValueError("host_rows takes CPU tensors")
    N = qvel.shape[0]
    o = _outputs(sys, plan, N, qvel.dtype, qvel.device, legs)
    if N == 0 or plan.fields["nefc"] == 0:
        return _result(sys, plan, o, N)
    tab = tables(sys, lay, qvel.dtype, qvel.device)
    ins, outs = _pointers(xs, o)
    lt = layout(sys, lay, host=True)
    lib = build.load_host("assemble_host")
    fn = getattr(lib, "assemble_host_f32" if qvel.dtype == torch.float32
                 else "assemble_host_f64")
    fn.argtypes = _ARGTYPES + [ctypes.c_int]
    fn.restype = ctypes.c_int
    err = fn(lt, len(lt), tab.topo.data_ptr(), tab.cst.data_ptr(),
             tab.pcst.data_ptr(), ins, len(xs), outs, len(OUTS), N, team)
    if err != 0:
        raise RuntimeError(f"assemble host driver refused its arguments "
                           f"({err})")
    return _result(sys, plan, o, N)
