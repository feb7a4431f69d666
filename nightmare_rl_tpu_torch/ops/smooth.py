"""The smooth half of a physics substep as one CUDA kernel per call.

``smooth_forward`` computes what the start of ``physics/pipeline.py::
forward`` computes before collision (the port of the JAX package's compiled
``nightmare_rl_tpu/physics/pipeline.py:59-82``): kinematics, com_vel, the
CRB mass matrix, the RNE bias, actuation and passive forces, qfrc_smooth
and, where the model has a block-arrow layout, the arrow factor and
qacc_smooth.  CPU tensors go to the plain version ``plain`` (the port's
``kinematics``, ``dynamics`` and ``arrow`` functions, looked up at call
time), CUDA tensors to the kernel ``csrc/smooth.cu`` (one warp per env; its
per-env arithmetic is ``csrc/smooth_env.cuh``).  A model the kernel does
not take (a BALL joint, a body before its parent, a workspace beyond a
block's shared memory) is refused on every device; on the card a failed
build or launch raises.  ``smooth_forward.launches`` counts kernel
launches.

The static tables are made once per (System, layout, dtype, device) and
cached, so a captured step never builds them: one int32 tensor of the
topology (parents, joints, the chains and rounds of the tree walks, each
body's children in descending order, the dof ancestor mask, the
actuators' transmissions) and one float tensor of the model constants.
Every offset into them and into an env's shared-memory workspace is a
field of the kernels' ``Layout`` (``smooth_env.cuh``), passed by value;
the fields are filled by the names the library reports, so the Python and
C++ sides cannot disagree on their order.  ``ops/integrate.py`` shares
the plan and the tables.

``host_forward`` runs the same per-env arithmetic on the CPU through the
host driver ``csrc/smooth_host.cpp`` (built with g++), for the tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from nightmare_rl_tpu_torch.ops import build
from nightmare_rl_tpu_torch.physics import arrow, dynamics, kinematics
from nightmare_rl_tpu_torch.physics import system as S

MAX_SMEM = 227 * 1024    # dynamic shared memory of one block on an H100
ENVS_PER_BLOCK = 8       # warps (one env each) per block, at most
NBASE = 6                # the free base of a block-arrow layout
MAX_BLOCK = 3            # dofs of a leg block (smooth_env.cuh kMaxBlock)
_UPDATE = {"euler": 0, "implicitfast": 1, "euler_damped": 2}


class SmoothOut(NamedTuple):
    kin: kinematics.KinOut
    vel: kinematics.VelOut
    M: torch.Tensor
    act: dynamics.ActOut
    qfrc_smooth: torch.Tensor
    fac: Optional[arrow.ArrowFac]      # None without a block-arrow layout
    qacc_smooth: Optional[torch.Tensor]


def plain(sys: S.System, lay: Optional[arrow.ArrowLayout], qpos: torch.Tensor,
          qvel: torch.Tensor, ctrl: torch.Tensor) -> SmoothOut:
    """The plain version: the port's functions, one statement per body."""
    kin = kinematics.kinematics(sys, qpos)
    vel = kinematics.com_vel(sys, kin, qvel)
    M = dynamics.crb(sys, kin)
    bias = dynamics.rne_bias(sys, kin, vel, qvel)
    act = dynamics.actuation(sys, qpos, qvel, ctrl)
    qfrc_smooth = act.qfrc_actuator + dynamics.passive(sys, qvel) - bias
    if lay is None:
        return SmoothOut(kin, vel, M, act, qfrc_smooth, None, None)
    fac = arrow.factor(lay, M)
    return SmoothOut(kin, vel, M, act, qfrc_smooth, fac,
                     arrow.solve_vec(lay, fac, qfrc_smooth))


def _pack(sections: List[Tuple[str, int]]) -> Tuple[Dict[str, int], int]:
    """Offsets of consecutive sections and their total, rounded up to 4."""
    off, total = {}, 0
    for name, n in sections:
        off[name] = total
        total += n
    return off, (total + 3) & ~3


@dataclasses.dataclass(frozen=True)
class Plan:
    """A model's static layout for the kernels: the ``Layout`` fields by
    name, and the int32 topology table's contents."""

    fields: Dict[str, int]
    topo: Tuple[int, ...]
    update: str


@functools.lru_cache(maxsize=None)
def model_plan(sys: S.System, lay: Optional[arrow.ArrowLayout]) -> Plan:
    """The plan of a model (read once per System and layout: the ancestor
    mask and the actuators' limits come to the host here); raises
    ValueError for a model the kernels do not take."""
    nb, nj, nv, nq, nu = sys.nbody, sys.njnt, sys.nv, sys.nq, sys.nu
    for j, jt in enumerate(sys.jnt_type):
        if jt not in (S.FREE, S.HINGE, S.SLIDE):
            raise ValueError(f"the smooth kernel takes free, hinge and slide "
                             f"joints, not type {jt} (joint {j})")
    parent = list(sys.body_parent)
    if any(not 0 <= parent[b] < b for b in range(1, nb)):
        raise ValueError("the smooth kernel needs every body after its parent")
    if lay is not None and lay.nbase != NBASE:
        raise ValueError(f"the smooth kernel takes a {NBASE}-dof arrow base")
    if lay is not None and lay.branch_size > MAX_BLOCK:
        raise ValueError(f"the smooth kernel takes leg blocks of at most "
                         f"{MAX_BLOCK} dofs, not {lay.branch_size}")
    depth = [0] * nb
    for b in range(1, nb):
        depth[b] = depth[parent[b]] + 1
    children = [sorted((c for c in range(1, nb) if parent[c] == p),
                       reverse=True) for p in range(nb)]
    child_start = [0]
    for p in range(nb):
        child_start.append(child_start[-1] + len(children[p]))
    chains = _chains(parent, children)
    rounds = [c[0] for c in chains]
    round_start = [sum(1 for rd in rounds if rd < k)
                   for k in range(max(rounds, default=-1) + 2)]
    mask = [[int(v != 0) for v in row]
            for row in sys.dof_ancestor_mask.cpu().tolist()]
    trn = sys.actuator_trnid
    act_dof = [sys.jnt_dofadr[j] for j in trn]
    dof_act = [[u for u in range(nu) if act_dof[u] == d] for d in range(nv)]
    if sys.integrator == S.IMPLICITFAST:
        update = "implicitfast"
    elif bool(sys.eulerdamp) and bool((sys.dof_damping.cpu() > 0).any()):
        update = "euler_damped"
    else:
        update = "euler"
    tables = [
        ("t_parent", parent), ("t_jntadr", list(sys.body_jntadr)),
        ("t_jntnum", list(sys.body_jntnum)),
        ("t_root", kinematics.body_root(sys)),
        ("t_round_start", round_start),
        ("t_chain_start", [sum(len(c[1]) for c in chains[:k])
                           for k in range(len(chains) + 1)]),
        ("t_chain_body", [b for c in chains for b in c[1]]),
        ("t_child_start", child_start),
        ("t_child", [c for p in range(nb) for c in children[p]]),
        ("t_jtype", list(sys.jnt_type)), ("t_qadr", list(sys.jnt_qposadr)),
        ("t_dadr", list(sys.jnt_dofadr)), ("t_jbody", list(sys.jnt_bodyid)),
        ("t_dof_body", list(sys.dof_bodyid)),
        ("t_mask", [mask[i][j] + 2 * mask[j][i] for i in range(nv)
                    for j in range(nv)]),
        ("t_act_dof", act_dof),
        ("t_act_qadr", [sys.jnt_qposadr[j] for j in trn]),
        ("t_act_ctrllim",
         [int(v) for v in sys.actuator_ctrllimited.cpu().tolist()]),
        ("t_act_forcelim",
         [int(v) for v in sys.actuator_forcelimited.cpu().tolist()]),
        ("t_dof_act_start", [sum(len(x) for x in dof_act[:d])
                             for d in range(nv + 1)]),
        ("t_dof_act", [u for x in dof_act for u in x]),
    ]
    t_off, _ = _pack([(k, len(v)) for k, v in tables])
    c_off, _ = _pack(_const_sections(sys))
    ntopo = sum(len(v) for _, v in tables)
    ncst = sum(n for _, n in _const_sections(sys))
    B, s = (lay.nbranch, lay.branch_size) if lay is not None else (0, 0)
    # the Schur complement S, its pivot and a column of its factor
    arrow_ws = NBASE * NBASE + NBASE + 1 if B else 0
    w_off, w_elems = _pack([
        ("w_xpos", 3 * nb), ("w_xquat", 4 * nb), ("w_xipos", 3 * nb),
        ("w_ximat", 9 * nb), ("w_xanchor", 3 * nj), ("w_xaxis", 3 * nj),
        ("w_sub_mass", nb), ("w_sub_mom", 3 * nb), ("w_subtree_com", 3 * nb),
        ("w_cinert", 36 * nb), ("w_cdof", 6 * nv), ("w_cvel", 6 * nb),
        ("w_cdof_dot", 6 * nv), ("w_F", 6 * nv),
        ("w_M", nv * nv), ("w_cacc", 6 * nb), ("w_cfrc", 6 * nb),
        ("w_force", nu), ("w_qfrc_act", nv), ("w_bias", nv), ("w_qfrc", nv),
        ("w_qpos", nq), ("w_qvel", nv), ("w_A", arrow_ws),
        ("w_Ld", B * s * s), ("w_W", B * s * NBASE),
        ("w_Ls", NBASE * NBASE if B else 0), ("w_y", B * s),
        ("w_x", nv if B else 0), ("w_ctrl", nu)])
    u_off, u_elems = _pack([
        ("u_M", nv * (nv + 1)), ("u_A", arrow_ws), ("u_Ld", B * s * s),
        ("u_W", B * s * NBASE), ("u_Ls", NBASE * NBASE if B else 0),
        ("u_rhs", nv), ("u_y", B * s), ("u_x", nv), ("u_qpos", nq),
        ("u_qvel", nv), ("u_qfrc", nv), ("u_qacc", nv), ("u_qvel0", nv),
        ("u_qpos0", nq)])
    fields = dict(nbody=nb, njnt=nj, nv=nv, nq=nq, nu=nu,
                  nlevel=max(depth) + 1, nround=len(round_start) - 1,
                  ntopo=ntopo, ncst=ncst,
                  nbranch=B, bsize=s, update=_UPDATE[update], w_elems=w_elems,
                  u_elems=u_elems, **t_off, **c_off, **w_off, **u_off)
    return Plan(fields, tuple(x for _, v in tables for x in v), update)


def _chains(parent: List[int], children: List[List[int]]) -> List[tuple]:
    """The tree walks' chains as (round, bodies top-down), by round and
    head: a chain runs down from its head through bodies with one child
    each and ends at a leaf or at a body with two or more children, each of
    which heads a chain of the next round; round 0's heads are the world's
    children."""
    out, heads = [], [(0, c) for c in sorted(children[0])]
    while heads:
        nxt = []
        for rd, b in heads:
            bodies = [b]
            while len(children[b]) == 1:
                b = children[b][0]
                bodies.append(b)
            out.append((rd, bodies))
            nxt += [(rd + 1, c) for c in sorted(children[b])]
        heads = nxt
    out.sort(key=lambda c: (c[0], c[1][0]))
    return out


def _const_sections(sys: S.System):
    return [
        ("c_body_pos", 3 * sys.nbody), ("c_body_quat", 4 * sys.nbody),
        ("c_body_ipos", 3 * sys.nbody), ("c_body_iquat", 4 * sys.nbody),
        ("c_mass", sys.nbody), ("c_inertia", 3 * sys.nbody),
        ("c_jnt_axis", 3 * sys.njnt), ("c_jnt_pos", 3 * sys.njnt),
        ("c_damping", sys.nv), ("c_armature", sys.nv), ("c_gravity", 3),
        ("c_gear", sys.nu), ("c_gain", sys.nu), ("c_bias", 3 * sys.nu),
        ("c_ctrlrange", 2 * sys.nu), ("c_forcerange", 2 * sys.nu),
        ("c_qpos0", sys.nq), ("c_dt", 1), ("c_vel_deriv", sys.nv)]


def _const_values(sys: S.System) -> List[torch.Tensor]:
    """The constants in ``_const_sections``' order."""
    return [sys.body_pos, sys.body_quat, sys.body_ipos, sys.body_iquat,
            sys.body_mass, sys.body_inertia, sys.jnt_axis, sys.jnt_pos,
            sys.dof_damping, sys.dof_armature, sys.gravity,
            sys.actuator_gear, sys.actuator_gainprm, sys.actuator_biasprm,
            sys.actuator_ctrlrange, sys.actuator_forcerange, sys.qpos0,
            sys.timestep,
            dynamics.actuator_vel_deriv(sys, sys.dof_damping)]


class Tables(NamedTuple):
    topo: torch.Tensor    # int32, on the device
    cst: torch.Tensor     # the model constants, on the device
    vel_deriv: torch.Tensor  # (nv,), a view of cst


@functools.lru_cache(maxsize=None)
def tables(sys: S.System, lay: Optional[arrow.ArrowLayout],
           dtype: torch.dtype, device: torch.device) -> Tables:
    """The static tables of a model on ``device`` (made once; never inside
    a captured step, whose warm-up call makes them)."""
    plan = model_plan(sys, lay)
    topo = torch.tensor(plan.topo, dtype=torch.int32).to(device)
    cst = torch.cat([v.reshape(-1).to(device=device, dtype=dtype)
                     for v in _const_values(sys)])
    off = plan.fields["c_vel_deriv"]
    return Tables(topo, cst, cst[off:off + sys.nv])


@dataclasses.dataclass(frozen=True)
class Geometry:
    """``envs_per_block`` warps of one env each per block, each env taking
    ``env_elems`` elements of shared memory, after ``tables`` bytes of the
    block's staged tables."""

    envs_per_block: int
    env_elems: int
    smem_bytes: int
    tables: int = 0


def table_bytes(fields: Dict[str, int], itemsize: int) -> int:
    """Shared memory of a block's copy of the model's tables (smooth.cu
    ``table_bytes``): the constants and the topology, each padded to 16
    bytes."""
    return (-(-fields["ncst"] * itemsize // 16) * 16
            + -(-fields["ntopo"] * 4 // 16) * 16)


def geometry(elems: int, itemsize: int, what: str,
             tables: int = 0) -> Geometry:
    envs = min(ENVS_PER_BLOCK, (MAX_SMEM - tables) // (elems * itemsize))
    if envs < 1:
        raise ValueError(f"the {what} kernel keeps one env in shared memory: "
                         f"{elems * itemsize} bytes and {tables} of tables, "
                         f"more than {MAX_SMEM}")
    return Geometry(envs, elems, tables + envs * elems * itemsize, tables)


def kernel_geometry(fields: Dict[str, int], itemsize: int,
                    what: str) -> Geometry:
    """The launch geometry of the ``smooth`` kernel (the block's copy of the
    tables, then its envs' workspaces) or of the ``integrate`` kernel (its
    envs' workspaces)."""
    if what == "smooth":
        return geometry(fields["w_elems"], itemsize, what,
                        table_bytes(fields, itemsize))
    return geometry(fields["u_elems"], itemsize, what)


def _outputs(sys: S.System, lay, N: int, dtype, device) -> List[torch.Tensor]:
    """Kernel 1's outputs, in ``smooth_env::Out``'s order."""
    nb, nj, nv = sys.nbody, sys.njnt, sys.nv
    B, s = (lay.nbranch, lay.branch_size) if lay is not None else (0, 0)
    shapes = [(nb, 3), (nb, 4), (nb, 3), (nb, 3, 3), (nj, 3), (nj, 3), (nb, 3),
              (nb, 6, 6), (nv, 6), (nb, 6), (nv, 6), (nv, nv), (nv,),
              (sys.nu,), (nv,), (B, s, s), (B, s, NBASE), (NBASE, NBASE),
              (B, s, NBASE), (nv,)]
    return [torch.empty((N,) + sh, dtype=dtype, device=device) for sh in shapes]


def _result(lay, outs: List[torch.Tensor], vel_deriv) -> SmoothOut:
    (xpos, xquat, xipos, ximat, xanchor, xaxis, com, cinert, cdof, cvel,
     cdof_dot, M, qfrc_act, force, qfrc, Ld, W, Ls, C, qacc) = outs
    kin = kinematics.KinOut(xpos, xquat, xipos, ximat, xanchor, xaxis, com,
                            cinert, cdof)
    act = dynamics.ActOut(qfrc_act, force, vel_deriv.expand_as(qfrc_act))
    fac = arrow.ArrowFac(Ld, W, Ls, C) if lay is not None else None
    return SmoothOut(kin, kinematics.VelOut(cvel, cdof_dot), M, act, qfrc,
                     fac, qacc if lay is not None else None)


def _inputs(sys: S.System, qpos, qvel, ctrl):
    """The kernels' operands: shapes checked, contiguous, ctrl in qpos's
    dtype (the plain version's actuation promotes it so)."""
    N, dt = qpos.shape[0], qpos.dtype
    for name, x, shape in (("qpos", qpos, (N, sys.nq)),
                           ("qvel", qvel, (N, sys.nv)),
                           ("ctrl", ctrl, (N, sys.nu))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.device != qpos.device:
            raise ValueError("smooth_forward's operands must share one device")
    if dt not in (torch.float32, torch.float64) or qvel.dtype != dt:
        raise ValueError(f"the smooth kernel takes float32 or float64 qpos "
                         f"and qvel of one dtype, not {dt} and {qvel.dtype}")
    return qpos.contiguous(), qvel.contiguous(), ctrl.to(dt).contiguous()


@functools.lru_cache(maxsize=None)
def _kernel_fn(dtype: torch.dtype):
    lib = build.load("smooth")
    fn = getattr(lib, "smooth_f32" if dtype == torch.float32 else "smooth_f64")
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def layout(sys: S.System, lay: Optional[arrow.ArrowLayout],
           host: bool = False) -> ctypes.Array:
    """The model's ``Layout`` (a ctypes int array) for the card's libraries
    or the host driver, its fields in the order the library names them
    (``smooth_layout_names``)."""
    lib = build.load_host("smooth_host") if host else build.load("smooth")
    names = lib.smooth_layout_names
    names.restype = ctypes.c_char_p
    keys = [k for k in names().decode().split(",") if k]
    fields = model_plan(sys, lay).fields
    return (ctypes.c_int * len(keys))(*[fields[k] for k in keys])


def smooth_forward(sys: S.System, lay: Optional[arrow.ArrowLayout],
                   qpos: torch.Tensor, qvel: torch.Tensor,
                   ctrl: torch.Tensor) -> SmoothOut:
    """The smooth half of ``pipeline.forward``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    plan = model_plan(sys, lay)
    geo = kernel_geometry(plan.fields, qpos.element_size(), "smooth")
    dev = qpos.device
    if dev.type == "cpu":
        return plain(sys, lay, qpos, qvel, ctrl)
    qpos, qvel, ctrl = _inputs(sys, qpos, qvel, ctrl)
    if dev.type != "cuda":
        raise ValueError(f"smooth_forward runs on cpu or cuda, not {dev}")
    N = qpos.shape[0]
    tab = tables(sys, lay, qpos.dtype, dev)
    outs = _outputs(sys, lay, N, qpos.dtype, dev)
    if N == 0:
        return _result(lay, outs, tab.vel_deriv)
    ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    lt = layout(sys, lay)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel_fn(qpos.dtype)(
            lt, len(lt), tab.topo.data_ptr(), tab.cst.data_ptr(),
            qpos.data_ptr(), qvel.data_ptr(), ctrl.data_ptr(), ptrs,
            len(outs), N, geo.envs_per_block, geo.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"smooth kernel launch failed: cudaError_t {err}")
    _counted.launches += 1
    return _result(lay, outs, tab.vel_deriv)


smooth_forward.launches = 0
_counted = smooth_forward  # counts on, where a caller wraps the module's name


def envs_per_sm(geo: Geometry, dtype: torch.dtype, name: str = "smooth") -> int:
    """Envs one SM of the current card holds at once with this geometry
    (CUDA occupancy query; needs the card)."""
    fn = getattr(build.load(name), f"{name}_blocks_per_sm")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(torch.finfo(dtype).bits // 8, geo.envs_per_block,
             geo.smem_bytes, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{name} occupancy query failed: cudaError_t {err}")
    return blocks.value * geo.envs_per_block


def host_forward(sys: S.System, lay: Optional[arrow.ArrowLayout],
                 qpos: torch.Tensor, qvel: torch.Tensor, ctrl: torch.Tensor,
                 team: int = 1) -> SmoothOut:
    """The kernel's per-env arithmetic (``csrc/smooth_env.cuh``) on CPU
    tensors, through the host driver ``csrc/smooth_host.cpp`` built with
    g++: a team of ``team`` threads (1 to 64) splits each env's loops as
    the kernel's warp lanes do, the envs in series.  For the tests; raises
    RuntimeError where g++ is missing."""
    plan = model_plan(sys, lay)
    kernel_geometry(plan.fields, qpos.element_size(), "smooth")
    qpos, qvel, ctrl = _inputs(sys, qpos, qvel, ctrl)
    if qpos.device.type != "cpu":
        raise ValueError("host_forward takes CPU tensors")
    N = qpos.shape[0]
    tab = tables(sys, lay, qpos.dtype, qpos.device)
    outs = _outputs(sys, lay, N, qpos.dtype, qpos.device)
    ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    lt = layout(sys, lay, host=True)
    lib = build.load_host("smooth_host")
    fn = getattr(lib, "smooth_host_f32" if qpos.dtype == torch.float32
                 else "smooth_host_f64")
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 3)
    fn.restype = ctypes.c_int
    err = fn(lt, len(lt), tab.topo.data_ptr(), tab.cst.data_ptr(),
             qpos.data_ptr(), qvel.data_ptr(), ctrl.data_ptr(), ptrs,
             len(outs), N, team)
    if err != 0:
        raise RuntimeError(f"smooth host driver refused its arguments ({err})")
    return _result(lay, outs, tab.vel_deriv)
