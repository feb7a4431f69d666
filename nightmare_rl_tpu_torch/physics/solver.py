"""Constraint assembly + PGS solve (+ noslip), MuJoCo semantics: the PGS /
pyramidal-cone branch of ``nightmare_rl_tpu/physics/solver.py``.

Row families: dof friction rows (|f| ≤ frictionloss), joint-limit rows and
pyramidal contact rows (condim 3 → 4 facets, J = Jn ± μ·Jt_i, f ≥ 0), in
MuJoCo's order: friction, limits, contacts, then pair contacts.  Reference
acceleration aref = -B·(J·qvel) - K·imp·pos from solref/solimp,
regularization R from MuJoCo's diag-approximation, then the dual PGS
(``ops/pgs.py``) with box bounds [lo, hi] per row and the noslip pass on the
contact tangent pairs.  Inactive candidate rows stay in the system with
bounds [0, 0], so every env has the same row count.

Not in this port: Newton/CG, elliptic cones, condim > 3 and the leg-sparse
PGS core.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from nightmare_rl_tpu_torch.ops.pgs import pgs
from nightmare_rl_tpu_torch.physics import arrow
from nightmare_rl_tpu_torch.physics import system as S
from nightmare_rl_tpu_torch.physics.collision import (
    Contacts, PairContacts, topk_smallest,
)


class Efc(NamedTuple):
    J: torch.Tensor     # (N, nefc, nv) constraint jacobian
    aref: torch.Tensor  # (N, nefc)
    R: torch.Tensor     # (N, nefc) regularization
    lo: torch.Tensor    # (N, nefc) force lower bound (0 for inactive rows)
    hi: torch.Tensor    # (N, nefc) force upper bound (0 for inactive rows)


_MINIMP, _MAXIMP = 1e-4, 0.9999  # mjMINIMP/mjMAXIMP


def impedance(solimp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """MuJoCo's sigmoid impedance d(pos) from solimp = (d0,dmax,width,mid,pow)."""
    d0, dmax, width, mid, power = solimp.unbind(-1)
    d0 = torch.clamp(d0, _MINIMP, _MAXIMP)
    dmax = torch.clamp(dmax, _MINIMP, _MAXIMP)
    x = torch.clamp(torch.abs(pos) / torch.clamp_min(width, 1e-12), 0.0, 1.0)
    y_lo = (x / torch.clamp_min(mid, 1e-12)) ** (power - 1.0) * x
    y_hi = 1.0 - ((1.0 - x) / torch.clamp_min(1.0 - mid, 1e-12)) ** (
        power - 1.0) * (1.0 - x)
    y = torch.where(x < mid, y_lo, y_hi)
    return d0 + y * (dmax - d0)


def _kb(solref: torch.Tensor, solimp: torch.Tensor):
    """Stiffness/damping from solref (positive convention; the direct
    negative convention gives (-K, -B))."""
    tc, dr = solref[..., 0], solref[..., 1]
    dmax = torch.clamp(solimp[..., 1], _MINIMP, _MAXIMP)
    K = torch.where(tc > 0, 1.0 / torch.clamp_min(dmax * tc * dr, 1e-12) ** 2, -tc)
    B = torch.where(tc > 0, 2.0 / torch.clamp_min(dmax * tc, 1e-12), -dr)
    return K, B


def _contact_R(imp, mu0, iw, impratio) -> torch.Tensor:
    """Pyramidal-row regularization, MuJoCo's diag-approximation:
    R = (1-imp)/imp · 2μ₀²(1+μ₀²)·(iw1+iw2)/impratio."""
    R = ((1.0 - imp) / torch.clamp_min(imp, 1e-12)
         * 2.0 * mu0**2 * (1.0 + mu0**2) * iw / impratio)
    return torch.clamp_min(R, 1e-12)


def _pyramid_rows(Jn, fdirs, mus, dist, active, solref, solimp, iw, impratio,
                  qvel) -> Efc:
    """Pyramid facet rows for a group of n contacts per env.  Jn and each
    fdir: (N, n, nv); mus: matching (N, n) coefficients.  Facet layout per
    point: +d0, -d0, +d1, -d1 (mjData.efc_J's row order)."""
    rows = []
    for mu_i, Ji in zip(mus, fdirs):
        m = mu_i[..., None]
        rows.append(Jn + m * Ji)
        rows.append(Jn - m * Ji)
    J = torch.stack(rows, dim=2)                       # (N, n, nf, nv)
    N, n, nf, nv = J.shape

    imp = impedance(solimp, dist)
    K, B = _kb(solref, solimp)
    vel = torch.einsum("ncfv,nv->ncf", J, qvel)
    aref = -B[..., None] * vel - (K * imp * dist)[..., None]
    R = _contact_R(imp, mus[0], iw, impratio)

    act = torch.repeat_interleave(active, nf, dim=1)
    return Efc(
        J.reshape(N, n * nf, nv),
        aref.reshape(N, n * nf),
        torch.repeat_interleave(R, nf, dim=1),
        torch.zeros_like(act, dtype=J.dtype),
        torch.where(act, torch.inf, 0.0).to(J.dtype),
    )


def _fdirs(jac, mu, condim: int):
    """Friction directions/coefficients for the plane-contact frame
    (mju_makeFrame for n=+z: t1 = (0,1,0), t2 = (-1,0,0)); condim 3 only."""
    if condim != 3:
        raise NotImplementedError(f"condim {condim} contacts are not ported")
    return jac[..., 2], [jac[..., 1], -jac[..., 0]], [mu, mu]


def make_efc(sys: S.System, con: Contacts, qvel: torch.Tensor, iw=None,
             condim: int = 3) -> Efc:
    """Pyramidal contact rows for every candidate point."""
    if iw is None:  # world side contributes 0 invweight
        iw = sys.body_invweight[S.index_tensor(sys.cpoint_bodyid, qvel.device), 0]
    Jn, fdirs, mus = _fdirs(con.jac, sys.cpoint_friction, condim)
    return _pyramid_rows(Jn, fdirs, mus, con.dist, con.active,
                         sys.cpoint_solref, sys.cpoint_solimp, iw,
                         sys.impratio, qvel)


def make_pair_efc(sys: S.System, pc: PairContacts, qvel: torch.Tensor) -> Efc:
    """Pyramid facet rows for the selected body↔body sphere-pair contacts."""
    mu = sys.cpair_friction[pc.sel]                         # (N, K)
    Jn = torch.einsum("nkvd,nkd->nkv", pc.jac, pc.normal)
    Jt1 = torch.einsum("nkvd,nkd->nkv", pc.jac, pc.t1)
    Jt2 = torch.einsum("nkvd,nkd->nkv", pc.jac, pc.t2)
    solimp = sys.cpair_solimp[pc.sel]
    solref = sys.cpair_solref[pc.sel]
    iw_all = sys.body_invweight[:, 0]
    bodyid = S.index_tensor(sys.cpoint_bodyid, qvel.device)
    iw = iw_all[bodyid[pc.a]] + iw_all[bodyid[pc.b]]
    return _pyramid_rows(Jn, [Jt1, Jt2], [mu, mu], pc.dist, pc.active,
                         solref, solimp, iw, sys.impratio, qvel)


@functools.lru_cache(maxsize=None)
def _dof_row_sources(sys: S.System) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Dofs with friction loss and limited hinge joints, read once per System
    (so the step never copies them to the host)."""
    fl = sys.dof_frictionloss.cpu()
    limited = sys.jnt_limited.cpu()
    fric_dofs = tuple(int(d) for d in torch.nonzero(fl > 0).flatten())
    lim_jnts = tuple(j for j in range(sys.njnt)
                     if bool(limited[j]) and sys.jnt_type[j] == S.HINGE)
    return fric_dofs, lim_jnts


def make_dof_efc(sys: S.System, qpos: torch.Tensor,
                 qvel: torch.Tensor) -> Optional[Efc]:
    """Dof-friction and joint-limit rows (friction, then lower limits, then
    upper limits — MuJoCo's efc layout).  None when the model has neither."""
    N, dev, dtype = qvel.shape[0], qvel.device, qvel.dtype
    fric_dofs, lim_jnts = _dof_row_sources(sys)
    if not fric_dofs and not lim_jnts:
        return None

    rows = []
    eye = torch.eye(sys.nv, dtype=dtype, device=dev)
    if fric_dofs:
        d = S.index_tensor(fric_dofs, dev)
        solimp = sys.dof_solimp[d]
        K, B = _kb(sys.dof_solref[d], solimp)
        imp = solimp[:, 0]  # impedance at pos = 0
        R = torch.clamp_min((1.0 - imp) / torch.clamp_min(imp, 1e-12)
                            * sys.dof_invweight[d], 1e-12)
        flv = sys.dof_frictionloss[d]
        rows.append(Efc(eye[d].expand(N, -1, -1), -B * qvel[:, d],
                        R.expand(N, -1), (-flv).expand(N, -1),
                        flv.expand(N, -1)))

    if lim_jnts:
        dofs = S.index_tensor(tuple(sys.jnt_dofadr[j] for j in lim_jnts), dev)
        qadr = S.index_tensor(tuple(sys.jnt_qposadr[j] for j in lim_jnts), dev)
        jl = S.index_tensor(lim_jnts, dev)
        rng = sys.jnt_range[jl]
        solref, solimp = sys.jnt_solref[jl], sys.jnt_solimp[jl]
        q, v = qpos[:, qadr], qvel[:, dofs]
        Jbase = eye[dofs]
        # lower: dist = q - lo, J = +e; upper: dist = hi - q, J = -e
        for sign, dist in ((1.0, q - rng[:, 0]), (-1.0, rng[:, 1] - q)):
            imp = impedance(solimp, dist)
            K, B = _kb(solref, solimp)
            aref = -B * (sign * v) - K * imp * torch.clamp_max(dist, 0.0)
            R = torch.clamp_min((1.0 - imp) / torch.clamp_min(imp, 1e-12)
                                * sys.dof_invweight[dofs], 1e-12)
            rows.append(Efc((sign * Jbase).expand(N, -1, -1), aref, R,
                            torch.zeros_like(aref),
                            torch.where(dist < 0.0, torch.inf, 0.0).to(dtype)))
    return _cat(rows)


def _cat(parts: List[Efc]) -> Efc:
    return Efc(*[torch.cat([getattr(p, f) for p in parts], dim=1)
                 for f in Efc._fields])


class Assembled(NamedTuple):
    """The assembled constraint system plus what is needed to scatter forces
    back to candidate points."""

    efc: Efc
    ns_offset: int
    cparts: List[Tuple[Efc, torch.Tensor, int]]  # (rows, point idx (N, n), nf)


def assemble(sys: S.System, con: Contacts, qpos: torch.Tensor,
             qvel: torch.Tensor, pair: Optional[PairContacts] = None
             ) -> Assembled:
    """Assemble every constraint row as solve_contacts consumes it:
    [dof friction | joint limits | top-K plane-contact facets | pair facets]."""
    condim = sys.cpoint_condim if len(sys.cpoint_condim) else (3,) * sys.ncp
    if any(d != 3 for d in condim):
        raise NotImplementedError("only condim-3 contacts are ported")
    if sys.solver_type != S.SOLVER_PGS or sys.cone != S.PYRAMIDAL:
        raise NotImplementedError("only the PGS solver with pyramidal cones "
                                  "is ported")
    N, dev = qvel.shape[0], qvel.device
    rows_n = torch.arange(N, device=dev)[:, None]
    K = sys.max_contacts
    if 0 < K < sys.ncp:
        sel = topk_smallest(con.dist, K)                    # (N, K)
    else:
        sel = torch.arange(sys.ncp, device=dev).expand(N, -1)
    iw_full = sys.body_invweight[S.index_tensor(sys.cpoint_bodyid, dev), 0]
    Jn, fdirs, mus = _fdirs(con.jac[rows_n, sel], sys.cpoint_friction[sel], 3)
    rows = _pyramid_rows(Jn, fdirs, mus, con.dist[rows_n, sel],
                         con.active[rows_n, sel], sys.cpoint_solref[sel],
                         sys.cpoint_solimp[sel], iw_full[sel], sys.impratio,
                         qvel)
    cparts = [(rows, sel, 4)]
    parts = [rows]
    if pair is not None:
        parts.append(make_pair_efc(sys, pair, qvel))
    efc_d = make_dof_efc(sys, qpos, qvel)
    ns_offset = 0
    if efc_d is not None:
        ns_offset = efc_d.J.shape[1]
        parts.insert(0, efc_d)
    efc = _cat(parts) if len(parts) > 1 else parts[0]
    return Assembled(efc, ns_offset, cparts)


class SolveOut(NamedTuple):
    force: torch.Tensor            # (N, nefc) constraint forces
    qfrc_constraint: torch.Tensor  # (N, nv)
    qacc: torch.Tensor             # (N, nv) constrained acceleration


def solve(sys: S.System, efc: Efc, qacc_smooth: torch.Tensor,
          ns_offset: int, lay: arrow.ArrowLayout,
          fac: arrow.ArrowFac) -> SolveOut:
    """Dual box-PGS from zero with fixed sweeps, then noslip on the contact
    tangent pairs from row ns_offset: the dense matrix-free branch of the JAX
    solver.  M⁻¹ comes from the block-arrow factor and U = J M⁻¹ is one
    batched matmul; the sweeps run in ``ops.pgs.pgs``."""
    b = torch.einsum("nkv,nv->nk", efc.J, qacc_smooth) - efc.aref
    Minv = arrow.inv(lay, fac)
    U = efc.J @ Minv                                        # (N, nefc, nv)
    f = pgs(efc.J, U, b, efc.R, efc.lo, efc.hi, sys.solver_iterations,
            sys.noslip_iterations, ns_offset)
    qfrc = torch.einsum("nkv,nk->nv", efc.J, f)
    qacc = qacc_smooth + torch.einsum("nij,nj->ni", Minv, qfrc)
    return SolveOut(f, qfrc, qacc)


class ContactSolveOut(NamedTuple):
    nforce: torch.Tensor           # (N, ncp) normal force per candidate point
    qfrc_constraint: torch.Tensor  # (N, nv)
    qacc: torch.Tensor             # (N, nv)


def solve_contacts(sys: S.System, con: Contacts, qpos: torch.Tensor,
                   qvel: torch.Tensor, qacc_smooth: torch.Tensor,
                   pair: Optional[PairContacts] = None,
                   lay: Optional[arrow.ArrowLayout] = None,
                   fac: Optional[arrow.ArrowFac] = None) -> ContactSolveOut:
    """Full constraint solve with top-K candidate selection; normal forces
    (Σ facet forces) are scattered back to the full candidate set for the
    touch sensors."""
    if lay is None or fac is None:
        raise NotImplementedError(
            "the port solves only models with a block-arrow mass matrix")
    asm = assemble(sys, con, qpos, qvel, pair=pair)
    sol = solve(sys, asm.efc, qacc_smooth, asm.ns_offset, lay, fac)

    N = qvel.shape[0]
    nforce = sol.force.new_zeros(N, sys.ncp)
    off = asm.ns_offset
    for _, idx, nf in asm.cparts:
        n = idx.shape[1]
        blk = sol.force[:, off:off + n * nf].reshape(N, n, nf)
        nforce = nforce.scatter(1, idx, blk.sum(dim=-1))
        off += n * nf
    if pair is not None:
        # pair normal force feeds the touch sensors of BOTH bodies; duplicate
        # indices accumulate (scatter_add, the batched index_add_)
        nf_pair = sol.force[:, off:].reshape(N, -1, 4).sum(dim=-1)
        nforce = nforce.scatter_add(1, pair.a, nf_pair).scatter_add(
            1, pair.b, nf_pair)
    return ContactSolveOut(nforce, sol.qfrc_constraint, sol.qacc)
