# A frozen copy of the port's physics/solver.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
"""Constraint assembly and solve (port of
``nightmare_rl_tpu/physics/solver.py``), MuJoCo semantics.

Row families: dof friction rows (|f| ≤ frictionloss), joint-limit rows and
pyramidal contact rows (condim 3 → 4 facets, J = Jn ± μ·Jt_i, f ≥ 0), in
MuJoCo's order: friction, limits, contacts, then pair contacts.  Reference
acceleration aref = -B·(J·qvel) - K·imp·pos from solref/solimp,
regularization R from MuJoCo's diag-approximation, then the dual PGS
(``ops/pgs.py``) with box bounds [lo, hi] per row and the noslip pass on the
contact tangent pairs.  Inactive candidate rows stay in the system with
bounds [0, 0], so every env has the same row count.

The PGS solve has two forms (``ops/pgs.py``), chosen per call by
``ops/pgs.py::choose_mode`` as the JAX package chooses them: the dense
matrix-free form (U = J M⁻¹, then ``pgs``) and, for models whose mass
matrix is block-arrow (``physics/arrow.py``), the leg-block-sparse form
(``pgs_legs`` on the G = J L⁻ᵀ panels, with the per-row slot assignment
``LegMeta``), which forms neither U nor M⁻¹.  ``prewarm`` runs the
dispatch's probe before the first step.

Newton models (``solver_type`` Newton or CG) solve with
``ops/newton.py::newton_solve`` instead (the kernel ``ops/csrc/newton.cu`` on
the card, the plain ``physics/newton.py`` on the CPU): elliptic cones get one row per friction direction (condim 3, 4 or
6), pyramidal cones the same facets as PGS followed by the noslip pass.

After every form, ``ops/solve_out.py::outputs`` (one kernel launch on the
card) forms qfrc = Jᵀf and qacc from what the form leaves, scatters the
normal forces to the candidate points and reads the touch sensors.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from benchmark.reference.plain.ops import linalg
from benchmark.reference.plain.ops import solve_out as SO
from benchmark.reference.plain.ops.newton import newton_solve
from benchmark.reference.plain.ops.pgs import choose_mode, dtype_key, pgs, pgs_legs
from benchmark.reference.plain.physics import arrow, newton
from benchmark.reference.plain.physics import system as S
from benchmark.reference.plain.physics.collision import (
    Contacts, PairContacts, topk_smallest,
)
from benchmark.reference.plain.utils.device import constant


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


def _fdirs(jac, jac_rot, mu, mu_rot, condim: int):
    """Friction directions and coefficients for the plane-contact frame
    (mju_makeFrame for n=+z: t1 = (0,1,0), t2 = (-1,0,0)), in MuJoCo's order
    t1, t2[, torsion[, roll1, roll2]]."""
    Jn = jac[..., 2]
    fdirs = [jac[..., 1], -jac[..., 0]]
    mus = [mu, mu]
    if condim >= 4:
        fdirs.append(jac_rot[..., 2])
        mus.append(mu_rot[..., 0])
    if condim >= 6:
        fdirs += [jac_rot[..., 1], -jac_rot[..., 0]]
        mus += [mu_rot[..., 1], mu_rot[..., 2]]
    return Jn, fdirs, mus


def _friction_rot(sys: S.System, like: torch.Tensor) -> torch.Tensor:
    """(ncp, 3) torsional and rolling friction; zeros for an archive
    without them."""
    if sys.cpoint_friction_rot is not None:
        return sys.cpoint_friction_rot
    return like.new_zeros(sys.ncp, 3)


def make_efc(sys: S.System, con: Contacts, qvel: torch.Tensor, iw=None,
             condim: int = 3) -> Efc:
    """Pyramidal contact rows for every candidate point."""
    if iw is None:  # world side contributes 0 invweight
        iw = sys.body_invweight[S.index_tensor(sys.cpoint_bodyid, qvel.device), 0]
    Jn, fdirs, mus = _fdirs(con.jac, con.jac_rot, sys.cpoint_friction,
                            _friction_rot(sys, qvel), condim)
    return _pyramid_rows(Jn, fdirs, mus, con.dist, con.active,
                         sys.cpoint_solref, sys.cpoint_solimp, iw,
                         sys.impratio, qvel)


def _elliptic_rows(Jn, fdirs, mus, dist, active, solref, solimp, iw,
                   impratio, qvel) -> Tuple[Efc, torch.Tensor, torch.Tensor]:
    """Elliptic-cone rows for a group of n contacts of one condim d per env:
    per contact [normal | t1 | t2 | (torsion) | (roll1 | roll2)], one row per
    friction direction.  Friction rows carry aref = −B·vel (no position
    term); R₀ = (1−imp)/imp·Σinvweight on the normal row and
    Rᵢ = R₀·(μ₁/μᵢ)²/impratio on friction rows; the cone coefficient is
    μ̄ = μ₁/√impratio.  Returns (rows, μ̄ (N, n), μ (N, n, d-1))."""
    J = torch.stack([Jn] + list(fdirs), dim=2)           # (N, n, d, nv)
    N, n, d, nv = J.shape
    mus_arr = torch.stack(list(mus), dim=-1)              # (N, n, d-1)
    mu1 = mus[0]

    imp = impedance(solimp, dist)
    K, B = _kb(solref, solimp)
    vel = torch.einsum("ncfv,nv->ncf", J, qvel)
    aref = -B[..., None] * vel
    aref[..., 0] = aref[..., 0] + (-(K * imp * dist))
    R0 = torch.clamp_min((1.0 - imp) / torch.clamp_min(imp, 1e-12) * iw, 1e-12)
    Rf = R0[..., None] * (mu1[..., None] / mus_arr) ** 2 / impratio
    R = torch.cat([R0[..., None], Rf], dim=-1)
    # a constant made once (a tensor made of impratio here would be a
    # host-to-device copy on every substep); a tensor, not a Python float,
    # because the card divides by a Python scalar as a product with its
    # reciprocal, which rounds differently
    mu_bar = mu1 / constant((math.sqrt(impratio),), J.dtype, J.device)

    efc = Efc(
        J.reshape(N, n * d, nv),
        aref.reshape(N, n * d),
        R.reshape(N, n * d),
        J.new_zeros(N, n * d),
        torch.where(torch.repeat_interleave(active, d, dim=1), torch.inf,
                    0.0).to(J.dtype),
    )
    return efc, mu_bar, mus_arr


def make_pair_efc(sys: S.System, pc: PairContacts, qvel: torch.Tensor,
                  elliptic: bool = False):
    """Rows for the selected body↔body sphere-pair contacts (condim 3):
    pyramid facets, or per-direction cone rows when ``elliptic``.  Returns
    (rows, μ̄, μ) as ``_elliptic_rows`` does, μ̄ and μ None for facets."""
    mu = sys.cpair_friction[pc.sel]                         # (N, K)
    Jn = torch.einsum("nkvd,nkd->nkv", pc.jac, pc.normal)
    Jt1 = torch.einsum("nkvd,nkd->nkv", pc.jac, pc.t1)
    Jt2 = torch.einsum("nkvd,nkd->nkv", pc.jac, pc.t2)
    solimp = sys.cpair_solimp[pc.sel]
    solref = sys.cpair_solref[pc.sel]
    iw_all = sys.body_invweight[:, 0]
    bodyid = S.index_tensor(sys.cpoint_bodyid, qvel.device)
    iw = iw_all[bodyid[pc.a]] + iw_all[bodyid[pc.b]]
    args = (Jn, [Jt1, Jt2], [mu, mu], pc.dist, pc.active, solref, solimp, iw,
            sys.impratio, qvel)
    if elliptic:
        return _elliptic_rows(*args)
    return _pyramid_rows(*args), None, None


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


class LegMeta(NamedTuple):
    """Per-row slot assignment of the leg-sparse PGS (``ops/pgs.py``): every
    constraint row of an arrow-layout model touches at most two legs plus
    the base.  The leg ids address the branches; ``hasN`` False zeroes slot
    N's panel where the row does not involve it (a plane-contact row repeats
    leg1's id in slot 2, and the mask is what keeps it from counting twice).
    Each (N, nefc), in the row order of ``Efc``."""

    leg1: torch.Tensor  # int32 branch id of slot 1
    leg2: torch.Tensor  # int32 branch id of slot 2
    has1: torch.Tensor  # bool
    has2: torch.Tensor  # bool


@functools.lru_cache(maxsize=None)
def _point_leg_map(sys: S.System, lay: arrow.ArrowLayout) -> Tuple[int, ...]:
    """Static candidate-point → branch map, read once per System: a point's
    body, or the first ancestor that has a joint, names the branch of that
    joint's dof; -1 where the walk ends on the base or the world (the
    point's rows involve only base dofs)."""
    out = []
    for p in range(sys.ncp):
        b = sys.cpoint_bodyid[p]
        while b > 0 and sys.body_jntnum[b] == 0:
            b = sys.body_parent[b]
        leg = -1
        if b > 0:
            d = sys.jnt_dofadr[sys.body_jntadr[b]]
            if d >= lay.nbase:
                leg = (d - lay.nbase) // lay.branch_size
        out.append(leg)
    return tuple(out)


def _dof_row_dofs(sys: S.System) -> Tuple[int, ...]:
    """The dof of each dof-constraint row, in make_dof_efc's row order
    (friction rows, then lower-limit rows, then upper-limit rows)."""
    fric_dofs, lim_jnts = _dof_row_sources(sys)
    lim_dofs = tuple(sys.jnt_dofadr[j] for j in lim_jnts)
    return fric_dofs + lim_dofs + lim_dofs


def leg_panels(lay: arrow.ArrowLayout, fac: arrow.ArrowFac, J: torch.Tensor,
               lm: LegMeta) -> torch.Tensor:
    """(N, nefc, 2s+nb) row panels of G = J L⁻ᵀ in [leg1 | leg2 | base] slot
    layout, from the block-arrow factor: the plain version of the legs
    kernel's prologue (the JAX package's ``_leg_panels``, batched).  With
    dofs ordered legs first and base last, L = [[blkdiag(Ld_b), 0],
    [W_bᵀ…, Ls]] is a no-fill Cholesky factor of M, so per row

        g_leg = Ld[leg]⁻¹ j_leg                       (s×s triangular solve)
        g_b   = Ls⁻¹ (j_b − Σ g_leg · W[leg])          (nb×nb triangular solve)
    """
    s, nb = lay.branch_size, lay.nbase
    ar = torch.arange(s, device=J.device)
    n = torch.arange(J.shape[0], device=J.device)[:, None]

    def slot(leg, has):
        leg = leg.long()
        j = torch.gather(J, 2, nb + s * leg[..., None] + ar) * has[..., None].to(J.dtype)
        return arrow._solve_tril(fac.Ld[n, leg], j[..., None])[..., 0], fac.W[n, leg]

    g1, W1 = slot(lm.leg1, lm.has1)
    g2, W2 = slot(lm.leg2, lm.has2)
    rb = (J[..., :nb] - torch.einsum("nrs,nrsk->nrk", g1, W1)
          - torch.einsum("nrs,nrsk->nrk", g2, W2))
    gb = arrow._solve_tril(fac.Ls, rb.transpose(1, 2)).transpose(1, 2)
    return torch.cat([g1, g2, gb], dim=-1)


@functools.lru_cache(maxsize=None)
def _static_slots(sys: S.System, lay: arrow.ArrowLayout, device: torch.device):
    """The point → branch map (ncp,) and the dof rows' branch and mask
    (ndof rows,) as tensors on device, made once (a host-to-device copy in
    the step would wait for the card)."""
    nb, s = lay.nbase, lay.branch_size
    dd = _dof_row_dofs(sys)
    return (torch.tensor(_point_leg_map(sys, lay), dtype=torch.int32,
                         device=device),
            torch.tensor([(d - nb) // s if d >= nb else 0 for d in dd],
                         dtype=torch.int32, device=device),
            torch.tensor([d >= nb for d in dd], dtype=torch.bool,
                         device=device))


def _legmeta(sys: S.System, lay: arrow.ArrowLayout, N: int, device,
             cparts: List[tuple], pair: Optional[PairContacts]) -> LegMeta:
    """The slot assignment of every row, in the concatenated row order
    [dof | contact groups | pairs] (pyramidal facets only: Newton models do
    not run the PGS)."""
    plm, dleg, dhas = _static_slots(sys, lay, torch.device(device))
    parts = []
    if dleg.numel():
        leg, has = dleg.expand(N, -1), dhas.expand(N, -1)
        parts.append((leg, leg, has, torch.zeros_like(has)))
    for _, idx, nf, _, _, _ in cparts:
        lp = plm[idx]                                       # (N, n)
        leg = torch.repeat_interleave(lp.clamp_min(0), nf, dim=1)
        has = torch.repeat_interleave(lp >= 0, nf, dim=1)
        parts.append((leg, leg, has, torch.zeros_like(has)))
    if pair is not None:
        la, lb = plm[pair.a], plm[pair.b]
        # a same-branch pair (e.g. coxa against tibia of one leg): J's leg
        # columns already carry both points, and slot 1 takes them whole;
        # slot 2 as well would count the leg twice
        parts.append(tuple(torch.repeat_interleave(x, 4, dim=1) for x in (
            la.clamp_min(0), lb.clamp_min(0), la >= 0, (lb >= 0) & (la != lb))))
    return LegMeta(*[torch.cat([p[k] for p in parts], dim=1) for k in range(4)])


class Assembled(NamedTuple):
    """The assembled constraint system plus what is needed to scatter forces
    back to candidate points."""

    efc: Efc
    nefc: Optional[newton.NewtonEfc]  # set for Newton models
    ns_offset: int
    # per plane-contact group: (rows, point idx (N, n), rows per point,
    # condim, μ̄, μ), μ̄ and μ None for pyramidal rows
    cparts: List[tuple]
    pair_part: Optional[tuple]        # make_pair_efc's (rows, μ̄, μ)
    # the leg-sparse PGS's slot assignment, for PGS models with a layout
    legmeta: Optional[LegMeta] = None


@functools.lru_cache(maxsize=None)
def _condim_groups(sys: S.System) -> Tuple[Tuple[int, ...], tuple]:
    """Candidate points of condim 3, and (condim, points) for each higher
    condim in ascending order: the static split of the contact rows."""
    condim = sys.cpoint_condim if len(sys.cpoint_condim) else (3,) * sys.ncp
    if condim and min(condim) < 3:
        raise NotImplementedError("condim 1 contacts are not supported")
    c3 = tuple(i for i, d in enumerate(condim) if d == 3)
    higher = tuple((d, tuple(i for i, c in enumerate(condim) if c == d))
                   for d in sorted(set(condim)) if d > 3)
    return c3, higher


@functools.lru_cache(maxsize=None)
def _cone_row_mask(nefc: int, spans: Tuple[Tuple[int, int], ...],
                   device: torch.device) -> torch.Tensor:
    """(nefc,) False on the rows [start, stop) of each cone group (their cost
    is handled per contact, not as one-sided quadratics)."""
    mask = torch.ones(nefc, dtype=torch.bool)
    for a, b in spans:
        mask[a:b] = False
    return mask.to(device)


def assemble(sys: S.System, con: Contacts, qpos: torch.Tensor,
             qvel: torch.Tensor, pair: Optional[PairContacts] = None,
             lay: Optional[arrow.ArrowLayout] = None) -> Optional[Assembled]:
    """Assemble every constraint row as solve_contacts consumes it:
    [dof friction | joint limits | condim-3 contacts (the top-K deepest when
    sys.max_contacts = K > 0) | condim > 3 contacts (ascending condim) |
    pair contacts].  Pyramidal models get ± facet rows; Newton models with
    elliptic cones get one row per direction, grouped into cones.  With a
    block-arrow layout ``lay``, PGS models also get each row's leg slots
    (``legmeta``).  None where the model has no constraint row at all."""
    N, dev = qvel.shape[0], qvel.device
    rows_n = torch.arange(N, device=dev)[:, None]
    use_newton = sys.solver_type in (S.SOLVER_CG, S.SOLVER_NEWTON)
    elliptic = use_newton and sys.cone == S.ELLIPTIC
    iw_full = sys.body_invweight[S.index_tensor(sys.cpoint_bodyid, dev), 0]
    mu_rot_full = _friction_rot(sys, qvel)

    def group_rows(idx, d: int):
        """Rows for the points idx (N, n), all of condim d."""
        Jn, fdirs, mus = _fdirs(con.jac[rows_n, idx], con.jac_rot[rows_n, idx],
                                sys.cpoint_friction[idx], mu_rot_full[idx], d)
        args = (Jn, fdirs, mus, con.dist[rows_n, idx], con.active[rows_n, idx],
                sys.cpoint_solref[idx], sys.cpoint_solimp[idx], iw_full[idx],
                sys.impratio, qvel)
        if elliptic:
            return _elliptic_rows(*args)
        return _pyramid_rows(*args), None, None

    c3, higher = _condim_groups(sys)
    K = sys.max_contacts
    cparts = []
    if c3:
        c3t = S.index_tensor(c3, dev)
        if 0 < K < len(c3):
            sel3 = c3t[topk_smallest(con.dist[:, c3t], K)]   # (N, K)
        else:
            sel3 = c3t.expand(N, -1)
        rows, mu_bar, mus = group_rows(sel3, 3)
        cparts.append((rows, sel3, 3 if elliptic else 4, 3, mu_bar, mus))
    for d, pts in higher:
        idx = S.index_tensor(pts, dev).expand(N, -1)
        rows, mu_bar, mus = group_rows(idx, d)
        cparts.append((rows, idx, d if elliptic else 2 * (d - 1), d, mu_bar, mus))

    parts = [p[0] for p in cparts]
    pair_part = None
    if pair is not None:
        pair_part = make_pair_efc(sys, pair, qvel, elliptic=elliptic)
        parts.append(pair_part[0])
    efc_d = make_dof_efc(sys, qpos, qvel)
    ns_offset = 0
    if efc_d is not None:
        ns_offset = efc_d.J.shape[1]
        parts.insert(0, efc_d)
    if not parts:
        return None
    efc = _cat(parts) if len(parts) > 1 else parts[0]

    nefc = None
    if use_newton:
        cones = []
        if elliptic:
            off = ns_offset
            for _, idx, nf, d, mu_bar, mus in cparts:
                cones.append(newton.ConeGroup(off, d, mu_bar, mus,
                                              con.active[rows_n, idx]))
                off += idx.shape[1] * nf
            if pair_part is not None:
                cones.append(newton.ConeGroup(off, 3, pair_part[1], pair_part[2],
                                              pair.active))
        spans = tuple((g.start, g.start + g.mus.shape[-2] * g.dim) for g in cones)
        is_fl = efc.lo < 0.0
        nefc = newton.NewtonEfc(
            J=efc.J, aref=efc.aref, R=efc.R,
            quad_active=(~is_fl) & (efc.hi > 0.0)
            & _cone_row_mask(efc.J.shape[1], spans, dev),
            fl=torch.where(is_fl, efc.hi, 0.0),
            cones=tuple(cones),
            cone_all=(tuple(torch.cat(x, dim=1) for x in zip(
                *[(g.mu, g.active, g.mus.flatten(1)) for g in cones]))
                if cones else None),
        )
    legmeta = None
    if lay is not None and not use_newton:
        legmeta = _legmeta(sys, lay, N, dev, cparts, pair)
    return Assembled(efc, nefc, ns_offset, cparts, pair_part, legmeta)


@functools.lru_cache(maxsize=None)
def _row_count(sys: S.System) -> int:
    """nefc of a PGS model's assembled system, from the System alone: dof
    rows, 4 facets per selected condim-3 point, 2(d-1) per condim-d point,
    4 per selected pair."""
    c3, higher = _condim_groups(sys)
    K = sys.max_contacts
    n = len(_dof_row_dofs(sys))
    if c3:
        n += 4 * (K if 0 < K < len(c3) else len(c3))
    n += sum(2 * (d - 1) * len(pts) for d, pts in higher)
    if sys.max_pair_contacts > 0 and len(sys.cpair_a) > 0:
        n += 4 * min(sys.max_pair_contacts, len(sys.cpair_a))
    return n


def _lay_shape(lay: Optional[arrow.ArrowLayout]):
    return None if lay is None else (lay.nbranch, lay.branch_size, lay.nbase)


def _pgs_mode(sys: S.System, lay: Optional[arrow.ArrowLayout],
              legs_available: bool, nefc: int, ns_offset: int, dtype,
              device) -> str:
    """``choose_mode`` at a PGS solve's key."""
    return choose_mode(
        legs_available=legs_available, nefc=nefc, nv=sys.nv,
        iterations=sys.solver_iterations, noslip=sys.noslip_iterations,
        ns_offset=ns_offset, lay_shape=_lay_shape(lay),
        dtype_name=dtype_key(dtype), device=device)


def prewarm(sys: S.System, device=None) -> str:
    """Runs the solver-form dispatch now (``ops/pgs.py::choose_mode``: on the
    card a timing probe, unless a verdict is cached), at the key the solve
    will ask for: nefc, nv and ns_offset derived from the System without
    stepping.  Called from the env's constructor, so the probe runs before
    the first step; returns the form, "newton" for Newton and CG models."""
    if sys.solver_type in (S.SOLVER_CG, S.SOLVER_NEWTON):
        return "newton"
    lay = arrow.layout(sys)
    return _pgs_mode(sys, lay, lay is not None, _row_count(sys),
                     len(_dof_row_dofs(sys)), sys.dtype,
                     sys.device if device is None else device)


def solve(sys: S.System, efc: Efc, b: torch.Tensor, ns_offset: int,
          lay: Optional[arrow.ArrowLayout] = None,
          fac: Optional[arrow.ArrowFac] = None,
          M_chol: Optional[torch.Tensor] = None,
          legmeta: Optional[LegMeta] = None) -> SO.Solved:
    """Dual box-PGS from zero with fixed sweeps, then noslip on the contact
    tangent pairs from row ns_offset, in the form ``choose_mode`` picked
    when the rows were assembled (``legs_form``):

    - legs (the slot assignment ``legmeta`` given, with the block-arrow
      factor): ``pgs_legs`` on
      the G panels, which also gives qacc's change M⁻¹ Jᵀ f = L⁻ᵀ u from
      its final slot state u = Gᵀf; no M⁻¹, no U and no solve with M are
      formed (the JAX package solves M⁻¹ qfrc with ``arrow.solve_vec``: the
      two agree to round-off);
    - dense: M⁻¹ from the block-arrow or the dense Cholesky factor
      (``minv``), U = J M⁻¹ in one batched matmul, ``pgs``.

    ``b`` = J qacc_smooth - aref, as the assembly made it.  Returns the
    force and what the form leaves for the output stage
    (``ops/solve_out.py``: qfrc = Jᵀf and qacc)."""
    if legmeta is not None:
        f, dq = pgs_legs(lay, fac, efc.J, legmeta, b, efc.R, efc.lo, efc.hi,
                         sys.solver_iterations, sys.noslip_iterations,
                         ns_offset)
        return SO.Solved(SO.LEGS, f, J=efc.J, dq=dq)
    Minv = minv(lay, fac, M_chol)
    U = efc.J @ Minv                                        # (N, nefc, nv)
    f = pgs(efc.J, U, b, efc.R, efc.lo, efc.hi, sys.solver_iterations,
            sys.noslip_iterations, ns_offset)
    return SO.Solved(SO.DENSE, f, J=efc.J, Minv=Minv)


def minv(lay: Optional[arrow.ArrowLayout], fac: Optional[arrow.ArrowFac],
         M_chol: Optional[torch.Tensor]) -> torch.Tensor:
    """M⁻¹ (N, nv, nv) from whichever factor the pipeline made: the
    block-arrow one, else the dense Cholesky factor."""
    if fac is not None:
        return arrow.inv(lay, fac)
    if M_chol is None:
        raise ValueError("the solve needs the block-arrow factor or the "
                         "dense Cholesky factor of M")
    return linalg.spd_inv_from_chol(M_chol)


class ContactSolveOut(NamedTuple):
    nforce: torch.Tensor           # (N, ncp) normal force per candidate point
    qfrc_constraint: torch.Tensor  # (N, nv)
    qacc: torch.Tensor             # (N, nv)


def _noslip_pairs(A: torch.Tensor, b: torch.Tensor, f: torch.Tensor,
                  hi: torch.Tensor, ns_offset: int, sweeps: int) -> torch.Tensor:
    """MuJoCo's noslip post-pass on consecutive ± facet pairs from row
    ns_offset, starting from the force f (after a Newton solve), with the
    Delassus matrix A (N, nefc, nefc)."""
    nefc = b.shape[1]
    npairs = (nefc - ns_offset) // 2
    if sweeps <= 0 or npairs <= 0:
        return f
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    f = f.clone()
    for _ in range(sweeps):
        for p in range(npairs):
            i, j = ns_offset + 2 * p, ns_offset + 2 * p + 1
            s = f[:, i] + f[:, j]
            g = torch.einsum("nk,nk->n", A[:, i] - A[:, j], f) + b[:, i] - b[:, j]
            h = diag[:, i] + diag[:, j] - 2.0 * A[:, i, j]
            y = 0.5 * (f[:, i] - f[:, j]) - g / torch.clamp_min(h, 1e-12)
            y = torch.minimum(torch.maximum(y, -0.5 * s), 0.5 * s)
            ok = hi[:, i] > 0
            fi = torch.where(ok, 0.5 * s + y, f[:, i])
            fj = torch.where(ok, 0.5 * s - y, f[:, j])
            f[:, i], f[:, j] = fi, fj
    return f


class Rows(NamedTuple):
    """The assembled constraint system as the solve consumes it: what
    ``ops/assemble.py::rows`` returns (the assemble kernel on the card) and
    ``assembled_rows`` makes from the plain functions."""

    efc: Efc
    b: torch.Tensor                   # (N, nefc) J qacc_smooth - aref
    ns_offset: int
    nefc: Optional[newton.NewtonEfc]  # set for Newton models
    # per plane-contact group, in row order: its points (N, n) and rows per
    # point
    groups: Tuple[Tuple[torch.Tensor, int], ...]
    # the selected pairs' points a and b (N, Kp), for models with pairs
    pair_ab: Optional[Tuple[torch.Tensor, torch.Tensor]]
    # the leg-sparse PGS's slot assignment, where the legs form solves
    legmeta: Optional[LegMeta] = None


def rhs(efc: Efc, qacc_smooth: torch.Tensor) -> torch.Tensor:
    """b = J qacc_smooth - aref."""
    return torch.einsum("nkv,nv->nk", efc.J, qacc_smooth) - efc.aref


def legs_form(sys: S.System, lay: Optional[arrow.ArrowLayout], dtype,
              device) -> bool:
    """Whether a PGS model's solve runs in the legs form (``choose_mode``
    at the System's row count), so that its rows need their slots."""
    if lay is None or sys.solver_type in (S.SOLVER_CG, S.SOLVER_NEWTON):
        return False
    return _pgs_mode(sys, lay, True, _row_count(sys), len(_dof_row_dofs(sys)),
                     dtype, device) == "legs"


def assembled_rows(sys: S.System, con: Contacts, qpos: torch.Tensor,
                   qvel: torch.Tensor, qacc_smooth: torch.Tensor,
                   pair: Optional[PairContacts] = None,
                   lay: Optional[arrow.ArrowLayout] = None,
                   legs: bool = False) -> Optional[Rows]:
    """``Rows`` from the plain functions: ``assemble``, the slot
    assignment (``_legmeta``, only where ``legs``) and b.  None where the
    model has no constraint row."""
    asm = assemble(sys, con, qpos, qvel, pair=pair)
    if asm is None:
        return None
    legmeta = None
    if legs:
        legmeta = _legmeta(sys, lay, qvel.shape[0], qvel.device, asm.cparts,
                           pair)
    return Rows(asm.efc, rhs(asm.efc, qacc_smooth), asm.ns_offset, asm.nefc,
                tuple((p[1], p[2]) for p in asm.cparts),
                None if pair is None else (pair.a, pair.b), legmeta)


def solve_contacts(sys: S.System, con: Contacts, qpos: torch.Tensor,
                   qvel: torch.Tensor, qacc_smooth: torch.Tensor,
                   pair: Optional[PairContacts] = None,
                   lay: Optional[arrow.ArrowLayout] = None,
                   fac: Optional[arrow.ArrowFac] = None,
                   M: Optional[torch.Tensor] = None,
                   warmstart: Optional[torch.Tensor] = None,
                   M_chol: Optional[torch.Tensor] = None) -> ContactSolveOut:
    """Full constraint solve with top-K candidate selection: the plain
    assembly (``assembled_rows``; the slot assignment only where the legs
    form solves), then ``solve_rows``."""
    rows = assembled_rows(sys, con, qpos, qvel, qacc_smooth, pair=pair,
                          lay=lay, legs=legs_form(sys, lay, qvel.dtype,
                                                  qvel.device))
    return solve_rows(sys, rows, qacc_smooth, lay=lay, fac=fac, M=M,
                      warmstart=warmstart, M_chol=M_chol)[0]


def solve_rows(sys: S.System, rows: Optional[Rows], qacc_smooth: torch.Tensor,
               lay: Optional[arrow.ArrowLayout] = None,
               fac: Optional[arrow.ArrowFac] = None,
               M: Optional[torch.Tensor] = None,
               warmstart: Optional[torch.Tensor] = None,
               M_chol: Optional[torch.Tensor] = None
               ) -> Tuple[ContactSolveOut, torch.Tensor]:
    """The solve of assembled rows and the touch sensors.  PGS models run
    the PGS solve (the legs form where ``rows.legmeta`` is set); Newton
    models run ``ops/newton.py::newton_solve`` from the warmstart (the CUDA
    kernel on the card, ``newton.solve`` on the CPU; then noslip for
    pyramidal cones).  The output stage, ``ops/solve_out.py::outputs`` (one
    kernel launch on the card), forms qfrc and qacc, scatters the normal
    forces (Σ facet forces, or the normal row of an elliptic cone) back to
    the full candidate set and reads the touch sensors from them.  M⁻¹,
    where a step needs it, comes from the block-arrow factor (``lay``,
    ``fac``) or, without one, from the dense Cholesky factor ``M_chol``.
    Returns the solve's outputs and sensordata (N, nsensor)."""
    N = qacc_smooth.shape[0]
    if rows is None:  # nothing constrains the model
        return (ContactSolveOut(qacc_smooth.new_zeros(N, sys.ncp),
                                torch.zeros_like(qacc_smooth), qacc_smooth),
                qacc_smooth.new_zeros(N, sys.nsensor))
    efc, ns_offset, b = rows.efc, rows.ns_offset, rows.b
    elliptic = rows.nefc is not None and sys.cone == S.ELLIPTIC
    if rows.nefc is not None:
        if M is None:
            raise ValueError("the Newton solve needs the mass matrix M")
        ne = rows.nefc
        nefc = ne._replace(J=ne.J.contiguous(), aref=ne.aref.contiguous(),
                           R=ne.R.contiguous(), fl=ne.fl.contiguous(),
                           quad_active=ne.quad_active.contiguous())
        nsol = newton_solve(nefc, M.contiguous(), qacc_smooth.contiguous(),
                            sys.solver_iterations,
                            min(sys.ls_iterations, sys.ls_refine),
                            x0=None if warmstart is None
                            else warmstart.contiguous())
        solved = SO.Solved(SO.NEWTON, nsol.force, qfrc=nsol.qfrc_constraint,
                           qacc=nsol.qacc)
        if sys.noslip_iterations > 0 and not elliptic:
            Minv = minv(lay, fac, M_chol)
            A = (efc.J @ Minv) @ efc.J.transpose(1, 2)
            force = _noslip_pairs(A, b, nsol.force, efc.hi, ns_offset,
                                  sys.noslip_iterations)
            solved = SO.Solved(SO.DENSE, force, J=efc.J, Minv=Minv)
    else:
        solved = solve(sys, efc, b, ns_offset, lay, fac, M_chol,
                       rows.legmeta)
    out = SO.outputs(sys, rows.groups, rows.pair_ab, ns_offset, solved,
                     qacc_smooth, elliptic)
    return (ContactSolveOut(out.nforce, out.qfrc_constraint, out.qacc),
            out.sensordata)
