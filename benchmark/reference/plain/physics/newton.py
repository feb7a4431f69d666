# A frozen copy of the port's physics/newton.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
"""MuJoCo-semantics Newton constraint solver, pyramidal and elliptic cones
(port of ``nightmare_rl_tpu/physics/newton.py``), batched over envs.

The solver minimizes the strictly convex primal cost over qacc = x,

    C(x) = 0.5·(x-a₀)ᵀM(x-a₀) + Σᵢ s(jarᵢ),   jar = J·x − aref,

with per-row costs s (D = 1/R): one-sided rows 0.5·D·jar² for jar < 0;
dof-friction rows quadratic for |jar| ≤ fl·R and linear outside; elliptic
contacts by zone, in scaled coordinates u₀ = jar₀, wᵢ = jarᵢ·μᵢ/μ̄,
T = ‖w‖:

    bottom  (μ̄·(−u₀) ≥ T):  f = −D·jar
    top     (u₀ ≥ μ̄·T):     f = 0
    middle:                  f₀ = D₀·(μ̄T − u₀)/(1+μ̄²),  fᵢ = −f₀·μᵢ·wᵢ/T.

Each Newton iteration builds the zone-aware Hessian, takes p = −H⁻¹∇C and
runs the JAX package's line search: the root of φ'(α) is bracketed in
[0, −φ'(0)/pᵀMp], a 12-candidate grid over the bracket is evaluated in one
batched call (a leading candidate axis, where JAX uses vmap), then
``ls_refine`` guarded Newton/bisection steps polish it.  The budgets are
fixed: ``iterations`` Newton steps and ``ls_refine`` refinements, with no
early exit.  The line search ends as the JAX package's does: when φ' at the
last refinement is > 0 it takes the bracket's low end.  Where the
refinements converge on the root from above, φ' sits on its round-off
floor and that choice is noise; the port keeps the rule.

On the card the solve runs as one CUDA kernel per call (``ops/csrc/
newton.cu`` through ``ops/newton.py::newton_solve``, which the solver
calls); ``solve`` here is its plain version, run on the CPU and held
against the kernel.  Eagerly it is bound by launches, so ``solve`` reads
the rows in its own order (``_prep``): the rows outside the cones, then the
cone groups merged per condim (anymal_c's pair cones join its condim-3
group), with what does not depend on jar computed once per solve.  Forces
come back in the efc's order.

Every function takes jar with any leading axes that broadcast against the
efc's (N, nefc) fields: (N, nefc) for one point per env, (C, N, nefc) for C
candidates per env.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from benchmark.reference.plain.ops import linalg


class ConeGroup(NamedTuple):
    """A block of elliptic contacts with one condim: rows
    [start, start + n·dim) of the efc system, per contact
    [normal | friction directions]."""

    start: int             # static row offset
    dim: int               # static condim
    mu: torch.Tensor       # (N, n) regularized cone coefficient μ₁/√impratio
    mus: torch.Tensor      # (N, n, dim-1) physical friction per direction
    active: torch.Tensor   # (N, n) candidate activity


class NewtonEfc(NamedTuple):
    J: torch.Tensor            # (N, nefc, nv)
    aref: torch.Tensor         # (N, nefc)
    R: torch.Tensor            # (N, nefc)
    quad_active: torch.Tensor  # (N, nefc) activity of one-sided rows (False
                               # on cone and friction rows)
    fl: torch.Tensor           # (N, nefc) frictionloss (> 0 marks dof-friction rows)
    cones: Tuple[ConeGroup, ...] = ()
    # the cone groups' mu (N, nc), active (N, nc) and mus (N, nmus), each
    # concatenated over the groups in order (the assemble kernel writes one
    # buffer each, whose views the groups are); None where not made
    cone_all: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


class _Group(NamedTuple):
    """Per-solve constants of a block of contacts of one condim, rows
    [start, start + n·d) of the layout they are read in."""

    start: int
    n: int
    d: int
    mu: torch.Tensor        # (N, n)
    mus: torch.Tensor       # (N, n, d-1)
    active: torch.Tensor    # (N, n)
    inactive: torch.Tensor
    D: torch.Tensor         # (N, n, d) 1/R
    negD: torch.Tensor
    c2: torch.Tensor        # (N, n) D₀/(1+μ̄²)
    mu_c: torch.Tensor      # (N, n) max(μ̄, 1e-12)
    s: torch.Tensor         # (N, n, d-1) μᵢ/μ̄


def _group(R: torch.Tensor, start: int, d: int, mu, mus, active) -> _Group:
    n = mus.shape[-2]
    D = 1.0 / R[..., start:start + n * d].unflatten(-1, (n, d))
    mu_c = torch.clamp_min(mu, 1e-12)
    return _Group(start, n, d, mu, mus, active, ~active, D, -D,
                  D[..., 0] / (1.0 + mu * mu), mu_c, mus / mu_c[..., None])


class _Prep(NamedTuple):
    """A NewtonEfc in the order the solver reads it: the k rows outside the
    cones first (efc order), then the cones merged per condim.  ``perm``
    takes a row vector from efc order to this one, ``inv`` back (both None
    when the orders agree)."""

    k: int
    R: torch.Tensor         # (N, k) the rows outside the cones
    D: torch.Tensor         # 1/R
    negD: torch.Tensor
    quad: torch.Tensor      # (N, k) activity of one-sided rows
    fl: torch.Tensor        # (N, k)
    is_fl: torch.Tensor
    groups: Tuple[_Group, ...]
    perm: Optional[torch.Tensor]
    inv: Optional[torch.Tensor]


@functools.lru_cache(maxsize=None)
def _order(nefc: int, spans: Tuple[Tuple[int, int, int], ...],
           device: torch.device):
    """The solver's row order for cone groups (start, dim, n): rows outside
    the cones, then each condim's groups in turn.  Returns (k, merged
    groups as (dim, (group indices)), perm, inv)."""
    cone_rows = set()
    for start, d, n in spans:
        cone_rows.update(range(start, start + d * n))
    order = [r for r in range(nefc) if r not in cone_rows]
    k = len(order)
    merged = []
    for d in sorted({d for _, d, _ in spans}):
        idx = tuple(i for i, sp in enumerate(spans) if sp[1] == d)
        merged.append((d, idx))
        for i in idx:
            start, _, n = spans[i]
            order.extend(range(start, start + d * n))
    if order == list(range(nefc)):
        return k, tuple(merged), None, None
    perm = torch.tensor(order, dtype=torch.long)
    return k, tuple(merged), perm.to(device), torch.argsort(perm).to(device)


def _prep(efc: NewtonEfc) -> _Prep:
    nefc = efc.R.shape[-1]
    spans = tuple((g.start, g.dim, g.mus.shape[-2]) for g in efc.cones)
    k, merged, perm, inv = _order(nefc, spans, efc.R.device)
    R = efc.R if perm is None else efc.R[..., perm]
    groups, start = [], k
    for d, idx in merged:
        gs = [efc.cones[i] for i in idx]
        cat = (lambda xs: xs[0]) if len(gs) == 1 else (
            lambda xs: torch.cat(xs, dim=1))
        g = _group(R, start, d, cat([g.mu for g in gs]),
                   cat([g.mus for g in gs]), cat([g.active for g in gs]))
        groups.append(g)
        start += g.n * d
    take = (lambda x: x[..., :k]) if perm is None else (lambda x: x[..., perm[:k]])
    D = 1.0 / R[..., :k]
    fl = take(efc.fl)
    return _Prep(k, R[..., :k], D, -D, take(efc.quad_active), fl, fl > 0,
                 tuple(groups), perm, inv)


def _take(p: _Prep, x: torch.Tensor) -> torch.Tensor:
    return x if p.perm is None else x[..., p.perm]


def _give(p: _Prep, x: torch.Tensor) -> torch.Tensor:
    return x if p.inv is None else x[..., p.inv]


class _Cone(NamedTuple):
    """Per-contact zone quantities of one cone group at one jar."""

    jar_c: torch.Tensor   # (..., n, d)
    w: torch.Tensor       # (..., n, d-1)
    Ts: torch.Tensor      # (..., n) max(T, 1e-12)
    bottom: torch.Tensor
    mid: torch.Tensor
    gap: torch.Tensor
    f: torch.Tensor       # (..., n, d)


def _zones(g: _Group, jar: torch.Tensor) -> _Cone:
    jar_c = jar[..., g.start:g.start + g.n * g.d].unflatten(-1, (g.n, g.d))
    u0 = jar_c[..., 0]
    w = jar_c[..., 1:] * g.mus / g.mu_c[..., None]
    T = torch.sqrt(torch.sum(w * w, dim=-1))
    Ts = torch.clamp_min(T, 1e-12)
    muT = g.mu * T
    bottom = g.active & (g.mu * (-u0) >= T)
    top = g.inactive | (u0 >= muT)
    mid = g.active & ~bottom & ~top
    gap = muT - u0                                 # ≥ 0 in the middle zone
    f0 = g.c2 * gap
    f_mid = torch.cat([f0[..., None],
                       -f0[..., None] * g.mus * w / Ts[..., None]], dim=-1)
    f = torch.where(bottom[..., None], g.negD * jar_c,
                    torch.where(mid[..., None], f_mid, 0.0))
    return _Cone(jar_c, w, Ts, bottom, mid, gap, f)


def _cone_terms(efc: NewtonEfc, g: ConeGroup, jar: torch.Tensor) -> _Cone:
    """Zone quantities of the contacts of one of efc's cone groups, jar in
    efc order."""
    return _zones(_group(efc.R, g.start, g.dim, g.mu, g.mus, g.active), jar)


def _forces(p: _Prep, jar: torch.Tensor):
    """Forces, the diagonal curvature and the cone terms, jar and the
    results in the solver's order."""
    jr = jar[..., :p.k]
    fl_mid = p.is_fl & (torch.abs(jr) * p.D <= p.fl)
    quad = (p.quad & (jr < 0.0)) | fl_mid
    f = torch.where(quad, p.negD * jr, 0.0)
    fs = [torch.where(p.is_fl & ~fl_mid, -torch.sign(jr) * p.fl, f)]
    diags = [torch.where(quad, p.D, 0.0)]
    cones = []
    for g in p.groups:
        c = _zones(g, jar)
        fs.append(c.f.flatten(-2))
        # bottom zone: plain diagonal D curvature on all contact rows
        diags.append(torch.where(c.bottom[..., None], g.D, 0.0).flatten(-2))
        cones.append(c)
    return torch.cat(fs, dim=-1), torch.cat(diags, dim=-1), cones


def _cost(p: _Prep, jar: torch.Tensor) -> torch.Tensor:
    jr = jar[..., :p.k]
    fl_mid = p.is_fl & (torch.abs(jr) * p.D <= p.fl)
    s = torch.where((p.quad & (jr < 0.0)) | fl_mid, 0.5 * p.D * jr * jr, 0.0)
    # saturated friction rows: linear continuation, C¹ at the break
    s = torch.where(p.is_fl & ~fl_mid,
                    p.fl * torch.abs(jr) - 0.5 * p.fl * p.fl * p.R, s)
    total = torch.sum(s, dim=-1)
    for g in p.groups:
        c = _zones(g, jar)
        s_bot = 0.5 * torch.sum(g.D * c.jar_c * c.jar_c, dim=-1)
        s_mid = 0.5 * g.c2 * c.gap * c.gap
        total = total + torch.sum(
            torch.where(c.bottom, s_bot, torch.where(c.mid, s_mid, 0.0)), dim=-1)
    return total


def _hessian(g: _Group, jar: torch.Tensor) -> torch.Tensor:
    c = _zones(g, jar)
    what = c.w / c.Ts[..., None]
    dg = torch.cat([-torch.ones_like(what[..., :1]), g.mus * what], dim=-1)
    B = g.c2[..., None, None] * dg[..., :, None] * dg[..., None, :]
    P = (torch.eye(g.d - 1, dtype=jar.dtype, device=jar.device)
         - what[..., :, None] * what[..., None, :])
    SPS = g.s[..., :, None] * P * g.s[..., None, :]
    coef = g.c2 * c.gap * g.mu / c.Ts
    B[..., 1:, 1:] += coef[..., None, None] * SPS
    return torch.where(c.mid[..., None, None], B, 0.0)


def _curv(p: _Prep, jar: torch.Tensor, Jp: torch.Tensor):
    f, diag, cones = _forces(p, jar)
    curv = torch.sum(diag * Jp * Jp, dim=-1)
    for g, c in zip(p.groups, cones):
        h = Jp[..., g.start:g.start + g.n * g.d].unflatten(-1, (g.n, g.d))
        what = c.w / c.Ts[..., None]
        dg_h = -h[..., 0] + torch.sum(g.mus * what * h[..., 1:], dim=-1)
        sh = g.s * h[..., 1:]
        perp = (torch.sum(sh * sh, dim=-1)
                - torch.sum(what * sh, dim=-1) ** 2)
        cc = g.c2 * dg_h ** 2 + g.c2 * c.gap * g.mu / c.Ts * perp
        curv = curv + torch.sum(torch.where(c.mid, cc, 0.0), dim=-1)
    return f, curv


def forces(efc: NewtonEfc, jar: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Constraint forces f(jar) and the diagonal curvature (rows whose s is
    locally 0.5·D·jar²); cone middle zones carry the non-diagonal curvature
    of ``_cone_hessians``."""
    p = _prep(efc)
    f, diag, _ = _forces(p, _take(p, jar))
    return _give(p, f), _give(p, diag)


def constraint_cost(efc: NewtonEfc, jar: torch.Tensor) -> torch.Tensor:
    """Σᵢ s(jarᵢ) per env: the constraint part of C(x), read by the
    warmstart selector."""
    p = _prep(efc)
    return _cost(p, _take(p, jar))


def _cone_hessians(efc: NewtonEfc, g: ConeGroup, jar: torch.Tensor
                   ) -> torch.Tensor:
    """Middle-zone Hessian blocks B (..., n, d, d) of one group:
    ∇²s = c₂·∇g∇gᵀ + c₂·gap·μ̄/T · S(I − ŵŵᵀ)S on the friction block, with
    ∇g = (−1, μᵢ·ŵᵢ) and S = diag(μᵢ/μ̄)."""
    return _hessian(_group(efc.R, g.start, g.dim, g.mu, g.mus, g.active), jar)


def _dir_curv(efc: NewtonEfc, jar: torch.Tensor, Jp: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forces and the directional curvature pᵀ(∂²Σs)p at jar (for the line
    search), cone middle-zone terms included."""
    p = _prep(efc)
    f, curv = _curv(p, _take(p, jar), _take(p, Jp))
    return _give(p, f), curv


class NewtonOut(NamedTuple):
    force: torch.Tensor            # (N, nefc)
    qfrc_constraint: torch.Tensor  # (N, nv)
    qacc: torch.Tensor             # (N, nv)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product A (N, m, k) · x (N, k)."""
    return torch.einsum("nmk,nk->nm", A, x)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


@functools.lru_cache(maxsize=None)
def _grid(dtype: torch.dtype, device: torch.device
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The line search's candidate multipliers, (7, 1) fractions of αmax
    and (5, 1) multiples of the Newton estimate, made once per device."""
    fracs = (1.0, 0.5, 0.25, 0.125, 1.0 / 16, 1.0 / 64, 1.0 / 256)
    return (torch.tensor(fracs, dtype=dtype, device=device)[:, None],
            torch.tensor((0.25, 0.5, 1.0, 2.0, 4.0), dtype=dtype,
                         device=device)[:, None])


def solve(efc: NewtonEfc, M: torch.Tensor, qacc_smooth: torch.Tensor,
          iterations: int, ls_refine: int,
          x0: Optional[torch.Tensor] = None,
          trace: Optional[list] = None) -> NewtonOut:
    """Newton solve with the bracketed exact line search, M (N, nv, nv).

    ``x0`` is a warmstart candidate (mjData.qacc_warmstart): each env starts
    from whichever of x0 and qacc_smooth has the lower total cost.

    ``trace``, where given, receives per Newton step a dict of per-env
    tensors about the line search's decisions, each a sign of φ'(α):
    ``margin``, the smallest |φ'(α)| over its round-off scale
    ε·(|gᵀMp| + |α·pᵀMp| + Σ|Jp·f| + |α|·φ''(α)) (the terms of φ', and
    φ' moved by α's own rounding) among φ'(0), the grid's candidates and
    the refinements; and ``reach``, the farthest the step can move x,
    |αmax|·max|p|.  Where a margin is of order 1, two correct
    implementations may decide apart by up to the reach."""
    p = _prep(efc)
    J = efc.J if p.perm is None else efc.J[:, p.perm]
    aref = _take(p, efc.aref)
    a0 = qacc_smooth
    tiny = 1e-12

    x = a0
    if x0 is not None:
        def total_cost(x):
            dx = x - a0
            return 0.5 * _dot(dx, _mv(M, dx)) + _cost(p, _mv(J, x) - aref)

        x = torch.where((total_cost(x0) < total_cost(a0))[:, None], x0, a0)

    fracs, newton_mult = _grid(a0.dtype, a0.device)
    for _ in range(iterations):
        jar = _mv(J, x) - aref
        f, diag, _ = _forces(p, jar)
        Mdx = _mv(M, x - a0)
        grad = Mdx - torch.einsum("nkv,nk->nv", J, f)
        H = M + (J * diag[..., None]).transpose(1, 2) @ J
        for g in p.groups:
            Jc = J[:, g.start:g.start + g.n * g.d]
            BJ = _hessian(g, jar) @ Jc.unflatten(1, (g.n, g.d))  # (N, n, d, nv)
            H = H + Jc.transpose(1, 2) @ BJ.flatten(1, 2)
        step = -linalg.cho_solve(linalg.chol(H), grad)

        Jp = _mv(J, step)
        pMp = _dot(step, _mv(M, step))
        gMp = _dot(step, Mdx)

        margins = []

        def phi_derivs(alpha):
            f_a, curv = _curv(p, jar + alpha[..., None] * Jp, Jp)
            d1, d2 = gMp + alpha * pMp - _dot(Jp, f_a), pMp + curv
            if trace is not None:
                scale = (gMp.abs() + (alpha * pMp).abs()
                         + torch.sum((Jp * f_a).abs(), dim=-1)
                         + alpha.abs() * d2.abs())
                m = d1.abs() / (torch.finfo(d1.dtype).eps * scale)
                margins.append(m.amin(dim=0) if m.dim() > 1 else m)
            return d1, d2

        d1_0, d2_0 = phi_derivs(torch.zeros_like(pMp))
        # φ'(α) ≥ φ'(0) + α·pᵀMp (every constraint cost is convex), so the
        # root lies in [0, αmax]; a grid over the bracket plus multiples of
        # the unguarded Newton estimate, evaluated in one call
        alpha_max = -d1_0 / torch.clamp_min(pMp, tiny)
        a1 = -d1_0 / torch.clamp_min(d2_0, tiny)
        cand = torch.cat([alpha_max * fracs, a1 * newton_mult])    # (12, N)
        cand = torch.minimum(torch.clamp_min(cand, 0.0), alpha_max)
        d1s, d2s = phi_derivs(cand)
        neg = d1s < 0.0
        lo = torch.amax(torch.where(neg, cand, 0.0), dim=0)
        hi = torch.amin(torch.where(neg, alpha_max, cand), dim=0)
        i_lo = torch.argmax(torch.where(neg, cand, -1.0), dim=0)[None]
        has_neg = torch.any(neg, dim=0)
        alpha = torch.where(has_neg, cand.gather(0, i_lo)[0], 0.0)
        d1 = torch.where(has_neg, d1s.gather(0, i_lo)[0], d1_0)
        d2 = torch.where(has_neg, d2s.gather(0, i_lo)[0], d2_0)

        for _ in range(ls_refine):
            lo = torch.where(d1 < 0.0, torch.maximum(lo, alpha), lo)
            hi = torch.where(d1 >= 0.0, torch.minimum(hi, alpha), hi)
            a_newton = alpha - d1 / torch.clamp_min(d2, tiny)
            inside = (a_newton > lo) & (a_newton < hi)
            alpha = torch.where(inside, a_newton, 0.5 * (lo + hi))
            d1, d2 = phi_derivs(alpha)
        if trace is not None:
            trace.append(dict(
                margin=torch.stack(margins).amin(dim=0),
                reach=alpha_max.abs() * step.abs().amax(dim=-1)))
        # land on the descent side of the bracket when φ'(final) > 0; a
        # converged iterate (φ'(0) ≥ 0) takes a null step
        alpha = torch.where(d1 <= 0.0, alpha, lo)
        alpha = torch.where(d1_0 < 0.0, alpha, 0.0)
        x = x + alpha[:, None] * step

    f, _, _ = _forces(p, _mv(J, x) - aref)
    return NewtonOut(_give(p, f), torch.einsum("nkv,nk->nv", J, f), x)
