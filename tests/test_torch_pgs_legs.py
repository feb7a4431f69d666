"""The port's leg-block-sparse PGS form and the solver-form dispatch against
the JAX package's, on the CPU in float64:

- ``physics/solver.py::leg_panels`` against ``_leg_panels`` (vmapped) and
  ``ops/pgs.py::pgs_legs_reference`` against ``_scan_core_legs`` (vmapped,
  per-env slot ids), on random block-arrow problems made with numpy
  (``chip_smoke._random_arrow_batch``, the batched form of
  tests/test_ops.py::_random_arrow_problem): with and without dof rows and
  pair rows, with base-only rows, with same-branch pairs; 1e-12 of max|f|
  (the two differ in summation order only);
- the Delassus identity G Gᵀ = J M⁻¹ Jᵀ of the port's panels, and the
  pre-fix slot metadata (slot 2 active on a same-branch pair) breaking it;
- ``LegMeta`` from the port's ``assemble`` against the JAX package's at
  random pushed-in hexapod states, integer-exact, and the static maps it is
  built from;
- ``solve_contacts`` and three decimated ``pipeline.step`` with both sides
  in the legs form (NIGHTMARE_PGS=legs), 1e-10; the port's legs form
  against its dense form, 1e-9 (another factorization of the same A);
- qacc's change M⁻¹ Jᵀ f from the final slot state (``pgs_legs``'s second
  output, ``arrow.solve_lt``) against M⁻¹ and against the JAX
  package's ``arrow.solve_vec``, 1e-12; the slot assignment made only for
  the legs form;
- ``choose_mode`` against the JAX package's rules for forced modes and the
  CPU default, the probe on the CPU at a small N, and the verdict cache,
  atomic on disk;
- the wrapper's refusals: a layout the legs kernel does not take raises on
  the CPU as on the card, also where the dispatch picks the legs form for
  it (forced, by the CPU default, in the probe).

The legs kernel itself runs on the card only: tests/test_torch_cuda.py and
chip_smoke.py hold it against the plain version.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nightmare_rl_tpu.ops import pgs as jpgs
from nightmare_rl_tpu.physics import arrow as jarrow
from nightmare_rl_tpu.physics import collision as jcol
from nightmare_rl_tpu.physics import dynamics as jdyn
from nightmare_rl_tpu.physics import kinematics as jkin
from nightmare_rl_tpu.physics import loader as jloader
from nightmare_rl_tpu.physics import pipeline as jpipe
from nightmare_rl_tpu.physics import solver as jsolver
from nightmare_rl_tpu_torch.ops import pgs as tpgs
from nightmare_rl_tpu_torch.physics import arrow as tarrow
from nightmare_rl_tpu_torch.physics import collision as tcol
from nightmare_rl_tpu_torch.physics import dynamics as tdyn
from nightmare_rl_tpu_torch.physics import kinematics as tkin
from nightmare_rl_tpu_torch.physics import loader as tloader
from nightmare_rl_tpu_torch.physics import pipeline as tpipe
from nightmare_rl_tpu_torch.physics import solver as tsolver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

TOL = 1e-12                 # plain versions against JAX, /max|f|
ATOL, RTOL = 1e-10, 1e-10   # physics against JAX, both in the legs form
LEGS_DENSE = 1e-9           # the port's legs form against its dense form
ITERS, NOSLIP = 3, 4
N = 4


def _problem(seed, nefc, B, ns_offset=0, npair_rows=0, same=0, base_share=0.15,
             n=3):
    return smoke._random_arrow_batch(np.random.default_rng(seed), n, nefc, B, 3,
                                     6, ns_offset, npair_rows, same, base_share)


def _jax_panels(p):
    """JAX ``_leg_panels`` of each env of a problem, as numpy."""
    n, B, s, _ = p["Ld"].shape
    lay = jarrow.ArrowLayout(6 + B * s, 6, B, s)

    def one(Ld, W, Ls, C, J, l1, l2, h1, h2):
        return jsolver._leg_panels(lay, jarrow.ArrowFac(Ld, W, Ls, C), J,
                                   jsolver.LegMeta(l1, l2, h1, h2))

    return np.array(jax.vmap(one)(*(jnp.asarray(p[k]) for k in (
        "Ld", "W", "Ls", "C", "J", "leg1", "leg2", "has1", "has2"))))


def _port(p):
    """(lay, fac, J, legmeta, b, R, lo, hi) of a problem, CPU tensors."""
    return smoke._legs_args(p, "cpu", torch.float64)


def _rel(out, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(out) - ref).max() / np.abs(ref).max()


CASES = [
    pytest.param(dict(nefc=16, B=4), 0, id="contacts_only"),
    pytest.param(dict(nefc=19, B=5, ns_offset=3, npair_rows=4), 3,
                 id="dof_and_pair_rows"),
    pytest.param(dict(nefc=20, B=6, npair_rows=8, base_share=0.5), 0,
                 id="base_only_rows"),
    pytest.param(dict(nefc=22, B=6, ns_offset=2, npair_rows=8, same=4), 2,
                 id="same_branch_pairs"),
]


@pytest.mark.parametrize("kw,ns_offset", CASES)
def test_leg_panels_match_jax(kw, ns_offset):
    p = _problem(1, **kw)
    lay, fac, J, lm, *_ = _port(p)
    out = tsolver.leg_panels(lay, fac, J, lm).numpy()
    ref = _jax_panels(p)
    assert out.shape == ref.shape == J.shape[:2] + (12,)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw,ns_offset", CASES)
def test_reference_matches_scan_core_legs(kw, ns_offset):
    """The same panels through both sweeps, per-env slot ids."""
    p = _problem(2, **kw)
    Gp = _jax_panels(p)
    B = p["Ld"].shape[1]
    ref = jax.vmap(lambda g, l1, l2, b, r, lo, hi: jpgs._scan_core_legs(
        g, l1, l2, b, r, lo, hi, B, 3, 6, ITERS, NOSLIP, ns_offset))(
        jnp.asarray(Gp), *(jnp.asarray(p[k]) for k in (
            "leg1", "leg2", "b", "R", "lo", "hi")))
    t = {k: torch.from_numpy(np.ascontiguousarray(p[k]))
         for k in ("leg1", "leg2", "b", "R", "lo", "hi")}
    out, _ = tpgs.pgs_legs_reference(torch.from_numpy(Gp), t["leg1"],
                                     t["leg2"], t["b"], t["R"], t["lo"],
                                     t["hi"], B, 3, 6, ITERS, NOSLIP, ns_offset)
    assert _rel(out.numpy(), ref) <= TOL
    assert float(np.abs(np.asarray(ref)).max()) > 0


@pytest.mark.parametrize("kw,ns_offset", CASES)
def test_wrapper_on_the_cpu_is_the_plain_version(kw, ns_offset):
    """``pgs_legs`` on CPU tensors: panels + reference, no kernel launch;
    and the legs form equals the dense form on the same system."""
    p = _problem(3, **kw)
    args = _port(p)
    lay, fac, J, lm, b, R, lo, hi = args
    before = tpgs.pgs_legs.launches
    out, _ = tpgs.pgs_legs(*args, ITERS, NOSLIP, ns_offset)
    assert tpgs.pgs_legs.launches == before
    plain, _ = tpgs.pgs_legs_reference(tsolver.leg_panels(lay, fac, J, lm),
                                       lm.leg1, lm.leg2, b, R, lo, hi,
                                       lay.nbranch, 3, 6, ITERS, NOSLIP,
                                       ns_offset)
    assert torch.equal(out, plain)
    dense = tpgs.pgs_reference(J, J @ torch.from_numpy(p["Minv"]), b, R, lo, hi,
                               ITERS, NOSLIP, ns_offset)
    assert _rel(out.numpy(), dense.numpy()) <= LEGS_DENSE


@pytest.mark.parametrize("kw,ns_offset", CASES)
def test_qacc_change_from_the_slot_state(kw, ns_offset):
    """``pgs_legs``'s second output, L⁻ᵀ u from the final slot state: equal
    to M⁻¹ Jᵀ f and to the JAX package's solve of Jᵀ f with the factor
    (``arrow.solve_vec``, which its legs branch runs)."""
    p = _problem(6, **kw)
    args = _port(p)
    lay, fac, J = args[:3]
    f, dq = tpgs.pgs_legs(*args, ITERS, NOSLIP, ns_offset)
    qfrc = np.einsum("nkv,nk->nv", p["J"], f.numpy())
    assert _rel(dq.numpy(), np.einsum("nij,nj->ni", p["Minv"], qfrc)) <= TOL
    n, B, s, _ = p["Ld"].shape
    jlay = jarrow.ArrowLayout(6 + B * s, 6, B, s)
    ref = jarrow.solve_vec(jlay, jarrow.ArrowFac(
        *(jnp.asarray(p[k]) for k in ("Ld", "W", "Ls", "C"))), jnp.asarray(qfrc))
    assert _rel(dq.numpy(), ref) <= TOL


def _dense_G(Gp, lm, lay):
    """Each env's G (nefc, nv) from its slot panels: slot values added into
    their legs' and the base's columns."""
    n, nefc, _ = Gp.shape
    s, nb = lay.branch_size, lay.nbase
    G = np.zeros((n, nefc, lay.nv))
    for e in range(n):
        for r in range(nefc):
            for slot, leg in ((0, lm.leg1[e, r]), (1, lm.leg2[e, r])):
                c = nb + int(leg) * s
                G[e, r, c:c + s] += Gp[e, r, slot * s:(slot + 1) * s]
            G[e, r, :nb] += Gp[e, r, 2 * s:]
    return G


def test_panels_reconstruct_delassus_and_prefix_metadata_breaks_it():
    """G Gᵀ = J M⁻¹ Jᵀ, same-branch pair rows included; with slot 2 active
    on those rows (the metadata before the same-branch mask) the leg is
    counted twice and the identity breaks."""
    p = _problem(4, nefc=24, B=6, ns_offset=2, npair_rows=10, same=6)
    lay, fac, J, lm, *_ = _port(p)
    A = np.einsum("nrv,nvw,nsw->nrs", p["J"], p["Minv"], p["J"])
    G = _dense_G(tsolver.leg_panels(lay, fac, J, lm).numpy(), lm, lay)
    np.testing.assert_allclose(np.einsum("nrv,nsv->nrs", G, G), A, atol=1e-9)

    same = (lm.leg1 == lm.leg2) & ~lm.has2 & (torch.arange(24) >= 14)
    assert bool(same.any())
    bad = tsolver.LegMeta(lm.leg1, lm.leg2, lm.has1, lm.has2 | same)
    Gb = _dense_G(tsolver.leg_panels(lay, fac, J, bad).numpy(), bad, lay)
    assert np.abs(np.einsum("nrv,nsv->nrs", Gb, Gb) - A).max() > 1e-3


# ---------------------------------------------------------------------------
# the wrapper's geometry and refusals


def test_legs_geometry_of_the_main_path():
    """nefc=112, 6 legs, float32: 4 envs of 8 lanes per warp-sized block,
    five such blocks in one SM's 228 KB (20 envs: one wave of 2048 on 132
    SMs), envs one bank apart (the prologue's rows, 12 words apart, then
    take all 32 banks)."""
    g = tpgs.legs_geometry(112, 6, 3, 6, 4, 0, 4)
    assert g.envs_per_block == 4
    assert g.env_stride % 32 == 1
    banks = {(12 * lane + env * g.env_stride) % 32
             for env in range(4) for lane in range(tpgs.LEG_LANES)}
    assert len(banks) == 32
    npairs = 56
    assert g.env_stride >= 112 * 19 + 3 * npairs + 6 * 27 + 112
    assert 5 * (g.smem_bytes + 1024) <= 228 * 1024
    assert g.smem_bytes <= tpgs.MAX_SMEM
    # and since the row skip: panels with two rows of zeros, records with
    # one, pair records with one zero pair, f with two more, the factor
    # blocks with Ls, then the int32 slot ids (nefc + 2), the 16-bit row and
    # pair lists and the byte slot masks
    ints = 4 * 114 + 2 * (112 + npairs) + 112
    assert g.env_stride >= (114 * 12 + 113 * 6 + 57 * 3 + 114 + 6 * 27 + 36
                            + ints // 4)
    d = tpgs.legs_geometry(112, 6, 3, 6, 4, 0, 8)
    assert d.env_stride >= (114 * 12 + 113 * 6 + 57 * 3 + 114 + 6 * 27 + 36
                            + -(-ints // 8))
    assert d.env_stride % 32 == 1


# ---------------------------------------------------------------------------
# the rows the legs kernel skips: pinned rows and pairs with hi[i] <= 0


def _pin(p, share, seed):
    """Pins all but a share of each env's rows before ns_offset and of its
    facet pairs, lo = hi = 0 on both rows (as an inactive contact's rows
    are); the others active (hi = inf on pairs that had hi = 0)."""
    rng = np.random.default_rng(seed)
    lo, hi = p["lo"], p["hi"]
    n, nefc = lo.shape
    ns_offset = int((lo[0] != 0).sum())
    hi[:, ns_offset:][hi[:, ns_offset:] == 0] = np.inf
    off = np.zeros((n, nefc), bool)
    off[:, :ns_offset] = rng.random((n, ns_offset)) >= share
    off[:, ns_offset:] = np.repeat(
        rng.random((n, (nefc - ns_offset) // 2)) >= share, 2, axis=1)
    lo[off] = 0.0
    hi[off] = 0.0
    return p


@pytest.mark.parametrize("ns_offset", [0, 3])
@pytest.mark.parametrize("share", [0.0, 0.1, 0.5, 1.0])
def test_skipping_pinned_rows_and_idle_pairs_is_exact(share, ns_offset):
    """The premise of the legs kernel's row and pair lists: on finite
    inputs the plain version over the full system gives exactly
    (``torch.equal``; a zero's sign may differ) the f and the final slot
    state, hence the dqacc, of a run over each env's rows that are not
    pinned and pairs with hi[i] > 0 only, f re-expanded with zeros.  The
    full run is also held against ``_scan_core_legs``."""
    nefc = ns_offset + 24
    p = _pin(_problem(8, nefc=nefc, B=6, ns_offset=ns_offset, npair_rows=8,
                      same=2), share, seed=int(share * 10) + ns_offset)
    lay, fac, J, lm, b, R, lo, hi = _port(p)
    Gp = tsolver.leg_panels(lay, fac, J, lm)
    f, u = tpgs.pgs_legs_reference(Gp, lm.leg1, lm.leg2, b, R, lo, hi, 6, 3, 6,
                                   ITERS, NOSLIP, ns_offset)
    dq = tarrow.solve_lt(lay, fac, u)
    ref = jax.vmap(lambda g, l1, l2, b_, r_, lo_, hi_: jpgs._scan_core_legs(
        g, l1, l2, b_, r_, lo_, hi_, 6, 3, 6, ITERS, NOSLIP, ns_offset))(
        jnp.asarray(Gp.numpy()), *(jnp.asarray(p[k]) for k in (
            "leg1", "leg2", "b", "R", "lo", "hi")))
    assert np.abs(f.numpy() - np.asarray(ref)).max() <= TOL * max(
        float(np.abs(np.asarray(ref)).max()), 1.0)
    pinned = (lo == 0) & (hi == 0)
    swept = 0
    for e in range(lo.shape[0]):
        rows = [r for r in range(ns_offset) if not pinned[e, r]]
        dof_rows = len(rows)
        for i in range(ns_offset, nefc - 1, 2):
            if hi[e, i] > 0:
                rows += [i, i + 1]
        swept += len(rows)
        assert not pinned[e, rows].any() and pinned[e].sum() + len(rows) == nefc
        fr, ur = torch.zeros(nefc, dtype=f.dtype), torch.zeros_like(u[e])
        if rows:
            sel = torch.tensor(rows)
            fk, uk = tpgs.pgs_legs_reference(
                Gp[e:e + 1, sel], lm.leg1[e:e + 1, sel], lm.leg2[e:e + 1, sel],
                b[e:e + 1, sel], R[e:e + 1, sel], lo[e:e + 1, sel],
                hi[e:e + 1, sel], 6, 3, 6, ITERS, NOSLIP, dof_rows)
            fr[sel], ur = fk[0], uk[0]
        assert torch.equal(f[e], fr) and torch.equal(u[e], ur)
        fac_e = tarrow.ArrowFac(*(x[e:e + 1] for x in fac))
        assert torch.equal(dq[e:e + 1], tarrow.solve_lt(lay, fac_e, ur[None]))
    assert swept == int((~pinned).sum())
    if share == 1.0:
        assert swept == lo.numel()
    if share == 0.0:
        assert swept == 0 and not f.any()


@pytest.mark.parametrize("where", ["pinned", "active"])
def test_nan_in_b_matches_scan_core_legs(where):
    """A NaN in b of a pinned row, or of an active row: the port's plain
    version (``pgs_legs`` on CPU tensors) and the JAX package's
    ``_scan_core_legs`` put NaN at the same positions, and the finite
    values agree; the legs kernel, which skips pinned rows, must do the same
    (tests/test_torch_cuda.py, chip_smoke.py kernel-legs)."""
    p = _pin(_problem(9, nefc=27, B=6, ns_offset=3, npair_rows=8, same=2),
             0.3, seed=9)
    pinned = (p["lo"] == 0) & (p["hi"] == 0)
    env = 1
    rows = np.nonzero(pinned[env] if where == "pinned" else ~pinned[env])[0]
    assert rows.size
    p["b"][env, rows[len(rows) // 2]] = np.nan
    out, dq = tpgs.pgs_legs(*_port(p), ITERS, NOSLIP, 3)
    ref = np.asarray(jax.vmap(lambda g, l1, l2, b_, r_, lo_, hi_:
                              jpgs._scan_core_legs(g, l1, l2, b_, r_, lo_, hi_,
                                                   6, 3, 6, ITERS, NOSLIP, 3))(
        jnp.asarray(_jax_panels(p)), *(jnp.asarray(p[k]) for k in (
            "leg1", "leg2", "b", "R", "lo", "hi"))))
    out = out.numpy()
    assert np.array_equal(np.isnan(out), np.isnan(ref))
    assert np.isnan(out[env]).any() and not np.isnan(np.delete(out, env, 0)).any()
    assert np.isnan(dq.numpy()[env]).all()
    fin = ~np.isnan(ref)
    assert _rel(out[fin], ref[fin]) <= TOL


@pytest.mark.parametrize("shape", [(6, 4, 6), (7, 3, 6), (4, 3, 7), (0, 3, 6)])
def test_wrapper_refuses_layouts_the_kernel_does_not_take(shape):
    """Legs of other than 3 dofs, more than 6 legs or a base of other than
    6 dofs: refused on every device."""
    B, s, nb = shape
    nv, nefc = nb + B * s, 8
    z = lambda *sh: torch.zeros(*sh, dtype=torch.float64)
    ids = torch.zeros(1, nefc, dtype=torch.int32)
    mask = torch.ones(1, nefc, dtype=torch.bool)
    lay = tarrow.ArrowLayout(nv, nb, B, s)
    fac = tarrow.ArrowFac(z(1, B, s, s), z(1, B, s, nb), z(1, nb, nb),
                          z(1, B, s, nb))
    v = z(1, nefc)
    with pytest.raises(ValueError):
        tpgs.pgs_legs(lay, fac, z(1, nefc, nv), tsolver.LegMeta(ids, ids, mask, mask),
                      v, v, v, v, ITERS, NOSLIP, 0)
    assert not tpgs.legs_layout_ok(shape)


@pytest.mark.parametrize("bad", ["ids_dtype", "ids_range", "mask_dtype", "shape"])
def test_wrapper_rejects_bad_operands(bad):
    lay, fac, J, lm, b, R, lo, hi = _port(_problem(5, nefc=16, B=4))
    if bad == "ids_dtype":
        lm = lm._replace(leg1=lm.leg1.long())
    elif bad == "ids_range":
        lm = lm._replace(leg2=lm.leg2 + 4)
    elif bad == "mask_dtype":
        lm = lm._replace(has1=lm.has1.double())
    else:
        b = b[:, :-1].contiguous()
    with pytest.raises(ValueError):
        tpgs.pgs_legs(lay, fac, J, lm, b, R, lo, hi, ITERS, NOSLIP, 0)


# ---------------------------------------------------------------------------
# the slot assignment and the physics, hexapod in float64


@pytest.fixture(scope="module")
def systems():
    js = dataclasses.replace(jloader.load_system("nightmare_v3"), max_contacts=24)
    ts = dataclasses.replace(tloader.load_system("nightmare_v3", device="cpu"),
                             max_contacts=24)
    return js, ts


@pytest.fixture(scope="module")
def inputs(systems):
    js, _ = systems
    rng = np.random.default_rng(7)
    qpos = np.tile(np.asarray(js.qpos0), (N, 1))
    qpos[:, 7:] += rng.normal(size=(N, 18)) * 0.3
    qpos[:, 3:7] += rng.normal(size=(N, 4)) * 0.1
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    qpos[:, 2] -= rng.uniform(0.09, 0.12, size=N)   # feet and tibias in the floor
    qvel = rng.normal(size=(N, 24))
    ctrl = rng.normal(size=(N, 18)) * 5.0
    return qpos, qvel, ctrl


@pytest.fixture(scope="module")
def jax_legs(systems, inputs):
    """The JAX package's assembly and contact solve in the legs form,
    vmapped over envs, one jit."""
    js, _ = systems
    lay = jarrow.layout(js)

    def one(q, v, c):
        kin = jkin.kinematics(js, q)
        vel = jkin.com_vel(js, kin, v)
        M = jdyn.crb(js, kin)
        act = jdyn.actuation(js, q, v, c)
        fac = jarrow.factor(lay, M)
        qacc_smooth = jarrow.solve_vec(
            lay, fac, act.qfrc_actuator - jdyn.rne_bias(js, kin, vel, v))
        con = jcol.find_contacts(js, kin)
        pair = jcol.find_pair_contacts(js, kin, con)
        asm = jsolver.assemble(js, con, q, v, pair=pair, lay=lay)
        sol = jsolver.solve_contacts(js, con, q, v, None, qacc_smooth,
                                     pair=pair, M=M, lay=lay, fac=fac)
        return asm.legmeta, sol

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NIGHTMARE_PGS", "legs")
        return jax.jit(jax.vmap(one))(*map(jnp.asarray, inputs))


def _port_solve(ts, inputs):
    q, v, c = (torch.from_numpy(x) for x in inputs)
    lay = tarrow.layout(ts)
    kin = tkin.kinematics(ts, q)
    vel = tkin.com_vel(ts, kin, v)
    M = tdyn.crb(ts, kin)
    act = tdyn.actuation(ts, q, v, c)
    fac = tarrow.factor(lay, M)
    qacc_smooth = tarrow.solve_vec(
        lay, fac, act.qfrc_actuator - tdyn.rne_bias(ts, kin, vel, v))
    con = tcol.find_contacts(ts, kin)
    pair = tcol.find_pair_contacts(ts, kin, con)
    asm = tsolver.assemble(ts, con, q, v, pair=pair, lay=lay)
    sol = tsolver.solve_contacts(ts, con, q, v, qacc_smooth, pair=pair, lay=lay,
                                 fac=fac)
    return asm, sol


def test_legmeta_matches_jax(systems, inputs, jax_legs, monkeypatch):
    """Integer-exact at states with base-only, plane and tibia-pair rows."""
    _, ts = systems
    monkeypatch.setenv("NIGHTMARE_PGS", "legs")
    asm, _ = _port_solve(ts, inputs)
    jlm, lm = jax_legs[0], asm.legmeta
    assert lm.leg1.dtype == torch.int32 and lm.has1.dtype == torch.bool
    for name in lm._fields:
        np.testing.assert_array_equal(getattr(lm, name).numpy(),
                                      np.asarray(getattr(jlm, name)), err_msg=name)
    assert bool((~lm.has1).any()) and bool(lm.has2.any())


def test_solve_contacts_legs_matches_jax(systems, inputs, jax_legs, monkeypatch):
    _, ts = systems
    monkeypatch.setenv("NIGHTMARE_PGS", "legs")
    before = tpgs.pgs.launches, tpgs.pgs_legs.launches
    _, sol = _port_solve(ts, inputs)
    assert (tpgs.pgs.launches, tpgs.pgs_legs.launches) == before
    jsol = jax_legs[1]
    for name in ("nforce", "qfrc_constraint", "qacc"):
        np.testing.assert_allclose(getattr(sol, name).numpy(),
                                   np.asarray(getattr(jsol, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert float(sol.nforce.abs().max()) > 0


def _port_steps(ts, inputs, mode):
    qpos, qvel, ctrl = inputs
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NIGHTMARE_PGS", mode)
        st = tpipe.make_state(ts, N).replace(qpos=torch.from_numpy(qpos),
                                             qvel=torch.from_numpy(qvel))
        for _ in range(3):
            st = tpipe.step(ts, st, torch.from_numpy(ctrl), 2)
    return st


def test_pipeline_three_decimated_steps_legs(systems, inputs):
    js, ts = systems
    qpos, qvel, ctrl = inputs
    jstate = jax.vmap(lambda q, v: jpipe.make_state(js).replace(qpos=q, qvel=v))(
        jnp.asarray(qpos), jnp.asarray(qvel))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NIGHTMARE_PGS", "legs")
        fn = jax.jit(jax.vmap(lambda s, c: jpipe.step(js, s, c, 2)))
        for _ in range(3):
            jstate = fn(jstate, jnp.asarray(ctrl))
    tstate = _port_steps(ts, inputs, "legs")
    for f in dataclasses.fields(tstate):
        np.testing.assert_allclose(getattr(tstate, f.name).numpy(),
                                   np.asarray(getattr(jstate, f.name)),
                                   rtol=RTOL, atol=ATOL, err_msg=f.name)
    assert float(tstate.sensordata.abs().max()) > 0


def test_port_legs_form_matches_dense_form(systems, inputs):
    _, ts = systems
    legs, dense = (_port_steps(ts, inputs, m) for m in ("legs", "scan"))
    for f in ("qpos", "qvel", "qacc_warmstart", "sensordata"):
        np.testing.assert_allclose(getattr(legs, f).numpy(),
                                   getattr(dense, f).numpy(), rtol=LEGS_DENSE,
                                   atol=LEGS_DENSE, err_msg=f)


def test_only_the_legs_form_makes_the_slot_assignment(systems, inputs,
                                                     monkeypatch):
    """``solve_contacts`` makes the rows' slot assignment for the legs form
    only: the dense form, forced or chosen, pays nothing for it."""
    _, ts = systems
    calls = []
    real = tsolver._legmeta
    monkeypatch.setattr(tsolver, "_legmeta",
                        lambda *a: calls.append(1) or real(*a))
    for mode, want in (("scan", 0), ("kernel", 0), ("legs", 1)):
        calls.clear()
        monkeypatch.setenv("NIGHTMARE_PGS", mode)
        q, v, c = (torch.from_numpy(x) for x in inputs)
        st = tpipe.make_state(ts, N).replace(qpos=q, qvel=v)
        tpipe.step(ts, st, c, 1)
        assert len(calls) == want, mode


@pytest.mark.parametrize("forced", ["legs", None])
def test_unsupported_layout_is_refused_through_the_dispatch(systems, inputs,
                                                            forced, monkeypatch):
    """A block-arrow layout the legs kernel does not take (the hexapod's 18
    leg dofs read as 9 legs of 2) has the legs form offered as the JAX
    package offers it, forced or by the CPU default, and the step refuses
    it with an error; it never steps in the dense form unasked.  Asked for
    (NIGHTMARE_PGS=scan), the dense form steps it."""
    _, ts = systems
    lay = tarrow.ArrowLayout(24, 6, 9, 2)
    monkeypatch.setattr(tarrow, "layout", lambda s: lay)
    if forced is None:
        monkeypatch.delenv("NIGHTMARE_PGS", raising=False)
    else:
        monkeypatch.setenv("NIGHTMARE_PGS", forced)
    assert tsolver.prewarm(ts) == "legs"
    q, v, c = (torch.from_numpy(x) for x in inputs)
    st = tpipe.make_state(ts, N).replace(qpos=q, qvel=v)
    with pytest.raises(ValueError, match="NIGHTMARE_PGS"):
        tpipe.step(ts, st, c, 1)
    monkeypatch.setenv("NIGHTMARE_PGS", "scan")
    assert bool(torch.isfinite(tpipe.step(ts, st, c, 1).qpos).all())


def test_point_leg_map_and_dof_rows_match_jax(systems):
    """The static maps, on the hexapod, on anymal_c (dof rows) and on a
    hexapod whose tibias lost their joints (the walk up to the femur), and
    the row count prewarm derives against the assembled one."""
    js, ts = systems
    assert tsolver._point_leg_map(ts, tarrow.layout(ts)) == tuple(
        jsolver._point_leg_map(js, jarrow.layout(js)))
    assert -1 in tsolver._point_leg_map(ts, tarrow.layout(ts))  # base points
    tib = sorted({ts.cpoint_bodyid[p] for p in range(ts.ncp)} - {1})
    cut = lambda s: dataclasses.replace(s, body_jntnum=tuple(
        0 if b in tib else n for b, n in enumerate(s.body_jntnum)))
    lay = tarrow.layout(ts)
    assert tsolver._point_leg_map(cut(ts), lay) == tuple(
        jsolver._point_leg_map(cut(js), jarrow.layout(js)))
    assert tsolver._point_leg_map(cut(ts), lay) == tsolver._point_leg_map(ts, lay)
    ja, ta = jloader.load_system("anymal_c"), tloader.load_system("anymal_c",
                                                                  device="cpu")
    assert tsolver._dof_row_dofs(ta) == tuple(
        int(d) for d in jsolver._dof_row_dofs(ja))
    assert len(tsolver._dof_row_dofs(ta)) == 36
    assert tsolver._row_count(ts) == 112


def test_prewarm_derives_the_solve_key(systems, inputs, monkeypatch):
    """prewarm asks choose_mode with the key the first solve asks with:
    nefc from the System alone, the legs form on the CPU; Newton models
    answer "newton"."""
    _, ts = systems
    monkeypatch.delenv("NIGHTMARE_PGS", raising=False)
    keys = []
    real = tsolver.choose_mode

    def spy(**kw):
        keys.append(kw)
        return real(**kw)

    monkeypatch.setattr(tsolver, "choose_mode", spy)
    assert tsolver.prewarm(ts) == "legs"
    _port_solve(ts, inputs)
    assert keys[0] == keys[1], keys
    assert keys[0]["nefc"] == 112 and keys[0]["lay_shape"] == (6, 3, 6)
    assert tsolver.prewarm(tloader.load_system("anymal_c", device="cpu")) == "newton"
    spheres = tloader.load_system("spheres_condim6", device="cpu")
    assert tsolver.prewarm(spheres) == "scan"
    assert tsolver._row_count(spheres) == 18


# ---------------------------------------------------------------------------
# the dispatch


@pytest.mark.parametrize("forced,avail", [
    ("scan", True), ("legs", True), ("legs", False), ("kernel", True),
    (None, True), (None, False)])
def test_choose_mode_matches_jax_rules(forced, avail, monkeypatch):
    """Forced modes and the CPU default, as the JAX package decides them."""
    if forced is None:
        monkeypatch.delenv("NIGHTMARE_PGS", raising=False)
    else:
        monkeypatch.setenv("NIGHTMARE_PGS", forced)
    lay = (4, 3, 6) if avail else None
    want = jpgs.choose_mode(avail, 16, 18, 3, 4, 0, lay)
    assert tpgs.choose_mode(avail, 16, 18, 3, 4, 0, lay, "float64", "cpu") == want
    assert want == {("legs", False): "scan", (None, True): "legs",
                    (None, False): "scan"}.get((forced, avail), forced)


def test_probe_runs_on_the_cpu(tmp_path, monkeypatch):
    """The probe at a small N times both candidates (the plain versions
    here) and returns one of them; a layout the legs kernel does not take
    is refused there too, not ranked out."""
    monkeypatch.setenv("NIGHTMARE_PROBE_CACHE", str(tmp_path / "probe.json"))
    mode = tpgs._probed_mode(16, 24, 3, 4, 0, (6, 3, 6), True, "float32", "cpu",
                             N=4)
    assert mode in ("scan", "legs")
    assert tpgs.last_probe["mode"] == mode and tpgs.last_probe["N"] == 4
    assert set(tpgs.last_probe["ms"]) == {"scan", "legs"}
    assert tpgs._probed_mode(16, 24, 3, 4, 0, None, False, "float64",
                             "cpu", N=4) == "scan"
    with pytest.raises(ValueError, match="NIGHTMARE_PGS"):
        tpgs._probed_mode(16, 24, 3, 4, 0, (9, 2, 6), True, "float32", "cpu",
                          N=4)


def test_choose_mode_caches_the_card_verdict(tmp_path, monkeypatch):
    """On the card (faked: the probe and the card's name stubbed) the first
    dispatch probes and stores its verdict atomically; a new process (the
    memory cache cleared) reads it back without probing, under the key of
    its card and NIGHTMARE_PROBE_N; NIGHTMARE_PROBE=reprobe probes again;
    without the legs form there is nothing to probe."""
    path = tmp_path / "probe.json"
    monkeypatch.setenv("NIGHTMARE_PROBE_CACHE", str(path))
    monkeypatch.delenv("NIGHTMARE_PGS", raising=False)
    monkeypatch.delenv("NIGHTMARE_PROBE", raising=False)
    monkeypatch.setattr(tpgs, "_MODE_CACHE", {})
    monkeypatch.setattr(tpgs, "_backend_fingerprint", lambda d: "cuda/fake")
    calls = []
    monkeypatch.setattr(tpgs, "_probed_mode",
                        lambda *a: calls.append(a) or "legs")
    key = (True, 112, 24, 3, 4, 0, (6, 3, 6), "float32", "cuda")
    assert tpgs.choose_mode(*key) == "legs" and len(calls) == 1
    assert tpgs.choose_mode(*key) == "legs" and len(calls) == 1
    stored = json.loads(path.read_text())
    assert list(stored.values()) == ["legs"]
    assert next(iter(stored)).startswith("cuda/fake|N2048|")
    assert [f for f in os.listdir(tmp_path) if f != "probe.json"] == []
    tpgs._MODE_CACHE.clear()
    assert tpgs.choose_mode(*key) == "legs" and len(calls) == 1
    monkeypatch.setenv("NIGHTMARE_PROBE", "reprobe")
    tpgs._MODE_CACHE.clear()
    assert tpgs.choose_mode(*key) == "legs" and len(calls) == 2
    assert tpgs.choose_mode(False, 112, 24, 3, 4, 0, None, "float32",
                            "cuda") == "kernel" and len(calls) == 2
    monkeypatch.setenv("NIGHTMARE_PROBE_CACHE", "")
    tpgs._MODE_CACHE.clear()
    assert tpgs.choose_mode(*key) == "legs" and len(calls) == 3


@pytest.mark.parametrize("tool,argv", [
    ("profile_pgs", ["-e", "8", "--form", "legs"]),
    ("profile_step", ["-e", "4", "--forms", "legs", "kernel"]),
])
def test_profilers_refuse_to_run_without_a_card(tool, argv, monkeypatch):
    """The profilers measure the card or nothing, in either form."""
    import importlib

    mod = importlib.import_module(f"nightmare_rl_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        mod.main(argv)
