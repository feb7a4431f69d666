"""The port's Newton solver (nightmare_rl_tpu_torch/physics/newton.py) and
its Cholesky (ops/linalg.py) against the JAX package's, on random batches.

Inputs are made with numpy from a seed in float64 and go through both
sides on the CPU.  The batches hold dof-friction rows (quadratic and
saturated), one-sided rows (active and not) and two elliptic cone groups,
of dim 3 and 6, with contacts in each zone (bottom, middle, top and
inactive).  The JAX functions take one env, so they run under vmap with the
cone groups' static offsets closed over.  The zone functions agree to
1e-12; the whole solve, a chain of Newton steps and line searches, to 1e-10.

The solve is held at 4 Newton steps with 2 line-search refinements.  Once
the refinements reach the round-off floor of φ'(α), the sign of φ' at the
last one is noise, and the rule "take the bracket's low end when φ' > 0"
jumps, so two correct implementations part far beyond round-off (the JAX
package's vmapped and per-env solves do:
test_torch_anymal.py::test_reference_solve_depends_on_batching).  On this
batch two refinements stop above that floor, so the comparison holds the
arithmetic to round-off.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nightmare_rl_tpu.ops import linalg as jlinalg
from nightmare_rl_tpu.physics import newton as jnewton
from nightmare_rl_tpu_torch.ops import linalg as tlinalg
from nightmare_rl_tpu_torch.physics import newton as tnewton

N, NV = 8, 10
N_FL, N_ONE = 4, 6                 # dof-friction rows, one-sided rows
GROUPS = ((3, 4), (6, 3))          # (dim, contacts) per cone group
ZONES = ("bottom", "middle", "top", "inactive")
TOL_FN, TOL_SOLVE = 1e-12, 1e-10


def _layout():
    start, out = N_FL + N_ONE, []
    for d, n in GROUPS:
        out.append((start, d, n))
        start += d * n
    return out, start


CONES, NEFC = _layout()


def _zone_jar(rng, mu, mus, zone):
    """A cone's jar [u0 | tangential] that lands in ``zone``."""
    t = rng.normal(size=mus.shape) * 0.5
    T = np.sqrt(np.sum((t * mus / mu) ** 2))
    u0 = {"bottom": -1.5 * T / mu, "middle": -0.5 * T / mu,
          "top": 1.5 * mu * T + 0.1, "inactive": rng.normal()}[zone]
    return np.concatenate([[u0], t])


@pytest.fixture(scope="module")
def batch():
    return make_batch()


def make_batch():
    """A random batch: the efc arrays, jar, a direction Jp and the zones."""
    rng = np.random.default_rng(7)
    J = rng.normal(size=(N, NEFC, NV))
    aref = rng.normal(size=(N, NEFC))
    R = rng.uniform(0.05, 0.5, size=(N, NEFC))
    fl = np.zeros((N, NEFC))
    fl[:, :N_FL] = rng.uniform(0.2, 1.0, size=(N, N_FL))
    qa = np.zeros((N, NEFC), bool)
    qa[:, N_FL:N_FL + N_ONE] = rng.random((N, N_ONE)) < 0.7
    jar = rng.normal(size=(N, NEFC))
    # dof friction: half quadratic (|jar|·D ≤ fl), half saturated
    sat = rng.random((N, N_FL)) < 0.5
    mag = np.where(sat, 2.0, 0.5) * fl[:, :N_FL] * R[:, :N_FL]
    jar[:, :N_FL] = np.sign(rng.normal(size=(N, N_FL))) * mag
    cones, zones = [], []
    for start, d, n in CONES:
        mus = rng.uniform(0.05, 1.0, size=(N, n, d - 1))
        mu = mus[..., 0] / 10.0                   # μ₁/√impratio, impratio 100
        zone = rng.integers(0, 4, size=(N, n))
        for e in range(N):
            for c in range(n):
                jar[e, start + c * d:start + (c + 1) * d] = _zone_jar(
                    rng, mu[e, c], mus[e, c], ZONES[zone[e, c]])
        cones.append(dict(mu=mu, mus=mus, active=zone != 3))
        zones.append(zone)
    Jp = rng.normal(size=(N, NEFC))
    return dict(J=J, aref=aref, R=R, fl=fl, qa=qa, cones=cones, jar=jar,
                Jp=Jp, zones=zones, sat=sat)


def _leaves(b):
    out = [b["J"], b["aref"], b["R"], b["qa"], b["fl"]]
    for c in b["cones"]:
        out += [c["mu"], c["mus"], c["active"]]
    return [jnp.asarray(x) for x in out]


def _jefc(J, aref, R, qa, fl, *cones):
    gs = tuple(jnewton.ConeGroup(start, d, *cones[3 * i:3 * i + 3])
               for i, (start, d, _) in enumerate(CONES))
    return jnewton.NewtonEfc(J, aref, R, qa, fl, gs)


def _tefc(b):
    t = torch.from_numpy
    gs = tuple(tnewton.ConeGroup(start, d, t(c["mu"]), t(c["mus"]),
                                 t(c["active"]))
               for (start, d, _), c in zip(CONES, b["cones"]))
    return tnewton.NewtonEfc(t(b["J"]), t(b["aref"]), t(b["R"]), t(b["qa"]),
                             t(b["fl"]), gs)


def _close(a, b, tol, name=""):
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype == bool:
        np.testing.assert_array_equal(b, a, err_msg=name)
    else:
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=name)


def test_batch_covers_every_zone_and_row_kind(batch):
    for zone in batch["zones"]:
        assert set(np.unique(zone)) == {0, 1, 2, 3}
    assert batch["sat"].any() and (~batch["sat"]).any()
    assert batch["qa"].any() and (~batch["qa"][:, N_FL:N_FL + N_ONE]).any()


def test_cone_terms_zones_match_construction(batch):
    """The port's zone masks are the zones the batch was built for."""
    efc = _tefc(batch)
    for g, zone in zip(efc.cones, batch["zones"]):
        c = tnewton._cone_terms(efc, g, torch.from_numpy(batch["jar"]))
        np.testing.assert_array_equal(c.bottom.numpy(), zone == 0)
        np.testing.assert_array_equal(c.mid.numpy(), zone == 1)


def test_forces(batch):
    ref = jax.vmap(lambda jar, *l: jnewton.forces(_jefc(*l), jar))(
        jnp.asarray(batch["jar"]), *_leaves(batch))
    f, diag = tnewton.forces(_tefc(batch), torch.from_numpy(batch["jar"]))
    _close(ref[0], f, TOL_FN, "f")
    _close(ref[1], diag, TOL_FN, "diag")
    assert float(f.abs().max()) > 0.0


def test_constraint_cost(batch):
    ref = jax.vmap(lambda jar, *l: jnewton.constraint_cost(_jefc(*l), jar))(
        jnp.asarray(batch["jar"]), *_leaves(batch))
    _close(ref, tnewton.constraint_cost(_tefc(batch),
                                        torch.from_numpy(batch["jar"])), TOL_FN)


@pytest.mark.parametrize("group", [0, 1], ids=["dim3", "dim6"])
def test_cone_hessians(batch, group):
    ref = jax.vmap(lambda jar, *l: jnewton._cone_hessians(
        _jefc(*l), _jefc(*l).cones[group], jar))(
        jnp.asarray(batch["jar"]), *_leaves(batch))
    efc = _tefc(batch)
    B = tnewton._cone_hessians(efc, efc.cones[group],
                               torch.from_numpy(batch["jar"]))
    _close(ref, B, TOL_FN)
    assert float(B.abs().max()) > 0.0   # middle-zone contacts carry blocks


def test_dir_curv(batch):
    ref = jax.vmap(lambda jar, Jp, *l: jnewton._dir_curv(_jefc(*l), jar, Jp))(
        jnp.asarray(batch["jar"]), jnp.asarray(batch["Jp"]), *_leaves(batch))
    f, curv = tnewton._dir_curv(_tefc(batch), torch.from_numpy(batch["jar"]),
                                torch.from_numpy(batch["Jp"]))
    _close(ref[0], f, TOL_FN, "f")
    _close(ref[1], curv, TOL_FN, "curv")


def test_dir_curv_takes_a_candidate_axis(batch):
    """The line search's grid: jar (C, N, nefc) gives each candidate's
    result, as C separate calls do."""
    efc = _tefc(batch)
    jar, Jp = torch.from_numpy(batch["jar"]), torch.from_numpy(batch["Jp"])
    alphas = torch.tensor([0.0, 0.3, 2.0], dtype=torch.float64)
    f, curv = tnewton._dir_curv(efc, jar + alphas[:, None, None] * Jp, Jp)
    for k, a in enumerate(alphas):
        f1, c1 = tnewton._dir_curv(efc, jar + a * Jp, Jp)
        torch.testing.assert_close(f[k], f1, rtol=0, atol=0)
        torch.testing.assert_close(curv[k], c1, rtol=1e-15, atol=1e-15)


def _spd(rng, n, batch=()):
    G = rng.normal(size=batch + (n, n))
    return G @ np.swapaxes(G, -1, -2) + n * np.eye(n)


def test_chol_matches_and_solves():
    rng = np.random.default_rng(3)
    H = _spd(rng, 18, (N,))
    b = rng.normal(size=(N, 18))
    L = tlinalg.chol(torch.from_numpy(H))
    _close(jlinalg.chol(jnp.asarray(H)), L, TOL_FN)
    x = tlinalg.cho_solve(L, torch.from_numpy(b))
    ref = jax.vmap(lambda Hi, bi: jax.scipy.linalg.cho_solve(
        (jlinalg.chol(Hi), True), bi))(jnp.asarray(H), jnp.asarray(b))
    _close(ref, x, TOL_FN)


def test_chol_gives_nan_where_not_spd():
    """A matrix with a negative pivot factors to NaN, as the JAX package's
    unrolled factor does; its neighbours in the batch are untouched."""
    rng = np.random.default_rng(4)
    H = _spd(rng, 6, (3,))
    H[1, 3, 3] = -50.0
    ref = np.asarray(jlinalg.chol(jnp.asarray(H)))
    L = tlinalg.chol(torch.from_numpy(H))
    assert np.isnan(ref[1]).any() and bool(torch.isnan(L[1]).all())
    _close(ref[[0, 2]], L[[0, 2]], TOL_FN)


@pytest.fixture(scope="module")
def solve_inputs(batch):
    return make_solve_inputs(batch)


def make_solve_inputs(batch):
    """M, qacc_smooth and a warmstart that is the converged solution for
    the first half of the envs and far off for the rest."""
    rng = np.random.default_rng(9)
    M = _spd(rng, NV, (N,)) * 0.2
    a0 = rng.normal(size=(N, NV)) * 3.0
    conv = jax.vmap(lambda M_, a, *l: jnewton.solve(_jefc(*l), M_, a, 30, 20))(
        jnp.asarray(M), jnp.asarray(a0), *_leaves(batch)).qacc
    x0 = np.array(conv)
    x0[N // 2:] = a0[N // 2:] + rng.normal(size=(N - N // 2, NV)) * 50.0
    return M, a0, x0


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warmstart"])
def test_solve(batch, solve_inputs, warm):
    M, a0, x0 = solve_inputs
    it, ls = 4, 2
    ref = jax.vmap(lambda M_, a, x, *l: jnewton.solve(
        _jefc(*l), M_, a, it, ls, x0=x if warm else None))(
        jnp.asarray(M), jnp.asarray(a0), jnp.asarray(x0), *_leaves(batch))
    t = torch.from_numpy
    out = tnewton.solve(_tefc(batch), t(M), t(a0), it, ls,
                        x0=t(x0) if warm else None)
    for name in ("force", "qfrc_constraint", "qacc"):
        _close(getattr(ref, name), getattr(out, name), TOL_SOLVE, name)
    if warm:
        # some envs start from the warmstart, some from qacc_smooth
        efc = _tefc(batch)

        def cost(x):
            dx = x - t(a0)
            return (0.5 * torch.sum(dx * torch.einsum("nij,nj->ni", t(M), dx), -1)
                    + tnewton.constraint_cost(efc, torch.einsum(
                        "nkv,nv->nk", efc.J, x) - efc.aref))

        use_ws = cost(t(x0)) < cost(t(a0))
        assert bool(use_ws.any()) and bool((~use_ws).any())
