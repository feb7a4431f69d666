"""The Newton kernel's arithmetic against the JAX package, on the CPU.

``ops/csrc/newton.cu`` runs its per-env solve from ``ops/csrc/
newton_env.cuh`` with a warp as the team; the host driver ``ops/csrc/
newton_host.cpp`` runs the same functions with a team of host threads
(built here with g++ into the package's ``_build/``; the tests skip where
g++ is missing), whose members split the loops as the warp's lanes do.
The driver is held against ``jax.vmap(nightmare_rl_tpu.physics.newton.
solve)`` in float64 on two batches: test_torch_newton.py's random one
(dof-friction and one-sided rows, dim-3 and dim-6 cone groups with
contacts in every zone) and anymal_c's own rows, taken from its physics
step at a few envs with perturbed joints and velocities.  Both run cold
and warmstarted at 4 Newton steps, with 2 and with 1 line-search
refinements, with teams of one and of four members, and in two cases with
a team whose size divides none of nv, nefc and the contact count; and
once at nv = 40, where the factor lives in the workspace.

Where a decision of the line search (the sign of φ' at a grid candidate
or a refinement, the last one's "take the bracket's low end when φ' > 0")
is taken on the round-off floor of φ', two correct solves part far beyond
round-off (tests/test_torch_newton.py, test_torch_anymal.py::
test_reference_solve_depends_on_batching).  So an env is held to TOL
unless the port's plain solve, traced (``physics/newton.py::solve(...,
trace=...)``), puts one of the φ' values its decisions read within FLOOR
round-off scales of zero in a Newton step that can move x by more than
TOL.  With one refinement most envs stand above the floor, with two some
do.

Beside it: the wrapper ``ops/newton.py`` gives CPU tensors to the plain
version and refuses on every device a shape the kernel does not take,
``physics/solver.py::solve_contacts`` on CPU tensors runs the plain
``newton.solve``, the driver gives NaN for the same envs as the plain
version, and the wrapper imports nothing of JAX.
"""

import dataclasses
import importlib.util
import os
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nightmare_rl_tpu.physics import newton as jnewton
from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg
from nightmare_rl_tpu_torch.ops import newton as K
from nightmare_rl_tpu_torch.physics import loader, pipeline
from nightmare_rl_tpu_torch.physics import newton as tnewton

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "test_torch_newton", os.path.join(REPO, "tests", "test_torch_newton.py"))
TN = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TN)

TOL = 1e-10           # max |driver - JAX| / (1 + max |JAX|) per env and field
FLOOR = 4.0           # |φ'| under FLOOR round-off scales: the decision is noise
BUDGETS = ((4, 2), (4, 1))
TEAMS = (1, 4)        # host team sizes: one member, and several as a warp's lanes
N_ANYMAL = 6
FIELDS = ("force", "qfrc_constraint", "qacc")


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host driver cannot be built")
    return K.host_solve


def _random_case():
    b = TN.make_batch()
    M, a0, x0 = TN.make_solve_inputs(b)
    t = torch.from_numpy
    return TN._tefc(b), t(M), t(a0), t(x0)


def _anymal_case():
    """The inputs of the last Newton solve of one decimated anymal_c step
    (the env's contact cap and budget) from the reference pose with
    perturbed joints and velocities that grow over the envs."""
    sys_ = dataclasses.replace(loader.load_system("anymal_c", device="cpu"),
                               max_contacts=AnymalCCfg().max_contacts,
                               solver_iterations=AnymalCCfg().solver_iterations)
    g = torch.Generator().manual_seed(1)
    N = N_ANYMAL
    st = pipeline.make_state(sys_, N)
    qpos = st.qpos.clone()
    qpos[:, 7:] += 0.2 * torch.randn(N, 12, generator=g, dtype=torch.float64)
    qvel = (0.5 * torch.linspace(0.0, 1.0, N, dtype=torch.float64)[:, None]
            * torch.randn(N, 18, generator=g, dtype=torch.float64))
    ctrl = sys_.qpos0[7:] + 0.1 * torch.randn(N, 12, generator=g,
                                              dtype=torch.float64)
    kept = {}
    real = tnewton.solve

    def keep(efc, M, a0, iterations, ls_refine, x0=None):
        kept["args"] = (efc, M, a0, x0)
        return real(efc, M, a0, iterations, ls_refine, x0=x0)

    with mock.patch.object(tnewton, "solve", keep):
        pipeline.step(sys_, st.replace(qpos=qpos, qvel=qvel), ctrl, 4)
    return kept["args"]


@pytest.fixture(scope="module")
def cases():
    return {"random": _random_case(), "anymal_c": _anymal_case()}


def _jax_solve(efc, M, a0, x0, iterations, ls_refine):
    spans = [(g.start, g.dim) for g in efc.cones]
    leaves = [efc.J, efc.aref, efc.R, efc.quad_active, efc.fl]
    for g in efc.cones:
        leaves += [g.mu, g.mus, g.active]

    def one(M_, a_, x_, *l):
        gs = tuple(jnewton.ConeGroup(s, d, *l[5 + 3 * i:8 + 3 * i])
                   for i, (s, d) in enumerate(spans))
        return jnewton.solve(jnewton.NewtonEfc(*l[:5], gs), M_, a_,
                             iterations, ls_refine,
                             x0=None if x0 is None else x_)

    args = [M, a0, a0 if x0 is None else x0] + leaves
    return jax.jit(jax.vmap(one))(*[jnp.asarray(a.numpy()) for a in args])


def _on_floor(efc, M, a0, x0, iterations, ls_refine) -> torch.Tensor:
    """Per env, whether a line-search decision of a Newton step that can
    move x by more than TOL (relative to 1 + max|qacc|) reads a φ' within
    FLOOR round-off scales of zero."""
    trace = []
    out = tnewton.solve(efc, M, a0, iterations, ls_refine, x0=x0, trace=trace)
    big = TOL * (1.0 + out.qacc.abs().amax(dim=1))
    return torch.stack([(t["margin"] < FLOOR) & (t["reach"] > big)
                        for t in trace]).any(dim=0)


def test_cases_cover_the_rows_and_zones(cases):
    efc = cases["random"][0]
    assert [(g.start, g.dim) for g in efc.cones] == [(10, 3), (22, 6)]
    efc, _, a0, _ = cases["anymal_c"]
    assert [(g.start, g.dim, g.mus.shape[1]) for g in efc.cones] == [
        (36, 3, 8), (60, 6, 4), (84, 3, 4)]
    assert bool((efc.fl > 0).any()) and bool(efc.quad_active.any())
    # at qacc_smooth, knee (dim 3) and foot (dim 6) contacts in the middle
    # zone, feet off the ground (inactive)
    jar = torch.einsum("nkv,nv->nk", efc.J, a0) - efc.aref
    mid = [int(tnewton._cone_terms(efc, g, jar).mid.sum()) for g in efc.cones]
    assert mid[0] > 0 and mid[1] > 0
    assert not bool(efc.cones[1].active.all())


def _host_cases():
    """(case, warm, budget, team): every case, warmth and budget with a team
    of one member and of four (ids without a team are the one-member
    cases), two teams whose size divides none of nv, nefc and the contact
    count (anymal_c: 18, 96, 16; random: 10, 40, 7), and one of a warp's
    32, whose members each keep one of the line search's 12 step lengths
    (a team of fewer than 12 walks the (item, step length) pairs)."""
    out = []
    for team in TEAMS:
        for case in ("random", "anymal_c"):
            for warm in (False, True):
                for budget in BUDGETS:
                    name = (f"{case}-{'warmstart' if warm else 'cold'}-"
                            f"{budget[0]}x{budget[1]}")
                    out.append(pytest.param(case, warm, budget, team,
                                            id=name if team == 1
                                            else f"{name}-team{team}"))
    out += [pytest.param("anymal_c", True, (4, 1), 5,
                         id="anymal_c-warmstart-4x1-team5"),
            pytest.param("random", False, (4, 2), 3,
                         id="random-cold-4x2-team3"),
            pytest.param("anymal_c", False, (4, 2), 32,
                         id="anymal_c-cold-4x2-team32")]
    return out


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's solves, kept for the cases that share them."""
    return {}


@pytest.mark.parametrize("case,warm,budget,team", _host_cases())
def test_host_driver_matches_jax(cases, jax_refs, host, case, warm, budget,
                                 team):
    efc, M, a0, x0 = cases[case]
    x0 = x0 if warm else None
    key = (case, warm, budget)
    if key not in jax_refs:
        jax_refs[key] = _jax_solve(efc, M, a0, x0, *budget)
    ref = jax_refs[key]
    out = host(efc, M, a0, *budget, x0=x0, team=team)
    err = torch.zeros(M.shape[0], dtype=torch.float64)
    for name in FIELDS:
        r = torch.from_numpy(np.asarray(getattr(ref, name)))
        # a NaN error would pass the comparison below: NaN where JAX's is
        assert torch.equal(torch.isnan(getattr(out, name)), torch.isnan(r)), name
        d = (getattr(out, name) - r).abs().amax(dim=1)
        err = torch.maximum(err, d / (1.0 + r.abs().amax(dim=1)))
    on_floor = _on_floor(efc, M, a0, x0, *budget)
    off = (err > TOL) & ~on_floor
    assert not bool(off.any()), (err.tolist(), on_floor.tolist())
    # one refinement ends above the floor in most envs; two, in some
    least = M.shape[0] // 2 + 1 if budget[1] == 1 else 2
    assert int((~on_floor).sum()) >= least, on_floor.tolist()


def test_host_driver_nan_where_plain_gives_nan(host):
    """An env whose Hessian meets a pivot that is not positive (M with a
    negative diagonal) and one with NaN in a friction row's aref give NaN
    where the plain version does (a NaN qacc in the first; torch.sign(NaN)
    is 0); the others agree with it."""
    efc, M, a0, x0 = _random_case()
    M = M.clone()
    M[1, 2, 2] = -40.0
    aref = efc.aref.clone()
    aref[5, 3] = float("nan")
    efc = efc._replace(aref=aref)
    for x in (None, x0):
        ref = tnewton.solve(efc, M, a0, 2, 1, x0=x)
        for team in TEAMS:
            out = host(efc, M, a0, 2, 1, x0=x, team=team)
            for name in FIELDS:
                a, b = getattr(ref, name), getattr(out, name)
                assert torch.equal(torch.isnan(a), torch.isnan(b)), name
                ok = ~torch.isnan(a).any(dim=1)
                torch.testing.assert_close(b[ok], a[ok], rtol=1e-10,
                                           atol=1e-10)
            assert bool(torch.isnan(out.qacc[1]).all())


@pytest.mark.parametrize("team", TEAMS)
def test_host_driver_above_slot_nv_matches_jax(host, team):
    """nv = 40, above what the members' slots hold (newton_env.cuh kRegNv
    32): the factor and the solves run in the workspace.  The random batch
    with 30 more columns in J (random combinations of its own) and M grown
    to a random SPD 40 x 40; held as test_host_driver_matches_jax."""
    efc, M, a0, x0 = _random_case()
    N, nefc, nv = efc.J.shape
    rng = np.random.default_rng(11)
    extra = torch.from_numpy(rng.normal(size=(N, nv, 40 - nv)) * 0.3)
    J = torch.cat([efc.J, efc.J @ extra], dim=2).contiguous()
    G = torch.from_numpy(rng.normal(size=(N, 40, 40)))
    M = (G @ G.transpose(1, 2) / 40 + torch.eye(40)).contiguous()
    a0 = torch.from_numpy(rng.normal(size=(N, 40)) * 3.0)
    efc = efc._replace(J=J)
    budget = (4, 1)
    ref = _jax_solve(efc, M, a0, None, *budget)
    out = host(efc, M, a0, *budget, team=team)
    err = torch.zeros(N, dtype=torch.float64)
    for name in FIELDS:
        r = torch.from_numpy(np.array(getattr(ref, name)))
        assert torch.equal(torch.isnan(getattr(out, name)), torch.isnan(r)), name
        d = (getattr(out, name) - r).abs().amax(dim=1)
        err = torch.maximum(err, d / (1.0 + r.abs().amax(dim=1)))
    on_floor = _on_floor(efc, M, a0, None, *budget)
    assert not bool(((err > TOL) & ~on_floor).any()), (err.tolist(),
                                                        on_floor.tolist())
    assert int((~on_floor).sum()) >= N // 2 + 1, on_floor.tolist()


def test_wrapper_on_cpu_is_the_plain_solve(cases):
    efc, M, a0, x0 = cases["anymal_c"]
    launches = K.newton_solve.launches
    ref = tnewton.solve(efc, M, a0, 8, 8, x0=x0)
    out = K.newton_solve(efc, M, a0, 8, 8, x0=x0)
    for name in FIELDS:
        assert torch.equal(getattr(ref, name), getattr(out, name)), name
    assert K.newton_solve.launches == launches


def test_solve_contacts_on_cpu_runs_the_plain_solve():
    sys_ = loader.load_system("anymal_c", device="cpu")
    st = pipeline.make_state(sys_, 2)
    calls = []
    real = tnewton.solve

    def counted(*args, **kw):
        calls.append(args[0].J.device)
        return real(*args, **kw)

    launches = K.newton_solve.launches
    with mock.patch.object(tnewton, "solve", counted):
        pipeline.step(sys_, st, sys_.qpos0[7:].expand(2, -1), 1)
    assert calls == [torch.device("cpu")]
    assert K.newton_solve.launches == launches


def test_wrapper_refuses_what_the_kernel_does_not_take(cases):
    efc, M, a0, x0 = cases["random"]
    g = efc.cones[1]
    n = g.mus.shape[1]
    big = g._replace(dim=7, mus=torch.ones(M.shape[0], 2, 6,
                                           dtype=torch.float64),
                     mu=g.mu[:, :2], active=g.active[:, :2])
    with pytest.raises(ValueError, match="condim"):
        K.newton_solve(efc._replace(cones=(efc.cones[0], big)), M, a0, 1, 1)
    with pytest.raises(ValueError, match="shared memory"):
        K.geometry(4000, 18, (), 8)
    with pytest.raises(ValueError, match="contiguous"):
        K.newton_solve(efc, M.transpose(1, 2), a0, 1, 1)
    with pytest.raises(ValueError, match="float32"):
        K.newton_solve(efc._replace(aref=efc.aref.float()), M, a0, 1, 1)
    assert n == 3


def test_descriptor_and_geometry_of_anymal_c():
    spans = ((36, 3, 8), (60, 6, 4), (84, 3, 4))
    desc, nplain, nc, nmus = K._descriptor(96, spans, torch.device("cpu"))
    assert (nplain, nc, nmus) == (36, 16, 8 * 2 + 4 * 5 + 4 * 2)
    d = desc.tolist()
    assert d[:36] == list(range(36))
    assert d[36:52] == [36 + 3 * i for i in range(8)] + [
        60 + 6 * i for i in range(4)] + [84 + 3 * i for i in range(4)]
    assert d[52:68] == [3] * 8 + [6] * 4 + [3] * 4
    assert d[68:] == [2 * i for i in range(8)] + [16 + 5 * i for i in range(4)] + [
        36 + 2 * i for i in range(4)]
    geo = K.geometry(96, 18, spans, 4)
    assert geo.envs_per_block == K.ENVS_PER_BLOCK
    assert geo.smem_bytes == geo.envs_per_block * geo.env_elems * 4
    assert geo.env_elems % 4 == 0


def test_wrapper_imports_nothing_of_jax():
    code = ("import sys\n"
            "import nightmare_rl_tpu_torch.ops.newton\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'nightmare_rl_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
