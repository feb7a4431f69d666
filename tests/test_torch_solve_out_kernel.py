"""The solve's output stage (``ops/solve_out.py``) against its plain version
and the JAX package, on the CPU.

``ops/csrc/solve_out.cu`` runs its per-env work from
``ops/csrc/solve_out_env.cuh`` with a warp as the team; the host driver
``ops/csrc/solve_out_host.cpp`` runs the same function with a team of host
threads (built here with g++ into the package's ``_build/``; the tests skip
where g++ is missing).  The inputs are the arguments of ``outputs`` as the
port's plain ``pipeline.forward`` makes them, float64, on states made with
numpy from a seed, the base lowered so that points and pairs touch: in
each solve form (nightmare_v3's legs and dense forms, anymal_c's Newton,
nightmare_v3_mjx's Newton then pyramidal noslip, which ends in the dense
form, spheres_condim6's two contact groups and a pair, hinge_dof_rows
without a contact point).

- The host driver (``host_outputs``, a team of 32) against ``plain`` at
  TOL of each field's scale, NaN at the same positions: on those
  arguments, and on nightmare_v3's two forms and anymal_c's with a
  selected point whose rows carry no force (its nforce exactly 0), two
  pairs that share a point, and a pair whose two points both carry a touch
  sensor (the pairs' rows loaded); bit for bit the same at team sizes 1,
  3, 5 and 32.
- The plain route against the JAX package at JAX_TOL: ``pipeline.forward``
  (nforce, qfrc, qacc and ``S @ nforce``) for nightmare_v3 in the dense
  form and for anymal_c.  anymal_c's Newton solve parts from the JAX
  package's beyond round-off where its budget does not converge
  (tests/test_torch_anymal.py), so there the port's solve is handed the
  JAX package's force, qfrc and qacc, and the output stage is what is held.
- ``newton_solve`` takes the assemble kernel's cone buffers whole
  (``NewtonEfc.cone_all``): no copy, and the host driver's solve equal bit
  for bit to the one from the concatenated groups.
- Two substeps with the host driver in place of every substep's output
  stage against the plain step, both robots.

Beside it: the wrapper gives CPU tensors to the plain version, counts only
kernel launches, refuses on every device what the kernel cannot compute,
and imports nothing of JAX.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
import types
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nightmare_rl_tpu.physics import arrow as jarrow
from nightmare_rl_tpu.physics import collision as jcol
from nightmare_rl_tpu.physics import loader as jloader
from nightmare_rl_tpu.physics import newton as jnewton
from nightmare_rl_tpu.physics import pipeline as jpipe
from nightmare_rl_tpu.physics import solver as jsolver
from nightmare_rl_tpu_torch.ops import assemble as AS
from nightmare_rl_tpu_torch.ops import build
from nightmare_rl_tpu_torch.ops import newton as K
from nightmare_rl_tpu_torch.ops import solve_out as SO
from nightmare_rl_tpu_torch.physics import loader as tloader
from nightmare_rl_tpu_torch.physics import newton as tnewton
from nightmare_rl_tpu_torch.physics import pipeline as tpipe
from nightmare_rl_tpu_torch.physics import solver as tsolver
from nightmare_rl_tpu_torch.physics import system as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12       # host driver against plain: max|err| / max|field|
JAX_TOL = 1e-10   # plain route against the JAX package (rtol and atol)
N = 5
# case: (model, top-K condim-3 points or None, NIGHTMARE_PGS or None)
CASES = {"nightmare_v3-legs": ("nightmare_v3", 24, "legs"),
         "nightmare_v3-dense": ("nightmare_v3", 24, "scan"),
         "anymal_c-newton": ("anymal_c", 8, None),
         "mjx-newton-noslip": ("nightmare_v3_mjx", None, None),
         "spheres_condim6-dense": ("spheres_condim6", None, "scan"),
         "hinge_dof_rows-dense": ("hinge_dof_rows", None, "scan")}
FORMS = {"nightmare_v3-legs": SO.LEGS, "nightmare_v3-dense": SO.DENSE,
         "anymal_c-newton": SO.NEWTON, "mjx-newton-noslip": SO.DENSE,
         "spheres_condim6-dense": SO.DENSE, "hinge_dof_rows-dense": SO.DENSE}
EDITS = ("inactive-point", "shared-pair-point", "sensed-pair")
EDITED = ("nightmare_v3-legs", "nightmare_v3-dense", "anymal_c-newton")


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host driver cannot be built")
    build.load_host("solve_out_host")
    return SO.host_outputs


def _system(name, K_):
    ts = tloader.load_system(name, device="cpu")
    return dataclasses.replace(ts, max_contacts=K_) if K_ else ts


def _state(ts, seed: int, n: int = N):
    """Seeded states around the reference pose, the free bases lowered
    0.1 m, and controls."""
    rng = np.random.default_rng(seed)
    q = np.tile(ts.qpos0.numpy(), (n, 1))
    q += rng.normal(size=q.shape) * 0.2
    for j, t in enumerate(ts.jnt_type):
        if t == S.FREE:
            a = ts.jnt_qposadr[j]
            q[:, a + 2] -= 0.1
            q[:, a + 3:a + 7] /= np.linalg.norm(q[:, a + 3:a + 7], axis=1,
                                                keepdims=True)
    st = tpipe.make_state(ts, n).replace(
        qpos=torch.from_numpy(q),
        qvel=torch.from_numpy(rng.normal(size=(n, ts.nv))))
    return st, torch.from_numpy(rng.normal(size=(n, ts.nu)))


def _recorded(name, K_, pgs, seed=0):
    """The arguments of the output stage's call in one plain forward."""
    ts = _system(name, K_)
    st, ctrl = _state(ts, seed)
    calls = []
    real = SO.outputs

    def rec(*args):
        calls.append(args)
        return real(*args)

    with pytest.MonkeyPatch.context() as mp:
        if pgs is not None:
            mp.setenv("NIGHTMARE_PGS", pgs)
        with mock.patch.object(SO, "outputs", rec):
            tpipe.forward(ts, st, ctrl)
    assert len(calls) == 1
    return calls[0]


@pytest.fixture(scope="module")
def recorded():
    return {case: _recorded(*spec) for case, spec in CASES.items()}


def _held(ref: SO.Out, got: SO.Out, tol=TOL):
    for name, r, g in zip(SO.Out._fields, ref, got):
        assert r.shape == g.shape and r.dtype == g.dtype, name
        assert torch.equal(torch.isnan(r), torch.isnan(g)), name
        if r.numel() == 0:
            continue
        ok = ~torch.isnan(r)
        err = float((r - g)[ok].abs().max()) if bool(ok.any()) else 0.0
        scale = float(r[ok].abs().max()) if bool(ok.any()) else 0.0
        assert err <= tol * max(scale, 1e-300), (name, err, scale)


def _pair_rows(args):
    """The first row of the pairs' rows and their rows per pair."""
    sys_, groups, pair_ab, ns_offset, solved, _, elliptic = args
    off = ns_offset + sum(ix.shape[1] * nf for ix, nf in groups)
    return off, 3 if elliptic else 4


def _edited(args, edit: str):
    """The arguments with one edit, and a check of the outputs it makes."""
    sys_, groups, pair_ab, ns_offset, solved, a0, elliptic = args
    rng = np.random.default_rng(7)
    f = solved.force.clone()
    pa, pb = (x.clone() for x in pair_ab)
    off, pnf = _pair_rows(args)
    if edit != "inactive-point":   # the pairs' rows loaded
        f[:, off:] = torch.from_numpy(rng.uniform(0.5, 2.0,
                                                  size=f[:, off:].shape))
    if edit == "inactive-point":
        idx, nf = groups[0]
        c = next(c for c in range(idx.shape[1])
                 if int(idx[0, c]) not in pa[0].tolist() + pb[0].tolist())
        p = int(idx[0, c])
        f[0, ns_offset + c * nf:ns_offset + (c + 1) * nf] = 0.0

        def check(out):
            assert float(out.nforce[0, p]) == 0.0
    elif edit == "shared-pair-point":
        pa[:, 1] = pa[:, 0]
        pb[:, 2] = pa[:, 0]

        def check(out):
            v = f[:, off::pnf] if elliptic else f[:, off:].reshape(
                N, -1, pnf).sum(-1)
            rest = out.nforce.clone()
            for k in range(pa.shape[1]):
                rest.scatter_add_(1, pa[:, k:k + 1], -v[:, k:k + 1])
            for k in range(pb.shape[1]):
                rest.scatter_add_(1, pb[:, k:k + 1], -v[:, k:k + 1])
            shared = rest.gather(1, pa[:, :1])
            assert bool((out.nforce.gather(1, pa[:, :1]) > shared + 1.0).all())
    else:
        S_ = sys_.sensor_cpoint_matrix
        sensed = [p for p in range(sys_.ncp) if bool(S_[:, p].any())]
        a = sensed[0]
        b = next(p for p in sensed
                 if not bool((S_[:, p].bool() & S_[:, a].bool()).any()))
        pa[:, 0], pb[:, 0] = a, b

        def check(out):
            for p in (a, b):
                s = int(torch.nonzero(S_[:, p])[0])
                assert bool((out.sensordata[:, s] > 0).all())
    solved = solved._replace(force=f)
    if solved.form == SO.NEWTON:
        solved = solved._replace(qfrc=solved.qfrc.clone(),
                                 qacc=solved.qacc.clone())
    return (sys_, groups, (pa, pb), ns_offset, solved, a0, elliptic), check


@pytest.mark.parametrize("case,edit", [(c, "as-solved") for c in CASES] + [
    (c, e) for c in EDITED for e in EDITS])
def test_host_driver_matches_plain(recorded, host, case, edit):
    args = recorded[case]
    assert args[4].form == FORMS[case]
    check = None
    if edit != "as-solved":
        args, check = _edited(args, edit)
    ref = SO.plain(*args)
    got = host(*args, team=32)
    _held(ref, got)
    if check is not None:
        check(ref)
        check(got)
    if case.startswith(("nightmare_v3-", "anymal_c")):
        assert float(ref.nforce.max()) > 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_host_driver_is_the_same_at_every_team_size(recorded, host, case):
    args = recorded[case]
    if case in EDITED:
        args, _ = _edited(args, "shared-pair-point")
    first = host(*args, team=1)
    for team in (3, 5, 32):
        out = host(*args, team=team)
        for a, b in zip(first, out):
            assert torch.equal(a, b), team


# ---------------------------------------------------------------------------
# the plain route against the JAX package
# ---------------------------------------------------------------------------


def _jax_inputs(ts, seed: int):
    """nightmare_v3-style states with the feet in the floor (as
    tests/test_torch_physics.py makes them), zero warmstart."""
    st, ctrl = _state(ts, seed, n=4)
    return st.qpos.numpy(), st.qvel.numpy(), ctrl.numpy()


@pytest.fixture(scope="module")
def jax_forward():
    """Per robot: the JAX package's vmapped forward (nforce, qfrc, qacc,
    sensordata) and its Newton solve's outputs, one jit each, and the
    inputs."""
    out = {}
    for robot, K_, pgs in (("nightmare_v3", 24, "scan"), ("anymal_c", 8, None)):
        js = jloader.load_system(robot)
        js = dataclasses.replace(js, max_contacts=K_)
        ts = _system(robot, K_)
        q, v, c = _jax_inputs(ts, 3)
        lay = jarrow.layout(js)
        newton = js.solver_type != S.SOLVER_PGS

        def one(qq, vv, cc, js=js, lay=lay, newton=newton):
            st = jpipe.make_state(js).replace(qpos=qq, qvel=vv)
            fwd = jpipe.forward(js, st, cc)
            res = dict(nforce=fwd.sol.nforce, qfrc=fwd.sol.qfrc_constraint,
                       qacc=fwd.sol.qacc, sensordata=fwd.sensordata)
            if newton:
                pair = jcol.find_pair_contacts(js, fwd.kin, fwd.con)
                asm = jsolver.assemble(js, fwd.con, qq, vv, pair=pair,
                                       lay=lay)
                ns = jnewton.solve(asm.nefc, fwd.M, fwd.qacc_smooth,
                                   js.solver_iterations,
                                   min(js.ls_iterations, js.ls_refine),
                                   x0=st.qacc_warmstart)
                res.update(force=ns.force, n_qfrc=ns.qfrc_constraint,
                           n_qacc=ns.qacc)
            return res

        with pytest.MonkeyPatch.context() as mp:
            if pgs is not None:
                mp.setenv("NIGHTMARE_PGS", pgs)
            res = jax.jit(jax.vmap(one))(*map(jnp.asarray, (q, v, c)))
        out[robot] = (ts, pgs, (q, v, c),
                      {k: np.asarray(x) for k, x in res.items()})
    return out


@pytest.mark.parametrize("robot", ["nightmare_v3", "anymal_c"])
def test_plain_route_matches_jax(jax_forward, robot):
    ts, pgs, (q, v, c), ref = jax_forward[robot]
    st = tpipe.make_state(ts, q.shape[0]).replace(qpos=torch.from_numpy(q),
                                                  qvel=torch.from_numpy(v))
    real = tsolver.newton_solve

    def jax_newton(efc, *args, **kw):
        real(efc, *args, **kw)   # the port's own solve runs all the same
        return tnewton.NewtonOut(*(torch.from_numpy(ref[k].copy()) for k in
                                   ("force", "n_qfrc", "n_qacc")))

    with pytest.MonkeyPatch.context() as mp:
        if pgs is not None:
            mp.setenv("NIGHTMARE_PGS", pgs)
        with mock.patch.object(tsolver, "newton_solve", jax_newton):
            fwd = tpipe.forward(ts, st, torch.from_numpy(c))
    got = dict(nforce=fwd.sol.nforce, qfrc=fwd.sol.qfrc_constraint,
               qacc=fwd.sol.qacc, sensordata=fwd.sensordata)
    for k, x in got.items():
        np.testing.assert_allclose(x.numpy(), ref[k], rtol=JAX_TOL,
                                   atol=JAX_TOL, err_msg=k)
    assert float(fwd.sol.nforce.max()) > 0.0
    assert float(fwd.sensordata.max()) > 0.0


# ---------------------------------------------------------------------------
# Newton's cone buffers, the step, the wrapper
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def anymal_newton_args():
    """newton_solve's arguments in one anymal_c forward whose rows come
    from the assemble kernel's host driver (whose NewtonEfc carries the
    cone buffers)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host driver cannot be built")
    ts = _system("anymal_c", 8)
    st, ctrl = _state(ts, 1)
    calls = []
    real = tsolver.newton_solve

    def rec(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    with mock.patch.object(AS, "rows", lambda *a: AS.host_rows(*a)), \
            mock.patch.object(tsolver, "newton_solve", rec):
        tpipe.forward(ts, st, ctrl)
    assert len(calls) == 1
    return calls[0]


def test_newton_takes_the_cone_buffers_whole(anymal_newton_args):
    (efc, M, a0, it, ls), kw = anymal_newton_args
    assert efc.cone_all is not None and len(efc.cones) == 3
    cat = efc._replace(cone_all=None)
    whole = K._cones(efc, N, efc.J.dtype, "cpu")
    for x, buf in zip(whole, efc.cone_all):
        assert x.data_ptr() == buf.data_ptr()      # no copy, no cat
    for g, field in ((efc.cones[1], "mu"), (efc.cones[2], "active")):
        view = getattr(g, field)
        buf = efc.cone_all[0 if field == "mu" else 1]
        assert view.untyped_storage().data_ptr() == \
            buf.untyped_storage().data_ptr()
    for x, y in zip(whole, K._cones(cat, N, efc.J.dtype, "cpu")):
        assert torch.equal(x, y)
    for a, b in zip(K.host_solve(efc, M, a0, it, ls, **kw),
                    K.host_solve(cat, M, a0, it, ls, **kw)):
        assert torch.equal(a, b)
    for a, b in zip(K.newton_solve(efc, M, a0, it, ls, **kw),
                    K.newton_solve(cat, M, a0, it, ls, **kw)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="cone_all mus"):
        K.newton_solve(efc._replace(cone_all=efc.cone_all[:2] + (
            efc.cone_all[2][:, :-1],)), M, a0, it, ls, **kw)


@pytest.mark.parametrize("case", ["nightmare_v3-legs", "anymal_c-newton"])
def test_step_with_host_driver_matches_plain(host, case):
    """Two substeps, every substep's output stage from the host driver,
    against the plain step."""
    name, K_, pgs = CASES[case]
    ts = _system(name, K_)
    st, ctrl = _state(ts, 5)
    dec = 2
    calls = []

    def outs(*args):
        calls.append(1)
        return host(*args)

    with pytest.MonkeyPatch.context() as mp:
        if pgs is not None:
            mp.setenv("NIGHTMARE_PGS", pgs)
        ref = tpipe.step(ts, st, ctrl, dec)
        with mock.patch.object(SO, "outputs", outs):
            got = tpipe.step(ts, st, ctrl, dec)
    assert len(calls) == dec
    for f in dataclasses.fields(ref):
        r, g = getattr(ref, f.name), getattr(got, f.name)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=JAX_TOL,
                                   atol=JAX_TOL, err_msg=f.name)
    assert float(ref.sensordata.max()) > 0.0


def test_cpu_tensors_take_the_plain_version_uncounted(recorded):
    args = recorded["nightmare_v3-legs"]
    before = SO.outputs.launches
    out = SO.outputs(*args)
    ref = SO.plain(*args)
    assert SO.outputs.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    meta = args[:4] + (args[4]._replace(force=args[4].force.to("meta")),
                       args[5].to("meta"), args[6])
    with pytest.raises(ValueError, match="cpu or cuda"):
        SO.outputs(*meta)
    with pytest.raises(ValueError, match="teams of 1 to 64"):
        SO.host_outputs(*args, team=65)


def _fake_sys(nv=3, ncp=4, nsensor=2):
    return types.SimpleNamespace(nv=nv, ncp=ncp, nsensor=nsensor)


@pytest.mark.parametrize("what", ["groups", "rows", "dtype", "shared"])
def test_refuses_what_it_cannot_compute(what):
    """On every device: the CPU refuses what the kernel would."""
    n, nefc, dt = 2, 40, torch.float64
    sys_ = _fake_sys()
    idx = torch.zeros(n, 1, dtype=torch.long)
    groups = ((idx, 4),)
    if what == "groups":
        groups = ((idx, 4),) * 5
        match = "5 contact groups"
    elif what == "rows":
        groups = ((idx, 44),)
        match = "outside the 40 rows"
    elif what == "dtype":
        dt = torch.float16
        match = "dtype"
    else:
        sys_ = _fake_sys(ncp=2000, nsensor=200)
        match = "shared memory"
    f = torch.zeros(n, nefc, dtype=dt)
    solved = SO.Solved(SO.NEWTON, f, qfrc=torch.zeros(n, 3, dtype=dt),
                       qacc=torch.zeros(n, 3, dtype=dt))
    with pytest.raises(ValueError, match=match):
        SO.outputs(sys_, groups, None, 0, solved, torch.zeros(n, 3, dtype=dt),
                   False)


def test_wrapper_imports_nothing_of_jax():
    code = ("import sys\n"
            "import nightmare_rl_tpu_torch.ops.solve_out\n"
            "import nightmare_rl_tpu_torch.physics.solver\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'nightmare_rl_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
