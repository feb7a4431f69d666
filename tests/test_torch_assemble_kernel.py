"""The assemble kernel's arithmetic against the JAX package, on the CPU.

``ops/csrc/assemble.cu`` runs its per-env work from
``ops/csrc/assemble_env.cuh`` with a warp as the team; the host driver
``ops/csrc/assemble_host.cpp`` runs the same function with a team of host
threads (built here with g++ into the package's ``_build/``; the tests skip
where g++ is missing), whose members split the loops as the warp's lanes
do.  Inputs are made with numpy from a seed, in float64: joint angles,
base pose and velocities, through the port's plain smooth half for the
frames, subtree coms, motion axes and qacc_smooth, the base lowered so
that points and pairs touch.

- The host driver (``host_rows``) against the JAX package's
  ``find_contacts``, ``find_pair_contacts`` and ``assemble`` (its leg
  slots for the PGS models with a layout) and b = J qacc_smooth - aref,
  vmapped, on nightmare_v3 (top 24 of 40 points), anymal_c (top 8 of 69
  condim-3 points), nightmare_v3_mjx, spheres_condim6 and hinge_dof_rows:
  indices equal, values within TOL of JAX's scaled by the field's largest
  |value|, NaN at JAX's positions; among the envs one whose qvel holds a
  NaN and one whose points tie (every body at one height, unrotated), whose
  selections break the ties by index.
- The host driver against ``ops/assemble.py::plain`` on the same inputs
  and two diverged envs more (a NaN body, whose points the port's top-k
  puts first, and bodies at ±inf, which the JAX package orders otherwise):
  indices equal, values within TOL, NaN at the same positions, bit for bit
  the same at team sizes 1, 3 and 32.
- The pairs' leg slots on a pair list of nightmare_v3's points that holds
  same-branch and base pairs (slot 2 masked by solver.py's rule).
- One decimated nightmare_v3 step of the port with the host driver's rows
  substituted for every substep's (counted) against the JAX package's
  step, both in the legs form.

Beside it: the wrapper gives CPU tensors to the plain version, refuses on
every device a model the kernel does not take, and imports nothing of JAX;
the plans of both robots; a kernel's own compiler flags (the assemble
kernel's ``-fmad=false``) name its library, so that a changed flag
rebuilds it.
"""

import dataclasses
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

from nightmare_rl_tpu.physics import arrow as jarrow
from nightmare_rl_tpu.physics import collision as jcol
from nightmare_rl_tpu.physics import kinematics as jkin
from nightmare_rl_tpu.physics import loader as jloader
from nightmare_rl_tpu.physics import pipeline as jpipe
from nightmare_rl_tpu.physics import solver as jsolver
from nightmare_rl_tpu_torch.ops import assemble as AS
from nightmare_rl_tpu_torch.ops import build
from nightmare_rl_tpu_torch.ops import smooth as SM
from nightmare_rl_tpu_torch.physics import arrow as tarrow
from nightmare_rl_tpu_torch.physics import loader as tloader
from nightmare_rl_tpu_torch.physics import pipeline as tpipe
from nightmare_rl_tpu_torch.physics import solver as tsolver
from nightmare_rl_tpu_torch.physics import system as S
from nightmare_rl_tpu_torch.utils.graph import leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "nightmare_rl_tpu_torch", "assets")
TOL = 1e-12          # max |driver - reference| / max |reference| per field
STEP_TOL = 1e-10     # the whole step, as tests/test_torch_pgs_legs.py
N_JAX = 5            # envs held against JAX
N = 7                # and two diverged envs more against the plain version
TIE_ENV, NAN_QVEL_ENV, NAN_BODY_ENV, INF_ENV = 1, 2, 5, 6
# (archive, the top-K condim-3 points the env keeps, or None)
MODELS = {"nightmare_v3": ("nightmare_v3", 24), "anymal_c": ("anymal_c", 8),
          "nightmare_v3_mjx": ("nightmare_v3_mjx", None),
          "spheres_condim6": (os.path.join(ASSETS, "spheres_condim6.npz"), None),
          "hinge_dof_rows": (os.path.join(ASSETS, "hinge_dof_rows.npz"), None)}


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host driver cannot be built")
    build.load_host("assemble_host")
    return AS.host_rows


def _systems(name):
    src, K = MODELS[name]
    js = jloader.load_system(src)
    ts = tloader.load_system(name, device="cpu")
    if K is not None:
        js = dataclasses.replace(js, max_contacts=K)
        ts = dataclasses.replace(ts, max_contacts=K)
    return js, ts


@pytest.fixture(scope="module")
def models():
    return {name: _systems(name) for name in MODELS}


def _legs(ts) -> bool:
    return tarrow.layout(ts) is not None and ts.solver_type == S.SOLVER_PGS


def _inputs(ts, seed: int):
    """The kernel's operands (N envs, float64): the port's plain smooth
    half at seeded random states, the base lowered 0.1 m; env TIE_ENV
    unrotated with every body at one height, env NAN_QVEL_ENV with a NaN
    velocity, env NAN_BODY_ENV with its last body at NaN, env INF_ENV with
    its last bodies at +inf and -inf height."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(ts.qpos0.numpy(), (N, 1))
    qpos += rng.normal(size=qpos.shape) * 0.2
    for j, t in enumerate(ts.jnt_type):
        if t == S.FREE:
            a = ts.jnt_qposadr[j]
            qpos[:, a + 2] -= 0.1
            qpos[:, a + 3:a + 7] /= np.linalg.norm(qpos[:, a + 3:a + 7],
                                                   axis=1, keepdims=True)
    qvel = rng.normal(size=(N, ts.nv))
    ctrl = rng.normal(size=(N, ts.nu))
    q, v, c = (torch.from_numpy(x) for x in (qpos, qvel, ctrl))
    lay = tarrow.layout(ts)
    sm = SM.plain(ts, lay, q, v, c)
    qacc = (sm.qacc_smooth if lay is not None
            else torch.from_numpy(rng.normal(size=(N, ts.nv))))
    xpos, xquat = sm.kin.xpos.clone(), sm.kin.xquat.clone()
    nb = ts.nbody
    xpos[TIE_ENV, :, 0] = 0.1 * torch.arange(nb)
    xpos[TIE_ENV, :, 1] = 0.05 * torch.arange(nb)
    xpos[TIE_ENV, :, 2] = 0.02
    xquat[TIE_ENV] = torch.tensor((1.0, 0.0, 0.0, 0.0), dtype=torch.float64)
    xpos[NAN_BODY_ENV, nb - 1] = float("nan")
    xpos[INF_ENV, nb - 1, 2] = float("inf")
    xpos[INF_ENV, max(nb - 2, 1), 2] = -float("inf")
    v = v.clone()
    v[NAN_QVEL_ENV, 0] = float("nan")
    return [xpos, xquat, sm.kin.subtree_com.clone(), sm.kin.cdof.clone(), q,
            v, qacc.clone()]


def _jax_rows(js, ts, args):
    """The JAX package's collision, assembly and b for the first N_JAX envs,
    vmapped, by the names of ``AS.OUTS``."""
    lay = jarrow.layout(js) if _legs(ts) else None
    has_pairs = js.max_pair_contacts > 0 and len(js.cpair_a) > 0
    c3 = [i for i, d in enumerate(ts.cpoint_condim or (3,) * ts.ncp) if d == 3]
    select = 0 < js.max_contacts < len(c3)
    nb, nj = js.nbody, js.njnt

    def one(xpos, xquat, com, cdof, qpos, qvel, qacc):
        kin = jkin.KinOut(xpos, xquat, jnp.zeros((nb, 3)),
                          jnp.zeros((nb, 3, 3)), jnp.zeros((nj, 3)),
                          jnp.zeros((nj, 3)), com, jnp.zeros((nb, 6, 6)), cdof)
        if not js.ncp:   # the JAX assemble takes contact points: dof rows
            e = jsolver.make_dof_efc(js, qpos, qvel)
            return dict(center=jnp.zeros((0, 3)), pos=jnp.zeros((0, 3)),
                        dist=jnp.zeros(0), active=jnp.zeros(0, bool), J=e.J,
                        aref=e.aref, R=e.R, lo=e.lo, hi=e.hi,
                        b=e.J @ qacc - e.aref)
        con = jcol.find_contacts(js, kin)
        pair = jcol.find_pair_contacts(js, kin, con) if has_pairs else None
        asm = jsolver.assemble(js, con, qpos, qvel, pair=pair, lay=lay)
        e = asm.efc
        out = dict(center=con.centers, pos=con.pos, dist=con.dist,
                   active=con.active, J=e.J, aref=e.aref, R=e.R, lo=e.lo,
                   hi=e.hi, b=e.J @ qacc - e.aref)
        if select:
            out["sel3"] = asm.cparts[0][1]
        if pair is not None:
            out.update(pair_sel=pair.sel, pair_a=pair.a, pair_b=pair.b)
        if lay is not None:
            out.update(zip(("leg1", "leg2", "has1", "has2"), asm.legmeta))
        if asm.nefc is not None:
            out.update(quad_active=asm.nefc.quad_active, fl=asm.nefc.fl)
            if asm.nefc.cones:
                g = asm.nefc.cones
                out.update(
                    cone_mu=jnp.concatenate([c.mu for c in g]),
                    cone_mus=jnp.concatenate([c.mus.reshape(-1) for c in g]),
                    cone_active=jnp.concatenate([c.active for c in g]))
        return out

    ins = [jnp.asarray(x[:N_JAX].numpy()) for x in args]
    return {k: np.asarray(v) for k, v in jax.jit(jax.vmap(one))(*ins).items()}


@pytest.fixture(scope="module")
def jax_rows(models):
    """Per model: the inputs and the JAX package's outputs, one jit each."""
    out = {}
    for name, (js, ts) in models.items():
        args = _inputs(ts, seed=len(name))
        out[name] = args, _jax_rows(js, ts, args)
    return out


def _by_name(out: AS.AssembleOut) -> dict:
    """The outputs by the names of ``AS.OUTS`` (the cone coefficients
    concatenated over the groups, as the kernel writes them)."""
    r = out.rows
    d = dict(center=out.con.centers, pos=out.con.pos, dist=out.con.dist,
             active=out.con.active, sel3=out.sel3, pair_sel=out.pair_sel,
             pair_a=out.pair_a, pair_b=out.pair_b)
    if r is None:
        return d
    d.update(J=r.efc.J, aref=r.efc.aref, R=r.efc.R, lo=r.efc.lo, hi=r.efc.hi,
             b=r.b)
    if r.legmeta is not None:
        d.update(r.legmeta._asdict())
    if r.nefc is not None:
        d.update(quad_active=r.nefc.quad_active, fl=r.nefc.fl)
        if r.nefc.cones:
            g = r.nefc.cones
            d.update(cone_mu=torch.cat([c.mu for c in g], 1),
                     cone_mus=torch.cat([c.mus.flatten(1) for c in g], 1),
                     cone_active=torch.cat([c.active for c in g], 1))
    return d


def _held(ref, got, tol=TOL, where=""):
    """``got`` (tensors by name) against ``ref``: the same names; integer
    and flag outputs equal; float outputs within ``tol`` of ref's, scaled
    by the output's largest finite |value|, NaN at the same positions."""
    got = {k: v for k, v in got.items() if v is not None}
    ref = {k: v for k, v in ref.items() if v is not None}
    assert sorted(ref) == sorted(got), (where, sorted(ref), sorted(got))
    for k, r in ref.items():
        r = torch.from_numpy(np.array(r))
        g = got[k]
        assert tuple(r.shape) == tuple(g.shape), (where, k, r.shape, g.shape)
        if not g.is_floating_point():
            assert torch.equal(r.to(g.dtype), g), (where, k, r, g)
            continue
        assert torch.equal(torch.isnan(r), torch.isnan(g)), (where, k)
        assert torch.equal(torch.isinf(r), torch.isinf(g)), (where, k)
        fin = torch.isfinite(r)
        if not bool(fin.any()):
            continue
        scale = max(float(r[fin].abs().max()), 1e-300)
        err = float((r[fin] - g[fin]).abs().max()) / scale
        assert err <= tol, (where, k, err)


@pytest.mark.parametrize("name", list(MODELS))
def test_host_driver_matches_jax(models, jax_rows, host, name):
    _, ts = models[name]
    args, ref = jax_rows[name]
    out = host(ts, tarrow.layout(ts), *args, legs=_legs(ts), team=32)
    got = {k: v[:N_JAX] for k, v in _by_name(out).items() if v is not None}
    _held(ref, got, where=name)
    if ts.ncp:
        # the tie env's points tie, and the NaN velocity reaches b
        d = got["dist"][TIE_ENV]
        assert len(set(d.tolist())) < d.numel()
        assert bool(torch.isnan(got["b"][NAN_QVEL_ENV]).any())
        assert not bool(torch.isnan(got["b"][0]).any())


@pytest.mark.parametrize("name", list(MODELS))
def test_host_driver_matches_plain(models, jax_rows, host, name):
    """Every env, the diverged ones included, against the plain version,
    at team sizes 1, 3 and 32, which agree bit for bit."""
    _, ts = models[name]
    args, _ = jax_rows[name]
    lay = tarrow.layout(ts)
    ref = _by_name(AS.plain(ts, lay, *args, legs=_legs(ts)))
    outs = [host(ts, lay, *args, legs=_legs(ts), team=t) for t in (1, 3, 32)]
    _held(ref, _by_name(outs[0]), where=name)
    for other in outs[1:]:
        for a, b in zip(leaves(outs[0]), leaves(other)):
            assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)), name
    if ts.ncp and AS.model_plan(ts, lay).fields["K"]:
        # the NaN body's condim-3 points come first in the port's order
        c3 = torch.tensor(tsolver._condim_groups(ts)[0])
        nan_pts = torch.isnan(ref["dist"][NAN_BODY_ENV])
        first = ref["sel3"][NAN_BODY_ENV, :int(nan_pts[c3].sum())]
        assert bool(nan_pts[first].all()) and bool(nan_pts[c3].any())


def test_pair_slots_of_same_branch_and_base_pairs(models, host):
    """The pairs' leg slots (solver.py's same-branch rule): nightmare_v3 with
    a pair list of its own, two points of one leg, a base point against a
    leg's, two base points; the host driver against the plain version,
    slot 2 masked exactly where both points lie on one branch or the second
    on the base."""
    _, ts = models["nightmare_v3"]
    pairs = ((10, 11), (10, 14), (15, 18), (0, 10), (3, 22), (1, 2))
    n = len(pairs)
    ts = dataclasses.replace(
        ts, cpair_a=torch.tensor([p[0] for p in pairs]),
        cpair_b=torch.tensor([p[1] for p in pairs]),
        cpair_friction=ts.cpair_friction[:n], cpair_solref=ts.cpair_solref[:n],
        cpair_solimp=ts.cpair_solimp[:n])
    lay = tarrow.layout(ts)
    args = _inputs(ts, seed=9)
    ref = AS.plain(ts, lay, *args, legs=True)
    out = host(ts, lay, *args, legs=True, team=32)
    _held(_by_name(ref), _by_name(out), where="pairs")
    leg = torch.tensor(tsolver._point_leg_map(ts, lay))
    la, lb = leg[out.pair_a], leg[out.pair_b]
    rows = out.rows.legmeta.has2[:, -4 * out.pair_a.shape[1]::4]
    assert torch.equal(rows, (lb >= 0) & (la != lb))
    assert bool(((la == lb) & (la >= 0)).any()) and bool((la < 0).any())


def test_step_with_host_rows_matches_jax(models, host, monkeypatch):
    """One decimated nightmare_v3 step (2 substeps) in the legs form, every
    substep's rows from the host driver, against the JAX package's step."""
    js, ts = models["nightmare_v3"]
    rng = np.random.default_rng(4)
    n = 4
    qpos = np.tile(ts.qpos0.numpy(), (n, 1))
    qpos[:, 7:] += rng.normal(size=(n, ts.nq - 7)) * 0.2
    qpos[:, 2] -= 0.1
    qvel = rng.normal(size=(n, ts.nv)) * 0.3
    ctrl = rng.normal(size=(n, ts.nu))
    monkeypatch.setenv("NIGHTMARE_PGS", "legs")
    jstate = jax.vmap(lambda q, v: jpipe.make_state(js).replace(qpos=q, qvel=v))(
        jnp.asarray(qpos), jnp.asarray(qvel))
    jstate = jax.jit(jax.vmap(lambda s, c: jpipe.step(js, s, c, 2)))(
        jstate, jnp.asarray(ctrl))
    calls = []

    def rows(sys_, lay, *args):
        calls.append(1)
        legs = tsolver.legs_form(sys_, lay, args[0].dtype, args[0].device)
        assert legs
        return AS.host_rows(sys_, lay, *args, legs=legs, team=32)

    tstate = tpipe.make_state(ts, n).replace(qpos=torch.from_numpy(qpos),
                                             qvel=torch.from_numpy(qvel))
    with mock.patch.object(AS, "rows", rows):
        tstate = tpipe.step(ts, tstate, torch.from_numpy(ctrl), 2)
    assert len(calls) == 2
    for f in dataclasses.fields(tstate):
        np.testing.assert_allclose(getattr(tstate, f.name).numpy(),
                                   np.asarray(getattr(jstate, f.name)),
                                   rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=f.name)
    assert float(tstate.sensordata.abs().max()) > 0.0


def test_rows_on_cpu_is_the_plain_version(models, jax_rows):
    _, ts = models["anymal_c"]
    args, _ = jax_rows["anymal_c"]
    lay = tarrow.layout(ts)
    launches = AS.rows.launches
    for a, b in zip(leaves(AS.plain(ts, lay, *args)),
                    leaves(AS.rows(ts, lay, *args))):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    assert AS.rows.launches == launches


def test_rows_refuse_what_the_kernel_does_not_take(models):
    _, ts = models["spheres_condim6"]
    five = dataclasses.replace(ts, cpoint_condim=(3, 5))
    with pytest.raises(ValueError, match="condim 3, 4 and 6"):
        AS.model_plan(five, None)
    _, hexa = models["nightmare_v3"]
    many = dataclasses.replace(hexa, max_pair_contacts=AS.MAX_PAIRS + 1)
    with pytest.raises(ValueError, match="at most 8 pairs"):
        AS.model_plan(many, tarrow.layout(hexa))
    f = dict(AS.model_plan(hexa, tarrow.layout(hexa)).fields, w_elems=60000)
    with pytest.raises(ValueError, match="shared memory"):
        AS.geometry(f, 4)
    x = torch.zeros(2, hexa.nbody, 3)
    with pytest.raises(ValueError, match="xquat"):
        AS.host_rows(hexa, tarrow.layout(hexa), x, x, x,
                     torch.zeros(2, 24, 6), torch.zeros(2, 25),
                     torch.zeros(2, 24), torch.zeros(2, 24))


def test_plans_of_the_robots(models):
    _, hexa = models["nightmare_v3"]
    f = AS.model_plan(hexa, tarrow.layout(hexa)).fields
    assert (f["ncp"], f["nc3"], f["K"], f["npair"], f["Kp"], f["nslot"],
            f["ndofrow"], f["nefc"], f["elliptic"]) == (
        40, 40, 24, 375, 4, 28, 0, 112, 0)
    assert f["nefc"] == tsolver._row_count(hexa)
    geo = AS.geometry(f, 4)
    assert geo.smem_bytes <= AS.MAX_SMEM and geo.envs_per_block >= 2
    _, quad = models["anymal_c"]
    plan = AS.model_plan(quad, tarrow.layout(quad))
    f = plan.fields
    assert (f["nc3"], f["K"], f["npair"], f["Kp"], f["ndofrow"], f["nefc"],
            f["elliptic"]) == (69, 8, 1566, 4, 36, 96, 1)
    # the cone groups start where the Newton kernel's spans do
    assert [(pts is None, d, nf) for pts, d, nf in plan.groups] == [
        (True, 3, 3), (False, 6, 6)]
    assert plan.nmus == 8 * 2 + 4 * 5 + 4 * 2
    geo = AS.geometry(f, 4)
    assert geo.tables == AS.table_bytes(f, 4) > 4 * 2 * 1566


def test_wrapper_imports_nothing_of_jax():
    code = ("import sys\n"
            "import nightmare_rl_tpu_torch.ops.assemble\n"
            "import nightmare_rl_tpu_torch.physics.pipeline\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'nightmare_rl_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_kernel_flags_name_the_library(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// k\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    calls = []

    def nvcc(cmd, **_):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as fh:
            fh.write("lib")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(build.subprocess, "run", nvcc)
    monkeypatch.setattr(build, "KERNEL_FLAGS", {})
    plain = build.build("k")["path"]
    assert build.build("k") == {"path": plain, "seconds": 0.0, "log": ""}
    monkeypatch.setattr(build, "KERNEL_FLAGS", {"k": ["-fmad=false"]})
    flagged = build.build("k")["path"]
    assert flagged != plain and len(calls) == 2
    assert "-fmad=false" in calls[1] and "-fmad=false" not in calls[0]
