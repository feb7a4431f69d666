"""The smooth and integrate kernels' arithmetic against the JAX package, on
the CPU.

``ops/csrc/smooth.cu`` and ``ops/csrc/integrate.cu`` run their per-env
work from ``ops/csrc/smooth_env.cuh`` with a warp as the team; the host
driver ``ops/csrc/smooth_host.cpp`` runs the same functions with a team of
host threads (built here with g++ into the package's ``_build/``; the
tests skip where g++ is missing), whose members split the loops as the
warp's lanes do.  Inputs are made with numpy from a seed, in float64.

- Kernel 1 (``host_forward``, teams of 1 and 32) against ``jax.vmap`` of
  the JAX package's kinematics, com_vel, crb, rne_bias, actuation,
  passive, arrow.factor and solve_vec on nightmare_v3 and anymal_c, with
  one env whose qvel holds a NaN: every output field within TOL of JAX's,
  scaled by the field's largest |value|, NaN at JAX's positions.
- Kernel 2 (``host_update``) against the JAX package's update
  (``pipeline.step`` with its ``forward`` replaced by the given M, forces
  and qacc, so that only pipeline.py:125-191 runs) in each integrator
  branch: implicitfast (nightmare_v3), Euler with implicit damping
  (anymal_c) and plain Euler (anymal_c with eulerdamp off), with an env
  whose qvel holds a NaN and one whose forces drive qvel past 1e10.
- The whole slice: ``pipeline.step`` with both host drivers patched in
  (teams of 32), two decimated nightmare_v3 steps against the JAX
  package's ``pipeline.step`` (the dense PGS on both sides), held as
  tests/test_torch_physics.py holds the plain port.

Each value is computed by one member in a fixed order, so the driver's
results are bit for bit the same at every team size (checked).  Against
JAX they differ by summation order only: TOL = 1e-12 scaled (measured
~1e-15).

Beside it: the wrappers give CPU tensors to the plain versions, refuse on
every device a model the kernels do not take, import nothing of JAX, and
``ops/build.py`` hashes a source with the headers it includes and no
other; and nightmare_v3_mjx's step, which the smoke holds card against
CPU only in envs whose Newton solves decide above the line-search floor,
stays within 1e-9 in those envs under one ulp of noise on the smooth
half's outputs.
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
from nightmare_rl_tpu.physics import dynamics as jdyn
from nightmare_rl_tpu.physics import kinematics as jkin
from nightmare_rl_tpu.physics import loader as jloader
from nightmare_rl_tpu.physics import pipeline as jpipe
from nightmare_rl_tpu_torch.ops import build
from nightmare_rl_tpu_torch.ops import integrate as IN
from nightmare_rl_tpu_torch.ops import smooth as SM
from nightmare_rl_tpu_torch.physics import arrow as tarrow
from nightmare_rl_tpu_torch.physics import loader as tloader
from nightmare_rl_tpu_torch.physics import pipeline as tpipe
from nightmare_rl_tpu_torch.physics import system as S
from nightmare_rl_tpu_torch.utils.graph import leaves, rebuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12           # max |driver - JAX| / max |JAX| per field, float64
STEP_TOL = 1e-10      # the whole step, as tests/test_torch_physics.py
N = 5
NAN_ENV = 1           # qvel[NAN_ENV, 3] is NaN
BIG_ENV = 3           # kernel 2: forces that drive qvel past 1e10
TEAMS = (1, 32)
ROBOTS = ("nightmare_v3", "anymal_c")


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the host driver cannot be built")
    build.load_host("smooth_host")
    return SM.host_forward


@pytest.fixture(scope="module")
def models():
    return {name: (jloader.load_system(name),
                   tloader.load_system(name, device="cpu")) for name in ROBOTS}


def _inputs(ts: S.System, seed: int):
    """Random joints, base pose and velocities around the reference pose,
    float64, with a NaN in one env's qvel."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(ts.qpos0.numpy(), (N, 1))
    qpos[:, 7:] += rng.normal(size=(N, ts.nq - 7)) * 0.3
    qpos[:, :3] += rng.normal(size=(N, 3)) * 0.05
    qpos[:, 3:7] += rng.normal(size=(N, 4)) * 0.1
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    qvel = rng.normal(size=(N, ts.nv))
    qvel[NAN_ENV, 3] = np.nan
    ctrl = rng.normal(size=(N, ts.nu)) * 5.0
    return qpos, qvel, ctrl


@pytest.fixture(scope="module")
def jax_smooth(models):
    """The JAX package's smooth half per robot, vmapped, one jit each, in
    SmoothOut's order of fields."""
    out = {}
    for name, (js, ts) in models.items():
        lay = jarrow.layout(js)

        def one(q, v, c, js=js, lay=lay):
            kin = jkin.kinematics(js, q)
            vel = jkin.com_vel(js, kin, v)
            M = jdyn.crb(js, kin)
            bias = jdyn.rne_bias(js, kin, vel, v)
            act = jdyn.actuation(js, q, v, c)
            qfrc = act.qfrc_actuator + jdyn.passive(js, v) - bias
            fac = jarrow.factor(lay, M)
            return kin, vel, M, act, qfrc, fac, jarrow.solve_vec(lay, fac, qfrc)

        inputs = _inputs(ts, seed=len(name))
        out[name] = inputs, jax.jit(jax.vmap(one))(*map(jnp.asarray, inputs))
    return out


def _held(ref, got, tol=TOL):
    """Every leaf of ``got`` within ``tol`` of ``ref``'s, scaled by the
    leaf's largest finite |value|, NaN at the same positions."""
    ref_leaves = jax.tree_util.tree_leaves(ref)
    got_leaves = leaves(got)
    assert len(ref_leaves) == len(got_leaves)
    for k, (r, g) in enumerate(zip(ref_leaves, got_leaves)):
        r = torch.from_numpy(np.array(r))
        assert tuple(r.shape) == tuple(g.shape), (k, r.shape, g.shape)
        assert torch.equal(torch.isnan(r), torch.isnan(g)), k
        fin = torch.isfinite(r)
        if not bool(fin.any()):
            continue
        scale = max(float(r[fin].abs().max()), 1e-300)
        err = float((r[fin] - g[fin]).abs().max()) / scale
        assert err <= tol, (k, err)


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("robot", ROBOTS)
def test_smooth_matches_jax(models, jax_smooth, host, robot, team):
    _, ts = models[robot]
    inputs, ref = jax_smooth[robot]
    out = host(ts, tarrow.layout(ts), *map(torch.from_numpy, inputs),
               team=team)
    _held(ref, out)
    # the NaN env's velocities are NaN below the NaN dof; its frames are not
    assert bool(torch.isnan(out.vel.cvel[NAN_ENV]).any())
    assert bool(torch.isfinite(out.kin.xpos).all())


@pytest.mark.parametrize("robot", ROBOTS)
def test_smooth_is_the_same_at_every_team_size(models, host, robot):
    """Both kernels' arithmetic at team sizes that split the work
    differently (3, 5: fewer members than the legs' items, the Schur
    complement's rows and the chains' values; 6: a member per Schur row; 32:
    the warp), bit for bit the same as one member's."""
    _, ts = models[robot]
    args = [torch.from_numpy(x) for x in _inputs(ts, seed=7)]
    lay = tarrow.layout(ts)
    uargs = [torch.from_numpy(np.ascontiguousarray(a))
             for a in _update_inputs(ts, seed=8)[0]]
    one = leaves(host(ts, lay, *args, team=1))
    one_update = IN.host_update(ts, lay, *uargs, team=1)
    for team in (3, 5, 6, 32):
        for a, b in zip(one, leaves(host(ts, lay, *args, team=team))):
            assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)), team
        for a, b in zip(one_update, IN.host_update(ts, lay, *uargs,
                                                   team=team)):
            assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)), team


def test_smooth_without_a_layout_matches_plain(models, host):
    """The dense branch: everything up to M and qfrc_smooth, no factor."""
    _, ts = models["nightmare_v3"]
    args = [torch.from_numpy(x) for x in _inputs(ts, seed=3)]
    out = host(ts, None, *args, team=32)
    ref = SM.plain(ts, None, *args)
    assert out.fac is None and out.qacc_smooth is None
    for a, b in zip(leaves(ref), leaves(out)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        torch.testing.assert_close(b, a.expand_as(b), rtol=1e-12, atol=1e-12,
                                   equal_nan=True)


def test_smooth_float32_matches_plain(models, host):
    _, ts = models["anymal_c"]
    ts32 = S.tree_cast(ts, torch.float32)
    lay = tarrow.layout(ts32)
    args = [torch.from_numpy(x).float() for x in _inputs(ts, seed=5)]
    ref, out = SM.plain(ts32, lay, *args), host(ts32, lay, *args, team=32)
    for a, b in zip(leaves(ref), leaves(out)):
        a = a.expand_as(b)
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        fin = torch.isfinite(a)
        if bool(fin.any()):
            scale = max(float(a[fin].abs().max()), 1e-30)
            err = float((a[fin] - b[fin]).abs().max()) / scale
            assert err <= 1e-5, err


# ---------------------------------------------------------------------------
# kernel 2: the integrator's update
# ---------------------------------------------------------------------------

BRANCHES = {"implicitfast": ("nightmare_v3", {}),
            "euler_damped": ("anymal_c", {}),
            "euler": ("anymal_c", {"eulerdamp": False})}


def _update_inputs(ts: S.System, seed: int):
    """The update's operands: qpos, qvel, M (the model's own at qpos),
    qfrc_smooth, qfrc_constraint, qacc; NaN in one env's qvel, forces of
    1e14 in another's.  And the actuators' velocity derivative, which the
    JAX update takes from its forward."""
    qpos, qvel, ctrl = _inputs(ts, seed)
    rng = np.random.default_rng(seed + 100)
    sm = SM.plain(ts, None, torch.from_numpy(qpos),
                  torch.from_numpy(np.nan_to_num(qvel)), torch.from_numpy(ctrl))
    qfrc_smooth = rng.normal(size=(N, ts.nv)) * 3.0
    qfrc_constraint = rng.normal(size=(N, ts.nv)) * 3.0
    qacc = rng.normal(size=(N, ts.nv)) * 10.0
    qfrc_constraint[BIG_ENV] *= 1e14
    qacc[BIG_ENV] *= 1e14
    return ((qpos, qvel, sm.M.numpy(), qfrc_smooth, qfrc_constraint, qacc),
            sm.act.vel_deriv.numpy())


def _jax_update(js, qpos, qvel, M, qfrc_smooth, qfrc_constraint, qacc,
                vel_deriv):
    """The JAX package's pipeline.step with its forward replaced by these
    values: only its update runs."""
    nb, nv = js.nbody, js.nv

    def fake_forward(sys_, state, x):
        z = jnp.zeros((nb, 3))
        return types.SimpleNamespace(
            M=x["M"], qfrc_smooth=x["fs"], sensordata=jnp.zeros(js.nsensor),
            sol=types.SimpleNamespace(qfrc_constraint=x["fc"], qacc=x["qacc"]),
            act=types.SimpleNamespace(vel_deriv=x["vd"],
                                      qfrc_actuator=jnp.zeros(nv)),
            kin=types.SimpleNamespace(xpos=z, xquat=jnp.zeros((nb, 4)),
                                      xipos=z, subtree_com=z),
            vel=types.SimpleNamespace(cvel=jnp.zeros((nb, 6))))

    def one(q, v, x):
        st = jpipe.make_state(js).replace(qpos=q, qvel=v)
        out = jpipe.step(js, st, x, 1)
        return out.qpos, out.qvel, out.qacc_warmstart

    x = dict(M=M, fs=qfrc_smooth, fc=qfrc_constraint, qacc=qacc, vd=vel_deriv)
    with mock.patch.object(jpipe, "forward", fake_forward):
        return jax.jit(jax.vmap(one))(
            jnp.asarray(qpos), jnp.asarray(qvel),
            {k: jnp.asarray(v) for k, v in x.items()})


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_update_matches_jax(models, host, branch):
    robot, change = BRANCHES[branch]
    js, ts = models[robot]
    js, ts = dataclasses.replace(js, **change), dataclasses.replace(ts, **change)
    lay = tarrow.layout(ts)
    assert SM.model_plan(ts, lay).update == branch
    args, vel_deriv = _update_inputs(ts, seed=11)
    ref = _jax_update(js, *args, vel_deriv)
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    for team in TEAMS:
        out = IN.host_update(ts, lay, *targs, team=team)
        _held(ref, out)
        for env in (NAN_ENV, BIG_ENV):   # reset to the reference pose
            assert torch.equal(out[0][env], ts.qpos0), (team, env)
            assert float(out[1][env].abs().max()) == 0.0
            assert float(out[2][env].abs().max()) == 0.0
        assert bool(torch.isfinite(out[1]).all())
        # the plain version gives the same, and the CPU wrapper is it
        plain = IN.plain_update(ts, lay, *targs)
        _held(ref, plain)
        launches = IN.integrate_update.launches
        wrapped = IN.integrate_update(ts, lay, *targs)
        assert all(torch.equal(a, b) for a, b in zip(plain, wrapped))
        assert IN.integrate_update.launches == launches


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------


def test_pipeline_step_with_host_drivers_matches_jax(models, host,
                                                     monkeypatch):
    """Two decimated nightmare_v3 steps (4 substeps), every substep's smooth
    half and update through the host drivers (counted), against the JAX
    package's pipeline.step, feet pushed into the floor so that contacts
    are active."""
    js, ts = models["nightmare_v3"]
    js = dataclasses.replace(js, max_contacts=24)
    ts = dataclasses.replace(ts, max_contacts=24)
    qpos, qvel, ctrl = _inputs(ts, seed=2)
    qvel = np.nan_to_num(qvel)
    qpos[:, 2] -= 0.1
    monkeypatch.setenv("NIGHTMARE_PGS", "scan")
    jstate = jax.vmap(lambda q, v: jpipe.make_state(js).replace(qpos=q, qvel=v))(
        jnp.asarray(qpos), jnp.asarray(qvel))
    fn = jax.jit(jax.vmap(lambda s, c: jpipe.step(js, s, c, 2)))
    for _ in range(2):
        jstate = fn(jstate, jnp.asarray(ctrl))
    calls = {"smooth": 0, "update": 0}

    def smooth(*a):
        calls["smooth"] += 1
        return SM.host_forward(*a, team=32)

    def update(*a):
        calls["update"] += 1
        return IN.host_update(*a, team=32)

    tstate = tpipe.make_state(ts, N).replace(qpos=torch.from_numpy(qpos),
                                             qvel=torch.from_numpy(qvel))
    with mock.patch.object(SM, "smooth_forward", smooth), \
            mock.patch.object(IN, "integrate_update", update):
        for _ in range(2):
            tstate = tpipe.step(ts, tstate, torch.from_numpy(ctrl), 2)
    assert calls == {"smooth": 4, "update": 4}
    for f in dataclasses.fields(tstate):
        np.testing.assert_allclose(getattr(tstate, f.name).numpy(),
                                   np.asarray(getattr(jstate, f.name)),
                                   rtol=STEP_TOL, atol=STEP_TOL)
    assert float(tstate.sensordata.abs().max()) > 0.0


# ---------------------------------------------------------------------------
# the wrappers and the build
# ---------------------------------------------------------------------------


def test_wrappers_on_cpu_are_the_plain_versions(models):
    _, ts = models["anymal_c"]
    lay = tarrow.layout(ts)
    args = [torch.from_numpy(x) for x in _inputs(ts, seed=4)]
    launches = SM.smooth_forward.launches
    for a, b in zip(leaves(SM.plain(ts, lay, *args)),
                    leaves(SM.smooth_forward(ts, lay, *args))):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    assert SM.smooth_forward.launches == launches


def test_wrappers_refuse_what_the_kernels_do_not_take(models):
    _, ts = models["nightmare_v3"]
    ball = dataclasses.replace(ts, jnt_type=(S.FREE, S.BALL) + ts.jnt_type[2:])
    args = [torch.from_numpy(x) for x in _inputs(ts, seed=4)]
    with pytest.raises(ValueError, match="free, hinge and slide"):
        SM.smooth_forward(ball, None, *args)
    with pytest.raises(ValueError, match="shared memory"):
        SM.geometry(40000, 8, "smooth")
    with pytest.raises(ValueError, match="block-arrow"):
        IN.host_update(ts, None, *[torch.zeros(1)] * 6)
    wide = tarrow.layout(ts)._replace(branch_size=4)
    with pytest.raises(ValueError, match="at most 3 dofs"):
        SM.model_plan(ts, wide)


def test_plan_of_the_hexapod():
    ts = tloader.load_system("nightmare_v3", device="cpu")
    plan = SM.model_plan(ts, tarrow.layout(ts))
    f = plan.fields
    assert (f["nbody"], f["nv"], f["nlevel"], f["nbranch"], f["bsize"]) == (
        20, 24, 5, 6, 3)
    def table(name, n):
        return list(plan.topo[f[name]:f[name] + n])

    # the walks' rounds: the base's chain, then the six legs' chains
    assert f["nround"] == 2 and table("t_round_start", 3) == [0, 1, 7]
    assert table("t_chain_start", 8) == [0, 1, 4, 7, 10, 13, 16, 19]
    assert table("t_chain_body", 19) == list(range(1, 20))
    # the world's child, then the base's, descending
    assert table("t_child", 7) == [1, 17, 14, 11, 8, 5, 2]
    # t_mask[i nv + j] = mask[i][j] + 2 mask[j][i]; each leg dof has its
    # actuator, the base's none
    mask = ts.dof_ancestor_mask.numpy() != 0
    assert table("t_mask", 576) == [int(mask[i, j]) + 2 * int(mask[j, i])
                                    for i in range(24) for j in range(24)]
    assert table("t_dof_act_start", 25) == [0] * 7 + list(range(1, 19))
    # eight envs a block after the block's copy of the tables, two blocks
    # (16 envs) an SM in float32
    geo = SM.kernel_geometry(f, 4, "smooth")
    assert geo.envs_per_block == SM.ENVS_PER_BLOCK and f["w_elems"] % 4 == 0
    assert geo.tables == SM.table_bytes(f, 4) > 0
    assert 2 * (geo.smem_bytes + 1024) <= 228 * 1024


def test_digest_hashes_the_headers_a_source_includes(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "x.cuh"\n#include <cuda.h>\n')
    (tmp_path / "b.cu").write_text('#include "y.cuh"\n')
    (tmp_path / "x.cuh").write_text('#include "y.cuh"\n')
    (tmp_path / "y.cuh").write_text("// y\n")
    (tmp_path / "z.cuh").write_text("// z\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    a, b = str(tmp_path / "a.cu"), str(tmp_path / "b.cu")
    assert [os.path.basename(p) for p in build._includes(a)] == ["x.cuh",
                                                                 "y.cuh"]
    before = build._digest(a), build._digest(b)
    (tmp_path / "z.cuh").write_text("// z, edited\n")
    assert (build._digest(a), build._digest(b)) == before
    (tmp_path / "x.cuh").write_text('#include "y.cuh"\n// edited\n')
    assert build._digest(a) != before[0] and build._digest(b) == before[1]


def test_wrappers_import_nothing_of_jax():
    code = ("import sys\n"
            "import nightmare_rl_tpu_torch.ops.smooth\n"
            "import nightmare_rl_tpu_torch.ops.integrate\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'nightmare_rl_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_mjx_step_above_the_floor_is_stable_under_round_off():
    """The premise of the smoke's nightmare_v3_mjx check of the main path
    (newton-kernel: with every kernel, the card's step against the CPU's at
    1e-9 in the envs whose plain Newton solves decide above the line-search
    floor): one ulp of noise on every output of the plain smooth half
    leaves those envs within 1e-9, and moves the envs on the floor by far
    more than those.  The smoke's step: 16 envs, float64, budget 30, two
    substeps."""
    from nightmare_rl_tpu_torch.physics import newton, solver

    ts = dataclasses.replace(tloader.load_system("nightmare_v3_mjx",
                                                 device="cpu"),
                             solver_iterations=30, ls_iterations=50)
    n, g = 16, torch.Generator().manual_seed(2)
    st = tpipe.make_state(ts, n)
    qpos = st.qpos.clone()
    qpos[:, 7:] += 0.2 * torch.randn(n, 18, generator=g, dtype=torch.float64)
    qpos[:, 2] -= 0.09
    qvel = 0.3 * torch.randn(n, 24, generator=g, dtype=torch.float64)
    st = st.replace(qpos=qpos, qvel=qvel)
    ctrl = torch.randn(n, 18, generator=g, dtype=torch.float64)
    margins, real_solve, real_smooth = [], solver.newton_solve, SM.smooth_forward

    def traced(efc, M, a0, iterations, ls_refine, x0=None):
        trace = []
        out = newton.solve(efc, M, a0, iterations, ls_refine, x0=x0,
                           trace=trace)
        big = 1e-9 * (1.0 + out.qacc.abs().amax(dim=1))
        margins.append(torch.stack([
            torch.where(t["reach"] > big, t["margin"], torch.inf)
            for t in trace]).amin(dim=0))
        return real_solve(efc, M, a0, iterations, ls_refine, x0=x0)

    with mock.patch.object(solver, "newton_solve", traced):
        ref = tpipe.step(ts, st, ctrl, 2)
    held = torch.stack(margins).amin(dim=0) >= 4.0   # the smoke's NEWTON_FLOOR
    assert int(held.sum()) >= n // 2, held.tolist()
    moved, still = [], []
    for seed in range(2):
        rng = np.random.default_rng(seed)

        def noisy(*args, **kw):
            out = real_smooth(*args, **kw)
            return rebuild(out, [x * (1 + 2e-16 * torch.from_numpy(
                rng.choice([-1.0, 1.0], size=tuple(x.shape))))
                for x in leaves(out)])

        with mock.patch.object(SM, "smooth_forward", noisy):
            out = tpipe.step(ts, st, ctrl, 2)
        err = torch.zeros(n, dtype=torch.float64)
        for f in ("qpos", "qvel", "qacc_warmstart"):
            a, b = getattr(ref, f), getattr(out, f)
            err = torch.maximum(err, (a - b).abs().amax(dim=1)
                                / max(1.0, float(a.abs().max())))
        assert float(err[held].max()) <= 1e-9, err.tolist()
        moved.append(float(err[~held].max()))
        still.append(float(err[held].max()))
    print(f"under one ulp the envs on the floor moved by {max(moved):.3e}, "
          f"the others by {max(still):.3e}")
    assert max(moved) > 1e-11 and max(moved) > 100 * max(still), (moved, still)
