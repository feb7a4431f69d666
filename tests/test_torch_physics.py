"""The port's physics (nightmare_rl_tpu_torch/core, physics) against the JAX
package's, stage by stage, on random nightmare_v3 states pushed into the
ground so that plane and tibia-pair contacts are active.

Inputs are made with numpy from a seed and fed to both sides in float64 on
the CPU.  The JAX side runs once per module (one jit over every stage, one
over the decimated step).  Its solve runs the dense matrix-free PGS
(NIGHTMARE_PGS=scan), and so does the port's (the same variable around its
calls; its CPU default is the leg-sparse form); the two sides then differ
only in summation order, so every comparison holds to ATOL=1e-10 absolute
plus RTOL=1e-10 relative."""

import dataclasses
import hashlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nightmare_rl_tpu.core import quat as jQ
from nightmare_rl_tpu.core import spatial as jsp
from nightmare_rl_tpu.physics import arrow as jarrow
from nightmare_rl_tpu.physics import collision as jcol
from nightmare_rl_tpu.physics import dynamics as jdyn
from nightmare_rl_tpu.physics import kinematics as jkin
from nightmare_rl_tpu.physics import loader as jloader
from nightmare_rl_tpu.physics import pipeline as jpipe
from nightmare_rl_tpu.physics import solver as jsolver
from nightmare_rl_tpu_torch.core import quat as tQ
from nightmare_rl_tpu_torch.core import spatial as tsp
from nightmare_rl_tpu_torch.physics import arrow as tarrow
from nightmare_rl_tpu_torch.physics import collision as tcol
from nightmare_rl_tpu_torch.physics import dynamics as tdyn
from nightmare_rl_tpu_torch.physics import kinematics as tkin
from nightmare_rl_tpu_torch.physics import loader as tloader
from nightmare_rl_tpu_torch.physics import pipeline as tpipe
from nightmare_rl_tpu_torch.physics import solver as tsolver

ATOL, RTOL = 1e-10, 1e-10
N = 4


def _close(a, b):
    """a: JAX/numpy value, b: torch tensor; infinite bounds compare equal."""
    a = np.asarray(a)
    b = b.detach().cpu().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == bool or b.dtype == bool:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def systems():
    js = dataclasses.replace(jloader.load_system("nightmare_v3"), max_contacts=24)
    ts = dataclasses.replace(tloader.load_system("nightmare_v3", device="cpu"),
                             max_contacts=24)
    return js, ts


@pytest.fixture(scope="module")
def inputs(systems):
    js, _ = systems
    rng = np.random.default_rng(0)
    qpos = np.tile(np.asarray(js.qpos0), (N, 1))
    qpos[:, 7:] += rng.normal(size=(N, 18)) * 0.3
    qpos[:, 3:7] += rng.normal(size=(N, 4)) * 0.1
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    qpos[:, 2] -= rng.uniform(0.09, 0.12, size=N)   # feet and tibias in the floor
    qvel = rng.normal(size=(N, 24))
    ctrl = rng.normal(size=(N, 18)) * 5.0
    return qpos, qvel, ctrl


@pytest.fixture(scope="module")
def jax_stages(systems, inputs):
    """Every stage of the JAX forward pass, vmapped over envs, one jit."""
    js, _ = systems
    lay = jarrow.layout(js)

    def one(q, v, c):
        kin = jkin.kinematics(js, q)
        vel = jkin.com_vel(js, kin, v)
        M = jdyn.crb(js, kin)
        bias = jdyn.rne_bias(js, kin, vel, v)
        act = jdyn.actuation(js, q, v, c)
        fac = jarrow.factor(lay, M)
        rhs = act.qfrc_actuator - bias
        con = jcol.find_contacts(js, kin)
        pair = jcol.find_pair_contacts(js, kin, con)
        asm = jsolver.assemble(js, con, q, v, pair=pair, lay=lay)
        qacc_smooth = jarrow.solve_vec(lay, fac, rhs)
        sol = jsolver.solve_contacts(js, con, q, v, None, qacc_smooth,
                                     pair=pair, M=M, lay=lay, fac=fac)
        return dict(kin=kin, vel=vel, M=M, bias=bias, act=act,
                    passive=jdyn.passive(js, v), fac=fac,
                    solve_vec=jarrow.solve_vec(lay, fac, rhs),
                    inv=jarrow.inv(lay, fac), con=con, pair=pair, efc=asm.efc,
                    efc_all=jsolver.make_efc(js, con, v),
                    ns_offset=asm.ns_offset, qacc_smooth=qacc_smooth, sol=sol)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NIGHTMARE_PGS", "scan")
        out = jax.jit(jax.vmap(lambda q, v, c: {
            k: val for k, val in one(q, v, c).items() if k != "ns_offset"}))(
            *map(jnp.asarray, inputs))
    return out


@pytest.fixture(scope="module")
def torch_stages(systems, inputs):
    _, ts = systems
    q, v, c = (torch.from_numpy(x) for x in inputs)
    lay = tarrow.layout(ts)
    kin = tkin.kinematics(ts, q)
    vel = tkin.com_vel(ts, kin, v)
    M = tdyn.crb(ts, kin)
    bias = tdyn.rne_bias(ts, kin, vel, v)
    act = tdyn.actuation(ts, q, v, c)
    fac = tarrow.factor(lay, M)
    rhs = act.qfrc_actuator - bias
    con = tcol.find_contacts(ts, kin)
    pair = tcol.find_pair_contacts(ts, kin, con)
    asm = tsolver.assemble(ts, con, q, v, pair=pair)
    qacc_smooth = tarrow.solve_vec(lay, fac, rhs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NIGHTMARE_PGS", "scan")   # the dense form, as the JAX side
        sol = tsolver.solve_contacts(ts, con, q, v, qacc_smooth, pair=pair,
                                     lay=lay, fac=fac)
    return dict(kin=kin, vel=vel, M=M, bias=bias, act=act,
                passive=tdyn.passive(ts, v), fac=fac,
                solve_vec=tarrow.solve_vec(lay, fac, rhs),
                inv=tarrow.inv(lay, fac), con=con, pair=pair, asm=asm,
                efc_all=tsolver.make_efc(ts, con, v),
                qacc_smooth=qacc_smooth, sol=sol)


# ---------------------------------------------------------------------------
# core math
# ---------------------------------------------------------------------------


def test_quat_functions_match():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(6, 4))
    q2 = rng.normal(size=(6, 4))
    v = rng.normal(size=(6, 3))
    w = rng.normal(size=(6, 3))
    t = lambda x: torch.from_numpy(np.array(x))
    qn = np.asarray(jQ.normalize(jnp.asarray(q)))
    _close(jQ.normalize(q), tQ.normalize(t(q)))
    _close(jQ.conj(q), tQ.conj(t(q)))
    _close(jQ.mul(q, q2), tQ.mul(t(q), t(q2)))
    _close(jQ.rotate(v, qn), tQ.rotate(t(v), t(qn)))
    _close(jQ.rotate_inv(v, qn), tQ.rotate_inv(t(v), t(qn)))
    _close(jQ.to_mat(qn), tQ.to_mat(t(qn)))
    m = np.asarray(jQ.to_mat(qn))
    _close(jQ.from_mat(m), tQ.from_mat(t(m)))
    _close(jQ.from_axis_angle(v / np.linalg.norm(v, axis=1, keepdims=True),
                              w[:, 0]),
           tQ.from_axis_angle(t(v / np.linalg.norm(v, axis=1, keepdims=True)),
                              t(w[:, 0])))
    _close(jQ.integrate(qn, w, 0.008), tQ.integrate(t(qn), t(w), 0.008))


def test_spatial_functions_match():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(5, 6)), rng.normal(size=(5, 6))
    mass = np.abs(rng.normal(size=5))
    inert = rng.normal(size=(5, 3, 3))
    off = rng.normal(size=(5, 3))
    t = lambda x: torch.from_numpy(np.array(x))
    _close(jsp.skew(off), tsp.skew(t(off)))
    _close(jsp.motion_cross(a, b), tsp.motion_cross(t(a), t(b)))
    _close(jsp.force_cross(a, b), tsp.force_cross(t(a), t(b)))
    I = jsp.inertia_matrix(mass, inert, off)
    _close(I, tsp.inertia_matrix(t(mass), t(inert), t(off)))
    _close(jsp.inertia_mul(I, a), tsp.inertia_mul(t(np.asarray(I)), t(a)))


# ---------------------------------------------------------------------------
# the archive
# ---------------------------------------------------------------------------


def test_asset_is_byte_identical():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def digest(pkg):
        with open(os.path.join(here, pkg, "assets", "nightmare_v3.npz"), "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()

    assert digest("nightmare_rl_tpu_torch") == digest("nightmare_rl_tpu")


def test_load_system_every_field(systems):
    js = jloader.load_system("nightmare_v3")
    ts = tloader.load_system("nightmare_v3", device="cpu")
    jfields = {f.name for f in dataclasses.fields(js)}
    assert jfields == {f.name for f in dataclasses.fields(ts)}
    for name in sorted(jfields):
        a, b = getattr(js, name), getattr(ts, name)
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
        else:
            assert b == a, name
    assert ts.dtype == torch.float64
    ts32 = tloader.load_system("nightmare_v3", dtype=torch.float32, device="cpu")
    assert ts32.body_mass.dtype == torch.float32
    assert ts32.cpair_a.dtype == torch.int64


# ---------------------------------------------------------------------------
# smooth dynamics and the mass-matrix factor
# ---------------------------------------------------------------------------


def test_kinematics_and_com_vel(jax_stages, torch_stages):
    for name in jax_stages["kin"]._fields:
        _close(getattr(jax_stages["kin"], name), getattr(torch_stages["kin"], name))
    for name in jax_stages["vel"]._fields:
        _close(getattr(jax_stages["vel"], name), getattr(torch_stages["vel"], name))


def test_crb_rne_actuation_passive(jax_stages, torch_stages):
    _close(jax_stages["M"], torch_stages["M"])
    _close(jax_stages["bias"], torch_stages["bias"])
    for name in jax_stages["act"]._fields:
        _close(getattr(jax_stages["act"], name), getattr(torch_stages["act"], name))
    _close(jax_stages["passive"], torch_stages["passive"])


def test_arrow_factor_solve_inv(jax_stages, torch_stages):
    for name in jax_stages["fac"]._fields:
        _close(getattr(jax_stages["fac"], name), getattr(torch_stages["fac"], name))
    _close(jax_stages["solve_vec"], torch_stages["solve_vec"])
    _close(jax_stages["inv"], torch_stages["inv"])
    # and the factor really inverts M
    M, Minv = torch_stages["M"], torch_stages["inv"]
    eye = torch.eye(24, dtype=M.dtype).expand_as(M)
    assert float((M @ Minv - eye).abs().max()) < 1e-9


# ---------------------------------------------------------------------------
# contacts, constraint rows, the solve
# ---------------------------------------------------------------------------


def test_find_contacts(jax_stages, torch_stages):
    jc, tc = jax_stages["con"], torch_stages["con"]
    for name in tc._fields:
        _close(getattr(jc, name), getattr(tc, name))
    assert bool(tc.active.any(dim=1).all())  # every env touches the floor


def test_find_pair_contacts(jax_stages, torch_stages):
    jp, tp = jax_stages["pair"], torch_stages["pair"]
    for name in tp._fields:
        _close(getattr(jp, name), getattr(tp, name))


def test_topk_ties_take_lower_index_first():
    x = torch.tensor([[0.5, -1.0, 0.0, -1.0, 0.0, -1.0]])
    sel = tcol.topk_smallest(x, 4)
    _, ref = jax.lax.top_k(-jnp.asarray(x.numpy()), 4)
    assert sel.tolist() == np.asarray(ref).tolist() == [[1, 3, 5, 2]]


def test_assemble_rows(jax_stages, torch_stages):
    je, asm = jax_stages["efc"], torch_stages["asm"]
    assert asm.ns_offset == 0
    assert tuple(asm.efc.J.shape) == (N, 112, 24)  # 24×4 plane + 4×4 pair rows
    for name in asm.efc._fields:
        a = np.asarray(getattr(je, name))
        b = getattr(asm.efc, name)
        if name == "hi":
            np.testing.assert_array_equal(np.isinf(a), torch.isinf(b).numpy())
            a, b = np.where(np.isinf(a), 0.0, a), torch.where(torch.isinf(b), 0.0, b)
        _close(a, b)
    assert int((asm.efc.hi > 0).sum()) > 0


def test_make_efc_every_candidate(jax_stages, torch_stages):
    je, te = jax_stages["efc_all"], torch_stages["efc_all"]
    assert tuple(te.J.shape) == (N, 160, 24)  # 40 candidates × 4 facets
    for name in te._fields:
        a, b = np.asarray(getattr(je, name)), getattr(te, name)
        _close(np.where(np.isinf(a), 7.0, a), torch.where(torch.isinf(b), 7.0, b))


def test_dof_rows_of_a_limited_model(systems, inputs):
    """make_dof_efc on a hexapod copy with friction loss and joint limits
    (the shipped archive has neither, so nightmare_v3's ns_offset is 0)."""
    js, ts = systems
    fl = np.zeros(24)
    fl[[7, 12]] = 0.3
    lim = np.zeros(19, bool)
    lim[[2, 5, 9]] = True
    js2 = dataclasses.replace(js, dof_frictionloss=fl, jnt_limited=lim)
    ts2 = dataclasses.replace(ts, dof_frictionloss=torch.from_numpy(fl),
                              jnt_limited=torch.from_numpy(lim))
    q, v, _ = inputs
    ref = jax.vmap(lambda qq, vv: jsolver.make_dof_efc(js2, qq, vv))(
        jnp.asarray(q), jnp.asarray(v))
    out = tsolver.make_dof_efc(ts2, torch.from_numpy(q), torch.from_numpy(v))
    for name in out._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(out, name)
        a, b = np.where(np.isinf(a), 7.0, a), torch.where(torch.isinf(b), 7.0, b)
        _close(a, b)


def test_solve_contacts(jax_stages, torch_stages):
    for name in ("nforce", "qfrc_constraint", "qacc"):
        _close(getattr(jax_stages["sol"], name), getattr(torch_stages["sol"], name))
    assert float(torch_stages["sol"].nforce.max()) > 0.0


# ---------------------------------------------------------------------------
# the decimated step
# ---------------------------------------------------------------------------


def test_pipeline_three_decimated_steps(systems, inputs):
    js, ts = systems
    qpos, qvel, ctrl = inputs

    def jstep(state, c):
        return jpipe.step(js, state, c, 2)

    jstate = jax.vmap(lambda q, v: jpipe.make_state(js).replace(qpos=q, qvel=v))(
        jnp.asarray(qpos), jnp.asarray(qvel))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NIGHTMARE_PGS", "scan")
        fn = jax.jit(jax.vmap(jstep))
        for _ in range(3):
            jstate = fn(jstate, jnp.asarray(ctrl))
        tstate = tpipe.make_state(ts, N).replace(
            qpos=torch.from_numpy(qpos), qvel=torch.from_numpy(qvel))
        for _ in range(3):
            tstate = tpipe.step(ts, tstate, torch.from_numpy(ctrl), 2)
    for name in dataclasses.fields(tstate):
        _close(getattr(jstate, name.name), getattr(tstate, name.name))
    assert float(tstate.sensordata.abs().max()) > 0.0


def test_validity_reset_keeps_diverged_sensordata(systems, inputs):
    """A non-finite velocity resets the env to qpos0 with zero velocity; the
    reset frame keeps the diverged step's sensordata and kinematics."""
    js, ts = systems
    qpos, qvel, ctrl = inputs
    qvel = qvel.copy()
    qvel[1, 3] = np.nan
    jstate = jax.vmap(lambda q, v: jpipe.make_state(js).replace(qpos=q, qvel=v))(
        jnp.asarray(qpos), jnp.asarray(qvel))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NIGHTMARE_PGS", "scan")
        jstate = jax.jit(jax.vmap(lambda s, c: jpipe.step(js, s, c, 1)))(
            jstate, jnp.asarray(ctrl))
        tstate = tpipe.step(ts, tpipe.make_state(ts, N).replace(
            qpos=torch.from_numpy(qpos), qvel=torch.from_numpy(qvel)),
            torch.from_numpy(ctrl), 1)
    assert torch.equal(tstate.qpos[1], ts.qpos0)
    assert float(tstate.qvel[1].abs().max()) == 0.0
    for name in ("qpos", "qvel", "qacc_warmstart"):
        _close(getattr(jstate, name), getattr(tstate, name))
    for name in ("sensordata", "xpos", "cvel"):
        a = np.asarray(getattr(jstate, name))
        b = getattr(tstate, name).numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(a)
        np.testing.assert_allclose(b[ok], a[ok], rtol=RTOL, atol=ATOL)
