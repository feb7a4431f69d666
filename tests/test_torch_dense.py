"""The port's dense mass-matrix branch (``physics/pipeline.py`` and
``physics/solver.py`` for models without a block-arrow layout) against the
JAX package's ``pipeline.step``, in float64 on the CPU.

Models (MJCF compiled by each package's own ``system_from_mjmodel``; the
PGS ones are the port's assets, which chip_smoke.py steps on the card):
- two free spheres on a plane, condim 3 and 6, PGS with 100 sweeps
  (assets/spheres_condim6.xml, the model of tests/test_condim6.py): 50
  steps, 1e-10 relative;
- a limited hinge with frictionloss and damping (assets/hinge_dof_rows.xml,
  the model of tests/test_dof_rows.py):
  50 steps, 1e-10 relative.  The JAX ``pipeline.step`` cannot step a model
  without contact points (its condim grouping reduces an empty array), so
  the JAX side steps the same hinge with its capsule made collidable with
  the floor 5 m below; those contact rows never activate, and the port
  steps both models;
- the spheres under Newton, pyramidal cones with noslip and elliptic cones
  (tests/test_newton.py): held one step at a time (each port step starts
  from the JAX state before it), as the anymal_c Newton path is, because
  the cones amplify round-off from step to step.  At the model's budget the
  line search reaches its round-off floor, where its last decision is noise
  (tests/test_torch_newton.py): 1e-6, against a spread of 1.1e-7 between
  the JAX package's own vmapped and per-env steps.  Pyramidal cones with
  noslip are also held at a budget that stops above that floor, to 1e-10;
- ``NIGHTMARE_NO_WARMSTART`` set on both sides before anything is built;
- the hexapod with its arrow layout withheld against the port's own arrow
  path (no JAX compile).

Each port step runs several envs in one batch; the JAX side steps each env
alone.  Errors are max|port - jax| / max(1, max|jax|).
"""

import dataclasses
import os
from unittest import mock

import mujoco as mj
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nightmare_rl_tpu.physics import loader as jloader
from nightmare_rl_tpu.physics import pipeline as jpipeline
from nightmare_rl_tpu_torch.physics import arrow, loader, newton, pipeline

PGS_TOL = 1e-10
# one Newton step at the model's budget (30 iterations, 8 line-search
# refinements): the JAX package's own vmapped and per-env steps differ by
# up to 1.1e-7 (pyramidal) and 5.0e-8 (elliptic) on these states
NEWTON_TOL = 1e-6
# one step at 10 iterations and 4 refinements, which stop above the
# round-off floor of the line search on these states
NEWTON_ABOVE_FLOOR_TOL = 1e-10
FIELDS = ("qpos", "qvel", "qacc_warmstart", "sensordata", "qfrc_actuator")

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "nightmare_rl_tpu_torch", "assets")
with open(os.path.join(ASSETS, "spheres_condim6.xml")) as _fh:
    SPHERES_PGS = _fh.read()
with open(os.path.join(ASSETS, "hinge_dof_rows.xml")) as _fh:
    HINGE_FREE = _fh.read()
SPHERES_NEWTON = SPHERES_PGS.replace(
    'solver="PGS" cone="pyramidal" impratio="7" timestep="0.002"\n'
    '          iterations="100" noslip_iterations="0"',
    'solver="Newton" cone="{cone}" impratio="7" timestep="0.002"\n'
    '          iterations="30" ls_iterations="50" noslip_iterations="{noslip}"')

HINGE_FLOOR = HINGE_FREE.replace('contype="0" conaffinity="0"', "")
assert SPHERES_NEWTON != SPHERES_PGS and HINGE_FLOOR != HINGE_FREE


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests step a few envs, and the suite's
    workers share the machine's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(xml):
    m = mj.MjModel.from_xml_string(xml)
    return m, jloader.system_from_mjmodel(m), loader.system_from_mjmodel(
        m, device="cpu")


def _sphere_states(nv, n):
    """n initial (qpos, qvel) rows: the JAX tests' spinning, rolling and
    sliding spheres, then seeded perturbations of them."""
    m = mj.MjModel.from_xml_string(SPHERES_PGS)
    qpos = np.tile(m.qpos0, (n, 1))
    qvel = np.zeros((n, nv))
    qvel[:, 3:6] = [0.0, 4.0, 8.0]
    qvel[:, 0] = 0.5
    qvel[:, 9:12] = [0.0, 4.0, 8.0]
    qvel[:, 6] = 0.5
    rng = np.random.default_rng(0)
    qvel[1:] += rng.normal(scale=0.5, size=(n - 1, nv))
    qpos[1:, [2, 9]] -= rng.uniform(0.0, 0.004, size=(n - 1, 2))
    return qpos, qvel


def _jstate(jsys, row):
    st = jpipeline.make_state(jsys)
    return st.replace(**{k: jnp.array(v) for k, v in row.items()})


def _tstate(tsys, rows):
    st = pipeline.make_state(tsys, len(rows))
    return st.replace(**{k: torch.tensor(np.stack([r[k] for r in rows]))
                         for k in rows[0]})


def _jstep(jsys):
    return jax.jit(lambda s: jpipeline.step(jsys, s, jnp.zeros(jsys.nu), 1))


def _err(jstates, tstate) -> float:
    out = 0.0
    for f in FIELDS:
        a = np.stack([np.asarray(getattr(s, f)) for s in jstates])
        if a.size == 0:
            continue
        b = getattr(tstate, f).numpy()
        assert a.shape == b.shape, (f, a.shape, b.shape)
        out = max(out, float(np.abs(b - a).max() / max(1.0, np.abs(a).max())))
    return out


def _trajectory(xml_j, xml_t, rows, steps):
    """Steps the JAX model xml_j (each env alone) and the port's xml_t (all
    envs in one batch) from the same rows; returns the worst error over the
    steps."""
    _, jsys, _ = _models(xml_j)
    _, _, tsys = _models(xml_t)
    step = _jstep(jsys)
    js = [_jstate(jsys, r) for r in rows]
    ts = _tstate(tsys, rows)
    worst = 0.0
    for _ in range(steps):
        js = [step(s) for s in js]
        ts = pipeline.step(tsys, ts, torch.zeros(len(rows), tsys.nu), 1)
        worst = max(worst, _err(js, ts))
    return worst, ts


def test_layouts_are_dense():
    for xml in (SPHERES_PGS, HINGE_FREE, HINGE_FLOOR,
                SPHERES_NEWTON.format(cone="elliptic", noslip=0)):
        assert arrow.layout(_models(xml)[2]) is None


def test_spheres_pgs_trajectory():
    """PGS, 100 sweeps, condim 3 and 6, 50 steps from four states."""
    qpos, qvel = _sphere_states(12, 4)
    rows = [dict(qpos=qpos[i], qvel=qvel[i]) for i in range(4)]
    worst, ts = _trajectory(SPHERES_PGS, SPHERES_PGS, rows, 50)
    assert worst <= PGS_TOL, worst
    assert float(ts.sensordata.abs().max()) > 0  # the spheres touch the floor


@pytest.mark.parametrize("xml_t", [HINGE_FLOOR, HINGE_FREE],
                         ids=["floor", "no-contacts"])
def test_hinge_dof_rows_trajectory(xml_t):
    """Frictionloss and limit rows (the second state starts past the upper
    limit), damping under the Euler integrator, 50 steps."""
    rows = [dict(qpos=np.array([q]), qvel=np.array([v]))
            for q, v in ((0.45, 1.3), (0.55, 0.0), (-0.3, -2.0), (0.1, 0.4))]
    worst, ts = _trajectory(HINGE_FLOOR, xml_t, rows, 50)
    assert worst <= PGS_TOL, worst
    if xml_t is HINGE_FREE:
        assert tuple(ts.sensordata.shape) == (4, 0)


def _newton_xml(cone, noslip, iterations=30, ls_iterations=50):
    return SPHERES_NEWTON.format(cone=cone, noslip=noslip).replace(
        'iterations="30" ls_iterations="50"',
        f'iterations="{iterations}" ls_iterations="{ls_iterations}"')


def _one_step_at_a_time(xml, steps, tol, no_warmstart=False):
    _, jsys, tsys = _models(xml)
    step = _jstep(jsys)
    qpos, qvel = _sphere_states(12, 3)
    js = [_jstate(jsys, dict(qpos=qpos[i], qvel=qvel[i])) for i in range(3)]
    worst = 0.0
    x0s = []
    real_solve = newton.solve

    def recorded(*args, x0=None, **kw):
        x0s.append(x0)
        return real_solve(*args, x0=x0, **kw)

    with mock.patch.object(newton, "solve", recorded):
        for _ in range(steps):
            rows = [{f: np.asarray(getattr(s, f)) for f in FIELDS} for s in js]
            ts = pipeline.step(tsys, _tstate(tsys, rows),
                               torch.zeros(3, 0), 1)
            js = [step(s) for s in js]
            worst = max(worst, _err(js, ts))
    assert worst <= tol, worst
    assert len(x0s) == steps
    assert all((x is None) == no_warmstart for x in x0s)
    assert float(ts.sensordata.abs().max()) > 0


@pytest.mark.parametrize("budget,tol", [((30, 50), NEWTON_TOL),
                                        ((10, 4), NEWTON_ABOVE_FLOOR_TOL)],
                         ids=["model-budget", "above-floor"])
def test_newton_pyramidal_noslip_steps(budget, tol):
    """Newton, pyramidal cones, then 3 noslip sweeps on M⁻¹ from the dense
    factor; 30 steps."""
    _one_step_at_a_time(_newton_xml("pyramidal", 3, *budget), 30, tol)


def test_newton_elliptic_steps():
    """Newton, elliptic cones (condim 3 and 6); 30 steps."""
    _one_step_at_a_time(_newton_xml("elliptic", 0), 30, NEWTON_TOL)


def test_no_warmstart_switch(monkeypatch):
    """NIGHTMARE_NO_WARMSTART, set before either side builds anything: every
    Newton solve of the port starts without the warmstart, and the two
    sides agree step by step."""
    monkeypatch.setenv("NIGHTMARE_NO_WARMSTART", "1")
    _one_step_at_a_time(_newton_xml("pyramidal", 3, 10, 4), 10,
                        NEWTON_ABOVE_FLOOR_TOL, no_warmstart=True)


def test_hexapod_dense_matches_arrow(monkeypatch):
    """nightmare_v3 at 4 envs, one decimated step (2 substeps) from
    perturbed states: the dense branch (arrow layout withheld) against the
    block-arrow path, both through the dense PGS form (NIGHTMARE_PGS=scan:
    M⁻¹ from one factor or the other).  Exact algebra on both: 1e-10
    relative."""
    monkeypatch.setenv("NIGHTMARE_PGS", "scan")
    tsys = dataclasses.replace(loader.load_system("nightmare_v3", device="cpu"),
                               max_contacts=24)
    g = torch.Generator().manual_seed(5)
    st = pipeline.make_state(tsys, 4)
    qpos = st.qpos.clone()
    qpos[:, 7:] += 0.3 * torch.randn(4, 18, generator=g, dtype=torch.float64)
    qpos[:, 2] -= 0.13               # the feet reach the floor
    st = st.replace(qpos=qpos, qvel=torch.randn(4, tsys.nv, generator=g,
                                                dtype=torch.float64))
    ctrl = torch.randn(4, tsys.nu, generator=g, dtype=torch.float64)
    ref = pipeline.step(tsys, st, ctrl, 2)
    fwd = pipeline.forward(tsys, st, ctrl)
    assert fwd.M_chol is None and float(fwd.sol.nforce.max()) > 0
    with mock.patch.object(arrow, "layout", lambda sys: None):
        dense = pipeline.step(tsys, st, ctrl, 2)
        fwd_d = pipeline.forward(tsys, st, ctrl)
    assert fwd_d.M_chol is not None
    torch.testing.assert_close(fwd_d.M_chol @ fwd_d.M_chol.transpose(1, 2),
                               fwd_d.M, rtol=1e-12, atol=1e-12)
    for f in FIELDS:
        a, b = getattr(ref, f), getattr(dense, f)
        err = float((a - b).abs().max() / max(1.0, float(a.abs().max())))
        assert err <= PGS_TOL, (f, err)
