"""The port's Newton/elliptic path (nightmare_rl_tpu_torch physics on the
anymal_c and nightmare_v3_mjx archives, envs/anymal_c.py) against the JAX
package's.

Inputs are made with numpy from a seed and fed to both sides in float64 on
the CPU, 4 envs; the JAX side compiles once per fixture.  Contacts, the
rotational jacobian and every assembled row agree to 1e-10.

The steps are compared one decimated step at a time (each port step
starts from the JAX state before it), relative to each field's scale, at
STEP_TOL.  Round-off is all that separates the two sides, but the anymal_c
step amplifies it: the elliptic cones (impratio 100) make the Newton
Hessian stiff, and one decimated step from the reset pose moves the two
sides apart by a few 1e-9 of a field's scale.  Where the Newton budget
does not converge, the line search's last decision (take the bracket's low
end when φ' > 0) is taken on the round-off floor of φ' and jumps: on such
states the JAX package's own vmapped and per-env solves part far beyond
round-off (test_reference_solve_depends_on_batching).  So the step
tests start from the reset pose with small servo targets, where the
env's budget of 8 converges, and the env test (whose masked reset puts an
env back into the floor with a stale warmstart) runs a converged budget.
"""

import dataclasses
import hashlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nightmare_rl_tpu.envs.anymal_c import AnymalCCfg as JCfg
from nightmare_rl_tpu.envs.anymal_c import AnymalCEnv as JEnv
from nightmare_rl_tpu.physics import arrow as jarrow
from nightmare_rl_tpu.physics import collision as jcol
from nightmare_rl_tpu.physics import dynamics as jdyn
from nightmare_rl_tpu.physics import kinematics as jkin
from nightmare_rl_tpu.physics import loader as jloader
from nightmare_rl_tpu.physics import pipeline as jpipe
from nightmare_rl_tpu.physics import solver as jsolver
from nightmare_rl_tpu.utils import checkpoint as jckpt
from nightmare_rl_tpu.models import actor_critic as jac
from nightmare_rl_tpu_torch.envs import anymal_c as tenv_mod
from nightmare_rl_tpu_torch.models.actor_critic import ActorCritic
from nightmare_rl_tpu_torch.physics import collision as tcol
from nightmare_rl_tpu_torch.physics import kinematics as tkin
from nightmare_rl_tpu_torch.physics import loader as tloader
from nightmare_rl_tpu_torch.physics import pipeline as tpipe
from nightmare_rl_tpu_torch.physics import system as S
from nightmare_rl_tpu_torch.physics import solver as tsolver
from nightmare_rl_tpu_torch.utils.torch_io import actor_critic_state_from_jax

N = 4
ROW_TOL = 1e-10      # contacts and assembled rows (no solve)
STEP_TOL = 2e-8      # one decimated step, relative to the field's scale
MJX_TOL = 1e-9       # nightmare_v3_mjx (impratio 1), converged budget
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol=ROW_TOL, name=""):
    """Elementwise, infinite bounds compared as such."""
    a = np.asarray(a)
    b = b.detach().cpu().numpy()
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(b, a, err_msg=name)
        return
    np.testing.assert_array_equal(np.isinf(b), np.isinf(a), err_msg=name)
    fin = np.isfinite(a)
    np.testing.assert_allclose(b[fin], a[fin], rtol=tol, atol=tol, err_msg=name)


def _rel(a, b) -> float:
    """max|a - b| / max(1, max|a|): the error relative to the field's scale."""
    a = np.asarray(a)
    b = b.detach().cpu().numpy()
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(1.0, np.abs(a).max()))


def _anymal():
    cfg = JCfg()
    js = dataclasses.replace(jloader.load_system("anymal_c"),
                             solver_iterations=cfg.solver_iterations,
                             max_contacts=cfg.max_contacts)
    ts = dataclasses.replace(tloader.load_system("anymal_c", device="cpu"),
                             solver_iterations=cfg.solver_iterations,
                             max_contacts=cfg.max_contacts)
    return js, ts


@pytest.fixture(scope="module")
def systems():
    return _anymal()


# ---------------------------------------------------------------------------
# the archives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["anymal_c", "nightmare_v3_mjx"])
def test_asset_is_byte_identical_and_loads(name):
    def digest(pkg):
        with open(os.path.join(REPO, pkg, "assets", name + ".npz"), "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()

    assert digest("nightmare_rl_tpu_torch") == digest("nightmare_rl_tpu")
    js = jloader.load_system(name)
    ts = tloader.load_system(name, device="cpu")
    fields = {f.name for f in dataclasses.fields(js)}
    assert fields == {f.name for f in dataclasses.fields(ts)}
    for f in sorted(fields):
        a, b = getattr(js, f), getattr(ts, f)
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
        else:
            assert b == a, f
    assert ts.solver_type == S.SOLVER_NEWTON and ts.ls_refine == 8


# ---------------------------------------------------------------------------
# contacts and rows, on perturbed states with sliding feet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rich_inputs(systems):
    js, _ = systems
    rng = np.random.default_rng(0)
    qpos = np.tile(np.asarray(js.qpos0), (N, 1))
    qpos[:, 7:] += rng.normal(size=(N, 12)) * 0.2
    qpos[:, 3:7] += rng.normal(size=(N, 4)) * 0.05
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    qpos[:, 2] -= rng.uniform(0.0, 0.02, size=N)
    # one hinge per env past its upper limit, so limit rows are active
    rng_hi = np.asarray(js.jnt_range)[1:, 1]
    for e in range(N):
        qpos[e, 7 + 3 * e] = rng_hi[3 * e] + 0.05
    qvel = rng.normal(size=(N, 18)) * 0.5
    return qpos, qvel


@pytest.fixture(scope="module")
def jax_rows(systems, rich_inputs):
    js, _ = systems

    def one(q, v):
        kin = jkin.kinematics(js, q)
        con = jcol.find_contacts(js, kin)
        pair = jcol.find_pair_contacts(js, kin, con)
        asm = jsolver.assemble(js, con, q, v, pair=pair)
        return con, asm.efc, asm.nefc

    return jax.jit(jax.vmap(one))(*map(jnp.asarray, rich_inputs))


@pytest.fixture(scope="module")
def torch_rows(systems, rich_inputs):
    _, ts = systems
    q, v = (torch.from_numpy(x) for x in rich_inputs)
    kin = tkin.kinematics(ts, q)
    con = tcol.find_contacts(ts, kin)
    pair = tcol.find_pair_contacts(ts, kin, con)
    return con, tsolver.assemble(ts, con, q, v, pair=pair)


def test_find_contacts_and_jac_rot(systems, jax_rows, torch_rows):
    jc, tc = jax_rows[0], torch_rows[0]
    for name in tc._fields:
        _close(getattr(jc, name), getattr(tc, name), name=name)
    assert float(tc.jac_rot.abs().max()) > 0.0
    # the rotational jacobian is masked to the owning body's dofs
    _, ts = systems
    body = list(ts.cpoint_bodyid)
    mask = ts.body_dof_mask[body]                       # (ncp, nv)
    assert float((tc.jac_rot * (1 - mask)[None, ..., None]).abs().max()) == 0.0


def test_assemble_rows(jax_rows, torch_rows):
    _, je, jn = jax_rows
    asm = torch_rows[1]
    assert asm.ns_offset == 36
    assert tuple(asm.efc.J.shape) == (N, 96, 18)
    for name in asm.efc._fields:
        _close(getattr(je, name), getattr(asm.efc, name), name=name)
    for name in ("J", "aref", "R", "quad_active", "fl"):
        _close(getattr(jn, name), getattr(asm.nefc, name), name=name)
    assert [(g.start, g.dim, g.mus.shape[1]) for g in asm.nefc.cones] == [
        (36, 3, 8), (60, 6, 4), (84, 3, 4)]
    for jg, tg in zip(jn.cones, asm.nefc.cones):
        assert np.all(np.asarray(jg.start) == tg.start)
        for name in ("mu", "mus", "active"):
            _close(getattr(jg, name), getattr(tg, name), name=name)
    assert bool(asm.nefc.quad_active.any())
    assert all(bool(g.active.any()) for g in asm.nefc.cones[:2])


# ---------------------------------------------------------------------------
# the solve and the step, from the reset pose (where the feet sit 1 cm in
# the floor) with small joint offsets and servo targets
# ---------------------------------------------------------------------------


def _reset_inputs(js, seed, n_ctrl):
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(js.qpos0), (N, 1))
    qpos[:, 7:] += rng.normal(size=(N, 12)) * 0.02
    ctrl = [np.asarray(js.qpos0)[7:] + rng.normal(size=(N, 12)) * 0.1
            for _ in range(n_ctrl)]
    return qpos, np.zeros((N, 18)), ctrl


@pytest.fixture(scope="module")
def anymal_steps(systems):
    """Three decimated steps: the JAX states before and after each."""
    js, _ = systems
    qpos, qvel, ctrls = _reset_inputs(js, 1, 3)
    fn = jax.jit(jax.vmap(lambda s, c: jpipe.step(js, s, c, 4)))
    st = jax.vmap(lambda q, v: jpipe.make_state(js).replace(qpos=q, qvel=v))(
        jnp.asarray(qpos), jnp.asarray(qvel))
    out = []
    for c in ctrls:
        nxt = fn(st, jnp.asarray(c))
        out.append((st, c, nxt))
        st = nxt
    return out


def _port_phys(js_state) -> S.State:
    return S.State(**{f: _t(getattr(js_state, f))
                      for f in S.State.__dataclass_fields__})


def test_solve_contacts(systems, anymal_steps):
    """One forward pass from the state after the first decimated step (a
    warmstart is set): normal forces, constraint forces and qacc."""
    js, ts = systems
    jst, ctrl, _ = anymal_steps[1]
    lay = jarrow.layout(js)

    def one(s, c):
        kin = jkin.kinematics(js, s.qpos)
        vel = jkin.com_vel(js, kin, s.qvel)
        M = jdyn.crb(js, kin)
        act = jdyn.actuation(js, s.qpos, s.qvel, c)
        rhs = (act.qfrc_actuator + jdyn.passive(js, s.qvel)
               - jdyn.rne_bias(js, kin, vel, s.qvel))
        fac = jarrow.factor(lay, M)
        con = jcol.find_contacts(js, kin)
        pair = jcol.find_pair_contacts(js, kin, con)
        return jsolver.solve_contacts(
            js, con, s.qpos, s.qvel, None, jarrow.solve_vec(lay, fac, rhs),
            pair=pair, M=M, lay=lay, fac=fac, warmstart=s.qacc_warmstart)

    ref = jax.jit(jax.vmap(one))(jst, jnp.asarray(ctrl))
    st = _port_phys(jst)
    fwd = tpipe.forward(ts, st, torch.from_numpy(ctrl))
    for name in ("nforce", "qfrc_constraint", "qacc"):
        err = _rel(getattr(ref, name), getattr(fwd.sol, name))
        assert err <= STEP_TOL, (name, err)
    assert float(fwd.sol.nforce.max()) > 0.0


def test_pipeline_decimated_steps(systems, anymal_steps):
    """Euler with implicit damping, warmstarted Newton, elliptic cones:
    each of three decimated steps from the JAX state before it."""
    _, ts = systems
    for jst, ctrl, jnext in anymal_steps:
        out = tpipe.step(ts, _port_phys(jst), torch.from_numpy(ctrl), 4)
        for name in S.State.__dataclass_fields__:
            err = _rel(getattr(jnext, name), getattr(out, name))
            assert err <= STEP_TOL, (name, err)
    assert float(out.sensordata.min()) > 0.0        # all four feet loaded


def test_pipeline_free_running(systems, anymal_steps):
    """The same three decimated steps with the port carrying its own state:
    from these calm inputs the two stay within STEP_TOL over 12 substeps."""
    _, ts = systems
    st = _port_phys(anymal_steps[0][0])
    for _, ctrl, _ in anymal_steps:
        st = tpipe.step(ts, st, torch.from_numpy(ctrl), 4)
    jend = anymal_steps[-1][2]
    for name in ("qpos", "qvel", "qacc_warmstart", "sensordata"):
        err = _rel(getattr(jend, name), getattr(st, name))
        assert err <= STEP_TOL, (name, err)


def test_mjx_pyramidal_newton_noslip_steps():
    """nightmare_v3_mjx: pyramidal Newton then 5 noslip sweeps, plain
    Euler; three steps of 2 substeps, each from the JAX state before it.
    The archive's budget (1 Newton step, 4 refinements) is far from
    converged on states in contact, where the JAX package's own vmapped and
    per-env solves part (test_reference_solve_depends_on_batching); so both
    sides run a converged budget (30 steps, 8 refinements), as the JAX
    package's own MuJoCo comparison of this archive does."""
    js = jloader.load_system("nightmare_v3_mjx")
    ts = tloader.load_system("nightmare_v3_mjx", device="cpu")
    assert ts.cone == S.PYRAMIDAL and ts.noslip_iterations == 5
    assert not ts.eulerdamp and ts.integrator == S.EULER
    assert (ts.solver_iterations, ts.ls_iterations) == (1, 4)
    js = dataclasses.replace(js, solver_iterations=30, ls_iterations=50)
    ts = dataclasses.replace(ts, solver_iterations=30, ls_iterations=50)
    rng = np.random.default_rng(2)
    qpos = np.tile(np.asarray(js.qpos0), (N, 1))
    qpos[:, 7:] += rng.normal(size=(N, 18)) * 0.2
    qpos[:, 2] -= 0.09                               # tibias in the floor
    qvel = rng.normal(size=(N, 24)) * 0.3
    fn = jax.jit(jax.vmap(lambda s, c: jpipe.step(js, s, c, 2)))
    st = jax.vmap(lambda q, v: jpipe.make_state(js).replace(qpos=q, qvel=v))(
        jnp.asarray(qpos), jnp.asarray(qvel))
    active = 0
    for _ in range(3):
        ctrl = rng.normal(size=(N, 18))
        nxt = fn(st, jnp.asarray(ctrl))
        out = tpipe.step(ts, _port_phys(st), torch.from_numpy(ctrl), 2)
        for name in S.State.__dataclass_fields__:
            err = _rel(getattr(nxt, name), getattr(out, name))
            assert err <= MJX_TOL, (name, err)
        active += int((out.sensordata > 0).sum())
        st = nxt
    assert active > 0


def test_reference_solve_depends_on_batching():
    """Why the Newton comparisons pick their budgets: at nightmare_v3_mjx's
    own budget (1 Newton step, 4 refinements) the JAX package's solve of
    states in contact is not a continuous function of its inputs.  The same
    forward pass, vmapped over 4 envs and jitted per env, differs far beyond
    round-off, because the line search's last choice is taken on the
    round-off floor of φ'."""
    js = jloader.load_system("nightmare_v3_mjx")
    rng = np.random.default_rng(2)
    qpos = np.tile(np.asarray(js.qpos0), (N, 1))
    qpos[:, 7:] += rng.normal(size=(N, 18)) * 0.2
    qpos[:, 2] -= rng.uniform(0.09, 0.12, size=N)
    qvel = rng.normal(size=(N, 24)) * 0.3
    ctrl = rng.normal(size=(N, 18))

    def qacc(q, v, c):
        st = jpipe.make_state(js).replace(qpos=q, qvel=v)
        return jpipe.forward(js, st, c).sol.qacc

    args = [jnp.asarray(x) for x in (qpos, qvel, ctrl)]
    batched = np.asarray(jax.jit(jax.vmap(qacc))(*args))
    one = jax.jit(qacc)
    per_env = np.stack([np.asarray(one(*(a[e] for a in args)))
                        for e in range(N)])
    spread = np.abs(batched - per_env).max() / np.abs(batched).max()
    assert spread > 1e-6, spread


# ---------------------------------------------------------------------------
# the env
# ---------------------------------------------------------------------------


RESET_ENV = 2
ENV_ITERATIONS = 30   # a budget that converges (see the module docstring)


@pytest.fixture(scope="module")
def episode():
    """Both envs side by side, 3 steps of 4 envs with a masked reset at the
    first.  Each port step starts from the JAX state before it and is
    handed the commands the JAX step ended with (the JAX env draws from
    per-env keys that torch cannot reproduce)."""
    jenv = JEnv(JCfg(num_envs=N, solver_iterations=ENV_ITERATIONS),
                dtype=jnp.float64)
    tenv = tenv_mod.AnymalCEnv(
        tenv_mod.AnymalCCfg(num_envs=N, solver_iterations=ENV_ITERATIONS),
        dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(11)
    jstate, _ = jenv.reset(0)
    jstate = jstate.replace(episode_length=jstate.episode_length.at[
        RESET_ENV].set(jenv.max_episode_length))
    pairs = []
    with pytest.MonkeyPatch.context() as mp:
        for _ in range(3):
            acts = rng.normal(size=(N, 12)) * 0.1
            jout = jenv.step(jstate, jnp.asarray(acts))
            cmds = _t(jout.state.commands)
            mp.setattr(tenv, "_sample_commands", lambda n, c=cmds: c)
            tout = tenv.step(_port_state(jstate), torch.from_numpy(acts))
            pairs.append((jout, tout))
            jstate = jout.state
    return jenv, tenv, pairs


def _port_state(js) -> tenv_mod.EnvState:
    kw = {f: _t(getattr(js, f)) for f in tenv_mod.EnvState.__dataclass_fields__
          if f != "phys"}
    return tenv_mod.EnvState(phys=_port_phys(js.phys), **kw)


def test_env_steps_match(episode):
    _, _, pairs = episode
    for jout, tout in pairs:
        for name in ("done", "time_out"):
            _close(getattr(jout, name), getattr(tout, name), name=name)
        for name in ("obs", "reward", "reward_terms", "finished_episode_sums",
                     "record_qpos", "record_qvel"):
            a, b = np.asarray(getattr(jout, name)), getattr(tout, name)
            np.testing.assert_array_equal(np.isnan(b.numpy()), np.isnan(a))
            ok = ~np.isnan(a)
            if ok.any():
                err = _rel(a[ok], b[torch.from_numpy(ok)])
                assert err <= STEP_TOL, (name, err)
        js, ts = jout.state, tout.state
        for name in tenv_mod.EnvState.__dataclass_fields__:
            if name == "phys":
                continue
            a, b = getattr(js, name), getattr(ts, name)
            if np.asarray(a).dtype in (bool, np.int32):
                _close(a, b, name=name)
            else:
                assert _rel(a, b) <= STEP_TOL, name
        for name in S.State.__dataclass_fields__:
            assert _rel(getattr(js.phys, name), getattr(ts.phys, name)) <= STEP_TOL, name


def test_masked_reset_keeps_warmstart(episode):
    jenv, tenv, pairs = episode
    jout, tout = pairs[0]
    assert tout.done.tolist() == [i == RESET_ENV for i in range(N)]
    st = tout.state
    assert torch.equal(st.phys.qpos[RESET_ENV], tenv.sys.qpos0)
    assert float(st.phys.qvel[RESET_ENV].abs().max()) == 0.0
    # the reset leaves the physics warmstart as the step left it
    assert float(st.phys.qacc_warmstart[RESET_ENV].abs().max()) > 0.0
    assert int(st.episode_length[RESET_ENV]) == 0
    fin = tout.finished_episode_sums
    assert torch.isfinite(fin[RESET_ENV]).all()
    assert torch.isnan(fin[[i for i in range(N) if i != RESET_ENV]]).all()


def test_reward_names_and_config():
    from nightmare_rl_tpu.envs.anymal_c import REWARD_NAMES

    assert tenv_mod.REWARD_NAMES == REWARD_NAMES
    assert dataclasses.asdict(tenv_mod.AnymalCCfg()) == dataclasses.asdict(JCfg())


def test_float32_env_resamples_at_1249():
    """dt comes from the float32 System: 4 · 0.002f = 0.008000000379…, so
    int(10 / dt) is 1249, as in the JAX env (1250 in float64)."""
    jenv = JEnv(JCfg(num_envs=2))
    env32 = tenv_mod.AnymalCEnv(tenv_mod.AnymalCCfg(num_envs=2), device="cpu")
    env64 = tenv_mod.AnymalCEnv(tenv_mod.AnymalCCfg(num_envs=2),
                                dtype=torch.float64, device="cpu")
    assert int(JCfg().resampling_time / jenv.dt) == 1249
    assert env32.resample_every == 1249 and env64.resample_every == 1250
    assert env32.dt == jenv.dt
    assert env32.max_episode_length == jenv.max_episode_length


def test_port_reset_and_commands():
    env = tenv_mod.AnymalCEnv(tenv_mod.AnymalCCfg(num_envs=8),
                              dtype=torch.float64, device="cpu")
    state, obs = env.reset(3)
    assert obs.shape == (8, 48) and torch.isfinite(obs).all()
    c = state.commands
    assert float(c[:, 0].abs().max()) <= 1.0 and float(c[:, 1].abs().max()) <= 0.5
    assert float(c[:, 2].abs().max()) <= 1.0
    _, obs2 = env.reset(3)
    assert torch.equal(obs, obs2)  # a seed fixes the draw


# ---------------------------------------------------------------------------
# the trained quadruped policy
# ---------------------------------------------------------------------------


def test_anymal_model_122_carried_across():
    """artifacts/anymal_model_122 restored through the JAX package, its
    params carried into the port's ActorCritic (48 -> 12): forward passes
    agree to 1e-12 in float64."""
    path = os.path.join(REPO, "artifacts", "anymal_model_122")
    tree = jckpt._checkpointer().restore(path)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, dtype=np.float64), {"params": tree["params"]["params"]})
    net_j = jac.ActorCritic(num_actions=12)
    obs = np.random.default_rng(0).normal(size=(16, 48))
    mu_j, std_j, v_j = net_j.apply(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(obs))
    net = ActorCritic(48, 12).double()
    net.load_state_dict(actor_critic_state_from_jax(params))
    with torch.no_grad():
        mu, std, v = net(torch.from_numpy(obs))
    std = std.detach()
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(std.numpy(), np.asarray(std_j), rtol=0, atol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the captured step (utils/graph.py; the CUDA graph itself is held on the
# card by chip_smoke.py's graph-anymal phase)
# ---------------------------------------------------------------------------


def _bitwise_equal(a, b) -> bool:
    from nightmare_rl_tpu_torch.utils.graph import leaves

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and bool(torch.all((x == y) | (torch.isnan(x) & torch.isnan(y))
                           if x.is_floating_point() else x == y))
        for x, y in zip(la, lb))


def test_captured_step_equals_env_step():
    """``CapturedStep`` of the anymal_c step (float32, 4 envs, the env's
    own budget of 8) gives every StepOut field of ``env.step`` bit for bit
    over 4 steps with a masked reset at the first, and draws the same
    numbers from the env's generator; its warm-up leaves the state buffers
    and the generator as they were.  On the CPU the captured step runs
    eagerly on its own buffers: tolerance 0, bit for bit."""
    from nightmare_rl_tpu_torch.utils.graph import CapturedStep, clone

    env = tenv_mod.AnymalCEnv(tenv_mod.AnymalCCfg(num_envs=N), device="cpu")
    s0, _ = env.reset(0)
    s0.episode_length[RESET_ENV] = env.max_episode_length  # resets at step 1
    rng = np.random.default_rng(12)
    acts = [torch.from_numpy((rng.normal(size=(N, 12)) * 0.3).astype(
        np.float32)) for _ in range(4)]
    gen0 = env.generator.get_state()
    eager, s = [], s0
    for a in acts:
        out = env.step(s, a)
        eager.append(clone(out))
        s = out.state
    gen_eager = env.generator.get_state()
    assert bool(eager[0].done[RESET_ENV]) and bool(eager[0].time_out[RESET_ENV])

    env.generator.set_state(gen0)
    step = CapturedStep(env.step, s0, acts[0], generators=[env.generator],
                        state_field="state")
    before = clone(step.state)
    step.warm_up([env.generator])
    assert _bitwise_equal(step.state, before)
    assert torch.equal(env.generator.get_state(), gen0)
    s = s0
    for k, a in enumerate(acts):
        out = step(s, a)
        assert out.state is step.state
        assert _bitwise_equal(out, eager[k]), k
        s = out.state
    assert torch.equal(env.generator.get_state(), gen_eager)
