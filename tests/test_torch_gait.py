"""The port's batched gait engine and CPG bank
(nightmare_rl_tpu_torch/engine/gait.py, envs/cpg.py) against the JAX
package's, on the CPU in float64.

The journeys are those of tests/test_engine.py (idle → get up → stand or
walk, straight and turning), run for every gait table and extended back to
stand, sit and idle so that every FSM state is visited.  The JAX engine runs
one env per jitted ``G.update`` call; the port steps a batch of envs in one
call.  Angles and every EngineState field agree to TOL = 1e-10 at every
tick; the CPG functions to 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nightmare_rl_tpu.engine import gait as JG
from nightmare_rl_tpu.envs import cpg as jcpg
from nightmare_rl_tpu_torch.engine import gait as G
from nightmare_rl_tpu_torch.envs import cpg

TOL = 1e-10
FPS = 50.0
FIELDS = ("fsm", "state_start", "pose", "adj_start_pose", "gait_step",
          "gait_phase", "last_step_pose")

_jupdate = jax.jit(JG.update)


def _cmd(state_s, mode_s):
    return (G.CMD_AWAKE if state_s == "awake" else G.CMD_IDLE,
            G.MODE_WALK if mode_s == "walk" else G.MODE_STAND)


def drive(gait, scripts, fps=FPS, probe=None):
    """Run len(scripts) envs through their scripts (equal tick counts) on
    both engines.  scripts[i]: [(ticks, lin, ang, state, mode)].  Returns
    the per-tick angles and states of both, (T, N, ...) each."""
    N = len(scripts)
    per_env = []
    for script in scripts:
        rows = []
        for (ticks, lin, ang, st, md) in script:
            rows += [(lin, ang) + _cmd(st, md)] * ticks
        per_env.append(rows)
    T = len(per_env[0])
    assert all(len(r) == T for r in per_env)

    jcfg = JG.make_cfg(gait=gait, engine_fps=fps)
    jes = [JG.init_state(jcfg) for _ in range(N)]
    cfg = G.make_cfg(gait=gait, engine_fps=fps)
    es = G.init_state(cfg, N)
    dt = 1.0 / fps
    t = 0.0
    out = {"j_angles": [], "t_angles": [],
           "j": {f: [] for f in FIELDS}, "t": {f: [] for f in FIELDS}}
    for k in range(T):
        t += dt
        rows = [per_env[i][k] for i in range(N)]
        lin, ang, cs, cm = (torch.tensor([r[c] for r in rows],
                                         dtype=torch.float64 if c < 2 else torch.long)
                            for c in range(4))
        if probe is not None:
            probe(cfg, es, lin, ang)
        es, angles = G.update(cfg, es, t, lin, ang, cs, cm)
        ja = []
        for i, (li, an, c_s, c_m) in enumerate(rows):
            jes[i], a = _jupdate(jcfg, jes[i], jnp.float64(t), jnp.float64(li),
                                 jnp.float64(an), jnp.int32(c_s), jnp.int32(c_m))
            ja.append(np.asarray(a))
        out["j_angles"].append(np.stack(ja))
        out["t_angles"].append(angles.numpy())
        for f in FIELDS:
            out["j"][f].append(np.stack([np.asarray(getattr(e, f)) for e in jes]))
            out["t"][f].append(getattr(es, f).numpy())
    for key in ("j_angles", "t_angles"):
        out[key] = np.stack(out[key])
    for side in ("j", "t"):
        out[side] = {f: np.stack(v) for f, v in out[side].items()}
    return out


def _assert_agree(out):
    np.testing.assert_allclose(out["t_angles"], out["j_angles"], rtol=0,
                               atol=TOL, err_msg="angles")
    for f in FIELDS:
        np.testing.assert_allclose(out["t"][f], out["j"][f], rtol=0, atol=TOL,
                                   err_msg=f)


# the journeys of tests/test_engine.py, extended back through stand, sit
# and idle
GETUP_STAND = [(5, 0.0, 0.0, "idle", "stand"), (250, 0.0, 0.0, "awake", "stand")]
WALK_STRAIGHT = [(180, 0.0, 0.0, "awake", "stand"),
                 (150, 0.08, 0.0, "awake", "walk"),
                 (60, 0.0, 0.0, "awake", "stand"),
                 (200, 0.0, 0.0, "idle", "stand")]
WALK_TURN = [(180, 0.0, 0.0, "awake", "stand"),
             (120, 0.05, 0.25, "awake", "walk"),
             (60, 0.0, 0.0, "awake", "stand"),
             (230, 0.0, 0.0, "idle", "stand")]


def test_getup_and_stand():
    out = drive("tripod", [GETUP_STAND])
    _assert_agree(out)
    assert out["t"]["fsm"][-1, 0] == G.STAND


@pytest.mark.parametrize("gait", ["tripod", "ripple", "wave"])
def test_walk_journeys_every_gait(gait):
    """Straight and turning walks, in one batch of two envs, through every
    FSM state."""
    out = drive(gait, [WALK_STRAIGHT, WALK_TURN])
    _assert_agree(out)
    visited = set(np.unique(out["t"]["fsm"]).tolist())
    assert visited == set(range(7)), visited
    assert out["t"]["gait_step"].max() == len(G.GAITS[gait]) - 1


def test_batch_of_four_with_fall_through():
    """Four envs with different commands in one call; env 3 walks so fast
    that no reduction factor passes the keep-out test (red = 0)."""
    reds = []

    def probe(cfg, es, lin, ang):
        dt = es.pose.dtype
        trasl = torch.tensor([0.0, 1.0, 0.0], dtype=dt) * lin[:, None]
        rot = torch.tensor([0.0, 0.0, 1.0], dtype=dt) * ang[:, None]
        red = G.walk_reduction(cfg, es, trasl, rot)
        reds.append(torch.where(es.fsm == G.WALK, red, torch.nan))

    scripts = [
        [(180, 0.0, 0.0, "awake", "stand"), (120, 0.08, 0.0, "awake", "walk")],
        [(180, 0.0, 0.0, "awake", "walk"), (120, -0.06, 0.3, "awake", "walk")],
        [(90, 0.0, 0.0, "idle", "stand"), (210, 0.0, -0.4, "awake", "walk")],
        [(180, 0.0, 0.0, "awake", "stand"), (120, 1.5, 0.0, "awake", "walk")],
    ]
    out = drive("tripod", scripts, probe=probe)
    _assert_agree(out)
    reds = torch.stack(reds)
    walking = ~torch.isnan(reds)
    assert (reds[walking[:, 3], 3] == 0.0).any(), \
        "no fall-through at the large speed"
    assert walking[:, 0].any() and (reds[walking[:, 0], 0] > 0.0).all()
    assert len(np.unique(out["t"]["fsm"][-1])) > 1  # the envs differ


def test_walk_reduction_takes_the_first_passing_factor():
    """argmax over a cast bool picks the first True, as jnp.argmax does."""
    ok = torch.tensor([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=torch.bool)
    assert torch.argmax(ok.to(torch.int32), dim=0).tolist() == [1, 2]


def test_ik_matches_including_unreachable_targets():
    rng = np.random.default_rng(3)
    cfg = G.make_cfg()
    jcfg = JG.make_cfg()
    base = cfg.default_pose.numpy()
    poses = [base + rng.normal(scale=0.03, size=(6, 3)) for _ in range(20)]
    # too far (beyond femur + tibia) and too close (inside |femur - tibia|)
    off = cfg.pose_offset.numpy()
    poses.append(off + np.array([0.5, 0.4, -0.3]))
    poses.append(off + np.array([0.07, 0.01, -0.01]))
    poses.append(off + np.array([0.08, 0.0, 0.0]))      # z = 0: nz = eps
    poses = np.stack(poses)
    ours = G.pose_to_angles(cfg, torch.from_numpy(poses)).numpy()
    ref = np.stack([np.asarray(JG.pose_to_angles(jcfg, jnp.asarray(p)))
                    for p in poses])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)
    assert np.isfinite(ours).all()


def test_cpg_matches():
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(2, 4, 6))
    w = rng.uniform(1.0, 4.0, size=(4, 6))
    got = cpg.hopf_deriv(torch.from_numpy(x), torch.from_numpy(y), 10.0, 20.0,
                         1.5, torch.from_numpy(w))
    ref = jcpg.hopf_deriv(jnp.asarray(x), jnp.asarray(y), 10.0, 20.0, 1.5,
                          jnp.asarray(w))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    got = cpg.rotate(torch.from_numpy(x), torch.from_numpy(y), np.pi / 3)
    ref = jcpg.rotate(jnp.asarray(x), jnp.asarray(y), jnp.pi / 3)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)

    s = cpg.init(6, torch.float64)
    js = jcpg.init(6, jnp.float64)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), atol=1e-12)
    np.testing.assert_allclose(s.y.numpy(), np.asarray(js.y), atol=1e-12)
    freqs = rng.uniform(1.0, 3.0, size=6)
    for _ in range(200):
        s = cpg.step(s, torch.from_numpy(freqs), mu=1.3)
        js = jcpg.step(js, jnp.asarray(freqs), mu=1.3)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), atol=1e-12)
    np.testing.assert_allclose(s.y.numpy(), np.asarray(js.y), atol=1e-12)
