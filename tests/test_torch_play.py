"""The port's evaluation tools against the JAX package's, on the CPU in
float64:

- ``tools/play.py``'s rollout of ``artifacts/model_3176.pt`` (deterministic
  mean): 1 env for 5 steps and the 7-command grid for 3 steps.  The JAX side
  is the JAX tool's step (play.py:92-105, 216-225: the command pinned, the
  policy mean through ``net.apply``, ``env._step_batch``) with the weights
  read by ``nightmare_rl_tpu.utils.torch_io.load_pt``; the port starts from
  the JAX env's post-reset state.  qpos, obs, vel and feet agree to 1e-9
  (both sides solve with the dense matrix-free PGS, NIGHTMARE_PGS=scan; the
  port's CPU default is the leg-sparse form);
- ``print_gait_metrics`` prints the same line for the same inputs;
- ``tools/custom_play.py``'s control step on 2 envs for 3 steps against
  the same step built from the JAX ``G.update`` + ``pipeline.step``
  (custom_play.py:55-66), 1e-9;
- the entry points' argument handling on the CPU at a tiny size.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nightmare_rl_tpu.core.config import EnvCfg as JEnvCfg
from nightmare_rl_tpu.core.config import NightmareV3Cfg as JCfg
from nightmare_rl_tpu.engine import gait as JG
from nightmare_rl_tpu.envs.nightmare_v3 import NightmareV3Env as JEnv
from nightmare_rl_tpu.models.actor_critic import ActorCritic as JActorCritic
from nightmare_rl_tpu.physics import loader as jloader
from nightmare_rl_tpu.physics import pipeline as jpipe
from nightmare_rl_tpu.physics import system as JS
from nightmare_rl_tpu.tools import play as jplay
from nightmare_rl_tpu.utils.torch_io import load_pt
from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
from nightmare_rl_tpu_torch.envs import nightmare_v3 as tenv_mod
from nightmare_rl_tpu_torch.physics import system as S
from nightmare_rl_tpu_torch.tools import custom_play, play, replay

TOL = 1e-9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "model_3176.pt")


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_state(js) -> tenv_mod.EnvState:
    """The JAX EnvState as the port's (its per-env keys dropped)."""
    phys = S.State(**{f: _t(getattr(js.phys, f))
                      for f in S.State.__dataclass_fields__})
    kw = {f: _t(getattr(js, f)) for f in tenv_mod.EnvState.__dataclass_fields__
          if f != "phys"}
    return tenv_mod.EnvState(phys=phys, **kw)


def _jax_rollout(N, cmd, steps):
    """The JAX play tool's deterministic step, in float64; returns the
    post-reset state and obs and the per-step records."""
    env = JEnv(JCfg().replace(env=JEnvCfg(num_envs=N)), dtype=jnp.float64)
    net = JActorCritic(num_actions=env.num_actions)
    params = net.init(jax.random.PRNGKey(0),
                      jnp.zeros((N, env.num_obs), jnp.float64))
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64),
                                    load_pt(CKPT, params))
    cmd = jnp.asarray(cmd, jnp.float64)
    rec = {k: [] for k in ("qpos", "obs", "vel", "feet")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NIGHTMARE_PGS", "scan")
        state, obs = env.reset(0)
        state0, obs0 = state, obs

        @jax.jit
        def step(state, obs):
            mu, _, _ = net.apply(params, obs)
            out = env._step_batch(state.replace(commands=cmd), mu)
            vel = jnp.concatenate([out.obs[:, :3] / 2.0, out.obs[:, 3:6] / 0.25],
                                  axis=1)
            return out.state, out.obs, vel, out.state.phys.sensordata[:, 6:12]

        for _ in range(steps):
            state, obs, vel, feet = step(state, obs)
            for k, v in (("qpos", state.phys.qpos), ("obs", obs), ("vel", vel),
                         ("feet", feet)):
                rec[k].append(np.asarray(v))
    return state0, obs0, {k: np.stack(v) for k, v in rec.items()}


@pytest.mark.parametrize("N,steps", [(1, 5), (7, 3)], ids=["single", "grid"])
def test_play_rollout_matches(N, steps, monkeypatch):
    cmd = (np.array([[0.3, 0.0, 0.0]]) if N == 1
           else play.GRID.astype(np.float64))
    jstate, jobs, ref = _jax_rollout(N, cmd, steps)
    monkeypatch.setenv("NIGHTMARE_PGS", "scan")   # the JAX side's form
    env = tenv_mod.NightmareV3Env(NightmareV3Cfg().replace(
        env=EnvCfg(num_envs=N)), dtype=torch.float64, device="cpu")
    net = play.load_policy(CKPT, env)
    assert next(net.parameters()).dtype == torch.float64
    _, _, rec = play.rollout(env, net, _port_state(jstate), _t(jobs),
                             torch.from_numpy(cmd), steps)
    for k in ("qpos", "obs", "vel", "feet"):
        assert rec[k].shape == ref[k].shape, k
        np.testing.assert_allclose(rec[k], ref[k], rtol=TOL, atol=TOL, err_msg=k)
    assert not rec["done"].any()
    # the commands stayed pinned: obs[9:12] is commands * (2, 2, 0.25)
    np.testing.assert_allclose(rec["obs"][-1, :, 9:12],
                               cmd * np.array([2.0, 2.0, 0.25]), atol=1e-12)


def test_gait_metrics_line_matches(capsys):
    rng = np.random.default_rng(4)
    feet = np.where(rng.random((300, 6)) < 0.6, rng.random((300, 6)) * 5, 0.0)
    base_z = 0.09 + 0.01 * rng.normal(size=300)
    jplay.print_gait_metrics(feet, base_z, 0.016)
    ref = capsys.readouterr().out.strip()
    line = play.print_gait_metrics(feet, base_z, 0.016)
    assert capsys.readouterr().out.strip() == line == ref


def test_custom_play_step_matches():
    N, steps = 2, 3
    lin = np.array([0.08, 0.05])
    ang = np.array([0.0, 0.25])
    rng = np.random.default_rng(9)
    dq = 0.05 * rng.normal(size=(N, 18))

    # the JAX tool's step (custom_play.py:39-66) in float64, lin/ang per env
    js = dataclasses.replace(JS.tree_cast(jloader.load_system("nightmare_v3"),
                                          jnp.float64), max_contacts=16)
    dt = float(js.timestep)
    jcfg = JG.make_cfg(engine_fps=1.0 / (dt * 2))

    def one(ph, e, lim, t, li, an):
        e, angles = JG.update(jcfg, e, t, li, an, jnp.int32(JG.CMD_AWAKE),
                              jnp.int32(JG.MODE_WALK))
        lim = lim + jnp.clip(angles - lim, -0.08, 0.08)
        ctrl = (lim - ph.qpos[7:]) * 12.0
        return jpipe.step(js, ph, ctrl, 2), e, lim

    jphys = jax.vmap(lambda _: jpipe.make_state(js))(jnp.arange(N))
    jphys = jphys.replace(qpos=jphys.qpos.at[:, 7:].add(jnp.asarray(dq)))
    jes = jax.vmap(lambda _: JG.init_state(jcfg))(jnp.arange(N))
    jlim = jnp.zeros((N, 18))

    sys_, cfg, phys, es, limited = custom_play.make(N, device="cpu",
                                                    dtype=torch.float64)
    phys = phys.replace(qpos=phys.qpos.clone())
    phys.qpos[:, 7:] += torch.from_numpy(dq)
    assert float(sys_.timestep) == dt and cfg.engine_fps == jcfg.engine_fps

    t = 0.0
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NIGHTMARE_PGS", "scan")
        jstep = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, None, 0, 0)))
        for _ in range(steps):
            t += dt * 2
            jphys, jes, jlim = jstep(jphys, jes, jlim, jnp.float64(t),
                                     jnp.asarray(lin), jnp.asarray(ang))
            phys, es, limited = custom_play.control_step(
                sys_, cfg, phys, es, limited, t, torch.from_numpy(lin),
                torch.from_numpy(ang))
            for name, a, b in (("qpos", jphys.qpos, phys.qpos),
                               ("qvel", jphys.qvel, phys.qvel),
                               ("sensordata", jphys.sensordata, phys.sensordata),
                               ("limited", jlim, limited),
                               ("pose", jes.pose, es.pose)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL,
                                           atol=TOL, err_msg=name)
    assert float(limited.abs().max()) > 0.0


def test_entry_points_on_the_cpu(tmp_path, capsys):
    """The CLIs at a tiny size with --device cpu: play writes a trajectory
    that replay loads; custom_play and simple_test run; a directory as
    --ckpt is refused with the JAX exporter's name."""
    out = str(tmp_path / "traj.npz")
    res = play.main(["--ckpt", CKPT, "--steps", "3", "--out", out,
                     "--device", "cpu"])
    assert len(res["traj"]) == 3 and res["falls"] == 0
    assert replay.main(["--file", out, "--no-view"]) == [(out, 3)]
    pkl = str(tmp_path / "gait.pkl")
    res = custom_play.main(["--steps", "2", "--envs", "2", "--out", pkl,
                            "--device", "cpu"])
    assert res["qpos"].shape == (2, 25) and np.isfinite(res["qpos"]).all()
    assert replay.main(["--dir", str(tmp_path), "--no-view"]) == [
        (pkl, 2), (out, 3)]
    from nightmare_rl_tpu_torch.tools import simple_test

    assert simple_test.main(["-e", "2", "-s", "1", "-d", "1",
                             "--device", "cpu"]) > 0
    with pytest.raises(SystemExit, match="export_torch"):
        play.main(["--ckpt", str(tmp_path), "--steps", "1", "--device", "cpu"])


def test_custom_play_spreads_commands_over_envs(monkeypatch):
    """``--lin``/``--ang`` with several values: env i takes the (i mod
    count)-th on every control step."""
    seen = []
    step = custom_play.control_step

    def kept(*args):
        seen.append((args[-2].clone(), args[-1].clone()))
        return step(*args)

    monkeypatch.setattr(custom_play, "control_step", kept)
    res = custom_play.main(["--steps", "2", "--envs", "3", "--lin", "0.08",
                            "0.05", "--ang", "0", "0.25", "--device", "cpu"])
    assert len(seen) == 2
    for lin, ang in seen:
        assert torch.equal(lin, torch.tensor([0.08, 0.05, 0.08]))
        assert torch.equal(ang, torch.tensor([0.0, 0.25, 0.0]))
    np.testing.assert_array_equal(res["qpos"][0], res["qpos"][2])


def test_load_policy_leaves_the_global_rng():
    """The random policy is seeded 0 without touching the caller's RNG."""
    env = tenv_mod.NightmareV3Env(NightmareV3Cfg().replace(
        env=EnvCfg(num_envs=1)), device="cpu")
    torch.manual_seed(123)
    expected = torch.rand(4)
    torch.manual_seed(123)
    a = play.load_policy(None, env)
    b = play.load_policy(CKPT, env)
    assert torch.equal(torch.rand(4), expected)
    c = play.load_policy(None, env)
    for k, v in a.state_dict().items():
        assert torch.equal(v, c.state_dict()[k]), k
    assert not torch.equal(a.state_dict()["actor.0.weight"],
                           b.state_dict()["actor.0.weight"])
