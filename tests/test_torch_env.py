"""The port's nightmare_v3 env (nightmare_rl_tpu_torch/envs/nightmare_v3.py)
against the JAX package's, plus the port's import hygiene and its refusal
to fall back to the CPU.

Both envs run 4 envs in float64 on the CPU.  The port starts from the JAX
env's post-reset state, and one env is put at the end of its episode so the
next step resets it (a masked reset).  The JAX env draws commands from
per-env keys that torch cannot reproduce, so each port step is handed the
commands the JAX step ended with; everything else the port computes itself
and carries from step to step.  Both sides solve with the dense
matrix-free PGS (NIGHTMARE_PGS=scan, set around both; the port's CPU
default is the leg-sparse form), so the two agree to summation order:
ATOL = RTOL = 1e-9 over three steps."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nightmare_rl_tpu.core.config import EnvCfg as JEnvCfg
from nightmare_rl_tpu.core.config import NightmareV3Cfg as JCfg
from nightmare_rl_tpu.envs.nightmare_v3 import NightmareV3Env as JEnv
from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
from nightmare_rl_tpu_torch.envs import nightmare_v3 as tenv_mod
from nightmare_rl_tpu_torch.physics import system as S

ATOL = RTOL = 1e-9
N = 4
STEPS = 3
RESET_ENV = 2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_state(js) -> tenv_mod.EnvState:
    """The JAX EnvState as the port's (its per-env keys dropped)."""
    phys = S.State(**{f: _t(getattr(js.phys, f))
                      for f in S.State.__dataclass_fields__})
    kw = {f: _t(getattr(js, f)) for f in tenv_mod.EnvState.__dataclass_fields__
          if f != "phys"}
    return tenv_mod.EnvState(phys=phys, **kw)


def _close(a, b, name):
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(b, a, err_msg=name)
    else:
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, equal_nan=True,
                                   err_msg=name)


@pytest.fixture(scope="module")
def episode():
    """Runs both envs side by side; returns the JAX env, the port's env and
    [(JAX StepOut, port StepOut)] per step."""
    jenv = JEnv(JCfg().replace(env=JEnvCfg(num_envs=N)), dtype=jnp.float64)
    tenv = tenv_mod.NightmareV3Env(NightmareV3Cfg().replace(
        env=EnvCfg(num_envs=N)), dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(11)
    pairs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NIGHTMARE_PGS", "scan")
        jstate, _ = jenv.reset(0)
        jstate = jstate.replace(episode_length=jstate.episode_length.at[
            RESET_ENV].set(jenv.max_episode_length))
        tstate = _port_state(jstate)
        for _ in range(STEPS):
            acts = rng.normal(size=(N, 18))
            jout = jenv.step(jstate, jnp.asarray(acts))
            cmds = _t(jout.state.commands)
            mp.setattr(tenv, "_sample_commands", lambda n, c=cmds: c)
            tout = tenv.step(tstate, torch.from_numpy(acts))
            pairs.append((jout, tout))
            jstate, tstate = jout.state, tout.state
    return jenv, tenv, pairs


def test_env_steps_match(episode):
    _, _, pairs = episode
    for jout, tout in pairs:
        for name in ("obs", "reward", "done", "time_out", "reward_terms",
                     "finished_episode_sums", "record_qpos", "record_qvel"):
            _close(getattr(jout, name), getattr(tout, name), name)


def test_env_state_matches(episode):
    _, _, pairs = episode
    for jout, tout in pairs:
        js, ts = jout.state, tout.state
        for name in tenv_mod.EnvState.__dataclass_fields__:
            if name != "phys":
                _close(getattr(js, name), getattr(ts, name), name)
        for name in S.State.__dataclass_fields__:
            _close(getattr(js.phys, name), getattr(ts.phys, name), name)


def test_masked_reset(episode):
    _, tenv, pairs = episode
    _, tout = pairs[0]
    assert tout.done.tolist() == [i == RESET_ENV for i in range(N)]
    assert bool(tout.time_out[RESET_ENV])
    st = tout.state
    assert torch.equal(st.phys.qpos[RESET_ENV], tenv.sys.qpos0)
    assert int(st.episode_length[RESET_ENV]) == 0
    # the finished episode's sums come out; others are nan
    fin = tout.finished_episode_sums
    assert torch.isfinite(fin[RESET_ENV]).all()
    assert torch.isnan(fin[[i for i in range(N) if i != RESET_ENV]]).all()
    # quirk: the reset env's first control reads the pre-reset dof_pos
    assert not torch.equal(st.dof_pos[RESET_ENV], tenv.sys.qpos0[7:])


def test_noise_scale_vec_keeps_stale_offsets(episode):
    """The inert noise path's scale vector, stale 12-DoF offsets included."""
    jenv, tenv, _ = episode
    v = tenv._noise_scale_vec()
    np.testing.assert_allclose(v.numpy(), np.asarray(jenv._noise_scale_vec()),
                               rtol=0, atol=0)
    assert float(v[36:].abs().max()) == 0.0


def test_reward_names_and_order():
    from nightmare_rl_tpu.envs.nightmare_v3 import REWARD_NAMES

    assert tenv_mod.REWARD_NAMES == REWARD_NAMES


def test_port_reset_and_commands():
    env = tenv_mod.NightmareV3Env(NightmareV3Cfg().replace(
        env=EnvCfg(num_envs=8)), dtype=torch.float64, device="cpu")
    state, obs = env.reset(3)
    assert obs.shape == (8, 66) and torch.isfinite(obs).all()
    c = state.commands
    assert float(c[:, 1].abs().max()) == 0.0
    assert float(c[:, 0].abs().max()) <= 0.5 and float(c[:, 2].abs().max()) <= 0.8
    state2, obs2 = env.reset(3)
    assert torch.equal(obs, obs2)  # a seed fixes the draw


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from nightmare_rl_tpu_torch.physics import loader
    from nightmare_rl_tpu_torch.tools import train

    from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv

    cfg = NightmareV3Cfg().replace(env=EnvCfg(num_envs=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        tenv_mod.NightmareV3Env(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        AnymalCEnv(AnymalCCfg(num_envs=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        loader.load_system("nightmare_v3")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["-e", "2", "-n", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--robot", "anymal_c", "-e", "2", "-n", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--mesh", "-e", "2", "-n", "1"])
    from nightmare_rl_tpu_torch.core.config import PPOCfg
    from nightmare_rl_tpu_torch.rl.external import ExternalPPO

    with pytest.raises(RuntimeError, match="CUDA"):
        ExternalPPO(66, 18, 2, PPOCfg())
    from nightmare_rl_tpu_torch.tools import custom_play, play, simple_test

    for main, argv in ((play.main, ["--steps", "1"]),
                       (play.main, ["--grid", "--steps", "1"]),
                       (custom_play.main, ["--steps", "1"]),
                       (simple_test.main, ["-e", "2", "-s", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)


def test_train_refuses_unported_robot(tmp_path):
    """A robot the port does not have is refused; anymal_c, ported now,
    trains: the CLI at a tiny size on the CPU, one PPO iteration of 4 envs
    over 2-step rollouts, ends with a finite loss and a checkpoint."""
    from nightmare_rl_tpu_torch.core.config import PPOCfg, RunnerCfg
    from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCEnv
    from nightmare_rl_tpu_torch.tools import train

    with pytest.raises(SystemExit):
        train.main(["--robot", "cassie", "--device", "cpu"])
    runner = train.main(["--robot", "anymal_c", "-e", "4", "-n", "1",
                         "--device", "cpu", "--log_root", str(tmp_path)],
                        pcfg=PPOCfg(runner=RunnerCfg(num_steps_per_env=2)))
    assert isinstance(runner.env, AnymalCEnv)
    assert runner.env.num_obs == 48 and runner.env.num_actions == 12
    assert np.isfinite(runner.last_stats["loss"])
    assert torch.isfinite(runner.ppo.obs).all()
    assert any(f.startswith("model_") for _, _, fs in os.walk(tmp_path)
               for f in fs)


def test_import_hygiene():
    """Importing every module of the port (the captured step,
    utils/graph.py, among them) and chip_smoke.py pulls in neither JAX,
    flax, optax nor the JAX package, and none of the host-side
    viewer and plotting packages (mujoco, pynput, matplotlib), which stay
    inside the functions that use them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import nightmare_rl_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "assert len(mods) > 20, mods\n"
        "assert 'nightmare_rl_tpu_torch.utils.graph' in mods, mods\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'nightmare_rl_tpu', 'mujoco', "
        "'pynput', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
