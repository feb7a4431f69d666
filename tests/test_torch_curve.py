"""The port's ``tools/compare_reference_curve.py`` (``--side tpu``: the
port's env on the CPU here) at 8 envs × 1 iteration writes metric rows with
the JAX tool's keys (those of its committed run,
logs/curvecmp/tpu_s1/metrics.jsonl), the episode terms included, and its
two seeds start from different networks.  ``tools/curve_windows.py`` reads
the rows back beside the committed JAX runs."""

import json
import os

import numpy as np
import pytest
import torch

from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.tools import compare_reference_curve as crc
from nightmare_rl_tpu_torch.tools import curve_windows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RUN = os.path.join(REPO, "logs", "curvecmp", "tpu_s1", "metrics.jsonl")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests step a few envs, and the suite's
    workers share the machine's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_rows():
    with open(JAX_RUN) as fh:
        return [json.loads(ln) for ln in fh]


def test_step_reports_the_jax_tools_episode_terms(monkeypatch):
    """Envs reset at the end of their episode, and the step reports the
    per-term means under the JAX tool's ``rew_*`` keys."""
    reset = NightmareV3Env.reset

    def reset_at_time_out(self, seed):
        state, obs = reset(self, seed)
        state.episode_length = torch.full_like(state.episode_length,
                                               self.max_episode_length)
        return state, obs

    monkeypatch.setattr(NightmareV3Env, "reset", reset_at_time_out)
    env, obs0, step = crc.make_tpu_env(8, "cpu")
    assert obs0.shape == (8, env.num_obs) and isinstance(obs0, np.ndarray)
    obs, rew, done, time_out, (n_reset, ep) = step(np.zeros((8, 18), np.float32))
    assert n_reset == 8 and done.all() and time_out.all()
    assert obs.shape == (8, env.num_obs) and rew.shape == (8,)
    jax_ep = {k for r in _jax_rows() for k in r if k.startswith("rew_")}
    assert set(ep) == jax_ep
    assert all(np.isfinite(v) for v in ep.values())


def test_tool_writes_the_jax_tools_rows(tmp_path):
    rows = {}
    for seed in (1, 2):
        out = tmp_path / f"torch_s{seed}"
        path = crc.main(["--side", "tpu", "--envs", "8", "--iters", "1",
                         "--seed", str(seed), "--device", "cpu",
                         "--out", str(out)])
        with open(path) as fh:
            rows[seed] = [json.loads(ln) for ln in fh]
    base = {k for k in _jax_rows()[1]}         # a row without episode terms
    for seed, rs in rows.items():
        assert len(rs) == 1 and rs[0]["iter"] == 1
        assert base <= set(rs[0]) <= set(_jax_rows()[0])
        assert all(np.isfinite(v) for v in rs[0].values())
    assert rows[1][0]["loss"] != rows[2][0]["loss"]  # seeded networks differ

    # the window tool reads the port's rows beside the JAX runs (cut to one
    # iteration here)
    for name in ("tpu_s1", "tpu_s2"):
        os.makedirs(tmp_path / name)
        with open(os.path.join(REPO, "logs", "curvecmp", name,
                               "metrics.jsonl")) as src, \
                open(tmp_path / name / "metrics.jsonl", "w") as dst:
            dst.write(src.readline())
    verdict = curve_windows.main(["--root", str(tmp_path),
                                  "--metrics", "mean_reward,kl"])
    assert set(verdict) == {"mean_reward", "kl"}
