"""Training-time recording in the port (mirrors tests/test_recorder.py and
tests/test_native.py on nightmare_rl_tpu_torch): a training run writes env
0's episodes as pkl files that tools/replay.py loads, the recorded frames
are the env's own post-step pre-reset states, and the port's own copy of the
native mmap ring log builds and round-trips."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from nightmare_rl_tpu_torch.core.config import (
    EnvCfg, NightmareV3Cfg, PPOCfg, RunnerCfg,
)
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.rl.ppo import PPO
from nightmare_rl_tpu_torch.rl.runner import JsonlWriter, OnPolicyRunner
from nightmare_rl_tpu_torch.tools.replay import load_any, save_npz
from nightmare_rl_tpu_torch.utils.binlog import TrajectoryLog


def _short_env(n=4):
    # ~13 control steps per episode, so env 0 finishes episodes quickly
    return NightmareV3Env(NightmareV3Cfg().replace(
        env=EnvCfg(num_envs=n, episode_length_s=0.2)), device="cpu")


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """One short training run whose env 0 finishes several episodes."""
    log_dir = str(tmp_path_factory.mktemp("recdir"))
    env = _short_env()
    pcfg = PPOCfg().replace(runner=RunnerCfg(num_steps_per_env=20))
    runner = OnPolicyRunner(env, pcfg, log_dir=log_dir)
    runner.init(0)
    runner.learn(2)
    return log_dir, env, runner


def test_recording_enabled_by_default(run_dir):
    log_dir, _, runner = run_dir
    pkls = [f for f in os.listdir(log_dir) if f.endswith(".pkl")]
    # 2 iterations x 20 steps / ~13-step episodes => >= 2 finished episodes
    assert len(pkls) >= 2, f"expected episode pkls in {log_dir}, got {pkls}"
    assert runner.recorder.frames == 2 * 20
    assert sorted(runner.recorder.files_written) == sorted(
        os.path.join(log_dir, f) for f in pkls)


def test_recording_format_matches_reference(run_dir):
    log_dir, env, _ = run_dir
    pkls = sorted(f for f in os.listdir(log_dir) if f.endswith(".pkl"))
    with open(os.path.join(log_dir, pkls[0]), "rb") as f:
        traj = pickle.load(f)
    nq = env.sys.qpos0.shape[0]
    t_prev = -1.0
    for (t, qpos, qvel, act) in traj:
        assert qpos.shape == (nq,)
        assert qvel.shape == (nq - 1,)  # free joint: 7 pos / 6 vel
        assert act.shape == (env.num_actions,)
        assert t > t_prev
        t_prev = t
    # the terminal state is included (reference :261-274)
    assert len(traj) <= env.max_episode_length + 1


def test_replay_tool_loads_recordings(run_dir):
    log_dir, _, _ = run_dir
    from nightmare_rl_tpu_torch.tools import replay

    seen = replay.main(["--dir", log_dir, "--no-view"])
    assert len(seen) >= 2 and all(n > 0 for _, n in seen)
    traj = load_any(seen[-1][0])
    assert np.isfinite(traj[-1][1]).all()


def test_recorded_frames_are_pre_reset_states():
    """stats['record'] holds, per step, env 0's post-step state before the
    reset (equal to the env's record_qpos/qvel), the action, the done flag
    and the command."""
    env = _short_env(2)
    cfg = PPOCfg().replace(runner=RunnerCfg(num_steps_per_env=16))
    ppo = PPO(env, cfg, record_states=True)
    ppo.init(0)
    seen = []
    step = env.step

    def spy(state, action):
        out = step(state, action)
        seen.append((out.record_qpos[0].clone(), out.record_qvel[0].clone(),
                     action[0].clone(), bool(out.done[0]),
                     out.state.commands[0].clone(),
                     out.state.phys.qpos[0].clone()))
        return out

    env.step = spy
    stats = ppo.learn_step()
    qpos, qvel, act, done, cmd = stats["record"]
    assert qpos.shape == (16, 25) and done.dtype == bool
    assert done.any(), "env 0 should finish a ~13-step episode"
    for k, (q, v, a, d, c, q_after) in enumerate(seen):
        np.testing.assert_array_equal(qpos[k], q.numpy())
        np.testing.assert_array_equal(qvel[k], v.numpy())
        np.testing.assert_array_equal(act[k], a.numpy())
        np.testing.assert_array_equal(cmd[k], c.numpy())
        assert done[k] == d
        # on a reset step the frame is the terminal state, not the reset one
        assert torch.equal(q, q_after) != d


def test_metrics_hold_each_iterations_times_and_captures(run_dir):
    """metrics.jsonl has learn_step's rollout and update seconds and the
    graphs captured in each iteration (the rollout step and the learning
    half's five parts in the first)."""
    log_dir, _, _ = run_dir
    with open(os.path.join(log_dir, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    perf = {(r["tag"], r["step"]): r["value"] for r in rows
            if r["tag"].startswith("perf/")}
    for step in (1, 2):
        assert perf[("perf/rollout_s", step)] > 0
        assert perf[("perf/update_s", step)] > 0
    assert perf[("perf/graph_captures", 1)] == 6
    assert perf[("perf/graph_captures", 2)] == 0


def test_jsonl_metrics(tmp_path):
    w = JsonlWriter(str(tmp_path))
    w.add_scalar("train/loss", 1.5, 3)
    w.flush()
    with open(tmp_path / "metrics.jsonl") as f:
        assert json.loads(f.readline()) == {"tag": "train/loss", "value": 1.5,
                                            "step": 3}


def test_npz_trajectory_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    traj = [(0.016 * (k + 1), rng.normal(size=25), rng.normal(size=24),
             rng.normal(size=18)) for k in range(7)]
    path = str(tmp_path / "traj.npz")
    save_npz(path, traj)
    back = load_any(path)
    assert len(back) == 7
    for (t0, q0, v0, a0), (t1, q1, v1, a1) in zip(traj, back):
        assert abs(t0 - t1) < 1e-12
        np.testing.assert_array_equal(q0, q1)
        np.testing.assert_array_equal(v0, v1)
        np.testing.assert_array_equal(a0, a1)


# ---- the native ring log (mirrors tests/test_native.py) ----


def test_ring_roundtrip(tmp_path):
    log = TrajectoryLog(str(tmp_path / "a.ring"), nq=25, nv=24, capacity=128)
    rng = np.random.default_rng(0)
    qs, vs = rng.normal(size=(50, 25)), rng.normal(size=(50, 24))
    for k in range(50):
        log.append(k * 0.016, qs[k], vs[k])
    t, q, v = log.read()
    assert log.frames_written == 50
    np.testing.assert_allclose(t, np.arange(50) * 0.016, rtol=1e-6)
    np.testing.assert_allclose(q, qs.astype(np.float32))
    np.testing.assert_allclose(v, vs.astype(np.float32))
    # the replay tool reads ring files too
    back = load_any(str(tmp_path / "a.ring"))
    assert len(back) == 50 and back[3][1].shape == (25,)


def test_ring_wraparound(tmp_path):
    log = TrajectoryLog(str(tmp_path / "b.ring"), nq=2, nv=1, capacity=8)
    for k in range(20):
        log.append(float(k), np.array([k, k]), np.array([k]))
    t, q, v = log.read()
    assert log.frames_written == 20
    assert len(t) == 8                       # ring retains the last 8
    np.testing.assert_allclose(t, np.arange(12, 20, dtype=np.float32))


def test_ring_reopen(tmp_path):
    path = str(tmp_path / "c.ring")
    log = TrajectoryLog(path, nq=3, nv=3, capacity=16)
    log.append(1.0, np.ones(3), np.zeros(3))
    log.flush()
    del log
    log2 = TrajectoryLog(path, nq=3, nv=3, capacity=16)
    t, q, v = log2.read()
    assert log2.frames_written == 1
    assert t[0] == 1.0


def test_ring_frame_size_mismatch_and_build_location(tmp_path):
    from nightmare_rl_tpu_torch import native

    rl = native.get_ringlog()
    ring = rl.RingLog(str(tmp_path / "d.ring"), frame_size=16, capacity=4)
    with pytest.raises(ValueError):
        ring.append(b"short")
    # built into the port's own _build/, never into the JAX package's tree
    assert os.path.dirname(rl.__file__) == native.BUILD_DIR
    assert rl.__name__ == "nightmare_rl_tpu_torch.native._ringlog"


def test_viewer_disables_itself_and_profile_hook_writes_a_trace(tmp_path,
                                                                capsys):
    """render=True without an MJCF path (or mujoco, or a display) prints a
    message and trains on; profile_dir gets a torch.profiler chrome trace
    of iterations 2-4 (here the run ends inside the window, at 3), which
    holds the port's spans, and those spans and counters beside it
    (``spans.json``, aligned to the trace's clock)."""
    import dataclasses

    env = _short_env(2)
    env.cfg = env.cfg.replace(viewer=dataclasses.replace(env.cfg.viewer,
                                                         render=True))
    cfg = PPOCfg().replace(runner=RunnerCfg(num_steps_per_env=2))
    runner = OnPolicyRunner(env, cfg)
    assert runner.recorder is None and runner.ppo.record_states
    runner.learn(3, profile_dir=str(tmp_path / "prof"))
    out = capsys.readouterr().out
    assert out.count("viewer unavailable, disabling render") == 1
    assert runner.viewer._dead and runner.ppo.iteration == 3
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    with open(tmp_path / "prof" / "trace.json") as fh:
        marks = [e["name"] for e in json.load(fh)["traceEvents"]
                 if e.get("cat") == "user_annotation"
                 and e["name"].startswith("ppo.")]
    with open(tmp_path / "prof" / "spans.json") as fh:
        spans = json.load(fh)
    names = [s["name"] for s in spans["spans"]]
    assert names == ["ppo.iteration", "ppo.rollout", "ppo.record",
                     "ppo.learn", "ppo.stats"]
    assert sorted(marks) == sorted(names)
    assert spans["counters"] == {"host.syncs": 4}
    assert all(s["iteration"] == 0 for s in spans["spans"])
    assert isinstance(spans["offset_ns"], int)
    assert not any(e for e in os.listdir(tmp_path / "prof")
                   if e not in ("trace.json", "spans.json"))
