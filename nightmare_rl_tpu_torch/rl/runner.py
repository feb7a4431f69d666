"""On-policy training runner: the rsl_rl OnPolicyRunner equivalent (port of
``nightmare_rl_tpu/rl/runner.py``).

Metric logging to ``metrics.jsonl``, periodic checkpoints in rsl_rl's
``model_<iter>.pt`` format plus the full train state (utils/checkpoint.py),
latest-run/latest-checkpoint resume resolution, a final save when
SIGTERM/SIGINT arrives, training-time recording of env 0's episodes as
``.pkl`` files (``cfg.viewer.record_states``, on by default, as in the
reference), render-during-training (``cfg.viewer.render``) and an optional
``torch.profiler`` trace of iterations 2-4 (``trace.json``), with the
port's tracing on (``utils/trace.py``) so that the trace holds its spans,
and those spans and counters beside it (``spans.json``).

With a ``mesh`` (``parallel/mesh.py``) the runner drives ``ShardedPPO``:
every rank runs it, the statistics are global, and rank 0 alone prints,
writes ``metrics.jsonl`` and writes checkpoints (every rank takes part in
gathering the env state for them).  Recording and render are off under a
mesh, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import signal
import time
from typing import Optional

from nightmare_rl_tpu_torch.core.config import PPOCfg
from nightmare_rl_tpu_torch.rl.ppo import PPO
from nightmare_rl_tpu_torch.utils import checkpoint, trace
from nightmare_rl_tpu_torch.utils.recorder import StateRecorder


class JsonlWriter:
    """Metrics sink: one JSON object per add_scalar, appended to
    <log_dir>/metrics.jsonl."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": value, "step": step}))
        self._f.write("\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TrainingViewer:
    """Render-during-training (reference cfg.viewer.render syncs a viewer
    every env step, envs/nightmare_v3_env.py:373-390): env 0's frames from
    each rollout window are injected into a passive mujoco.viewer with the
    commanded-velocity arrow drawn.  Disables itself, with a message, where
    there is no MJCF path, no mujoco or no display."""

    def __init__(self, xml: Optional[str]):
        self._viewer = None
        self._dead = False
        self._xml = xml

    def show(self, qpos, cmd) -> None:
        if self._dead:
            return
        try:
            if self._xml is None:
                raise RuntimeError("no MJCF path (cfg.viewer.xml_path)")
            import mujoco as mj

            if self._viewer is None:
                import mujoco.viewer as mjv

                self._m = mj.MjModel.from_xml_path(self._xml)
                self._d = mj.MjData(self._m)
                self._viewer = mjv.launch_passive(self._m, self._d)
            from nightmare_rl_tpu_torch.tools.play import draw_command_arrow

            for k in range(qpos.shape[0]):
                if not self._viewer.is_running():
                    self._dead = True
                    return
                self._d.qpos[:] = qpos[k]
                mj.mj_forward(self._m, self._d)
                draw_command_arrow(self._viewer, self._d.qpos, cmd[k])
                self._viewer.cam.lookat = self._d.qpos[:3]
                self._viewer.sync()
        except Exception as e:
            print(f"viewer unavailable, disabling render: {e}")
            self._dead = True


class OnPolicyRunner:
    def __init__(self, env, cfg: PPOCfg, log_dir: Optional[str] = None,
                 mesh=None):
        self.env = env
        self.cfg = cfg
        self.log_dir = log_dir
        # training-time trajectory recording (the reference records env 0 by
        # default, cfg.viewer.record_states / envs/nightmare_v3_env.py:261-272)
        # and render-during-training; both consume the same env-0 stream
        viewer_cfg = getattr(env.cfg, "viewer", None)
        record = log_dir is not None and getattr(viewer_cfg, "record_states",
                                                 False)
        render = getattr(viewer_cfg, "render", False)
        if mesh is not None:
            from nightmare_rl_tpu_torch.parallel.mesh import ShardedPPO

            self.ppo = ShardedPPO(env, cfg, mesh)
            record = render = False
        else:
            self.ppo = PPO(env, cfg, record_states=record or render)
        self.main = self.ppo.shard.rank == 0  # prints and writes
        self.recorder = StateRecorder(log_dir, dt=env.dt) if record else None
        self.viewer = (TrainingViewer(getattr(viewer_cfg, "xml_path", None))
                       if render else None)
        self.writer: Optional[JsonlWriter] = None
        self.last_stats: Optional[dict] = None

    def init(self, seed: Optional[int] = None) -> None:
        self.ppo.init(seed)

    def save(self, it: int) -> None:
        if self.log_dir is None:
            return
        checkpoint.save(os.path.join(self.log_dir, f"model_{it}.pt"), self.ppo)

    def load(self, path: str) -> bool:
        """Restore a checkpoint; returns whether it held the full train
        state (see utils/checkpoint.py)."""
        return checkpoint.load(path, self.ppo)

    def learn(self, num_learning_iterations: int,
              init_at_random_ep_len: bool = False,
              profile_dir: Optional[str] = None) -> None:
        """``profile_dir``: write a torch.profiler chrome trace of iterations
        2-4 there (the counterpart of the JAX package's jax.profiler hook),
        ``trace.json``, and the port's spans and counters of the same
        iterations, ``spans.json`` (``utils/trace.py``: its stamps aligned
        to the trace's clock)."""
        # checkpoint-on-signal: a preempted run saves model_<iter> and exits
        stop = {"flag": False}

        def _on_signal(signum, frame):
            stop["flag"] = True

        prev_handlers = {s: signal.signal(s, _on_signal)
                         for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            self._learn(num_learning_iterations, init_at_random_ep_len, stop,
                        profile_dir)
        finally:
            for s, h in prev_handlers.items():
                signal.signal(s, h)
            if self.writer is not None:
                self.writer.close()
                self.writer = None

    def _start_profiler(self):
        """The profiler started with the port's tracing on: (the stack that
        stops both, the profiler, the recording)."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.env.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        stack = contextlib.ExitStack()
        rec = stack.enter_context(trace.recording())
        prof = stack.enter_context(profile(activities=acts))
        return stack, prof, rec

    def _stop_profiler(self, profiling, profile_dir: str) -> None:
        stack, prof, rec = profiling
        stack.close()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            rec.align(json.load(fh))
        rec.write(os.path.join(profile_dir, "spans.json"))
        print(f"profiler trace written to {path}, spans beside it")

    def _learn(self, num_iters: int, init_at_random_ep_len: bool,
               stop: dict, profile_dir: Optional[str]) -> None:
        if self.ppo.env_state is None:
            self.init()
        if init_at_random_ep_len:
            self.ppo.randomize_episode_lengths()
        if self.log_dir is not None and self.writer is None and self.main:
            self.writer = JsonlWriter(self.log_dir)
        steps_per_iter = (self.cfg.runner.num_steps_per_env * self.env.num_envs
                          * self.ppo.shard.world)
        t_start = time.time()
        iters_run = 0
        prof = None
        for k in range(num_iters):
            iters_run = k + 1
            if profile_dir and k == 2 and self.main:  # skip the warm-up
                prof = self._start_profiler()
            t0 = time.time()
            stats = self.ppo.learn_step()
            it = self.ppo.iteration
            self.last_stats = stats
            if not math.isfinite(stats["loss"]):
                # never checkpoint a diverged state
                raise FloatingPointError(
                    f"iter {it}: loss is {stats['loss']} — training diverged; "
                    "resume from the last good checkpoint")
            if "record" in stats:
                qp, qv, act, done, cmd = stats["record"]
                if self.recorder is not None:
                    self.recorder.add_steps(qp, qv, act, done)
                if self.viewer is not None:
                    self.viewer.show(qp, cmd)
            dt_iter = time.time() - t0
            if prof is not None and k == 4:
                self._stop_profiler(prof, profile_dir)
                prof = None
            if self.writer is not None:
                for key in ("loss", "surrogate_loss", "value_loss", "kl", "lr",
                            "mean_reward", "mean_noise_std"):
                    self.writer.add_scalar(f"train/{key}", stats[key], it)
                for name, val in zip(self.env.active_rewards,
                                     stats["episode_reward_means"]):
                    self.writer.add_scalar(f"episode/rew_{name}", val, it)
                self.writer.add_scalar("perf/env_steps_per_s",
                                       steps_per_iter / dt_iter, it)
                for key in ("rollout_s", "update_s", "graph_captures"):
                    self.writer.add_scalar(f"perf/{key}", stats[key], it)
                self.writer.flush()
            if (it % 10 == 0 or k == 0) and self.main:
                print(f"iter {it}: reward {stats['mean_reward']:+.4f} "
                      f"loss {stats['loss']:.4f} kl {stats['kl']:.4f} "
                      f"lr {stats['lr']:.2e} "
                      f"({steps_per_iter / dt_iter:,.0f} env-steps/s)")
            if self.log_dir and it % self.cfg.runner.save_interval == 0:
                self.save(it)
            # under a mesh every rank stops when any rank got the signal
            if self.ppo.any_rank(stop["flag"]):
                if self.main:
                    print(f"signal received — checkpointing at iter {it} and "
                          "exiting")
                break
        if prof is not None:  # the run ended inside the traced window
            self._stop_profiler(prof, profile_dir)
        if self.log_dir:
            self.save(self.ppo.iteration)
        total = iters_run * steps_per_iter
        wall = time.time() - t_start
        if self.main:
            print(f"total: {total:,} env-steps in {wall:.1f}s "
                  f"({total / max(wall, 1e-9):,.0f} env-steps/s)")


def get_load_path(root: str, load_run=-1, checkpoint=-1) -> str:
    """Latest-run / latest-checkpoint resolution (envs/helpers.py:20-42)."""
    runs = sorted(os.listdir(root))
    if "exported" in runs:
        runs.remove("exported")
    if not runs:
        raise ValueError("No runs in this directory: " + root)
    if load_run == -1:
        # newest run that actually contains a checkpoint
        candidates = [
            os.path.join(root, r) for r in reversed(runs)
            if os.path.isdir(os.path.join(root, r))
            and any("model" in f for f in os.listdir(os.path.join(root, r)))
        ]
        if not candidates:
            raise ValueError("No checkpoints under: " + root)
        load_run = candidates[0]
    else:
        load_run = os.path.join(root, load_run)
    if checkpoint == -1:
        models = [f for f in os.listdir(load_run) if "model" in f]
        models.sort(key=lambda m: "{0:0>15}".format(m))
        model = models[-1]
    else:
        model = f"model_{checkpoint}.pt"
    return os.path.join(load_run, model)
