"""On-policy training runner: the rsl_rl OnPolicyRunner equivalent (port of
``nightmare_rl_tpu/rl/runner.py`` without the viewer, the trajectory
recorder and the profiler hook).

Metric logging to ``metrics.jsonl``, periodic checkpoints in rsl_rl's
``model_<iter>.pt`` format (``model_state_dict``, ``optimizer_state_dict``,
``iter``, ``infos``), latest-run/latest-checkpoint resume resolution, and a
final save when SIGTERM/SIGINT arrives.
"""

from __future__ import annotations

import json
import math
import os
import signal
import time
from typing import Optional

import torch

from nightmare_rl_tpu_torch.core.config import PPOCfg
from nightmare_rl_tpu_torch.rl.ppo import PPO


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


class OnPolicyRunner:
    def __init__(self, env, cfg: PPOCfg, log_dir: Optional[str] = None):
        self.env = env
        self.cfg = cfg
        self.log_dir = log_dir
        self.ppo = PPO(env, cfg)
        self.writer: Optional[JsonlWriter] = None
        self.last_stats: Optional[dict] = None

    def init(self, seed: Optional[int] = None) -> None:
        self.ppo.init(seed)

    def save(self, it: int) -> None:
        if self.log_dir is None:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        torch.save({
            "model_state_dict": self.ppo.net.state_dict(),
            "optimizer_state_dict": self.ppo.optimizer.state_dict(),
            "iter": it,
            "infos": None,
        }, os.path.join(self.log_dir, f"model_{it}.pt"))

    def load(self, path: str) -> None:
        blob = torch.load(path, map_location=self.env.device, weights_only=True)
        self.ppo.net.load_state_dict(blob["model_state_dict"])
        if "optimizer_state_dict" in blob:
            self.ppo.optimizer.load_state_dict(blob["optimizer_state_dict"])
            self.ppo.lr = self.ppo.optimizer.param_groups[0]["lr"]
        self.ppo.iteration = int(blob.get("iter", 0))

    def learn(self, num_learning_iterations: int,
              init_at_random_ep_len: bool = False) -> None:
        # checkpoint-on-signal: a preempted run saves model_<iter> and exits
        stop = {"flag": False}

        def _on_signal(signum, frame):
            stop["flag"] = True

        prev_handlers = {s: signal.signal(s, _on_signal)
                         for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            self._learn(num_learning_iterations, init_at_random_ep_len, stop)
        finally:
            for s, h in prev_handlers.items():
                signal.signal(s, h)
            if self.writer is not None:
                self.writer.close()
                self.writer = None

    def _learn(self, num_iters: int, init_at_random_ep_len: bool,
               stop: dict) -> None:
        if self.ppo.env_state is None:
            self.init()
        if init_at_random_ep_len:
            self.ppo.randomize_episode_lengths()
        if self.log_dir is not None and self.writer is None:
            self.writer = JsonlWriter(self.log_dir)
        steps_per_iter = self.cfg.runner.num_steps_per_env * self.env.num_envs
        t_start = time.time()
        iters_run = 0
        for k in range(num_iters):
            iters_run = k + 1
            t0 = time.time()
            stats = self.ppo.learn_step()
            dt_iter = time.time() - t0
            it = self.ppo.iteration
            self.last_stats = stats
            if not math.isfinite(stats["loss"]):
                # never checkpoint a diverged state
                raise FloatingPointError(
                    f"iter {it}: loss is {stats['loss']} — training diverged; "
                    "resume from the last good checkpoint")
            if self.writer is not None:
                for key in ("loss", "surrogate_loss", "value_loss", "kl", "lr",
                            "mean_reward", "mean_noise_std"):
                    self.writer.add_scalar(f"train/{key}", stats[key], it)
                for name, val in zip(self.env.active_rewards,
                                     stats["episode_reward_means"]):
                    self.writer.add_scalar(f"episode/rew_{name}", val, it)
                self.writer.add_scalar("perf/env_steps_per_s",
                                       steps_per_iter / dt_iter, it)
                self.writer.flush()
            if it % 10 == 0 or k == 0:
                print(f"iter {it}: reward {stats['mean_reward']:+.4f} "
                      f"loss {stats['loss']:.4f} kl {stats['kl']:.4f} "
                      f"lr {stats['lr']:.2e} "
                      f"({steps_per_iter / dt_iter:,.0f} env-steps/s)")
            if self.log_dir and it % self.cfg.runner.save_interval == 0:
                self.save(it)
            if stop["flag"]:
                print(f"signal received — checkpointing at iter {it} and exiting")
                break
        if self.log_dir:
            self.save(self.ppo.iteration)
        total = iters_run * steps_per_iter
        wall = time.time() - t_start
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
