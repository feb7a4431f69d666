"""Trajectory recording: pickle archives of env 0's episodes (the port's
copy of ``nightmare_rl_tpu/utils/recorder.py``).

Equivalent of the reference's training-time episode recorder, which appends
env 0's ``(time, qpos, qvel, act)`` each control step and pickles the list
when env 0 resets (nightmare_rl envs/nightmare_v3_env.py:261-272), replayed
by ``open_custom_play.py``.  Same on-disk format (a pickled list of tuples)
and file names as the JAX package's recorder.

The PPO rollout keeps env 0's pre-reset ``(qpos, qvel, action, done)`` rows
on the device and copies them to the host once per iteration
(``stats["record"]``); the runner hands those (T, ·) arrays to
:meth:`StateRecorder.add_steps`.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import List, Tuple

import numpy as np


class StateRecorder:
    def __init__(self, log_dir: str, dt: float):
        self.log_dir = log_dir
        self.dt = dt
        self._states: List[Tuple[float, np.ndarray, np.ndarray, np.ndarray]] = []
        self._t = 0.0        # sim-time clock; monotonic across episodes,
        self._seq = 0        # like the reference's data.time (never reset)
        self.frames = 0      # frames received in all
        self.files_written: List[str] = []

    def add_steps(self, qpos, qvel, act, done) -> None:
        """Append a rollout window of env-0 states; flush a pkl per episode.

        qpos (T, nq), qvel (T, nv), act (T, nu), done (T,) — the recorded
        state is post-step pre-reset, so each episode's file ends on its
        terminal state exactly like the reference (:261-274)."""
        qpos = np.asarray(qpos)
        qvel = np.asarray(qvel)
        act = np.asarray(act)
        done = np.asarray(done)
        for k in range(qpos.shape[0]):
            self._t += self.dt
            self._states.append((self._t, qpos[k].copy(), qvel[k].copy(),
                                 act[k].copy()))
            self.frames += 1
            if done[k]:
                self.flush()

    def flush(self) -> None:
        if not self._states:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        # unix-time names like the reference, sequence-suffixed so multiple
        # episodes finishing within one second don't clobber each other
        path = os.path.join(
            self.log_dir, f"{int(time.time())}_{self._seq:05d}.pkl"
        )
        self._seq += 1
        with open(path, "wb") as f:
            pickle.dump(self._states, f)
        self.files_written.append(path)
        self._states = []


def load_recording(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)
