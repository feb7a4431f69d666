"""Binary trajectory logging over the native mmap ring buffer (the port's
copy of ``nightmare_rl_tpu/utils/binlog.py``).

Streaming replacement for the reference's pickle recorder
(envs/nightmare_v3_env.py:261-272): frames are fixed-size float32 records
``[t | qpos | qvel]`` appended in O(1) into a crash-safe mmap ring.
"""

from __future__ import annotations

import numpy as np

from nightmare_rl_tpu_torch.native import get_ringlog


class TrajectoryLog:
    def __init__(self, path: str, nq: int, nv: int, capacity: int = 1 << 16):
        self.nq, self.nv = nq, nv
        self._width = 1 + nq + nv
        rl = get_ringlog()
        self.ring = rl.RingLog(
            path, frame_size=self._width * 4, capacity=capacity
        )

    def append(self, t: float, qpos, qvel) -> None:
        frame = np.empty(self._width, dtype=np.float32)
        frame[0] = t
        frame[1 : 1 + self.nq] = qpos
        frame[1 + self.nq :] = qvel
        self.ring.append(frame.tobytes())

    def read(self):
        """Return (t, qpos, qvel) arrays, oldest first."""
        raw = np.frombuffer(self.ring.read_all(), dtype=np.float32)
        n = raw.size // self._width
        raw = raw.reshape(n, self._width)
        return raw[:, 0], raw[:, 1 : 1 + self.nq], raw[:, 1 + self.nq :]

    def flush(self) -> None:
        self.ring.flush()

    @property
    def frames_written(self) -> int:
        return int(self.ring.head)
