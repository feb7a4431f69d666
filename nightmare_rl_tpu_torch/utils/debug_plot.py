"""Non-blocking live debug plots for gait-engine development (port of
``nightmare_rl_tpu/utils/debug_plot.py``).

Equivalent of the reference's debug helper (``nikengine/modules/debug.py``):
a persistent figure that is redrawn in place without blocking the control
loop — a curve + marker view (used there for the walk-state keep-out cost
line search) and a 2-D scatter of leg poses.  Headless-safe: with no display
it falls back to the Agg backend and ``save()`` writes PNGs instead.

Lazy-imports matplotlib so the training path never pays for it.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

_COLORS = (
    "red", "green", "blue", "yellow", "orange", "purple",
    "black", "pink", "brown", "gray", "cyan",
)


class DebugPlot:
    def __init__(self, interactive: Optional[bool] = None):
        import matplotlib

        if interactive is None:
            # a display alone isn't enough: MPLBACKEND=Agg (or an already-
            # selected non-GUI backend) means plt.pause would just sleep
            forced = os.environ.get("MPLBACKEND", "")
            interactive = (
                bool(os.environ.get("DISPLAY"))
                and forced.lower() not in ("agg", "pdf", "svg", "ps", "template")
            )
        if not interactive:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        # if another import already pinned a non-interactive backend, don't
        # pretend to be live
        if interactive and matplotlib.get_backend().lower() in (
            "agg", "pdf", "svg", "ps", "template"
        ):
            interactive = False
        self._plt = plt
        self._interactive = interactive
        self.fig, self.ax = plt.subplots()
        self._artists: list = []

    def _clear(self) -> None:
        for ln in self._artists:
            ln.remove()
        self._artists = []

    def _flush(self) -> None:
        if self._interactive:
            self.fig.canvas.draw()
            self._plt.pause(1e-6)

    def plot(self, x, y, markers: Sequence = (), xlabel: str = "x",
             ylabel: str = "y", title: str = "plot") -> None:
        """Line plot of (x, y) with highlighted (x, y) marker points, redrawn
        in place (nikengine/modules/debug.py:11-25)."""
        self._clear()
        self._artists.append(self.ax.plot(x, y, color="blue")[0])
        for mx, my in markers:
            self._artists.append(self.ax.plot(mx, my, "o", color="red")[0])
        self.ax.set_xlabel(xlabel)
        self.ax.set_ylabel(ylabel)
        self.ax.set_title(title)
        self._flush()

    def plot_poses_2d(self, poses: Sequence) -> None:
        """Top-down scatter of engine Pose leg positions, one color per pose
        (nikengine/modules/debug.py:28-39).  Accepts anything with a
        ``body_pos``-like (n_legs, 3) array or tensor (engine/gait.py poses,
        on any device)."""
        self._clear()
        for i, pose in enumerate(poses):
            pts = getattr(pose, "body_pos", pose)
            if isinstance(pts, torch.Tensor):
                pts = pts.detach().cpu().numpy()
            for vec in pts:
                self._artists.append(
                    self.ax.plot(
                        vec[0], vec[1], "o", color=_COLORS[i % len(_COLORS)]
                    )[0]
                )
        self._flush()

    def save(self, path: str) -> None:
        self.fig.savefig(path)
