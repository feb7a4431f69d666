"""Hopf-oscillator central pattern generator (CPG) bank (port of
``nightmare_rl_tpu/envs/cpg.py``), as plain tensor functions.

The reference carries a vestigial CPG pathway: a modified Hopf oscillator
(``envs/nightmare_v3_env.py:18-21``) plus a phase-coupling rotation
(``:23-24``), with its per-env integration and action-driven frequencies
commented out of the hot loop (``:157-176``).  Every function here works on
any leading batch shape.

The modified Hopf dynamics converge to a stable limit cycle of radius mu at
angular rate w:

    dx = alpha * (mu^2 - x^2 - y^2) * x - w * y
    dy = beta  * (mu^2 - x^2 - y^2) * y + w * x
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class CPGState(NamedTuple):
    x: torch.Tensor  # (..., n_osc)
    y: torch.Tensor  # (..., n_osc)


def init(n_osc: int, dtype: torch.dtype = torch.float32,
         device="cpu") -> CPGState:
    """Oscillators on the unit circle with evenly spread phases."""
    phase = torch.arange(n_osc, dtype=dtype, device=device) * (
        2.0 * math.pi / n_osc)
    return CPGState(torch.cos(phase), torch.sin(phase))


def hopf_deriv(x, y, alpha: float, beta: float, mu: float,
               w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Modified Hopf vector field (envs/nightmare_v3_env.py:18-21)."""
    r2 = mu * mu - x * x - y * y
    return alpha * r2 * x - w * y, beta * r2 * y + w * x


def rotate(xs, ys, angle) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase-coupling rotation (envs/nightmare_v3_env.py:23-24)."""
    if isinstance(angle, torch.Tensor):
        c, s = torch.cos(angle), torch.sin(angle)
    else:
        c, s = math.cos(angle), math.sin(angle)
    return xs * c - ys * s, xs * s + ys * c


def step(state: CPGState, freqs, alpha: float = 50.0, beta: float = 50.0,
         mu: float = 1.0, dt: float = 0.01) -> CPGState:
    """One Euler step at the reference's commented dt
    (envs/nightmare_v3_env.py:172-173); ``freqs`` are the angular rates."""
    dx, dy = hopf_deriv(state.x, state.y, alpha, beta, mu, freqs)
    return CPGState(state.x + dx * dt, state.y + dy * dt)
