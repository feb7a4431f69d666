# A frozen copy of the port's core/spatial.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
"""6-D spatial vector algebra (Featherstone) in MuJoCo layout (port of
``nightmare_rl_tpu/core/spatial.py``).

Spatial vectors are ``(..., 6)`` tensors laid out ``[angular(3); linear(3)]``
in a world-aligned frame about the subtree center of mass; spatial inertias
are ``(..., 6, 6)``.  Leading dimensions broadcast (envs first).
"""

from __future__ import annotations

import torch

from benchmark.reference.plain.core.quat import cross


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector → skew-symmetric matrix such that ``skew(a) @ b = a × b``."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial cross product for motion vectors: ``v ×ₘ m``."""
    w, u = v[..., :3], v[..., 3:]
    a, b = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, a), cross(w, b) + cross(u, a)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial cross product for force vectors: ``v ×f f``."""
    w, u = v[..., :3], v[..., 3:]
    t, n = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, t) + cross(u, n), cross(w, n)], dim=-1)


def inertia_matrix(mass: torch.Tensor, inertia_world: torch.Tensor,
                   com_offset: torch.Tensor) -> torch.Tensor:
    """6×6 spatial inertia about a frame origin::

        [ I + m·cx·cxᵀ   m·cx ]
        [ m·cxᵀ          m·1  ]      cx = skew(com_offset)
    """
    cx = skew(com_offset)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=cx.dtype, device=cx.device).expand(cx.shape)
    top_left = inertia_world + m * (cx @ cx.transpose(-1, -2))
    top_right = m * cx
    bottom_left = m * cx.transpose(-1, -2)
    bottom_right = m * eye
    top = torch.cat([top_left, top_right], dim=-1)
    bottom = torch.cat([bottom_left, bottom_right], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def inertia_mul(I: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``I @ v`` for spatial inertia (..., 6, 6) and motion vector (..., 6)."""
    return torch.einsum("...ij,...j->...i", I, v)
