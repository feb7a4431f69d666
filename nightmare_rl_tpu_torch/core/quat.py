"""Quaternion / rotation math with MuJoCo semantics (port of
``nightmare_rl_tpu/core/quat.py``).

Quaternions are ``(w, x, y, z)``, unit norm, active rotations:
``rotate(v, q) = R(q) @ v``.  Every function broadcasts over leading batch
dimensions (envs first), so a body-frame constant of shape ``(3,)`` rotates
by a batch of quaternions ``(N, 4)`` without expanding it first.
"""

from __future__ import annotations

import torch

from nightmare_rl_tpu_torch.utils.device import constant


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting 3-vector cross product over the last axis."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Return the unit quaternion (safe for zero input)."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(n, eps)


def conj(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate (``mju_negQuat``)."""
    return q * constant((1.0, -1.0, -1.0, -1.0), q.dtype, q.device)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``a ⊗ b`` (``mju_mulQuat``)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def rotate(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate vector by quaternion (``mju_rotVecQuat``): ``R(q) @ v``."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def rotate_inv(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate by the inverse quaternion: ``R(q)ᵀ @ v``."""
    return rotate(v, conj(q))


def to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → 3×3 rotation matrix (``mju_quat2Mat``)."""
    w, x, y, z = q.unbind(-1)
    rows = [
        torch.stack([1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
                     2.0 * (x * z + w * y)], dim=-1),
        torch.stack([2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
                     2.0 * (y * z - w * x)], dim=-1),
        torch.stack([2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
                     1.0 - 2.0 * (x * x + y * y)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def from_mat(m: torch.Tensor) -> torch.Tensor:
    """3×3 rotation matrix → quaternion (branch-free Shepperd, w >= 0)."""
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    qw = torch.stack([1.0 + tr, m[..., 2, 1] - m[..., 1, 2],
                      m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]],
                     dim=-1)
    qx = torch.stack([m[..., 2, 1] - m[..., 1, 2],
                      1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                      m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0]],
                     dim=-1)
    qy = torch.stack([m[..., 0, 2] - m[..., 2, 0], m[..., 0, 1] + m[..., 1, 0],
                      1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                      m[..., 1, 2] + m[..., 2, 1]], dim=-1)
    qz = torch.stack([m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0],
                      m[..., 1, 2] + m[..., 2, 1],
                      1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]], dim=-1)
    cases = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    diag = torch.stack([tr, m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], dim=-1)
    # argmax returns the first maximum, as jnp.argmax does
    best = torch.argmax(diag, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = normalize(torch.gather(cases, -2, idx)[..., 0, :])
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis + angle → quaternion (``mju_axisAngle2Quat``)."""
    half = 0.5 * angle
    s = torch.sin(half)[..., None]
    axis_s = axis * s
    c = torch.cos(half)[..., None].expand(axis_s.shape[:-1] + (1,))
    return torch.cat([c, axis_s], dim=-1)


def integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """Integrate local-frame angular velocity over dt (``mju_quatIntegrate``):
    q' = q ⊗ exp(½ ω_local dt)."""
    angle = torch.linalg.vector_norm(omega, dim=-1)
    axis = omega / torch.clamp_min(angle, 1e-12)[..., None]
    return normalize(mul(q, from_axis_angle(axis, angle * dt)))
