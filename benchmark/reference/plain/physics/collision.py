# A frozen copy of the port's physics/collision.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
"""Contact generation (port of ``nightmare_rl_tpu/physics/collision.py``):
body-attached candidate points against the ground plane, and the top-K
deepest body↔body sphere pairs (tibia self-collision).

Plane contact frame: n=(0,0,1), t1=(0,1,0), t2=(-1,0,0) (mju_makeFrame for a
+z normal).  The jacobian is evaluated at MuJoCo's contact point, the
mid-penetration point (z = dist/2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.plain.core import quat as Q
from benchmark.reference.plain.physics import system as S
from benchmark.reference.plain.physics.kinematics import KinOut, body_root
from benchmark.reference.plain.utils.device import constant


class Contacts(NamedTuple):
    pos: torch.Tensor      # (N, ncp, 3) world contact point
    dist: torch.Tensor     # (N, ncp) signed distance (negative = penetrating)
    active: torch.Tensor   # (N, ncp) bool
    jac: torch.Tensor      # (N, ncp, nv, 3) translational point jacobian
    centers: torch.Tensor  # (N, ncp, 3) world centers of the candidate spheres
    jac_rot: torch.Tensor  # (N, ncp, nv, 3) rotational jacobian (world axes),
                           # read by the condim > 3 rows


class PairContacts(NamedTuple):
    """Top-K deepest body↔body sphere-pair contacts (self-collision)."""

    sel: torch.Tensor     # (N, K) selected pair indices
    a: torch.Tensor       # (N, K) cpoint index of side a
    b: torch.Tensor       # (N, K) cpoint index of side b
    dist: torch.Tensor    # (N, K)
    active: torch.Tensor  # (N, K) bool
    normal: torch.Tensor  # (N, K, 3) from a to b
    t1: torch.Tensor      # (N, K, 3)
    t2: torch.Tensor      # (N, K, 3)
    jac: torch.Tensor     # (N, K, nv, 3) relative point jacobian (b minus a)


def topk_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries along the last axis, ties broken
    toward the lower index — ``jax.lax.top_k(-x, k)``'s order, which the
    Gauss-Seidel row order depends on (``torch.topk`` promises no tie
    order)."""
    return torch.sort(-x, dim=-1, descending=True, stable=True).indices[..., :k]


def find_contacts(sys: S.System, kin: KinOut) -> Contacts:
    dev = kin.xpos.device
    body = S.index_tensor(sys.cpoint_bodyid, dev)
    root = body_root(sys)
    origin = kin.subtree_com[:, S.index_tensor(
        tuple(root[b] for b in sys.cpoint_bodyid), dev)]      # (N, ncp, 3)

    center = kin.xpos[:, body] + Q.rotate(sys.cpoint_pos, kin.xquat[:, body])
    r = sys.cpoint_radius
    dist = center[..., 2] - r
    active = dist < 0.0

    # MuJoCo places the contact at mid-penetration along the normal
    pos = torch.cat([center[..., :2], (center[..., 2] - r)[..., None]], -1)
    mid = torch.cat([center[..., :2],
                     (torch.clamp_max(dist, 0.0) * 0.5)[..., None]], -1)

    # Jp[:, d] = cdof_lin[d] + cdof_ang[d] × (p - com_origin), masked to the
    # dofs on the path to the owning body
    rel = (mid - origin)[:, :, None, :]                       # (N, ncp, 1, 3)
    ang = kin.cdof[:, None, :, :3]                            # (N, 1, nv, 3)
    lin = kin.cdof[:, None, :, 3:]
    jac = lin + Q.cross(ang, rel)                             # (N, ncp, nv, 3)
    mask = sys.body_dof_mask[body][..., None]                 # (ncp, nv, 1)
    jac_rot = ang.expand_as(jac) * mask
    return Contacts(pos, dist, active, jac * mask, center, jac_rot)


def find_pair_contacts(sys: S.System, kin: KinOut,
                       con: Contacts) -> PairContacts:
    """Sphere-sphere contacts between the top-K deepest candidate pairs
    (sys.cpair_*).  Normal from a to b; tangents from a deterministic
    orthonormal construction."""
    N, dev = con.centers.shape[0], con.centers.device
    K = min(sys.max_pair_contacts, len(sys.cpair_a))
    pa, pb = sys.cpair_a, sys.cpair_b
    r = sys.cpoint_radius
    ca = con.centers[:, pa]
    cb = con.centers[:, pb]
    d_vec = cb - ca
    center_dist = torch.linalg.vector_norm(d_vec, dim=-1)
    dist = center_dist - (r[pa] + r[pb])

    sel = topk_smallest(dist, K)                              # (N, K)
    rows = torch.arange(N, device=dev)[:, None]
    a, b = pa[sel], pb[sel]
    n = d_vec[rows, sel] / torch.clamp_min(center_dist[rows, sel], 1e-9)[..., None]
    dist_s = dist[rows, sel]
    active = dist_s < 0.0

    # orthonormal tangents (branchless: cross with the axis least aligned)
    ref = torch.where(torch.abs(n[..., 2:3]) < 0.9,
                      constant((0.0, 0.0, 1.0), n.dtype, dev),
                      constant((1.0, 0.0, 0.0), n.dtype, dev))
    t1 = Q.cross(ref, n)
    t1 = t1 / torch.clamp_min(
        torch.linalg.vector_norm(t1, dim=-1, keepdim=True), 1e-9)
    t2 = Q.cross(n, t1)

    # contact point: midway between the sphere surfaces
    mid = 0.5 * (ca[rows, sel] + r[a][..., None] * n + cb[rows, sel]
                 - r[b][..., None] * n)

    bodyid = S.index_tensor(sys.cpoint_bodyid, dev)
    body_a, body_b = bodyid[a], bodyid[b]
    root = S.index_tensor(tuple(body_root(sys)), dev)
    origin = kin.subtree_com[rows, root[body_b]]              # (N, K, 3)
    rrel = (mid - origin)[:, :, None, :]
    ang = kin.cdof[:, None, :, :3]
    lin = kin.cdof[:, None, :, 3:]
    jac_pt = lin + Q.cross(ang, rrel)                         # (N, K, nv, 3)
    dmask = sys.body_dof_mask
    rel_mask = (dmask[body_b] - dmask[body_a])[..., None]
    return PairContacts(sel, a, b, dist_s, active, n, t1, t2, jac_pt * rel_mask)
