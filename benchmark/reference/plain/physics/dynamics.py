# A frozen copy of the port's physics/dynamics.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
"""Smooth dynamics: CRB mass matrix, RNE bias forces, actuation, damping
(port of ``nightmare_rl_tpu/physics/dynamics.py``).

The mass matrix uses the composite-rigid-body algorithm over the com-based
quantities from ``kinematics``; the ancestor mask turns the tree-structured
accumulation into one batched contraction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.plain.core import spatial as sp
from benchmark.reference.plain.physics import system as S
from benchmark.reference.plain.physics.kinematics import KinOut, VelOut


def crb(sys: S.System, kin: KinOut) -> torch.Tensor:
    """Dense joint-space mass matrix M (N, nv, nv)."""
    crb_inert = list(kin.cinert.unbind(1))
    for b in range(sys.nbody - 1, 0, -1):
        p = sys.body_parent[b]
        if p > 0:
            crb_inert[p] = crb_inert[p] + crb_inert[b]
    crb_arr = torch.stack(crb_inert, dim=1)  # (N, nbody, 6, 6)

    dof_body = S.index_tensor(sys.dof_bodyid, kin.cdof.device)
    F = torch.einsum("ndij,ndj->ndi", crb_arr[:, dof_body], kin.cdof)
    M = torch.einsum("nik,njk->nij", kin.cdof, F)
    # mask[i, j] = 1 iff dof i is an ancestor of (or equal to) dof j
    tri = M * sys.dof_ancestor_mask
    M = tri + tri.transpose(-1, -2) - torch.diag_embed(
        torch.diagonal(tri, dim1=-2, dim2=-1))
    return M + torch.diag(sys.dof_armature)


def rne_bias(sys: S.System, kin: KinOut, vel: VelOut,
             qvel: torch.Tensor) -> torch.Tensor:
    """qfrc_bias = C(q, v)·v + g(q)  (mj_rne with flg_acc=0), (N, nv)."""
    N = qvel.shape[0]
    cacc = [torch.cat([sys.gravity.new_zeros(3), -sys.gravity]).expand(N, 6)]
    for b in range(1, sys.nbody):
        a = cacc[sys.body_parent[b]]
        jadr, jnum = sys.body_jntadr[b], sys.body_jntnum[b]
        for j in range(jadr, jadr + jnum):
            d = sys.jnt_dofadr[j]
            n = 6 if sys.jnt_type[j] == S.FREE else 1
            for k in range(n):
                a = a + vel.cdof_dot[:, d + k] * qvel[:, d + k:d + k + 1]
        cacc.append(a)
    cacc = torch.stack(cacc, dim=1)

    # body forces: f = I a + v ×f (I v)
    Iv = torch.einsum("nbij,nbj->nbi", kin.cinert, vel.cvel)
    cfrc = (torch.einsum("nbij,nbj->nbi", kin.cinert, cacc)
            + sp.force_cross(vel.cvel, Iv))

    # backward accumulate to ancestors, project on cdof
    cfrc_l = list(cfrc.unbind(1))
    for b in range(sys.nbody - 1, 0, -1):
        p = sys.body_parent[b]
        if p > 0:
            cfrc_l[p] = cfrc_l[p] + cfrc_l[b]
    cfrc_tot = torch.stack(cfrc_l, dim=1)
    dof_body = S.index_tensor(sys.dof_bodyid, qvel.device)
    return torch.einsum("ndi,ndi->nd", kin.cdof, cfrc_tot[:, dof_body])


class ActOut(NamedTuple):
    qfrc_actuator: torch.Tensor   # (N, nv)
    actuator_force: torch.Tensor  # (N, nu)
    # d(actuator joint force)/d(qvel) diagonal contribution, for implicitfast
    vel_deriv: torch.Tensor       # (N, nv)


def actuation(sys: S.System, qpos: torch.Tensor, qvel: torch.Tensor,
              ctrl: torch.Tensor) -> ActOut:
    """MuJoCo "general" actuators on joint transmissions:
    force = gain·ctrl + b0 + b1·length + b2·velocity, clamped to forcerange;
    qfrc = gearᵀ·force."""
    if sys.nu == 0:  # passive model
        z = torch.zeros_like(qvel)
        return ActOut(z, qvel.new_zeros(qvel.shape[0], 0), z)
    dev = qvel.device
    trn_dof = S.index_tensor(
        tuple(sys.jnt_dofadr[j] for j in sys.actuator_trnid), dev)
    trn_qadr = S.index_tensor(
        tuple(sys.jnt_qposadr[j] for j in sys.actuator_trnid), dev)
    gear = sys.actuator_gear
    length = qpos[:, trn_qadr] * gear
    velocity = qvel[:, trn_dof] * gear

    cr = sys.actuator_ctrlrange
    c = torch.where(sys.actuator_ctrllimited,
                    torch.clamp(ctrl, cr[:, 0], cr[:, 1]), ctrl)
    bias = sys.actuator_biasprm
    force = (sys.actuator_gainprm * c + bias[:, 0] + bias[:, 1] * length
             + bias[:, 2] * velocity)
    fr = sys.actuator_forcerange
    force = torch.where(sys.actuator_forcelimited,
                        torch.clamp(force, fr[:, 0], fr[:, 1]), force)
    qfrc = torch.zeros_like(qvel).index_add_(1, trn_dof, gear * force)
    return ActOut(qfrc, force, actuator_vel_deriv(sys, qvel[0]).expand_as(qvel))


def actuator_vel_deriv(sys: S.System, like: torch.Tensor) -> torch.Tensor:
    """∂qfrc_actuator/∂qvel (diagonal), gear² · b2 per dof: (nv,), of
    ``like``'s dtype and device."""
    trn_dof = S.index_tensor(
        tuple(sys.jnt_dofadr[j] for j in sys.actuator_trnid), like.device)
    return torch.zeros_like(like).index_add_(
        0, trn_dof, sys.actuator_gear**2 * sys.actuator_biasprm[:, 2])


def passive(sys: S.System, qvel: torch.Tensor) -> torch.Tensor:
    """qfrc_passive: joint damping."""
    return -sys.dof_damping * qvel
