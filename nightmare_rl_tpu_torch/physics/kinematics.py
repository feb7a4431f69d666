"""Forward kinematics and com-based quantities (port of
``nightmare_rl_tpu/physics/kinematics.py``).

Body frames, inertial frames, subtree centers of mass, com-based spatial
inertias (cinert), dof motion axes (cdof), their velocity derivatives
(cdof_dot) and body velocities (cvel), with MuJoCo's conventions.  The loops
run over bodies on the host (nbody = 20 for the hexapod); each statement
inside is vectorised over the leading env dimension.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from nightmare_rl_tpu_torch.core import quat as Q
from nightmare_rl_tpu_torch.core import spatial as sp
from nightmare_rl_tpu_torch.physics import system as S
from nightmare_rl_tpu_torch.utils.device import constant


class KinOut(NamedTuple):
    xpos: torch.Tensor         # (N, nbody, 3)
    xquat: torch.Tensor        # (N, nbody, 4)
    xipos: torch.Tensor        # (N, nbody, 3)
    ximat: torch.Tensor        # (N, nbody, 3, 3)
    xanchor: torch.Tensor      # (N, njnt, 3)
    xaxis: torch.Tensor        # (N, njnt, 3)
    subtree_com: torch.Tensor  # (N, nbody, 3)
    cinert: torch.Tensor       # (N, nbody, 6, 6)
    cdof: torch.Tensor         # (N, nv, 6)


def body_root(sys: S.System) -> List[int]:
    """Root body (child of world) of each body's kinematic tree."""
    root = [0] * sys.nbody
    for b in range(1, sys.nbody):
        p = sys.body_parent[b]
        root[b] = b if p == 0 else root[p]
    return root


def kinematics(sys: S.System, qpos: torch.Tensor) -> KinOut:
    N, dtype, dev = qpos.shape[0], qpos.dtype, qpos.device
    zeros3 = qpos.new_zeros(N, 3)
    xpos = [zeros3]
    xquat = [constant((1.0, 0.0, 0.0, 0.0), dtype, dev).expand(N, 4)]
    xanchor = [zeros3] * sys.njnt
    xaxis = [zeros3] * sys.njnt

    for b in range(1, sys.nbody):
        p = sys.body_parent[b]
        pos = xpos[p] + Q.rotate(sys.body_pos[b], xquat[p])
        qt = Q.mul(xquat[p], sys.body_quat[b])
        jadr, jnum = sys.body_jntadr[b], sys.body_jntnum[b]
        for j in range(jadr, jadr + jnum):
            jt = sys.jnt_type[j]
            qadr = sys.jnt_qposadr[j]
            if jt == S.FREE:
                pos = qpos[:, qadr:qadr + 3]
                qt = Q.normalize(qpos[:, qadr + 3:qadr + 7])
                xanchor[j] = pos
                xaxis[j] = sys.jnt_axis[j].expand(N, 3)
            elif jt == S.HINGE:
                anchor = pos + Q.rotate(sys.jnt_pos[j], qt)
                axis_w = Q.rotate(sys.jnt_axis[j], qt)
                qt = Q.mul(qt, Q.from_axis_angle(sys.jnt_axis[j], qpos[:, qadr]))
                pos = anchor - Q.rotate(sys.jnt_pos[j], qt)
                xanchor[j] = anchor
                xaxis[j] = axis_w
            elif jt == S.SLIDE:
                axis_w = Q.rotate(sys.jnt_axis[j], qt)
                pos = pos + axis_w * qpos[:, qadr:qadr + 1]
                xanchor[j] = pos
                xaxis[j] = axis_w
            else:
                raise NotImplementedError(f"joint type {jt}")
        xpos.append(pos)
        xquat.append(qt)

    xpos = torch.stack(xpos, dim=1)
    xquat = torch.stack(xquat, dim=1)
    xanchor = (torch.stack(xanchor, dim=1) if sys.njnt
               else qpos.new_zeros(N, 0, 3))
    xaxis = torch.stack(xaxis, dim=1) if sys.njnt else qpos.new_zeros(N, 0, 3)

    # inertial frames
    xipos = xpos + Q.rotate(sys.body_ipos, xquat)
    ximat = Q.to_mat(Q.mul(xquat, sys.body_iquat))

    # subtree com (bottom-up accumulation)
    mass = sys.body_mass
    sub_mass = list(mass.unbind(0))
    sub_mom = [mass[b] * xipos[:, b] for b in range(sys.nbody)]
    for b in range(sys.nbody - 1, 0, -1):
        p = sys.body_parent[b]
        sub_mass[p] = sub_mass[p] + sub_mass[b]
        sub_mom[p] = sub_mom[p] + sub_mom[b]
    subtree_com = torch.stack(
        [sub_mom[b] / torch.clamp_min(sub_mass[b], 1e-12)
         for b in range(sys.nbody)], dim=1)

    root = body_root(sys)
    com_origin = subtree_com[:, S.index_tensor(tuple(root), dev)]

    # cinert: spatial inertia about com_origin, world axes
    inert_world = ximat @ (sys.body_inertia[..., None]
                           * ximat.transpose(-1, -2))
    cinert = sp.inertia_matrix(mass, inert_world, xipos - com_origin)

    # cdof: per-dof motion axes about the dof's tree com origin
    cdof = []
    for j in range(sys.njnt):
        b = sys.jnt_bodyid[j]
        o = subtree_com[:, root[b]]
        jt = sys.jnt_type[j]
        if jt == S.FREE:
            eye = torch.eye(3, dtype=dtype, device=dev)
            for i in range(3):
                cdof.append(torch.cat([eye.new_zeros(3), eye[i]]).expand(N, 6))
            R = Q.to_mat(xquat[:, b])
            for i in range(3):
                ax = R[:, :, i]
                cdof.append(torch.cat([ax, Q.cross(ax, o - xpos[:, b])], -1))
        elif jt == S.HINGE:
            ax = xaxis[:, j]
            cdof.append(torch.cat([ax, Q.cross(ax, o - xanchor[:, j])], -1))
        elif jt == S.SLIDE:
            cdof.append(torch.cat([torch.zeros_like(xaxis[:, j]),
                                   xaxis[:, j]], -1))
    cdof = torch.stack(cdof, dim=1) if cdof else qpos.new_zeros(N, 0, 6)

    return KinOut(xpos, xquat, xipos, ximat, xanchor, xaxis, subtree_com,
                  cinert, cdof)


class VelOut(NamedTuple):
    cvel: torch.Tensor      # (N, nbody, 6)
    cdof_dot: torch.Tensor  # (N, nv, 6)


def com_vel(sys: S.System, kin: KinOut, qvel: torch.Tensor) -> VelOut:
    """Body com-velocities and cdof time-derivatives (mj_comVel semantics)."""
    N = qvel.shape[0]
    zero6 = qvel.new_zeros(N, 6)
    cvel = [zero6]
    cdof_dot = [zero6] * sys.nv
    cdof = kin.cdof
    for b in range(1, sys.nbody):
        v = cvel[sys.body_parent[b]]
        jadr, jnum = sys.body_jntadr[b], sys.body_jntnum[b]
        for j in range(jadr, jadr + jnum):
            d = sys.jnt_dofadr[j]
            if sys.jnt_type[j] == S.FREE:
                # translation dofs: constant axes, cdof_dot = 0
                v = (v + cdof[:, d] * qvel[:, d:d + 1]
                     + cdof[:, d + 1] * qvel[:, d + 1:d + 2]
                     + cdof[:, d + 2] * qvel[:, d + 2:d + 3])
                # rotation dofs: cdof_dot = v_translated × cdof with the
                # velocity accumulated so far (translation included)
                for k in range(3, 6):
                    cdof_dot[d + k] = sp.motion_cross(v, cdof[:, d + k])
                v = (v + cdof[:, d + 3] * qvel[:, d + 3:d + 4]
                     + cdof[:, d + 4] * qvel[:, d + 4:d + 5]
                     + cdof[:, d + 5] * qvel[:, d + 5:d + 6])
            else:
                cdof_dot[d] = sp.motion_cross(v, cdof[:, d])
                v = v + cdof[:, d] * qvel[:, d:d + 1]
        cvel.append(v)
    return VelOut(torch.stack(cvel, dim=1), torch.stack(cdof_dot, dim=1))
