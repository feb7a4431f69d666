# A frozen copy of the port's ops/integrate.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
"""Plain versions of the port's ``ops/integrate.py``."""

from __future__ import annotations
from typing import Optional, Tuple
import torch
from benchmark.reference.plain.core import quat as Q
from benchmark.reference.plain.ops import linalg
from benchmark.reference.plain.ops import smooth as SM
from benchmark.reference.plain.physics import arrow, dynamics
from benchmark.reference.plain.physics import system as S


MAXVAL = 1e10  # mjMAXVAL: larger or non-finite qpos/qvel resets the env


Update = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def integrate_pos(sys: S.System, qpos: torch.Tensor, qvel: torch.Tensor,
                  dt) -> torch.Tensor:
    """mj_integratePos: joint-type-aware position update."""
    cols = list(qpos.unbind(1))
    for j in range(sys.njnt):
        qadr, dadr = sys.jnt_qposadr[j], sys.jnt_dofadr[j]
        if sys.jnt_type[j] == S.FREE:
            for k in range(3):
                cols[qadr + k] = cols[qadr + k] + dt * qvel[:, dadr + k]
            q = Q.integrate(qpos[:, qadr + 3:qadr + 7],
                            qvel[:, dadr + 3:dadr + 6], dt)
            cols[qadr + 3:qadr + 7] = q.unbind(1)
        else:
            cols[qadr] = cols[qadr] + dt * qvel[:, dadr]
    return torch.stack(cols, dim=1)


def plain_update(sys: S.System, lay: Optional[arrow.ArrowLayout],
                 qpos: torch.Tensor, qvel: torch.Tensor, M: torch.Tensor,
                 qfrc_smooth: torch.Tensor, qfrc_constraint: torch.Tensor,
                 qacc: torch.Tensor) -> Update:
    """The plain version, torch ops over the env axis."""

    def spd_solve(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
        if lay is not None:
            return arrow.solve_vec(lay, arrow.factor(lay, A), rhs)
        return linalg.cho_solve(linalg.chol(A), rhs)

    dt = sys.timestep
    qfrc = qfrc_smooth + qfrc_constraint
    update = SM.update_kind(sys)
    if update == "implicitfast":
        # (M - h·∂f/∂v)·qacc = qfrc_smooth + qfrc_constraint, with the
        # actuator (gear²·b2) and damping terms of the velocity derivative
        deriv = dynamics.actuator_vel_deriv(sys, qvel[0]) - sys.dof_damping
        Mhat = M - dt * torch.diag_embed(deriv)
        qvel_new = qvel + dt * spd_solve(Mhat, qfrc)
    elif update == "euler_damped":
        # mj_Euler with implicit joint damping:
        # (M + h·diag(B)) v⁺ = M v + h·qfrc_total
        MhB = M + dt * torch.diag(sys.dof_damping)
        rhs = torch.einsum("nij,nj->ni", M, qvel) + dt * qfrc
        qvel_new = spd_solve(MhB, rhs)
    else:
        qvel_new = qvel + dt * qacc
    qpos_new = integrate_pos(sys, qpos, qvel_new, dt)

    # mj_checkPos/mj_checkVel: non-finite or >mjMAXVAL values reset the env
    # to the reference pose
    bad = ~(torch.isfinite(qpos_new).all(dim=1)
            & torch.isfinite(qvel_new).all(dim=1)
            & (torch.abs(qpos_new).amax(dim=1) < MAXVAL)
            & (torch.abs(qvel_new).amax(dim=1) < MAXVAL))[:, None]
    return (torch.where(bad, sys.qpos0, qpos_new),
            torch.where(bad, torch.zeros_like(qvel_new), qvel_new),
            torch.where(bad, torch.zeros_like(qacc), qacc))


integrate_update = plain_update
