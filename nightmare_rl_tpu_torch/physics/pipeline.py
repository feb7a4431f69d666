"""Full physics step: forward dynamics + integration (implicitfast, or
Euler with or without implicit joint damping) + touch sensors (port of
``nightmare_rl_tpu/physics/pipeline.py``), the batched equivalent of
``mj_step`` with a decimation loop.

The mass matrix is factored block-arrow where the tree is a free base with
equal independent legs (``arrow.layout``; both bundled robots), and by dense
Cholesky otherwise.  The layout and the factor go to the contact solve,
whose assembly then gives each row its leg slots, so that PGS models can
solve in the leg-sparse form (``solver.solve``).  As in the JAX package, ``NIGHTMARE_NO_WARMSTART`` (any
non-empty value) starts every Newton solve from qacc_smooth instead of the
previous step's qacc; it is read on every call.  ``forward`` and ``step``
multiply at full float32 whatever the caller's TF32 settings.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import torch

from nightmare_rl_tpu_torch.core import quat as Q
from nightmare_rl_tpu_torch.ops import linalg
from nightmare_rl_tpu_torch.physics import arrow, collision, dynamics
from nightmare_rl_tpu_torch.physics import kinematics, solver
from nightmare_rl_tpu_torch.physics import system as S
from nightmare_rl_tpu_torch.utils.device import full_float32

_MAXVAL = 1e10  # mjMAXVAL: larger or non-finite qpos/qvel resets the env


class ForwardOut(NamedTuple):
    kin: kinematics.KinOut
    vel: kinematics.VelOut
    M: torch.Tensor
    # dense Cholesky factor of M, or None where the block-arrow factor was
    # used (arrow.layout(sys) is not None)
    M_chol: Optional[torch.Tensor]
    qfrc_smooth: torch.Tensor
    qacc_smooth: torch.Tensor
    con: collision.Contacts
    sol: solver.ContactSolveOut
    act: dynamics.ActOut
    sensordata: torch.Tensor


def make_state(sys: S.System, num_envs: int) -> S.State:
    """Fresh states at the model reference pose (mjData after reset)."""
    N, dt, dev = num_envs, sys.dtype, sys.device
    xquat = torch.zeros(N, sys.nbody, 4, dtype=dt, device=dev)
    xquat[..., 0] = 1.0
    return S.State(
        qpos=sys.qpos0.expand(N, -1).clone(),
        qvel=torch.zeros(N, sys.nv, dtype=dt, device=dev),
        qacc_warmstart=torch.zeros(N, sys.nv, dtype=dt, device=dev),
        sensordata=torch.zeros(N, sys.nsensor, dtype=dt, device=dev),
        xpos=torch.zeros(N, sys.nbody, 3, dtype=dt, device=dev),
        xquat=xquat,
        xipos=torch.zeros(N, sys.nbody, 3, dtype=dt, device=dev),
        cvel=torch.zeros(N, sys.nbody, 6, dtype=dt, device=dev),
        subtree_com=torch.zeros(N, sys.nbody, 3, dtype=dt, device=dev),
        qfrc_actuator=torch.zeros(N, sys.nv, dtype=dt, device=dev),
    )


@full_float32()
def forward(sys: S.System, state: S.State, ctrl: torch.Tensor) -> ForwardOut:
    qpos, qvel = state.qpos, state.qvel
    kin = kinematics.kinematics(sys, qpos)
    vel = kinematics.com_vel(sys, kin, qvel)
    M = dynamics.crb(sys, kin)
    bias = dynamics.rne_bias(sys, kin, vel, qvel)
    act = dynamics.actuation(sys, qpos, qvel, ctrl)
    qfrc_smooth = act.qfrc_actuator + dynamics.passive(sys, qvel) - bias

    # block-arrow factor where the tree allows it, dense Cholesky otherwise;
    # exact algebra either way
    lay = arrow.layout(sys)
    if lay is not None:
        fac, M_chol = arrow.factor(lay, M), None
        qacc_smooth = arrow.solve_vec(lay, fac, qfrc_smooth)
    else:
        fac, M_chol = None, linalg.chol(M)
        qacc_smooth = linalg.cho_solve(M_chol, qfrc_smooth)

    con = collision.find_contacts(sys, kin)
    pair = None
    if sys.max_pair_contacts > 0 and len(sys.cpair_a) > 0:
        pair = collision.find_pair_contacts(sys, kin, con)
    warmstart = (None if os.environ.get("NIGHTMARE_NO_WARMSTART")
                 else state.qacc_warmstart)
    sol = solver.solve_contacts(sys, con, qpos, qvel, qacc_smooth, pair=pair,
                                lay=lay, fac=fac, M=M, M_chol=M_chol,
                                warmstart=warmstart)
    # touch sensors: per-contact normal force (Σ pyramid facet forces, or
    # the normal row of an elliptic cone)
    sensordata = sol.nforce @ sys.sensor_cpoint_matrix.T
    return ForwardOut(kin, vel, M, M_chol, qfrc_smooth, qacc_smooth, con, sol,
                      act, sensordata)


def _integrate_pos(sys: S.System, qpos: torch.Tensor, qvel: torch.Tensor,
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


@functools.lru_cache(maxsize=None)
def _euler_damped(sys: S.System) -> bool:
    """Whether the Euler integrator treats joint damping implicitly (read
    once per System, so the step never copies it to the host)."""
    return bool(sys.eulerdamp) and bool((sys.dof_damping.cpu() > 0).any())


@full_float32()
def step(sys: S.System, state: S.State, ctrl: torch.Tensor,
         n_steps: int = 1) -> S.State:
    """Advance physics by ``n_steps`` timesteps with constant ctrl (the
    decimation loop of the reference env)."""
    lay = arrow.layout(sys)

    def spd_solve(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
        if lay is not None:
            return arrow.solve_vec(lay, arrow.factor(lay, A), rhs)
        return linalg.cho_solve(linalg.chol(A), rhs)

    dt = sys.timestep
    qpos0 = sys.qpos0
    for _ in range(n_steps):
        fwd = forward(sys, state, ctrl)
        qfrc = fwd.qfrc_smooth + fwd.sol.qfrc_constraint
        if sys.integrator == S.IMPLICITFAST:
            # (M - h·∂f/∂v)·qacc = qfrc_smooth + qfrc_constraint, with the
            # actuator (gear²·b2) and damping terms of the velocity derivative
            deriv = fwd.act.vel_deriv - sys.dof_damping
            Mhat = fwd.M - dt * torch.diag_embed(deriv)
            qacc = spd_solve(Mhat, qfrc)
            qvel = state.qvel + dt * qacc
        elif _euler_damped(sys):
            # mj_Euler with implicit joint damping:
            # (M + h·diag(B)) v⁺ = M v + h·qfrc_total
            MhB = fwd.M + dt * torch.diag(sys.dof_damping)
            rhs = torch.einsum("nij,nj->ni", fwd.M, state.qvel) + dt * qfrc
            qvel = spd_solve(MhB, rhs)
        else:
            qvel = state.qvel + dt * fwd.sol.qacc
        qpos = _integrate_pos(sys, state.qpos, qvel, dt)

        # mj_checkPos/mj_checkVel: non-finite or >mjMAXVAL values reset the
        # env to the reference pose.  The reset frame keeps this step's
        # sensordata and kinematics, as the JAX package does.
        bad = ~(torch.isfinite(qpos).all(dim=1) & torch.isfinite(qvel).all(dim=1)
                & (torch.abs(qpos).amax(dim=1) < _MAXVAL)
                & (torch.abs(qvel).amax(dim=1) < _MAXVAL))[:, None]
        qpos = torch.where(bad, qpos0, qpos)
        qvel = torch.where(bad, torch.zeros_like(qvel), qvel)
        state = state.replace(
            qpos=qpos,
            qvel=qvel,
            qacc_warmstart=torch.where(bad, torch.zeros_like(fwd.sol.qacc),
                                       fwd.sol.qacc),
            sensordata=fwd.sensordata,
            xpos=fwd.kin.xpos,
            xquat=fwd.kin.xquat,
            xipos=fwd.kin.xipos,
            cvel=fwd.vel.cvel,
            subtree_com=fwd.kin.subtree_com,
            qfrc_actuator=fwd.act.qfrc_actuator,
        )
    return state
