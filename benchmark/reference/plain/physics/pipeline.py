# A frozen copy of the port's physics/pipeline.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
"""Full physics step: forward dynamics + integration (implicitfast, or
Euler with or without implicit joint damping) + touch sensors (port of
``nightmare_rl_tpu/physics/pipeline.py``), the batched equivalent of
``mj_step`` with a decimation loop.

The smooth half of ``forward`` (kinematics to qfrc_smooth and the arrow
factor), its collision and row assembly (``ops/assemble.py``), the
solve's output stage (qfrc, qacc, the normal forces and the touch sensors:
``ops/solve_out.py``) and the integrator's update of ``step`` are one
kernel launch each on the card (``ops/smooth.py``, ``ops/integrate.py``),
the plain functions on the CPU. The mass matrix is factored block-arrow where the tree is a
free base with equal independent legs (``arrow.layout``; both bundled
robots), and by dense Cholesky otherwise. The layout and the factor go to
the contact solve, whose assembly then gives each row its leg slots, so
that PGS models can solve in the leg-sparse form (``solver.solve``). As in
the JAX package, ``NIGHTMARE_NO_WARMSTART`` (any non-empty value) starts
every Newton solve from qacc_smooth instead of the previous step's qacc; it
is read on every call. ``forward`` and ``step`` multiply at full float32
whatever the caller's TF32 settings.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from benchmark.reference.plain.ops import assemble, integrate, linalg, smooth
from benchmark.reference.plain.physics import arrow, collision, dynamics
from benchmark.reference.plain.physics import kinematics, solver
from benchmark.reference.plain.physics import system as S
from benchmark.reference.plain.utils.device import full_float32


class ForwardOut(NamedTuple):
    kin: kinematics.KinOut
    vel: kinematics.VelOut
    M: torch.Tensor
    # dense Cholesky factor of M, or None where the block-arrow factor was
    # used (arrow.layout(sys) is not None)
    M_chol: Optional[torch.Tensor]
    qfrc_smooth: torch.Tensor
    qacc_smooth: torch.Tensor
    # the candidate points' pos, dist, active and centers; their Jacobians
    # (jac, jac_rot) are not formed (None): the assembly builds the rows'
    # Jacobians for the selected points only
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
    # the smooth half in one launch on the card (ops/smooth.py): block-arrow
    # factor and qacc_smooth where the tree allows it; dense Cholesky
    # otherwise, exact algebra either way
    lay = arrow.layout(sys)
    sm = smooth.smooth_forward(sys, lay, qpos, qvel, ctrl)
    kin, M, fac, qacc_smooth = sm.kin, sm.M, sm.fac, sm.qacc_smooth
    M_chol = None
    if lay is None:
        M_chol = linalg.chol(M)
        qacc_smooth = linalg.cho_solve(M_chol, sm.qfrc_smooth)

    # collision and the rows of the constraint system, b included, in one
    # launch on the card (ops/assemble.py)
    asm = assemble.rows(sys, lay, kin.xpos, kin.xquat, kin.subtree_com,
                        kin.cdof, qpos, qvel, qacc_smooth)
    warmstart = (None if os.environ.get("NIGHTMARE_NO_WARMSTART")
                 else state.qacc_warmstart)
    # the solve, then its output stage in one launch on the card
    # (ops/solve_out.py): qfrc, qacc, the per-contact normal force (Σ pyramid
    # facet forces, or the normal row of an elliptic cone) and the touch
    # sensors read from it
    sol, sensordata = solver.solve_rows(sys, asm.rows, qacc_smooth, lay=lay,
                                        fac=fac, M=M, M_chol=M_chol,
                                        warmstart=warmstart)
    return ForwardOut(kin, sm.vel, M, M_chol, sm.qfrc_smooth, qacc_smooth,
                      asm.con, sol, sm.act, sensordata)


@full_float32()
def step(sys: S.System, state: S.State, ctrl: torch.Tensor,
         n_steps: int = 1) -> S.State:
    """Advance physics by ``n_steps`` timesteps with constant ctrl (the
    decimation loop of the reference env)."""
    lay = arrow.layout(sys)
    for _ in range(n_steps):
        fwd = forward(sys, state, ctrl)
        # the integrator's solve, mj_integratePos and the mj_checkPos/
        # mj_checkVel reset in one launch on the card (ops/integrate.py).
        # The reset frame keeps this step's sensordata and kinematics, as
        # the JAX package does.
        qpos, qvel, qacc_warmstart = integrate.integrate_update(
            sys, lay, state.qpos, state.qvel, fwd.M, fwd.qfrc_smooth,
            fwd.sol.qfrc_constraint, fwd.sol.qacc)
        state = state.replace(
            qpos=qpos,
            qvel=qvel,
            qacc_warmstart=qacc_warmstart,
            sensordata=fwd.sensordata,
            xpos=fwd.kin.xpos,
            xquat=fwd.kin.xquat,
            xipos=fwd.kin.xipos,
            cvel=fwd.vel.cvel,
            subtree_com=fwd.kin.subtree_com,
            qfrc_actuator=fwd.act.qfrc_actuator,
        )
    return state
