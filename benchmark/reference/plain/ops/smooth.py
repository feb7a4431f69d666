# A frozen copy of the port's ops/smooth.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
"""Plain versions of the port's ``ops/smooth.py``."""

from __future__ import annotations
from typing import NamedTuple, Optional
import torch
from benchmark.reference.plain.physics import arrow, dynamics, kinematics
from benchmark.reference.plain.physics import system as S


class SmoothOut(NamedTuple):
    kin: kinematics.KinOut
    vel: kinematics.VelOut
    M: torch.Tensor
    act: dynamics.ActOut
    qfrc_smooth: torch.Tensor
    fac: Optional[arrow.ArrowFac]      # None without a block-arrow layout
    qacc_smooth: Optional[torch.Tensor]


def plain(sys: S.System, lay: Optional[arrow.ArrowLayout], qpos: torch.Tensor,
          qvel: torch.Tensor, ctrl: torch.Tensor) -> SmoothOut:
    """The plain version: the port's functions, one statement per body."""
    kin = kinematics.kinematics(sys, qpos)
    vel = kinematics.com_vel(sys, kin, qvel)
    M = dynamics.crb(sys, kin)
    bias = dynamics.rne_bias(sys, kin, vel, qvel)
    act = dynamics.actuation(sys, qpos, qvel, ctrl)
    qfrc_smooth = act.qfrc_actuator + dynamics.passive(sys, qvel) - bias
    if lay is None:
        return SmoothOut(kin, vel, M, act, qfrc_smooth, None, None)
    fac = arrow.factor(lay, M)
    return SmoothOut(kin, vel, M, act, qfrc_smooth, fac,
                     arrow.solve_vec(lay, fac, qfrc_smooth))


def update_kind(sys: S.System) -> str:
    """The integrator's update, as the port's ``ops/smooth.py::model_plan``
    chooses it."""
    if sys.integrator == S.IMPLICITFAST:
        return "implicitfast"
    if bool(sys.eulerdamp) and bool((sys.dof_damping.cpu() > 0).any()):
        return "euler_damped"
    return "euler"


smooth_forward = plain
