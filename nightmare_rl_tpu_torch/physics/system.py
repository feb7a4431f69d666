"""Static model description (System) and batched dynamic state (State).

Port of ``nightmare_rl_tpu/physics/system.py``.  The System holds the
compiled robot model: sizes and tree topology stay Python ints and tuples
(the per-body loops run over them on the host), numeric constants are
tensors on one device.  The State is batched-first: every field has a
leading env dimension.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# Joint types (subset of MuJoCo's mjtJoint we support)
FREE = 0
BALL = 1
SLIDE = 2
HINGE = 3

# Integrators
EULER = 0
IMPLICITFAST = 1

# Constraint solvers (mjtSolver values)
SOLVER_PGS = 0
SOLVER_CG = 1
SOLVER_NEWTON = 2

# Friction cones (mjtCone values)
PYRAMIDAL = 0
ELLIPTIC = 1


@dataclass(eq=False)  # hashed by identity: per-System caches key on it
class System:
    # ---- sizes ----
    nq: int
    nv: int
    nu: int
    nbody: int
    njnt: int
    nsite: int
    nsensor: int
    ncp: int
    # ---- tree topology (index-aligned with MuJoCo) ----
    body_parent: Tuple[int, ...]
    body_jntadr: Tuple[int, ...]
    body_jntnum: Tuple[int, ...]
    jnt_type: Tuple[int, ...]
    jnt_bodyid: Tuple[int, ...]
    jnt_qposadr: Tuple[int, ...]
    jnt_dofadr: Tuple[int, ...]
    dof_bodyid: Tuple[int, ...]
    actuator_trnid: Tuple[int, ...]
    site_bodyid: Tuple[int, ...]
    cpoint_bodyid: Tuple[int, ...]
    cpoint_sensor: Tuple[int, ...]
    integrator: int
    solver_iterations: int
    noslip_iterations: int
    # ---- numeric constants ----
    body_pos: torch.Tensor      # (nbody, 3)
    body_quat: torch.Tensor     # (nbody, 4)
    body_ipos: torch.Tensor     # (nbody, 3)
    body_iquat: torch.Tensor    # (nbody, 4)
    body_mass: torch.Tensor     # (nbody,)
    body_inertia: torch.Tensor  # (nbody, 3)
    body_invweight: torch.Tensor  # (nbody, 2)
    jnt_axis: torch.Tensor      # (njnt, 3)
    jnt_pos: torch.Tensor       # (njnt, 3)
    jnt_range: torch.Tensor     # (njnt, 2)
    jnt_limited: torch.Tensor   # (njnt,) bool
    jnt_solref: torch.Tensor    # (njnt, 2)
    jnt_solimp: torch.Tensor    # (njnt, 5)
    dof_solref: torch.Tensor    # (nv, 2)
    dof_solimp: torch.Tensor    # (nv, 5)
    dof_damping: torch.Tensor   # (nv,)
    dof_armature: torch.Tensor  # (nv,)
    dof_frictionloss: torch.Tensor  # (nv,)
    dof_invweight: torch.Tensor  # (nv,)
    qpos0: torch.Tensor         # (nq,)
    actuator_gear: torch.Tensor       # (nu,)
    actuator_gainprm: torch.Tensor    # (nu,)
    actuator_biasprm: torch.Tensor    # (nu, 3)
    actuator_ctrlrange: torch.Tensor  # (nu, 2)
    actuator_ctrllimited: torch.Tensor  # (nu,)
    actuator_forcerange: torch.Tensor   # (nu, 2)
    actuator_forcelimited: torch.Tensor  # (nu,)
    site_pos: torch.Tensor      # (nsite, 3)
    site_quat: torch.Tensor     # (nsite, 4)
    cpoint_pos: torch.Tensor    # (ncp, 3) body frame
    cpoint_radius: torch.Tensor  # (ncp,)
    cpoint_friction: torch.Tensor  # (ncp,)
    cpoint_solref: torch.Tensor    # (ncp, 2)
    cpoint_solimp: torch.Tensor    # (ncp, 5)
    cpair_a: torch.Tensor          # (npair,) cpoint index
    cpair_b: torch.Tensor          # (npair,)
    cpair_friction: torch.Tensor   # (npair,)
    cpair_solref: torch.Tensor     # (npair, 2)
    cpair_solimp: torch.Tensor     # (npair, 5)
    sensor_cpoint_matrix: torch.Tensor  # (nsensor, ncp)
    gravity: torch.Tensor       # (3,)
    timestep: torch.Tensor      # ()
    dof_ancestor_mask: torch.Tensor  # (nv, nv)
    body_dof_mask: torch.Tensor      # (nbody, nv)
    # ---- options with defaults (as in the JAX System) ----
    max_contacts: int = -1
    eulerdamp: bool = True
    max_pair_contacts: int = 4
    cpoint_condim: Tuple[int, ...] = ()
    impratio: float = 1.0
    cpoint_friction_rot: Optional[torch.Tensor] = None
    solver_type: int = SOLVER_PGS
    cone: int = PYRAMIDAL
    ls_iterations: int = 50
    ls_refine: int = 8

    @property
    def dtype(self) -> torch.dtype:
        return self.qpos0.dtype

    @property
    def device(self) -> torch.device:
        return self.qpos0.device


@dataclass
class State:
    """Dynamic per-env state carried between physics steps, (N, ...)."""

    qpos: torch.Tensor            # (N, nq)
    qvel: torch.Tensor            # (N, nv)
    qacc_warmstart: torch.Tensor  # (N, nv)
    sensordata: torch.Tensor      # (N, nsensor)
    xpos: torch.Tensor            # (N, nbody, 3)
    xquat: torch.Tensor           # (N, nbody, 4)
    xipos: torch.Tensor           # (N, nbody, 3)
    cvel: torch.Tensor            # (N, nbody, 6)
    subtree_com: torch.Tensor     # (N, nbody, 3)
    qfrc_actuator: torch.Tensor   # (N, nv)

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


def tree_cast(sys: System, dtype: torch.dtype) -> System:
    """Cast every floating-point tensor of the System to dtype."""
    kw = {}
    for f in dataclasses.fields(sys):
        v = getattr(sys, f.name)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            kw[f.name] = v.to(dtype)
    return dataclasses.replace(sys, **kw)


@functools.lru_cache(maxsize=None)
def index_tensor(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A static index tuple as a long tensor on ``device``, made once."""
    return torch.tensor(values, dtype=torch.long, device=device)
