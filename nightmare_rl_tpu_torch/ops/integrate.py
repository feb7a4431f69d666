"""The integrator's update of a physics substep as one CUDA kernel per call.

``integrate_update`` computes what ``physics/pipeline.py::step`` does after
``forward`` (the port of the JAX package's compiled update,
``nightmare_rl_tpu/physics/pipeline.py:125-191``): the implicitfast solve
(M - h·diag(vel_deriv - damping)) qacc = qfrc_smooth + qfrc_constraint,
or Euler's with implicit joint damping (M + h·diag(B)) v⁺ = M v + h·qfrc,
or plain Euler; then mj_integratePos and the mj_checkPos/mj_checkVel reset
(qpos to qpos0, qvel and the next warmstart to 0 where qpos or qvel is not
finite or reaches 1e10).  It returns the next qpos, qvel and qacc_warmstart.

CPU tensors go to the plain version ``plain_update``.  CUDA tensors of a
model with a block-arrow layout go to the kernel ``csrc/integrate.cu``
(its per-env arithmetic is ``csrc/smooth_env.cuh``'s ``update_one``, whose
arrow factor the smooth kernel shares); a model without a layout keeps the
plain update on every device, a choice made from the model's structure.
Both read the actuators' velocity derivative gear²·b2 from the model
(``dynamics.actuator_vel_deriv``; the kernel through its static tables,
``ops/smooth.py::tables``).  A failed build or launch raises.  ``integrate_update.launches`` counts kernel launches.

``host_update`` runs the kernel's per-env arithmetic on the CPU through
the host driver ``csrc/smooth_host.cpp``, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from nightmare_rl_tpu_torch.core import quat as Q
from nightmare_rl_tpu_torch.ops import build, linalg
from nightmare_rl_tpu_torch.ops import smooth as SM
from nightmare_rl_tpu_torch.physics import arrow, dynamics
from nightmare_rl_tpu_torch.physics import system as S

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
    update = SM.model_plan(sys, lay).update
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


def _operands(sys: S.System, *xs: torch.Tensor):
    qpos = xs[0]
    N, dt, dev = qpos.shape[0], qpos.dtype, qpos.device
    shapes = [(N, sys.nq), (N, sys.nv), (N, sys.nv, sys.nv)] + [(N, sys.nv)] * 3
    names = ("qpos", "qvel", "M", "qfrc_smooth", "qfrc_constraint", "qacc")
    for name, x, shape in zip(names, xs, shapes):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != dt or x.device != dev:
            raise ValueError("integrate_update's operands must share one "
                             "dtype and device")
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"the integrate kernel takes float32 or float64, "
                         f"not {dt}")
    return [x.contiguous() for x in xs]


def _argtypes(fn, tail):
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 11
                   + [ctypes.c_int] + tail)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_fn(dtype: torch.dtype):
    fn = getattr(build.load("integrate"), "integrate_f32"
                 if dtype == torch.float32 else "integrate_f64")
    return _argtypes(fn, [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def integrate_update(sys: S.System, lay: Optional[arrow.ArrowLayout],
                     qpos: torch.Tensor, qvel: torch.Tensor, M: torch.Tensor,
                     qfrc_smooth: torch.Tensor, qfrc_constraint: torch.Tensor,
                     qacc: torch.Tensor) -> Update:
    """The update of ``pipeline.step``: the CUDA kernel for CUDA tensors of
    a model with a block-arrow layout, the plain version otherwise."""
    plan = SM.model_plan(sys, lay)
    dev = qpos.device
    if dev.type == "cpu" or lay is None:
        return plain_update(sys, lay, qpos, qvel, M, qfrc_smooth,
                            qfrc_constraint, qacc)
    xs = _operands(sys, qpos, qvel, M, qfrc_smooth, qfrc_constraint, qacc)
    if dev.type != "cuda":
        raise ValueError(f"integrate_update runs on cpu or cuda, not {dev}")
    geo = SM.kernel_geometry(plan.fields, qpos.element_size(), "integrate")
    outs = (torch.empty_like(xs[0]), torch.empty_like(xs[1]),
            torch.empty_like(xs[1]))
    N = qpos.shape[0]
    if N == 0:
        return outs
    tab = SM.tables(sys, lay, qpos.dtype, dev)
    lt = SM.layout(sys, lay)
    q, v, m, fs, fc, a = xs
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel_fn(qpos.dtype)(
            lt, len(lt), tab.topo.data_ptr(), tab.cst.data_ptr(),
            m.data_ptr(), fs.data_ptr(), fc.data_ptr(), a.data_ptr(),
            q.data_ptr(), v.data_ptr(), *[o.data_ptr() for o in outs], N,
            geo.envs_per_block, geo.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"integrate kernel launch failed: cudaError_t {err}")
    _counted.launches += 1
    return outs


integrate_update.launches = 0
_counted = integrate_update  # counts on, where a caller wraps the module's name


def host_update(sys: S.System, lay: arrow.ArrowLayout, qpos: torch.Tensor,
                qvel: torch.Tensor, M: torch.Tensor,
                qfrc_smooth: torch.Tensor, qfrc_constraint: torch.Tensor,
                qacc: torch.Tensor, team: int = 1) -> Update:
    """The kernel's per-env arithmetic on CPU tensors, through the host
    driver ``csrc/smooth_host.cpp`` with a team of ``team`` threads (1 to
    64), for a model with a block-arrow layout.  For the tests; raises
    RuntimeError where g++ is missing."""
    if lay is None:
        raise ValueError("the integrate kernel takes a block-arrow layout")
    plan = SM.model_plan(sys, lay)
    SM.kernel_geometry(plan.fields, qpos.element_size(), "integrate")
    q, v, m, fs, fc, a = _operands(sys, qpos, qvel, M, qfrc_smooth,
                                   qfrc_constraint, qacc)
    if q.device.type != "cpu":
        raise ValueError("host_update takes CPU tensors")
    outs = (torch.empty_like(q), torch.empty_like(v), torch.empty_like(v))
    tab = SM.tables(sys, lay, q.dtype, q.device)
    lt = SM.layout(sys, lay, host=True)
    fn = getattr(build.load_host("smooth_host"), "integrate_host_f32"
                 if q.dtype == torch.float32 else "integrate_host_f64")
    err = _argtypes(fn, [ctypes.c_int])(
        lt, len(lt), tab.topo.data_ptr(), tab.cst.data_ptr(), m.data_ptr(),
        fs.data_ptr(), fc.data_ptr(), a.data_ptr(), q.data_ptr(),
        v.data_ptr(), *[o.data_ptr() for o in outs], q.shape[0], team)
    if err != 0:
        raise RuntimeError(f"integrate host driver refused its arguments "
                           f"({err})")
    return outs
