"""Classical hexapod gait engine, batched over envs (port of
``nightmare_rl_tpu/engine/gait.py``, itself a re-derivation of nikengine).

- 7-state FSM: Idle, AdjustGetUp, GetUp, Sit, AdjustSit, Stand, Walk
  (engine.py:414-638);
- tripod/ripple/wave gait tables (engine.py:215-225);
- walk-state leg keep-out optimization: a 10-step reduction-factor line
  search over the 2-D min-distance between leg segments (engine.py:554-596);
- stance translate/rotate + cubic-Bezier swing interpolation
  (engine.py:606-622, modules/bezier.py);
- per-leg analytic 3-DoF IK with reachability clamping (engine.py:679-701);
- servo/URDF joint offsets (engine.py:123,201,715).

``update(cfg, state, t, lin (N,), ang (N,), cmd_state (N,), cmd_mode (N,))
-> (state, angles (N, 18))`` steps N engines in one call.  Where the JAX
package picks one FSM branch per env (``lax.switch``), every branch is
computed for all envs here and each env's is selected; the selection is a
``torch.where``/gather, so values of branches an env is not in never reach
it.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from nightmare_rl_tpu_torch.utils.device import constant, full_float32

# FSM state ids
IDLE, ADJ_GET_UP, GET_UP, SIT, ADJ_SIT, STAND, WALK = range(7)
# command states / modes
CMD_IDLE, CMD_AWAKE = 0, 1
MODE_STAND, MODE_WALK = 0, 1

PI = math.pi


def _default_legs():
    # geometry from engine.py:39-50,148-197
    STAND_MID_LEG_X = 26.0e-2
    STAND_OUT_LEG_X = 20.0e-2
    STAND_MID_LEG_Y = 0.0e-2
    STAND_OUT_LEG_Y = 20.0e-2
    BODY_LENGTH = 15.5e-2
    BODY_MID_WIDTH = 18.6e-2
    BODY_OUT_WIDTH = 13.7e-2
    STAND_HEIGHT = 10.0e-2
    offsets = np.array(
        [
            [BODY_OUT_WIDTH / 2, BODY_LENGTH / 2, 0],
            [BODY_MID_WIDTH / 2, 0, 0],
            [BODY_OUT_WIDTH / 2, -BODY_LENGTH / 2, 0],
            [-BODY_OUT_WIDTH / 2, -BODY_LENGTH / 2, 0],
            [-BODY_MID_WIDTH / 2, 0, 0],
            [-BODY_OUT_WIDTH / 2, BODY_LENGTH / 2, 0],
        ]
    )
    default_pose = np.array(
        [
            [STAND_OUT_LEG_X, STAND_OUT_LEG_Y, -STAND_HEIGHT],
            [STAND_MID_LEG_X, STAND_MID_LEG_Y, -STAND_HEIGHT],
            [STAND_OUT_LEG_X, -STAND_OUT_LEG_Y, -STAND_HEIGHT],
            [-STAND_OUT_LEG_X, -STAND_OUT_LEG_Y, -STAND_HEIGHT],
            [-STAND_MID_LEG_X, STAND_MID_LEG_Y, -STAND_HEIGHT],
            [-STAND_OUT_LEG_X, STAND_OUT_LEG_Y, -STAND_HEIGHT],
        ]
    )
    servo_offset = np.array(
        [PI / 4, 0, 0, 0, 0, 0, -PI / 4, 0, 0, PI / 4, 0, 0, 0, 0, 0,
         -PI / 4, 0, 0]
    )
    # sides: legs 1-3 RIGHT(1), 4-6 LEFT(0); rel convert (engine.py:203)
    rel_convert = np.array(
        [[1, 1, 1]] * 3 + [[-1, -1, 1]] * 3, dtype=np.float64
    )
    return offsets, default_pose, servo_offset, rel_convert


GAITS = {
    "tripod": np.array(
        [[1, 0, 1, 0, 1, 0], [0, 1, 0, 1, 0, 1]], dtype=bool
    ),
    "ripple": np.array(
        [
            [1, 0, 0, 0, 1, 0],
            [0, 1, 0, 1, 0, 0],
            [0, 0, 1, 0, 0, 1],
        ],
        dtype=bool,
    ),
    "wave": np.eye(6, dtype=bool),
}


@dataclass(frozen=True, eq=False)
class EngineCfg:
    # constants from engine.py:46-84
    leg_dim: torch.Tensor         # (3,) coxa, femur, tibia lengths
    pose_offset: torch.Tensor     # (6, 3)
    default_pose: torch.Tensor    # (6, 3)
    sit_pose: torch.Tensor        # (6, 3)
    servo_offset: torch.Tensor    # (18,)
    urdf_offset: torch.Tensor     # (18,)
    rel_convert: torch.Tensor     # (6, 3)
    gait: torch.Tensor            # (n_steps, 6) bool
    keepout: float = 0.03
    step_time: float = 1.0
    step_height: float = 5.0e-2
    engine_fps: float = 51.0
    time_get_up_adj: float = 1.0
    time_get_up: float = 2.5
    time_sit: float = 2.5


def make_cfg(gait: str = "tripod", engine_fps: float = 51.0,
             dtype: torch.dtype = torch.float64, device="cpu") -> EngineCfg:
    offsets, default_pose, servo_offset, rel_convert = _default_legs()
    urdf = np.array([0, -1.2734, -0.7854] * 6)
    sit = default_pose.copy()
    sit[:, 2] = 0.0

    def t(x):
        return torch.tensor(x, dtype=dtype, device=device)

    return EngineCfg(
        leg_dim=t([6.5e-2, 13.0e-2, 17.0e-2]),
        pose_offset=t(offsets),
        default_pose=t(default_pose),
        sit_pose=t(sit),
        servo_offset=t(servo_offset),
        urdf_offset=t(urdf),
        rel_convert=t(rel_convert),
        gait=torch.tensor(GAITS[gait], device=device),
        engine_fps=engine_fps,
    )


@dataclass
class EngineState:
    fsm: torch.Tensor             # (N,) int64 state id
    state_start: torch.Tensor     # (N,) time the current fsm state began
    pose: torch.Tensor            # (N, 6, 3) last commanded pose
    adj_start_pose: torch.Tensor  # (N, 6, 3) AdjustGetUp interpolation start
    gait_step: torch.Tensor       # (N,) int64
    gait_phase: torch.Tensor      # (N,) gait_step_state in [0, 1]
    last_step_pose: torch.Tensor  # (N, 6, 3)

    def replace(self, **kw) -> "EngineState":
        return dataclasses.replace(self, **kw)


def init_state(cfg: EngineCfg, num_envs: int) -> EngineState:
    N, dev = num_envs, cfg.default_pose.device
    pose = cfg.default_pose.expand(N, 6, 3).clone()
    zeros = torch.zeros(N, dtype=cfg.default_pose.dtype, device=dev)
    ints = torch.zeros(N, dtype=torch.long, device=dev)
    return EngineState(fsm=ints, state_start=zeros, pose=pose,
                       adj_start_pose=pose.clone(), gait_step=ints.clone(),
                       gait_phase=zeros.clone(), last_step_pose=pose.clone())


# ---------------------------------------------------------------------------
# geometry helpers (modules/math.py re-derivations), batched on leading dims
# ---------------------------------------------------------------------------


def _rotvec_apply(pose, rotvec):
    """Rotate each (..., 6, 3) row by the rotation vector (..., 3)
    (scipy R.from_rotvec semantics, modules/math.py:29-44)."""
    angle = torch.linalg.vector_norm(rotvec, dim=-1)
    axis = rotvec / torch.clamp_min(angle, 1e-12)[..., None]
    c, s = torch.cos(angle)[..., None, None], torch.sin(angle)[..., None, None]
    axis = axis[..., None, :]
    # Rodrigues: v' = v·cosθ + (k×v)·sinθ + k·(k·v)·(1−cosθ)
    dot = torch.sum(pose * axis, dim=-1, keepdim=True)
    return (pose * c
            + torch.linalg.cross(axis.expand_as(pose), pose) * s
            + axis * dot * (1 - c))


def _masked(new, old, mask):
    return torch.where(mask[..., None], new, old)


def _asym_sigmoid(v):
    return 1.0 / (1.0 + torch.exp(-13.0 * (v - 0.5)))


def _bezier4(t, p0, p1, p2, p3):
    u = 1.0 - t
    return u**3 * p0 + 3 * u**2 * t * p1 + 3 * u * t**2 * p2 + t**3 * p3


def _seg_point_dist(p1, p2, p):
    """Point-to-segment distance in 2D, batched on leading dims."""
    d = p2 - p1
    denom = torch.clamp_min(torch.sum(d * d, dim=-1), 1e-12)
    t = torch.clamp(torch.sum((p - p1) * d, dim=-1) / denom, 0.0, 1.0)
    proj = p1 + t[..., None] * d
    return torch.linalg.vector_norm(p - proj, dim=-1)


def _ccw(a, b, c):
    return ((c[..., 1] - a[..., 1]) * (b[..., 0] - a[..., 0])
            > (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))


def _segments_intersect(a, b, c, d):
    return (_ccw(a, c, d) != _ccw(b, c, d)) & (_ccw(a, b, c) != _ccw(a, b, d))


def _seg_seg_dist(p1a, p1b, p2a, p2b):
    inter = _segments_intersect(p1a, p1b, p2a, p2b)
    d = torch.minimum(
        torch.minimum(_seg_point_dist(p1a, p1b, p2a),
                      _seg_point_dist(p1a, p1b, p2b)),
        torch.minimum(_seg_point_dist(p2a, p2b, p1a),
                      _seg_point_dist(p2a, p2b, p1b)),
    )
    return torch.where(inter, 0.0, d)


# ---------------------------------------------------------------------------
# IK (engine.py:679-701)
# ---------------------------------------------------------------------------


def relative_ik(rel_pos, leg_dim):
    """rel_pos (..., 3) → joint angles (..., 3)."""
    x, y = rel_pos[..., 0], rel_pos[..., 1]
    CX, FM, TB = leg_dim[0], leg_dim[1], leg_dim[2]
    eps = 1e-6

    r_xy = torch.sqrt(x**2 + y**2)
    coxa_tip = (torch.stack([x, y, torch.zeros_like(x)], dim=-1)
                / torch.clamp_min(r_xy, 1e-12)[..., None] * CX)
    delta = rel_pos - coxa_tip
    dist = torch.linalg.vector_norm(delta, dim=-1)
    director = delta / torch.clamp_min(dist, 1e-12)[..., None]
    # reachability clamp (too far / too close)
    clamped = torch.clamp(dist, torch.abs(FM - TB) + eps, FM + TB - eps)
    pos = torch.where(
        ((dist > FM + TB) | (dist < torch.abs(FM - TB)))[..., None],
        coxa_tip + clamped[..., None] * director,
        rel_pos,
    )
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]

    d1 = torch.sqrt(y**2 + x**2) - CX
    d = torch.sqrt(z**2 + d1**2)
    dm = torch.clamp_min(d, 1e-12)
    alpha = -torch.arctan2(y, x)
    nz = torch.where(torch.abs(z) < eps, eps, z)
    acos1 = torch.arccos(torch.clamp(
        (z**2 + d**2 - d1**2) / (2.0 * (-nz) * dm), -1.0, 1.0))
    acos2 = torch.arccos(torch.clamp(
        (FM**2 + d**2 - TB**2) / (2.0 * FM * dm), -1.0, 1.0))
    beta = acos1 + acos2
    gamma = -torch.arccos(torch.clamp(
        (FM**2 + TB**2 - d**2) / (2.0 * FM * TB), -1.0, 1.0)) + 2.0 * PI
    return torch.stack([alpha, beta - PI / 2.0, gamma - 1.5 * PI], dim=-1)


def pose_to_angles(cfg: EngineCfg, pose: torch.Tensor) -> torch.Tensor:
    """set_hardware_pose (engine.py:703-708) + URDF offsets (:715):
    pose (N, 6, 3) → angles (N, 18)."""
    rel = (pose - cfg.pose_offset) * cfg.rel_convert
    angles = relative_ik(rel, cfg.leg_dim).reshape(pose.shape[0], 18)
    return angles + cfg.servo_offset + cfg.urdf_offset


# ---------------------------------------------------------------------------
# Walk state (engine.py:539-630)
# ---------------------------------------------------------------------------


def _stance_move(pose, walk_trasl, walk_rot, tmf):
    """Stance legs translate/rotate opposite the commanded motion; tmf
    (...,) broadcasts against pose (..., 6, 3)."""
    tm = tmf[..., None, None]
    return _rotvec_apply(pose + (-walk_trasl)[..., None, :] * tm,
                         -walk_rot * tmf[..., None])


def _step_target(cfg, walk_trasl, walk_rot, tmf_step):
    """Where a swing leg lands: the default pose moved by the command."""
    return _rotvec_apply(
        cfg.default_pose + walk_trasl[..., None, :] * tmf_step[..., None, None],
        walk_rot * tmf_step[..., None])


def _walk_predict_cost(cfg, pose, gait_mask, phase, walk_trasl, walk_rot,
                       n_gait, red):
    """cost(x) from engine.py:554-583: predicted min leg distance deficit.
    red (R, 1) candidate factors → (R, N)."""
    ground = ~gait_mask
    tmf = red * 2.0 * n_gait * (1.0 - phase)
    moved = _masked(_stance_move(pose, walk_trasl, walk_rot, tmf), pose, ground)
    target = _step_target(cfg, walk_trasl, walk_rot, red * cfg.step_time)
    predicted = _masked(target, moved, gait_mask)

    tips = predicted[..., :2]
    roots = cfg.pose_offset[:, :2].expand_as(tips)
    # every ordered pair of legs (i, j), i != j
    ii = torch.arange(6, device=pose.device).repeat_interleave(6)
    jj = torch.arange(6, device=pose.device).repeat(6)
    d = _seg_seg_dist(tips[..., ii, :], roots[..., ii, :],
                      tips[..., jj, :], roots[..., jj, :])
    d = torch.where(ii != jj, d, math.inf)
    deficit = cfg.keepout - torch.amin(d, dim=-1)
    return torch.clamp_min(deficit, 0.0)


def walk_reduction(cfg: EngineCfg, es: EngineState, walk_trasl, walk_rot):
    """The reduction-factor line search (engine.py:586-596): red starts at 1
    and decrements by 0.1 until cost < 0.01; falls through to 0.  → (N,)"""
    n_gait = cfg.gait.shape[0]
    gait_mask = cfg.gait[es.gait_step]
    reds = 1.0 - 0.1 * torch.arange(10, dtype=es.pose.dtype,
                                    device=es.pose.device)
    costs = _walk_predict_cost(cfg, es.pose, gait_mask, es.gait_phase,
                               walk_trasl, walk_rot, n_gait, reds[:, None])
    ok = costs < 0.01
    # the first passing factor: argmax of the int cast takes the first max
    first = torch.argmax(ok.to(torch.int32), dim=0)
    return torch.where(ok.any(dim=0), reds[first], 0.0)


def _walk(cfg: EngineCfg, es: EngineState, lin_speed, ang_speed):
    n_gait = cfg.gait.shape[0]
    dt, dev = es.pose.dtype, es.pose.device
    # constants made once: a tensor built here would be a host-to-device
    # copy on every tick
    walk_trasl = constant((0.0, 1.0, 0.0), dt, dev) * lin_speed[:, None]
    walk_rot = constant((0.0, 0.0, 1.0), dt, dev) * ang_speed[:, None]
    gait_mask = cfg.gait[es.gait_step]
    red = walk_reduction(cfg, es, walk_trasl, walk_rot)

    # stance legs: translate/rotate opposite the commanded motion (:606-609)
    ground = ~gait_mask
    tmf = red * (1.0 / cfg.engine_fps) * 2.0 * n_gait
    temp = _masked(_stance_move(es.pose, walk_trasl, walk_rot, tmf), es.pose,
                   ground)

    # swing legs: cubic Bezier toward the predicted target (:612-622)
    target = _step_target(cfg, walk_trasl, walk_rot, red * cfg.step_time)
    lift = constant((0.0, 0.0, cfg.step_height), dt, dev)
    sw = _bezier4(
        es.gait_phase[:, None, None],
        es.last_step_pose,
        es.last_step_pose + lift,
        target + lift,
        target,
    )
    new_pose = _masked(sw, temp, gait_mask)

    # phase advance (:625-630)
    phase = es.gait_phase + n_gait / (cfg.step_time * cfg.engine_fps)
    rollover = phase > 1.0
    gait_step = torch.where(rollover, (es.gait_step + 1) % n_gait, es.gait_step)
    # on rollover the reference snapshots the *incoming* pose (pre-update)
    last_step_pose = torch.where(rollover[:, None, None], es.pose,
                                 es.last_step_pose)
    phase = torch.where(rollover, 0.0, phase)
    return new_pose, gait_step, phase, last_step_pose


def _lerp_pose(start, end, w):
    """start + (end − start)·w with w (N,)."""
    return start + (end - start) * w[:, None, None]


@full_float32()
def update(cfg: EngineCfg, es: EngineState, t, lin_speed, ang_speed,
           cmd_state: torch.Tensor, cmd_mode: torch.Tensor
           ) -> Tuple[EngineState, torch.Tensor]:
    """One engine tick of N envs (EngineNode.update, engine.py:710-715).

    t: the clock (a float, a 0-dim tensor or (N,)); lin_speed, ang_speed (N,);
    cmd_state (N,): CMD_IDLE | CMD_AWAKE;  cmd_mode (N,): MODE_STAND |
    MODE_WALK.  Returns (new_state, joint angles (N, 18))."""
    N = es.fsm.shape[0]
    dt, dev = es.pose.dtype, es.pose.device
    task_t = t - es.state_start
    awake = cmd_state == CMD_AWAKE
    idle_cmd = cmd_state == CMD_IDLE
    walk_mode = cmd_mode == MODE_WALK
    default = cfg.default_pose.expand(N, 6, 3)
    sit_pose = cfg.sit_pose.expand(N, 6, 3)

    def const(v):
        return torch.full((N,), v, dtype=torch.long, device=dev)

    # idle
    idle_nxt = torch.where(awake, ADJ_GET_UP, IDLE)
    # adjust get-up
    adv = task_t / cfg.time_get_up_adj
    adj_pose = torch.where(
        (adv < 1.0)[:, None, None],
        _lerp_pose(es.adj_start_pose, sit_pose, torch.clamp_max(adv, 1.0)),
        sit_pose)
    adj_nxt = torch.where(adv >= 2.0, GET_UP, ADJ_GET_UP)
    # get up
    adv = task_t / cfg.time_get_up
    up_pose = torch.where(
        (adv < 1.0)[:, None, None],
        _lerp_pose(sit_pose, default, _asym_sigmoid(torch.clamp_max(adv, 1.0))),
        default)
    done = adv > 1.0
    up_nxt = torch.where(done & idle_cmd, ADJ_SIT,
                         torch.where(done & (cmd_mode == MODE_STAND), STAND,
                                     torch.where(done, WALK, GET_UP)))
    # sit
    adv = task_t / cfg.time_sit
    sit_now = torch.where(
        (adv < 1.0)[:, None, None],
        _lerp_pose(default, sit_pose, _asym_sigmoid(torch.clamp_max(adv, 1.0))),
        sit_pose)
    sit_nxt = torch.where(adv >= 1.0, IDLE, SIT)
    # stand
    stand_nxt = torch.where(awake & walk_mode, WALK,
                            torch.where(idle_cmd, ADJ_SIT, STAND))
    # walk
    w_pose, w_step, w_phase, w_lsp = _walk(cfg, es, lin_speed, ang_speed)
    keep = (awake & walk_mode) | (es.gait_phase != 0.0)
    walk_nxt = torch.where(keep, WALK, torch.where(idle_cmd, IDLE, STAND))
    w_pose = torch.where(keep[:, None, None], w_pose, es.pose)
    w_step = torch.where(keep, w_step, 0)
    w_phase = torch.where(keep, w_phase, 0.0)
    w_lsp = torch.where(keep[:, None, None], w_lsp, es.last_step_pose)

    # each env takes its own state's branch (the lax.switch of the JAX package)
    rows = torch.arange(N, device=dev)
    nxt = torch.stack([idle_nxt, adj_nxt, up_nxt, sit_nxt, const(SIT),
                       stand_nxt, walk_nxt])[es.fsm, rows].to(torch.long)
    pose = torch.stack([es.pose, adj_pose, up_pose, sit_now, default,
                        default, w_pose])[es.fsm, rows]
    walking = es.fsm == WALK
    gait_step = torch.where(walking, w_step, es.gait_step)
    gait_phase = torch.where(walking, w_phase, es.gait_phase)
    last_step_pose = torch.where(walking[:, None, None], w_lsp,
                                 es.last_step_pose)

    transitioned = nxt != es.fsm
    to_walk = transitioned & (nxt == WALK)
    to_adj = transitioned & (nxt == ADJ_GET_UP)
    es = EngineState(
        fsm=nxt,
        state_start=torch.where(
            transitioned, torch.as_tensor(t, dtype=dt, device=dev),
            es.state_start),
        # AdjustGetUp snapshots the pose at entry (engine.py:431-433)
        adj_start_pose=torch.where(to_adj[:, None, None], es.pose,
                                   es.adj_start_pose),
        # Walk snapshots last_step_pose at entry (engine.py:539-543)
        last_step_pose=torch.where(to_walk[:, None, None], pose, last_step_pose),
        gait_phase=torch.where(to_walk, 0.0, gait_phase),
        gait_step=torch.where(to_walk, 0, gait_step),
        pose=pose,
    )
    return es, pose_to_angles(cfg, pose)
