"""The task half of an env step (everything of ``envs/nightmare_v3.py``'s
and ``envs/anymal_c.py``'s step around ``pipeline.step``) as two CUDA
kernel launches per step.

``pre`` computes the actions and the controls from the policy's raw
actions, before the physics; ``post`` everything after ``pipeline.step``:
the readings, command resampling, terminations, the reset bookkeeping, the
reward terms and the observation (the port of the JAX package's compiled
env step around the physics, ``nightmare_rl_tpu/envs/nightmare_v3.py:
182-361`` and ``nightmare_rl_tpu/envs/anymal_c.py:183-293``).  CPU tensors
go to the plain versions ``plain_nightmare_v3_pre`` / ``_post`` and
``plain_anymal_c_pre`` / ``_post`` (the envs' step code, whose eager ops
are ~150 small launches per step on the card); CUDA tensors go to the
kernels ``csrc/task.cu`` (a team of eight lanes per env; the per-env
arithmetic is ``csrc/task_env.cuh``), and a failed build or launch raises.
``pre.launches`` and ``post.launches`` count kernel launches.

The random numbers stay the env's ``torch.rand`` draws, in the plain
version's count, shape and order (``draws``: the commands' uniforms, the
resample's first; ``noise``: the observation noise's, where ``add_noise``):
``post`` maps them to commands and noise, as the plain version does, so
every run draws the numbers it drew before.

``plan`` reads an env's config once (at the env's construction): the
active reward terms and their dt-premultiplied scales, the contact modes,
``add_noise`` and its noise vector, the command ranges and cuts,
``resample_every``, ``max_episode_length``, the termination thresholds and
the observation scales, into the kernels' parameter blocks (filled by the
names the library reports) and one table of constants on the env's device.
A config the kernels do not take is refused there with ValueError, on
every device.

What bounds the kernels: a few KB an env, ~1 us of bytes at 2048 envs,
well under a launch's latency (chip_smoke.py's task-kernel phase counts a
call's bytes); see ``csrc/task.cu``.

``host_pre`` and ``host_post`` run the same per-env arithmetic on CPU
tensors through the host driver ``csrc/task_host.cpp`` (built with g++),
for the tests.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from nightmare_rl_tpu_torch.core import quat as Q
from nightmare_rl_tpu_torch.ops import build

NIGHTMARE_V3, ANYMAL_C = 0, 1          # task_env.cuh Robot
MAX_TERMS = 16                         # task_env.cuh kMaxTerms
MAX_TEAM = 64                          # task_env.cuh kMaxTeam
# the reward terms each kernel computes, by id: each robot's REWARD_NAMES
# order (task_env.cuh NightmareTerm, AnymalTerm)
TERMS = {
    NIGHTMARE_V3: (
        "termination", "tracking_lin_vel", "tracking_ang_vel", "dof_acc",
        "action_rate", "body_contact_forces", "default_position",
        "orientation", "lin_vel_z", "ang_vel_xy", "feet_air_time", "torques",
        "base_height", "feet_contact_forces", "dof_vel", "stand_still"),
    ANYMAL_C: (
        "termination", "tracking_lin_vel", "tracking_ang_vel", "lin_vel_z",
        "ang_vel_xy", "orientation", "torques", "dof_acc", "action_rate",
        "feet_air_time", "feet_contact_forces", "stand_still"),
}
DRAWS = {NIGHTMARE_V3: 4, ANYMAL_C: 6}   # command draws per step
# post's operands and outputs, in task_env.cuh's PostIn and PostOut order
POST_INS = ("qpos", "qvel", "cvel", "xipos", "qfrc_actuator", "sensordata",
            "episode_length", "commands", "prev_actions", "actions",
            "prev_dof_vel", "feet_air_time", "last_contacts",
            "last_contacts_filt", "episode_sums", "draw0", "draw1", "draw2",
            "draw3", "draw4", "draw5", "noise")
POST_OUTS = ("qpos", "qvel", "episode_length", "commands", "dof_pos",
             "dof_vel", "feet_air_time", "last_contacts",
             "last_contacts_filt", "episode_sums", "obs", "reward",
             "reward_terms", "finished", "reset", "time_out")


class PostOut(NamedTuple):
    """What ``post`` returns: the reset physics qpos and qvel (new tensors;
    the pipeline's own stay as the step left them), the new EnvState's
    arrays and the StepOut's."""

    qpos: torch.Tensor
    qvel: torch.Tensor
    episode_length: torch.Tensor
    commands: torch.Tensor
    dof_pos: torch.Tensor
    dof_vel: torch.Tensor
    feet_air_time: torch.Tensor
    last_contacts: torch.Tensor
    last_contacts_filt: Optional[torch.Tensor]   # nightmare_v3's only
    episode_sums: torch.Tensor
    obs: torch.Tensor
    reward: torch.Tensor
    reward_terms: torch.Tensor
    finished: torch.Tensor        # the finished episodes' sums, NaN elsewhere
    reset: torch.Tensor
    time_out: torch.Tensor


# ---------------------------------------------------------------------------
# the plain versions (the envs' step code)
# ---------------------------------------------------------------------------


def nightmare_v3_commands(env, u_vx: torch.Tensor,
                          u_wz: torch.Tensor) -> torch.Tensor:
    """_resample_commands (:321-333) from two uniform draws: vx ∈
    ±max_lin_vel_x, vy ≡ 0, ωz ∈ ±max_ang_vel; zero xy commands with norm
    ≤ 0.02."""
    r = env.cfg.commands.ranges

    def uniform(u, lo, hi):
        return lo + (hi - lo) * u

    vx = uniform(u_vx, -r.max_lin_vel_x, r.max_lin_vel_x)
    wz = uniform(u_wz, -r.max_ang_vel, r.max_ang_vel)
    xy = torch.stack([vx, torch.zeros_like(vx)], dim=1)
    xy = xy * (torch.linalg.vector_norm(xy, dim=1, keepdim=True) > 0.02)
    return torch.cat([xy, wz[:, None]], dim=1)


def anymal_c_commands(env, u_vx: torch.Tensor, u_vy: torch.Tensor,
                      u_wz: torch.Tensor) -> torch.Tensor:
    """vx ∈ ±max_lin_vel_x, vy ∈ ±max_lin_vel_y, ωz ∈ ±max_ang_vel from
    three uniform draws; xy commands with norm ≤ 0.05 are zeroed."""
    c = env.cfg

    def uniform(u, bound):
        return -bound + 2.0 * bound * u

    vx = uniform(u_vx, c.max_lin_vel_x)
    vy = uniform(u_vy, c.max_lin_vel_y)
    wz = uniform(u_wz, c.max_ang_vel)
    xy = torch.stack([vx, vy], dim=1)
    xy = xy * (torch.linalg.vector_norm(xy, dim=1, keepdim=True) > 0.05)
    return torch.cat([xy, wz[:, None]], dim=1)


def plain_nightmare_v3_pre(env, state, raw_actions: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """nightmare_v3's actions (scaled, clipped) and its control law
    (:183-188), which uses the last READ dof_pos (possibly stale across
    resets, mirroring the reference buffers)."""
    cfg, dtype = env.cfg, env.dtype
    actions = torch.clamp(raw_actions.to(dtype) * cfg.control.action_scale,
                          -cfg.normalization.clip_actions,
                          cfg.normalization.clip_actions)
    ctrl = (actions - env.default_dof_pos - state.dof_pos) * cfg.control.p_gain
    return actions, ctrl


def plain_nightmare_v3_post(env, state, actions: torch.Tensor, phys,
                            draws: Sequence[torch.Tensor],
                            noise: Optional[torch.Tensor]) -> PostOut:
    """nightmare_v3's step after the physics (``phys``: the state
    ``pipeline.step`` returned; ``draws``: the resample's two uniforms, then
    the reset's; ``noise``: the observation noise's uniforms)."""
    cfg, sys, dtype, dt = env.cfg, env.sys, env.dtype, env.dt

    prev_actions = state.actions
    prev_dof_vel = state.dof_vel
    episode_length = state.episode_length + 1

    # readings (:216-232)
    base_quat = Q.conj(phys.qpos[:, 3:7])
    body = 1  # base_link
    base_lin_vel = Q.rotate(phys.cvel[:, body, 3:6], base_quat)
    base_ang_vel = Q.rotate(phys.cvel[:, body, :3], base_quat)
    projected_gravity = Q.rotate(env._gravity, base_quat)
    dof_pos = phys.qpos[:, 7:]
    dof_vel = phys.qvel[:, 6:]
    base_height = phys.xipos[:, body, 2]
    feet_forces = phys.sensordata[:, 6:12]
    body_force = phys.sensordata[:, 12]
    tibia_forces = phys.sensordata[:, 0:6] * (feet_forces == 0)
    dof_acc = (dof_vel - prev_dof_vel) / dt

    # command resampling (:235-236)
    resample_every = int(cfg.commands.resampling_time / dt)
    new_cmd = nightmare_v3_commands(env, draws[0], draws[1])
    commands = torch.where((episode_length % resample_every == 0)[:, None],
                           new_cmd, state.commands)

    # termination (:239-256)
    time_out = episode_length > env.max_episode_length
    reset = time_out | (feet_forces.amax(dim=1) > cfg.env.termination_contact_force)
    if cfg.env.tibia_contact_mode == 2:
        reset |= tibia_forces.amax(dim=1) > cfg.env.tibia_max_contact_force
    if cfg.env.body_contact_mode == 2:
        reset |= body_force > cfg.env.body_max_contact_force
    cosang = -projected_gravity[:, 2] / torch.clamp_min(
        torch.linalg.vector_norm(projected_gravity, dim=1), 1e-9)
    reset |= torch.arccos(torch.clamp(cosang, -1.0, 1.0)) > 60.0 * math.pi / 180.0

    # ---- reset bookkeeping BEFORE rewards (reference order :274-288) ----
    reset_cmd = nightmare_v3_commands(env, draws[2], draws[3])
    r1 = reset[:, None]
    qpos_reset = torch.where(r1, sys.qpos0, phys.qpos)
    qvel_reset = torch.where(r1, torch.zeros_like(phys.qvel), phys.qvel)
    commands = torch.where(r1, reset_cmd, commands)
    feet_air_time = torch.where(r1, 0.0, state.feet_air_time)
    episode_length = torch.where(reset, 0, episode_length)
    finished_sums = torch.where(r1, state.episode_sums, torch.nan)
    episode_sums = torch.where(r1, 0.0, state.episode_sums)

    # ---- feet_air_time stateful update (runs only if the term is
    # active; the default scale is 0, so the buffers stay frozen) ----
    contact = feet_forces > 1.0
    contact_filt = contact | state.last_contacts
    fat = (state.feet_air_time + dt) * (contact_filt == state.last_contacts_filt)
    if "feet_air_time" in env.active_rewards:
        last_contacts, last_contacts_filt, feet_air_time_new = (
            contact, contact_filt, fat)
    else:
        last_contacts, last_contacts_filt, feet_air_time_new = (
            state.last_contacts, state.last_contacts_filt, feet_air_time)

    # ---- rewards (:277-288, functions :399-497) ----
    r = cfg.rewards
    values = {
        "lin_vel_z": torch.square(base_lin_vel[:, 2]),
        "ang_vel_xy": torch.sum(torch.square(base_ang_vel[:, :2]), dim=1),
        "orientation": torch.sum(torch.square(projected_gravity[:, :2]), dim=1),
        "base_height": torch.square(base_height - r.base_height_target),
        # qfrc_applied is never set (:222), so the torques term is zero
        "torques": torch.zeros_like(base_height),
        "dof_vel": torch.sum(torch.square(dof_vel), dim=1),
        "dof_acc": torch.sum(torch.square(dof_acc), dim=1),
        "action_rate": torch.sum(torch.square(prev_actions - actions), dim=1),
        "termination": (reset & ~time_out).to(dtype),
        "tracking_lin_vel": torch.exp(
            -torch.sum(torch.square(commands[:, :2] - base_lin_vel[:, :2]),
                       dim=1) / r.tracking_sigma),
        "tracking_ang_vel": torch.exp(
            -torch.square(commands[:, 2] - base_ang_vel[:, 2])
            / r.tracking_sigma),
        "feet_air_time": torch.sum(torch.square(
            (fat > 1.0) * (fat - 1.0) + (fat < 0.5) * (0.5 - fat)), dim=1),
        "body_contact_forces": (
            (torch.sum(tibia_forces, dim=1) if cfg.env.tibia_contact_mode == 1
             else 0.0)
            + (body_force if cfg.env.body_contact_mode == 1 else 0.0)),
        "stand_still": torch.sum(torch.abs(dof_pos - env.default_dof_pos), dim=1)
        * (torch.linalg.vector_norm(commands[:, :2], dim=1) < 0.01),
        "feet_contact_forces": torch.sum(torch.square(
            (feet_forces - r.max_contact_force)
            * (feet_forces > r.max_contact_force)), dim=1),
        "default_position": torch.sum(
            torch.square(dof_pos - env.default_dof_pos), dim=1),
    }
    reward_terms = torch.stack(
        [values[n] for n in env.active_rewards], dim=1) * env.reward_scales
    reward = torch.sum(reward_terms, dim=1)
    episode_sums = episode_sums + reward_terms

    # ---- observations (:291-309) ----
    s = cfg.normalization.obs_scales
    obs = torch.cat([
        base_lin_vel * s.lin_vel,
        base_ang_vel * s.ang_vel,
        projected_gravity,
        commands * env._cmd_scale,
        (dof_pos - env.default_dof_pos) * s.dof_pos,
        dof_vel * s.dof_vel,
        actions,
    ], dim=1)
    if cfg.noise.add_noise:
        obs = obs + (2.0 * noise - 1.0) * env._noise_scale_vec()
    clip_obs = cfg.normalization.clip_observations
    obs = torch.clamp(obs, -clip_obs, clip_obs)

    return PostOut(qpos_reset, qvel_reset, episode_length, commands, dof_pos,
                   dof_vel, feet_air_time_new, last_contacts,
                   last_contacts_filt, episode_sums, obs, reward,
                   reward_terms, finished_sums, reset, time_out)


def plain_anymal_c_pre(env, state, raw_actions: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """anymal_c's actions (clipped) and its position servo targets:
    default + action·scale."""
    actions = torch.clamp(raw_actions.to(env.dtype), -100.0, 100.0)
    ctrl = env.default_dof_pos + actions * env.cfg.action_scale
    return actions, ctrl


def plain_anymal_c_post(env, state, actions: torch.Tensor, phys,
                        draws: Sequence[torch.Tensor],
                        noise: Optional[torch.Tensor] = None) -> PostOut:
    """anymal_c's step after the physics (``draws``: the resample's three
    uniforms, then the reset's; anymal_c has no observation noise)."""
    cfg, sys, dtype, dt = env.cfg, env.sys, env.dtype, env.dt

    prev_actions = state.actions
    episode_length = state.episode_length + 1
    base_quat = Q.conj(phys.qpos[:, 3:7])
    lin_vel = Q.rotate(phys.cvel[:, 1, 3:6], base_quat)
    ang_vel = Q.rotate(phys.cvel[:, 1, :3], base_quat)
    gravity = Q.rotate(env._gravity, base_quat)
    dof_pos = phys.qpos[:, 7:]
    dof_vel = phys.qvel[:, 6:]
    dof_acc = (dof_vel - state.dof_vel) / dt
    torques = phys.qfrc_actuator[:, 6:]
    feet_forces = phys.sensordata[:, :env.num_feet]

    commands = torch.where(
        (episode_length % env.resample_every == 0)[:, None],
        anymal_c_commands(env, *draws[:3]), state.commands)

    time_out = episode_length > env.max_episode_length
    tilt = torch.arccos(torch.clamp(-gravity[:, 2] / 9.81, -1.0, 1.0))
    reset = time_out | (tilt > math.pi / 3)
    reset = reset | (feet_forces.amax(dim=1) > cfg.termination_contact_force)

    r1 = reset[:, None]
    commands = torch.where(r1, anymal_c_commands(env, *draws[3:6]), commands)
    qpos_reset = torch.where(r1, sys.qpos0, phys.qpos)
    qvel_reset = torch.where(r1, torch.zeros_like(phys.qvel), phys.qvel)
    episode_length = torch.where(reset, 0, episode_length)
    finished = torch.where(r1, state.episode_sums, torch.nan)
    episode_sums = torch.where(r1, 0.0, state.episode_sums)
    feet_air_time = torch.where(r1, 0.0, state.feet_air_time)

    # feet air time: reward the first contact after a swing (target swing
    # 0.5 s), only while commanded to move
    contact = feet_forces > 1.0
    contact_filt = contact | state.last_contacts
    first_contact = (feet_air_time > 0.0) & contact_filt
    fat = feet_air_time + dt
    moving = torch.linalg.vector_norm(commands[:, :2], dim=1)
    rew_air = torch.sum((fat - 0.5) * first_contact, dim=1) * (moving > 0.1)
    feet_air_time_new = fat * ~contact_filt

    sigma = cfg.tracking_sigma
    values = {
        "termination": (reset & ~time_out).to(dtype),
        "tracking_lin_vel": torch.exp(-torch.sum(
            torch.square(commands[:, :2] - lin_vel[:, :2]), dim=1) / sigma),
        "tracking_ang_vel": torch.exp(
            -torch.square(commands[:, 2] - ang_vel[:, 2]) / sigma),
        "lin_vel_z": torch.square(lin_vel[:, 2]),
        "ang_vel_xy": torch.sum(torch.square(ang_vel[:, :2]), dim=1),
        "orientation": torch.sum(torch.square(gravity[:, :2] / 9.81), dim=1),
        "torques": torch.sum(torch.square(torques), dim=1),
        "dof_acc": torch.sum(torch.square(dof_acc), dim=1),
        "action_rate": torch.sum(torch.square(actions - prev_actions), dim=1),
        "feet_air_time": rew_air,
        "feet_contact_forces": torch.sum(torch.square(
            (feet_forces - cfg.max_contact_force)
            * (feet_forces > cfg.max_contact_force)), dim=1),
        "stand_still": torch.sum(torch.abs(dof_pos - env.default_dof_pos),
                                 dim=1) * (moving < 0.1),
    }
    reward_terms = torch.stack(
        [values[n] for n in env.active_rewards], dim=1) * env.reward_scales
    reward = torch.sum(reward_terms, dim=1)
    episode_sums = episode_sums + reward_terms

    obs = torch.cat([
        lin_vel * 2.0,
        ang_vel * 0.25,
        gravity / 9.81,
        commands * env._cmd_scale,
        dof_pos - env.default_dof_pos,
        dof_vel * 0.05,
        actions,
    ], dim=1)
    obs = torch.clamp(obs, -100.0, 100.0)

    return PostOut(qpos_reset, qvel_reset, episode_length, commands, dof_pos,
                   dof_vel, feet_air_time_new, contact, None, episode_sums,
                   obs, reward, reward_terms, finished, reset, time_out)


PLAIN_PRE = {NIGHTMARE_V3: plain_nightmare_v3_pre, ANYMAL_C: plain_anymal_c_pre}
PLAIN_POST = {NIGHTMARE_V3: plain_nightmare_v3_post,
              ANYMAL_C: plain_anymal_c_post}


# ---------------------------------------------------------------------------
# the plan: an env's config as the kernels' parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Plan:
    """An env's config for the kernels: the integer and the real
    parameters by name (task_env.cuh Ints, Reals) and the constants table
    (qpos0, the default joint angles, the reward scales, the noise vector,
    the command scales and gravity) on the env's device; ``blocks`` keeps
    the parameter blocks as each library orders them (``_params``)."""

    robot: int
    ints: Dict[str, int]
    reals: Dict[str, float]
    cst: torch.Tensor
    blocks: dict = dataclasses.field(default_factory=dict)

    @property
    def nightmare(self) -> bool:
        return self.robot == NIGHTMARE_V3


def _refuse(why: str):
    raise ValueError(f"the task kernels do not take this config: {why}")


def _check_model(env, nact: int) -> None:
    sys = env.sys
    if not sys.jnt_type or sys.jnt_type[0] != 0 or sys.nbody < 2:
        _refuse("the model's first joint must be the base's free joint")
    if sys.nq - 7 != nact or sys.nv - 6 != nact:
        _refuse(f"{nact} actions for a model of {sys.nq - 7} joint angles")
    if env.num_obs != 12 + 3 * nact:
        _refuse(f"{env.num_obs} observations, not {12 + 3 * nact}")
    if env.dtype not in (torch.float32, torch.float64):
        _refuse(f"dtype {env.dtype}")


def _terms(env, robot: int) -> Dict[str, int]:
    names = TERMS[robot]
    unknown = [n for n in env.active_rewards if n not in names]
    if unknown:
        _refuse(f"reward terms {unknown}")
    if len(env.active_rewards) > MAX_TERMS:
        _refuse(f"{len(env.active_rewards)} reward terms, more than "
                f"{MAX_TERMS}")
    ids = [names.index(n) for n in env.active_rewards]
    return {f"term{k}": ids[k] if k < len(ids) else -1
            for k in range(MAX_TERMS)}


def _table(env, noise: torch.Tensor) -> Tuple[Dict[str, int], torch.Tensor]:
    parts = (("c_qpos0", env.sys.qpos0), ("c_default", env.default_dof_pos),
             ("c_scales", env.reward_scales), ("c_noise", noise),
             ("c_cmd_scale", env._cmd_scale), ("c_gravity", env._gravity))
    off, at = {}, 0
    for name, t in parts:
        off[name] = at
        at += t.numel()
    cst = torch.cat([t.reshape(-1).to(device=env.device, dtype=env.dtype)
                     for _, t in parts])
    return dict(off, ncst=at), cst


def _reciprocals(reals: Dict[str, float]) -> Dict[str, float]:
    """The reciprocals, in double, of the Python floats that the plain
    version divides tensors by: the card divides so, as ``x * fl(1 / s)``
    (task_env.cuh ``div_scalar``)."""
    keys = ("dt", "sigma", "tilt_div", "grav_div")
    zero = [k for k in keys if reals[k] == 0.0]
    if zero:
        _refuse(f"a division by {zero} = 0")
    return dict(reals, **{f"inv_{k}": 1.0 / reals[k] for k in keys})


def nightmare_v3_plan(env) -> Plan:
    """The kernels' parameters for a NightmareV3Env; raises ValueError for
    a config they do not take."""
    cfg, sys = env.cfg, env.sys
    nact, nfeet = env.num_actions, 6
    _check_model(env, nact)
    if nact != 18 or sys.nsensor < 13:
        _refuse("nightmare_v3's task reads 18 joints and 13 touch sensors")
    e = cfg.env
    for name, mode in (("tibia", e.tibia_contact_mode),
                       ("body", e.body_contact_mode)):
        if mode not in (0, 1, 2):
            _refuse(f"{name}_contact_mode {mode} (0, 1 or 2)")
    if ("body_contact_forces" in env.active_rewards
            and e.tibia_contact_mode != 1 and e.body_contact_mode != 1):
        _refuse("body_contact_forces is active with neither contact mode "
                "1, where the plain version has no value for it")
    resample_every = int(cfg.commands.resampling_time / env.dt)
    if resample_every < 1:
        _refuse(f"resampling every {resample_every} steps")
    noise = (env._noise_scale_vec() if cfg.noise.add_noise
             else torch.zeros(env.num_obs, dtype=env.dtype))
    off, cst = _table(env, noise)
    r, s = cfg.commands.ranges, cfg.normalization.obs_scales
    ints = dict(
        robot=NIGHTMARE_V3, nq=sys.nq, nv=sys.nv, nbody=sys.nbody,
        nsensor=sys.nsensor, nact=nact, nobs=env.num_obs, nfeet=nfeet,
        nterms=len(env.active_rewards), max_len=env.max_episode_length,
        resample_every=resample_every, tibia_mode=e.tibia_contact_mode,
        body_mode=e.body_contact_mode, add_noise=int(cfg.noise.add_noise),
        fat_active=int("feet_air_time" in env.active_rewards),
        **off, **_terms(env, NIGHTMARE_V3))
    rw = cfg.rewards
    reals = dict(
        action_scale=cfg.control.action_scale,
        clip_actions=cfg.normalization.clip_actions,
        p_gain=cfg.control.p_gain, dt=env.dt,
        term_force=e.termination_contact_force,
        tibia_max=e.tibia_max_contact_force, body_max=e.body_max_contact_force,
        tilt_limit=60.0 * math.pi / 180.0, tilt_div=1.0,
        height_target=rw.base_height_target, sigma=rw.tracking_sigma,
        max_contact_force=rw.max_contact_force, contact_thr=1.0,
        s_lin=s.lin_vel, s_ang=s.ang_vel, grav_div=1.0, s_dof_pos=s.dof_pos,
        s_dof_vel=s.dof_vel, clip_obs=cfg.normalization.clip_observations,
        span_x=r.max_lin_vel_x - -r.max_lin_vel_x, lo_x=-r.max_lin_vel_x,
        span_y=0.0, lo_y=0.0,
        span_w=r.max_ang_vel - -r.max_ang_vel, lo_w=-r.max_ang_vel,
        cmd_cut=0.02, still_cut=0.01, air_cut=0.0, air_lo=0.5, air_hi=1.0,
        cos_eps=1e-9)
    return Plan(NIGHTMARE_V3, ints, _reciprocals(reals), cst)


def anymal_c_plan(env) -> Plan:
    """The kernels' parameters for an AnymalCEnv; raises ValueError for a
    config they do not take."""
    cfg, sys = env.cfg, env.sys
    nact, nfeet = env.num_actions, env.num_feet
    _check_model(env, nact)
    if nact != 12 or nfeet != 4:
        _refuse("anymal_c's task reads 12 joints and 4 feet")
    if env.resample_every < 1:
        _refuse(f"resampling every {env.resample_every} steps")
    off, cst = _table(env, torch.zeros(env.num_obs, dtype=env.dtype))
    ints = dict(
        robot=ANYMAL_C, nq=sys.nq, nv=sys.nv, nbody=sys.nbody,
        nsensor=sys.nsensor, nact=nact, nobs=env.num_obs, nfeet=nfeet,
        nterms=len(env.active_rewards), max_len=env.max_episode_length,
        resample_every=env.resample_every, tibia_mode=0, body_mode=0,
        add_noise=0, fat_active=1, **off, **_terms(env, ANYMAL_C))
    reals = dict(
        action_scale=cfg.action_scale, clip_actions=100.0, p_gain=0.0,
        dt=env.dt, term_force=cfg.termination_contact_force, tibia_max=0.0,
        body_max=0.0, tilt_limit=math.pi / 3, tilt_div=9.81,
        height_target=0.0, sigma=cfg.tracking_sigma,
        max_contact_force=cfg.max_contact_force, contact_thr=1.0, s_lin=2.0,
        s_ang=0.25, grav_div=9.81, s_dof_pos=1.0, s_dof_vel=0.05,
        clip_obs=100.0,
        span_x=2.0 * cfg.max_lin_vel_x, lo_x=-cfg.max_lin_vel_x,
        span_y=2.0 * cfg.max_lin_vel_y, lo_y=-cfg.max_lin_vel_y,
        span_w=2.0 * cfg.max_ang_vel, lo_w=-cfg.max_ang_vel,
        cmd_cut=0.05, still_cut=0.1, air_cut=0.1, air_lo=0.5, air_hi=0.0,
        cos_eps=0.0)
    return Plan(ANYMAL_C, ints, _reciprocals(reals), cst)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _names(host: bool) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    lib = build.load_host("task_host") if host else build.load("task")
    out = []
    for fn in (lib.task_int_names, lib.task_real_names):
        fn.restype = ctypes.c_char_p
        out.append(tuple(k for k in fn().decode().split(",") if k))
    return out[0], out[1]


def _params(plan: Plan, host: bool) -> Tuple[ctypes.Array, ctypes.Array]:
    """The plan's parameter blocks in the library's field order (made
    once per plan and library)."""
    if host not in plan.blocks:
        ik, rk = _names(host)
        plan.blocks[host] = (
            (ctypes.c_int * len(ik))(*[plan.ints[k] for k in ik]),
            (ctypes.c_double * len(rk))(*[plan.reals[k] for k in rk]))
    return plan.blocks[host]


@functools.lru_cache(maxsize=None)
def _fn(name: str, dtype: torch.dtype, host: bool):
    lib = build.load_host("task_host") if host else build.load("task")
    suffix = "_f32" if dtype == torch.float32 else "_f64"
    fn = getattr(lib, name + ("_host" if host else "") + suffix)
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_int if host else ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, name: str, shape, dtype, device) -> torch.Tensor:
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(x.shape)}")
    if x.dtype != dtype or x.device != device:
        raise ValueError(f"{name} must be {dtype} on {device}, got {x.dtype} "
                         f"on {x.device}")
    return x.contiguous()


def _pointers(xs) -> ctypes.Array:
    return (ctypes.c_void_p * len(xs))(
        *[None if x is None else x.data_ptr() for x in xs])


def _plan_on(env, dev: torch.device) -> Plan:
    plan = env.task_plan
    if plan.cst.device != dev:
        raise ValueError(f"the env's task tables are on {plan.cst.device}, "
                         f"its tensors on {dev}")
    return plan


def _pre_operands(env, state, raw_actions):
    N, dt, dev = raw_actions.shape[0], env.dtype, raw_actions.device
    plan = _plan_on(env, dev)
    na = env.num_actions
    raw = _check(raw_actions.to(dt), "raw_actions", (N, na), dt, dev)
    prev = (_check(state.dof_pos, "dof_pos", (N, na), dt, dev)
            if plan.nightmare else None)
    outs = [torch.empty(N, na, dtype=dt, device=dev) for _ in range(2)]
    return plan, N, [raw, prev], outs


def _failed(which: str, host: bool, err: int) -> str:
    if host:
        return f"the task {which} host driver refused its arguments ({err})"
    return f"task {which} kernel launch failed: cudaError_t {err}"


def _run_pre(env, state, raw_actions, host: bool, team: int = 1):
    plan, N, ins, outs = _pre_operands(env, state, raw_actions)
    ints, reals = _params(plan, host)
    last = team if host else torch.cuda.current_stream(
        raw_actions.device).cuda_stream
    ctx = (torch.cuda.device(raw_actions.device) if not host
           else contextlib.nullcontext())
    with ctx:
        err = _fn("task_pre", env.dtype, host)(
            ints, len(ints), reals, len(reals), plan.cst.data_ptr(),
            _pointers(ins), len(ins), _pointers(outs), len(outs), N, last)
    if err != 0:
        raise RuntimeError(_failed("pre", host, err))
    return outs[0], outs[1]


def pre(env, state, raw_actions: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The env step's actions and controls: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    plan = env.task_plan
    dev = raw_actions.device
    if dev.type == "cpu":
        return PLAIN_PRE[plan.robot](env, state, raw_actions)
    if dev.type != "cuda":
        raise ValueError(f"pre runs on cpu or cuda, not {dev}")
    out = _run_pre(env, state, raw_actions, host=False)
    _pre_counted.launches += 1
    return out


pre.launches = 0
_pre_counted = pre  # counts on, where a caller wraps the module's name


def _post_operands(env, state, actions, phys, draws, noise):
    sys, dt, dev = env.sys, env.dtype, actions.device
    plan = _plan_on(env, dev)
    N, na, nf = actions.shape[0], env.num_actions, plan.ints["nfeet"]
    nt = plan.ints["nterms"]
    if len(draws) != DRAWS[plan.robot]:
        raise ValueError(f"post takes {DRAWS[plan.robot]} command draws, "
                         f"not {len(draws)}")
    if bool(plan.ints["add_noise"]) != (noise is not None):
        raise ValueError("post takes the noise draws exactly where the "
                         "config adds noise")

    def c(x, name, *shape, dtype=dt):
        return _check(x, name, (N,) + shape, dtype, dev)

    ins = dict(
        qpos=c(phys.qpos, "qpos", sys.nq), qvel=c(phys.qvel, "qvel", sys.nv),
        cvel=c(phys.cvel, "cvel", sys.nbody, 6),
        xipos=(c(phys.xipos, "xipos", sys.nbody, 3)
               if "base_height" in env.active_rewards else None),
        qfrc_actuator=(None if plan.nightmare
                       else c(phys.qfrc_actuator, "qfrc_actuator", sys.nv)),
        sensordata=c(phys.sensordata, "sensordata", sys.nsensor),
        episode_length=c(state.episode_length, "episode_length",
                         dtype=torch.int32),
        commands=c(state.commands, "commands", 3),
        prev_actions=c(state.actions, "actions", na),
        actions=c(actions, "actions", na),
        prev_dof_vel=c(state.dof_vel, "dof_vel", na),
        feet_air_time=c(state.feet_air_time, "feet_air_time", nf),
        last_contacts=c(state.last_contacts, "last_contacts", nf,
                        dtype=torch.bool),
        last_contacts_filt=(c(state.last_contacts_filt, "last_contacts_filt",
                              nf, dtype=torch.bool) if plan.nightmare
                            else None),
        episode_sums=c(state.episode_sums, "episode_sums", nt),
        noise=None if noise is None else c(noise, "noise", env.num_obs))
    for k in range(6):
        ins[f"draw{k}"] = (c(draws[k], f"draws[{k}]") if k < len(draws)
                           else None)

    def empty(*shape, dtype=dt):
        return torch.empty((N,) + shape, dtype=dtype, device=dev)

    outs = dict(
        qpos=empty(sys.nq), qvel=empty(sys.nv),
        episode_length=empty(dtype=torch.int32), commands=empty(3),
        dof_pos=empty(na), dof_vel=empty(na), feet_air_time=empty(nf),
        last_contacts=empty(nf, dtype=torch.bool),
        last_contacts_filt=(empty(nf, dtype=torch.bool) if plan.nightmare
                            else None),
        episode_sums=empty(nt), obs=empty(env.num_obs), reward=empty(),
        reward_terms=empty(nt), finished=empty(nt),
        reset=empty(dtype=torch.bool), time_out=empty(dtype=torch.bool))
    return plan, N, [ins[k] for k in POST_INS], outs


def _run_post(env, state, actions, phys, draws, noise, host: bool,
              team: int = 1) -> PostOut:
    plan, N, ins, outs = _post_operands(env, state, actions, phys, draws,
                                        noise)
    ints, reals = _params(plan, host)
    last = team if host else torch.cuda.current_stream(
        actions.device).cuda_stream
    ctx = (torch.cuda.device(actions.device) if not host
           else contextlib.nullcontext())
    out_list = [outs[k] for k in POST_OUTS]
    with ctx:
        err = _fn("task_post", env.dtype, host)(
            ints, len(ints), reals, len(reals), plan.cst.data_ptr(),
            _pointers(ins), len(ins), _pointers(out_list), len(out_list), N,
            last)
    if err != 0:
        raise RuntimeError(_failed("post", host, err))
    return PostOut(**{k: outs[k] for k in PostOut._fields})


def post(env, state, actions: torch.Tensor, phys,
         draws: Sequence[torch.Tensor],
         noise: Optional[torch.Tensor] = None) -> PostOut:
    """The env step after the physics: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    plan = env.task_plan
    dev = actions.device
    if dev.type == "cpu":
        return PLAIN_POST[plan.robot](env, state, actions, phys, draws, noise)
    if dev.type != "cuda":
        raise ValueError(f"post runs on cpu or cuda, not {dev}")
    out = _run_post(env, state, actions, phys, draws, noise, host=False)
    _post_counted.launches += 1
    return out


post.launches = 0
_post_counted = post  # counts on, where a caller wraps the module's name


def host_pre(env, state, raw_actions: torch.Tensor, team: int = 1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pre``'s per-env arithmetic (``csrc/task_env.cuh``) on CPU
    tensors, through the host driver ``csrc/task_host.cpp`` built with g++:
    a team of ``team`` threads (1 to 64) splits each env's stores as the
    kernel's warp lanes do, the envs in series.  For the tests; raises
    RuntimeError where g++ is missing."""
    if not 1 <= team <= MAX_TEAM:
        raise ValueError(f"host_pre runs teams of 1 to {MAX_TEAM}, not {team}")
    if raw_actions.device.type != "cpu":
        raise ValueError("host_pre takes CPU tensors")
    return _run_pre(env, state, raw_actions, host=True, team=team)


def host_post(env, state, actions: torch.Tensor, phys,
              draws: Sequence[torch.Tensor],
              noise: Optional[torch.Tensor] = None, team: int = 1) -> PostOut:
    """``post``'s per-env arithmetic on CPU tensors through the host
    driver, as ``host_pre``."""
    if not 1 <= team <= MAX_TEAM:
        raise ValueError(f"host_post runs teams of 1 to {MAX_TEAM}, not {team}")
    if actions.device.type != "cpu":
        raise ValueError("host_post takes CPU tensors")
    return _run_post(env, state, actions, phys, draws, noise, host=True,
                     team=team)
