# A frozen copy of the port's ops/task.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
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

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from benchmark.reference.plain.core import quat as Q

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


def nightmare_v3_plan(env) -> int:
    return NIGHTMARE_V3


def anymal_c_plan(env) -> int:
    return ANYMAL_C


def pre(env, state, raw_actions: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    return PLAIN_PRE[env.task_plan](env, state, raw_actions)


def post(env, state, actions: torch.Tensor, phys,
         draws: Sequence[torch.Tensor],
         noise: Optional[torch.Tensor] = None) -> PostOut:
    return PLAIN_POST[env.task_plan](env, state, actions, phys, draws, noise)
