"""ANYmal-C quadruped velocity-command task, batched over envs (port of
``nightmare_rl_tpu/envs/anymal_c.py``).

12 position actuators (target = default pose + action·scale), the model's
Newton solver with elliptic cones (impratio 100) capped at
``AnymalCCfg.solver_iterations`` Newton steps, model dt 0.002 s and
decimation 4.  Per-term episode rewards, feet-air-time and contact-force
terms read the foot touch sensors; torque penalties read the servo forces.

Obs (48): [lin_vel·2 | ang_vel·0.25 | proj_gravity | cmd·(2,2,0.25) |
(q−q_def)·1 | q̇·0.05 | prev_actions].

As in the JAX env: ``dt`` comes from the System after the cast to the env's
dtype (in float32 the command resampling period is 1249 steps, in float64
1250); commands are drawn twice per step, for the resample and for the
reset, each draw covering the whole batch; the reset keeps the physics
state's ``qacc_warmstart``.  Randomness comes from one ``torch.Generator``
on the env's device, in place of the JAX env's per-env keys; under a mesh
the env holds one shard's envs and draws through ``parallel/shard.py``.

The Newton line search needs full float32 products: the step runs its
matrix products without TF32, whatever the process-wide setting.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nightmare_rl_tpu_torch.core import quat as Q
from nightmare_rl_tpu_torch.parallel.shard import Shard, local_envs
from nightmare_rl_tpu_torch.physics import loader, pipeline
from nightmare_rl_tpu_torch.physics import system as S
from nightmare_rl_tpu_torch.utils.device import full_float32, resolve_device

REWARD_NAMES = [
    "termination", "tracking_lin_vel", "tracking_ang_vel", "lin_vel_z",
    "ang_vel_xy", "orientation", "torques", "dof_acc", "action_rate",
    "feet_air_time", "feet_contact_forces", "stand_still",
]


@dataclass(frozen=True)
class AnymalCCfg:
    num_envs: int = 4096
    num_actions: int = 12
    num_obs: int = 48
    episode_length_s: float = 20.0
    action_scale: float = 0.5
    decimation: int = 4          # model dt = 0.002 s -> 8 ms control
    max_lin_vel_x: float = 1.0
    max_lin_vel_y: float = 0.5
    max_ang_vel: float = 1.0
    resampling_time: float = 10.0
    tracking_sigma: float = 0.25
    solver_iterations: int = 8   # Newton budget (the archive's bound is 100)
    max_contacts: int = 8
    termination_contact_force: float = 700.0   # N on any single foot
    max_contact_force: float = 500.0           # soft feet-force penalty knee
    # reward scales, multiplied by the control dt at env build
    rew_termination: float = -200.0
    rew_tracking_lin_vel: float = 1.0
    rew_tracking_ang_vel: float = 0.5
    rew_lin_vel_z: float = -2.0
    rew_ang_vel_xy: float = -0.05
    rew_orientation: float = -5.0
    rew_torques: float = -2.5e-5
    rew_dof_acc: float = -2.5e-7
    rew_action_rate: float = -0.01
    rew_feet_air_time: float = 1.0
    rew_feet_contact_forces: float = -1e-3
    rew_stand_still: float = 0.0


@dataclass
class EnvState:
    phys: S.State
    episode_length: torch.Tensor   # (N,) int32
    commands: torch.Tensor         # (N, 3)
    actions: torch.Tensor          # (N, 12)
    dof_vel: torch.Tensor          # (N, 12)
    feet_air_time: torch.Tensor    # (N, 4)
    last_contacts: torch.Tensor    # (N, 4) bool
    episode_sums: torch.Tensor     # (N, n_active_terms)
    obs: torch.Tensor              # (N, 48)
    reset_buf: torch.Tensor        # (N,) bool
    time_out_buf: torch.Tensor     # (N,) bool

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


class StepOut(NamedTuple):
    state: EnvState
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    time_out: torch.Tensor
    reward_terms: torch.Tensor
    finished_episode_sums: torch.Tensor
    # post-step, pre-reset physics state, for trajectory recording
    record_qpos: torch.Tensor
    record_qvel: torch.Tensor


class AnymalCEnv:
    """Batched lockstep env with the rsl_rl-style contract
    (num_envs/num_obs/num_actions/max_episode_length, step/reset)."""

    # the step makes no host synchronization (the Newton loops have fixed
    # budgets, as the JAX scans): the rollout replays it as a CUDA graph
    graph_step = True

    def __init__(self, cfg: AnymalCCfg = AnymalCCfg(),
                 sys: Optional[S.System] = None,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0, shard: Shard = Shard()):
        self.cfg = cfg
        self.device = resolve_device(device)
        if sys is None:
            sys = loader.load_system("anymal_c", device=self.device)
        sys = S.tree_cast(sys, dtype)
        self.sys = dataclasses.replace(
            sys, solver_iterations=cfg.solver_iterations,
            max_contacts=cfg.max_contacts)
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        self.shard = shard
        self.num_envs = local_envs(cfg.num_envs, shard)
        self.num_obs = cfg.num_obs
        self.num_privileged_obs = cfg.num_obs
        self.num_actions = cfg.num_actions
        self.num_feet = int(self.sys.nsensor)  # the foot touch sensors
        self.dt = float(self.sys.timestep) * cfg.decimation
        self.max_episode_length = int(np.ceil(cfg.episode_length_s / self.dt))
        self.max_episode_length_s = cfg.episode_length_s
        self.resample_every = int(cfg.resampling_time / self.dt)
        self.default_dof_pos = self.sys.qpos0[7:].clone()
        scales = {n: getattr(cfg, "rew_" + n) for n in REWARD_NAMES}
        self.active_rewards = [n for n in REWARD_NAMES if scales[n] != 0.0]
        self.reward_scales = torch.tensor(
            [scales[n] * self.dt for n in self.active_rewards], dtype=dtype,
            device=self.device)
        self._gravity = torch.tensor([0.0, 0.0, -9.81], dtype=dtype,
                                     device=self.device)
        self._cmd_scale = torch.tensor([2.0, 2.0, 0.25], dtype=dtype,
                                       device=self.device)

    def _uniform(self, n: int, bound: float) -> torch.Tensor:
        u = self.shard.draw(torch.rand, (n,), generator=self.generator,
                            dtype=self.dtype, device=self.device)
        return -bound + 2.0 * bound * u

    def _sample_commands(self, n: int) -> torch.Tensor:
        """vx ∈ ±max_lin_vel_x, vy ∈ ±max_lin_vel_y, ωz ∈ ±max_ang_vel;
        xy commands with norm ≤ 0.05 are zeroed."""
        c = self.cfg
        vx = self._uniform(n, c.max_lin_vel_x)
        vy = self._uniform(n, c.max_lin_vel_y)
        wz = self._uniform(n, c.max_ang_vel)
        xy = torch.stack([vx, vy], dim=1)
        xy = xy * (torch.linalg.vector_norm(xy, dim=1, keepdim=True) > 0.05)
        return torch.cat([xy, wz[:, None]], dim=1)

    def init(self) -> EnvState:
        N, dtype, dev = self.num_envs, self.dtype, self.device

        def zeros(*shape, dt=dtype):
            return torch.zeros(N, *shape, dtype=dt, device=dev)

        return EnvState(
            phys=pipeline.make_state(self.sys, N),
            episode_length=zeros(dt=torch.int32),
            commands=self._sample_commands(N),
            actions=zeros(self.num_actions),
            dof_vel=zeros(12),
            feet_air_time=zeros(self.num_feet),
            last_contacts=zeros(self.num_feet, dt=torch.bool),
            episode_sums=zeros(len(self.active_rewards)),
            obs=zeros(self.num_obs),
            reset_buf=torch.ones(N, dtype=torch.bool, device=dev),
            time_out_buf=zeros(dt=torch.bool),
        )

    def step(self, state: EnvState, raw_actions: torch.Tensor) -> StepOut:
        """raw_actions: (num_envs, 12) raw policy actions."""
        with full_float32():
            return self._step(state, raw_actions)

    def _step(self, state: EnvState, raw_actions: torch.Tensor) -> StepOut:
        cfg, sys, dtype, dt = self.cfg, self.sys, self.dtype, self.dt
        N = raw_actions.shape[0]

        prev_actions = state.actions
        actions = torch.clamp(raw_actions.to(dtype), -100.0, 100.0)
        # position servo: target angle = default + action·scale
        ctrl = self.default_dof_pos + actions * cfg.action_scale
        phys = pipeline.step(sys, state.phys, ctrl, cfg.decimation)

        episode_length = state.episode_length + 1
        base_quat = Q.conj(phys.qpos[:, 3:7])
        lin_vel = Q.rotate(phys.cvel[:, 1, 3:6], base_quat)
        ang_vel = Q.rotate(phys.cvel[:, 1, :3], base_quat)
        gravity = Q.rotate(self._gravity, base_quat)
        dof_pos = phys.qpos[:, 7:]
        dof_vel = phys.qvel[:, 6:]
        dof_acc = (dof_vel - state.dof_vel) / dt
        torques = phys.qfrc_actuator[:, 6:]
        feet_forces = phys.sensordata[:, :self.num_feet]

        commands = torch.where(
            (episode_length % self.resample_every == 0)[:, None],
            self._sample_commands(N), state.commands)

        time_out = episode_length > self.max_episode_length
        tilt = torch.arccos(torch.clamp(-gravity[:, 2] / 9.81, -1.0, 1.0))
        reset = time_out | (tilt > math.pi / 3)
        reset = reset | (feet_forces.amax(dim=1) > cfg.termination_contact_force)

        r1 = reset[:, None]
        commands = torch.where(r1, self._sample_commands(N), commands)
        rec_qpos, rec_qvel = phys.qpos, phys.qvel
        phys = phys.replace(
            qpos=torch.where(r1, sys.qpos0, phys.qpos),
            qvel=torch.where(r1, torch.zeros_like(phys.qvel), phys.qvel),
        )
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
            "stand_still": torch.sum(torch.abs(dof_pos - self.default_dof_pos),
                                     dim=1) * (moving < 0.1),
        }
        reward_terms = torch.stack(
            [values[n] for n in self.active_rewards], dim=1) * self.reward_scales
        reward = torch.sum(reward_terms, dim=1)
        episode_sums = episode_sums + reward_terms

        obs = torch.cat([
            lin_vel * 2.0,
            ang_vel * 0.25,
            gravity / 9.81,
            commands * self._cmd_scale,
            dof_pos - self.default_dof_pos,
            dof_vel * 0.05,
            actions,
        ], dim=1)
        obs = torch.clamp(obs, -100.0, 100.0)

        new_state = EnvState(
            phys=phys, episode_length=episode_length, commands=commands,
            actions=actions, dof_vel=dof_vel, feet_air_time=feet_air_time_new,
            last_contacts=contact, episode_sums=episode_sums, obs=obs,
            reset_buf=reset, time_out_buf=time_out,
        )
        return StepOut(new_state, obs, reward, reset, time_out, reward_terms,
                       finished, rec_qpos, rec_qvel)

    def reset(self, seed: Optional[int] = None) -> Tuple[EnvState, torch.Tensor]:
        """Fresh batch and a zero-action step for the initial obs.  ``seed``
        reseeds the env's generator."""
        if seed is not None:
            self.generator.manual_seed(seed)
        state = self.init()
        out = self.step(state, torch.zeros(self.num_envs, self.num_actions,
                                           dtype=self.dtype, device=self.device))
        return out.state, out.obs
