"""Nightmare v3 hexapod velocity-command task, batched over envs (port of
``nightmare_rl_tpu/envs/nightmare_v3.py``).

Behavioral re-derivation of the reference env (nightmare_rl
``envs/nightmare_v3_env.py``), including its deliberate quirks:

- control law: ``ctrl = ((a·scale clipped) − default_pos − dof_pos_read)·p_gain``
  where ``dof_pos_read`` is the *last post-step reading* — after a reset the
  first control still uses the pre-reset reading (:183-188 + reset_idx not
  refreshing buffers).
- tibia touch forces zeroed where the foot force is nonzero (:230-232).
- rewards are computed *after* reset bookkeeping, so the terminal step's
  reward lands in the new episode's sums (:274-288).
- observations returned for reset envs are the terminal-state obs; the fresh
  state is first observed on the next step (:291-311).
- commands resample every ``resampling_time/dt`` steps per env and on reset,
  with vy forced to 0 and small commands zeroed (:321-333).
- termination: timeout (len > 1250), any foot force > 160, tilt > 60°
  (:239-256); tibia/body contact modes 1 = penalty not termination.

Randomness comes from one ``torch.Generator`` on the env's device, in place
of the JAX package's per-env keys; the two give different numbers.  Under a
mesh the env holds one shard's envs (``cfg.env.num_envs`` is the global
count) and draws through ``parallel/shard.py``, so an env's numbers do not
depend on the world size.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from nightmare_rl_tpu_torch.core import quat as Q
from nightmare_rl_tpu_torch.core.config import NightmareV3Cfg
from nightmare_rl_tpu_torch.parallel.shard import Shard, local_envs
from nightmare_rl_tpu_torch.physics import loader, pipeline, solver
from nightmare_rl_tpu_torch.physics import system as S
from nightmare_rl_tpu_torch.utils.device import full_float32, resolve_device

# reward functions in the reference config's registration order
REWARD_NAMES = [
    "termination", "tracking_lin_vel", "tracking_ang_vel", "dof_acc",
    "action_rate", "body_contact_forces", "default_position", "orientation",
    "lin_vel_z", "ang_vel_xy", "feet_air_time", "torques", "base_height",
    "feet_contact_forces", "dof_vel", "stand_still",
]


@dataclass
class EnvState:
    phys: S.State
    episode_length: torch.Tensor      # (N,) int32
    commands: torch.Tensor            # (N, 3)
    actions: torch.Tensor             # (N, 18) scaled+clipped actions
    # last post-step sensor readings (the reference's numpy buffers)
    dof_pos: torch.Tensor             # (N, 18)
    dof_vel: torch.Tensor             # (N, 18)
    feet_air_time: torch.Tensor       # (N, 6)
    last_contacts: torch.Tensor       # (N, 6) bool
    last_contacts_filt: torch.Tensor  # (N, 6) bool
    episode_sums: torch.Tensor        # (N, n_reward_terms)
    obs: torch.Tensor                 # (N, 66)
    reset_buf: torch.Tensor           # (N,) bool — done flag of the last step
    time_out_buf: torch.Tensor        # (N,) bool

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


class StepOut(NamedTuple):
    state: EnvState
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    time_out: torch.Tensor
    reward_terms: torch.Tensor           # (N, n_terms) this step's terms
    finished_episode_sums: torch.Tensor  # (N, n_terms), nan where not reset
    # post-step PRE-reset physics state, for training-time trajectory
    # recording (the reference records env 0 before reset_idx runs,
    # envs/nightmare_v3_env.py:261-274)
    record_qpos: torch.Tensor            # (N, nq)
    record_qvel: torch.Tensor            # (N, nv)


class NightmareV3Env:
    """Batched lockstep env with the rsl_rl-style contract
    (num_envs/num_obs/num_actions/max_episode_length, step/reset)."""

    # the step makes no host synchronization and draws only from
    # ``self.generator``, so callers capture it as a CUDA graph
    # (utils/graph.py)
    graph_step = True

    def __init__(self, cfg: NightmareV3Cfg, sys: S.System | None = None,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0, shard: Shard = Shard()):
        self.cfg = cfg
        self.device = resolve_device(device)
        if sys is None:
            sys = loader.load_system(cfg.env.model_name, device=self.device)
        sys = S.tree_cast(sys, dtype)
        if cfg.solver.iterations is not None:
            sys = dataclasses.replace(sys, solver_iterations=cfg.solver.iterations)
        if cfg.solver.noslip_iterations is not None:
            sys = dataclasses.replace(
                sys, noslip_iterations=cfg.solver.noslip_iterations)
        self.sys = dataclasses.replace(sys, max_contacts=cfg.solver.max_contacts)
        # the PGS form's dispatch probe, before the first step (ops/pgs.py)
        solver.prewarm(self.sys, self.device)
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        self.shard = shard
        self.num_envs = local_envs(cfg.env.num_envs, shard)
        self.num_obs = cfg.env.num_obs
        self.num_privileged_obs = cfg.env.num_obs  # mirror reference (:34)
        self.num_actions = cfg.env.num_actions
        self.dt = float(self.sys.timestep) * cfg.control.decimation
        self.max_episode_length_s = cfg.env.episode_length_s
        self.max_episode_length = int(np.ceil(self.max_episode_length_s / self.dt))

        self.default_dof_pos = torch.tensor(cfg.control.default_pos, dtype=dtype,
                                            device=self.device)
        # reward scales premultiplied by dt, zeros dropped (reference :123-128)
        scales = {n: getattr(cfg.rewards.scales, n) for n in REWARD_NAMES}
        self.active_rewards = [n for n in REWARD_NAMES if scales[n] != 0.0]
        self.reward_scales = torch.tensor(
            [scales[n] * self.dt for n in self.active_rewards], dtype=dtype,
            device=self.device)
        s = cfg.normalization.obs_scales
        self._cmd_scale = torch.tensor([s.lin_vel, s.lin_vel, s.ang_vel],
                                       dtype=dtype, device=self.device)
        self._gravity = torch.tensor([0.0, 0.0, -9.81], dtype=dtype,
                                     device=self.device)

    # ------------------------------------------------------------------

    def _uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        u = self.shard.draw(torch.rand, shape, generator=self.generator,
                            dtype=self.dtype, device=self.device)
        return lo + (hi - lo) * u

    def _sample_commands(self, n: int) -> torch.Tensor:
        """_resample_commands (:321-333): vx ∈ ±max_lin_vel_x, vy ≡ 0,
        ωz ∈ ±max_ang_vel; zero xy commands with norm ≤ 0.02."""
        r = self.cfg.commands.ranges
        vx = self._uniform((n,), -r.max_lin_vel_x, r.max_lin_vel_x)
        wz = self._uniform((n,), -r.max_ang_vel, r.max_ang_vel)
        xy = torch.stack([vx, torch.zeros_like(vx)], dim=1)
        xy = xy * (torch.linalg.vector_norm(xy, dim=1, keepdim=True) > 0.02)
        return torch.cat([xy, wz[:, None]], dim=1)

    def init(self) -> EnvState:
        N, dtype, dev = self.num_envs, self.dtype, self.device
        phys = pipeline.make_state(self.sys, N)

        def zeros(*shape, dt=dtype):
            return torch.zeros(N, *shape, dtype=dt, device=dev)

        return EnvState(
            phys=phys,
            episode_length=zeros(dt=torch.int32),
            commands=self._sample_commands(N),
            actions=zeros(18),
            dof_pos=phys.qpos[:, 7:].clone(),
            dof_vel=zeros(18),
            feet_air_time=zeros(6),
            last_contacts=zeros(6, dt=torch.bool),
            last_contacts_filt=zeros(6, dt=torch.bool),
            episode_sums=zeros(len(self.active_rewards)),
            obs=zeros(self.num_obs),
            reset_buf=torch.ones(N, dtype=torch.bool, device=dev),
            time_out_buf=zeros(dt=torch.bool),
        )

    def step(self, state: EnvState, raw_actions: torch.Tensor) -> StepOut:
        """raw_actions: (num_envs, 18) raw policy actions."""
        with full_float32():
            return self._step(state, raw_actions)

    def _step(self, state: EnvState, raw_actions: torch.Tensor) -> StepOut:
        cfg, sys, dtype, dt = self.cfg, self.sys, self.dtype, self.dt
        N = raw_actions.shape[0]

        prev_actions = state.actions
        actions = torch.clamp(raw_actions.to(dtype) * cfg.control.action_scale,
                              -cfg.normalization.clip_actions,
                              cfg.normalization.clip_actions)
        prev_dof_vel = state.dof_vel

        # control law (:183-188) — uses the last READ dof_pos (possibly stale
        # across resets, mirroring the reference buffers)
        ctrl = (actions - self.default_dof_pos - state.dof_pos) * cfg.control.p_gain
        phys = pipeline.step(sys, state.phys, ctrl, cfg.control.decimation)
        episode_length = state.episode_length + 1

        # readings (:216-232)
        base_quat = Q.conj(phys.qpos[:, 3:7])
        body = 1  # base_link
        base_lin_vel = Q.rotate(phys.cvel[:, body, 3:6], base_quat)
        base_ang_vel = Q.rotate(phys.cvel[:, body, :3], base_quat)
        projected_gravity = Q.rotate(self._gravity, base_quat)
        dof_pos = phys.qpos[:, 7:]
        dof_vel = phys.qvel[:, 6:]
        base_height = phys.xipos[:, body, 2]
        feet_forces = phys.sensordata[:, 6:12]
        body_force = phys.sensordata[:, 12]
        tibia_forces = phys.sensordata[:, 0:6] * (feet_forces == 0)
        dof_acc = (dof_vel - prev_dof_vel) / dt

        # command resampling (:235-236)
        resample_every = int(cfg.commands.resampling_time / dt)
        new_cmd = self._sample_commands(N)
        commands = torch.where((episode_length % resample_every == 0)[:, None],
                               new_cmd, state.commands)

        # termination (:239-256)
        time_out = episode_length > self.max_episode_length
        reset = time_out | (feet_forces.amax(dim=1) > cfg.env.termination_contact_force)
        if cfg.env.tibia_contact_mode == 2:
            reset |= tibia_forces.amax(dim=1) > cfg.env.tibia_max_contact_force
        if cfg.env.body_contact_mode == 2:
            reset |= body_force > cfg.env.body_max_contact_force
        cosang = -projected_gravity[:, 2] / torch.clamp_min(
            torch.linalg.vector_norm(projected_gravity, dim=1), 1e-9)
        reset |= torch.arccos(torch.clamp(cosang, -1.0, 1.0)) > 60.0 * math.pi / 180.0

        # ---- reset bookkeeping BEFORE rewards (reference order :274-288) ----
        reset_cmd = self._sample_commands(N)
        r1 = reset[:, None]
        phys_reset = phys.replace(
            qpos=torch.where(r1, sys.qpos0, phys.qpos),
            qvel=torch.where(r1, torch.zeros_like(phys.qvel), phys.qvel),
        )
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
        if "feet_air_time" in self.active_rewards:
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
            "stand_still": torch.sum(torch.abs(dof_pos - self.default_dof_pos), dim=1)
            * (torch.linalg.vector_norm(commands[:, :2], dim=1) < 0.01),
            "feet_contact_forces": torch.sum(torch.square(
                (feet_forces - r.max_contact_force)
                * (feet_forces > r.max_contact_force)), dim=1),
            "default_position": torch.sum(
                torch.square(dof_pos - self.default_dof_pos), dim=1),
        }
        reward_terms = torch.stack(
            [values[n] for n in self.active_rewards], dim=1) * self.reward_scales
        reward = torch.sum(reward_terms, dim=1)
        episode_sums = episode_sums + reward_terms

        # ---- observations (:291-309) ----
        s = cfg.normalization.obs_scales
        obs = torch.cat([
            base_lin_vel * s.lin_vel,
            base_ang_vel * s.ang_vel,
            projected_gravity,
            commands * self._cmd_scale,
            (dof_pos - self.default_dof_pos) * s.dof_pos,
            dof_vel * s.dof_vel,
            actions,
        ], dim=1)
        if cfg.noise.add_noise:
            noise = 2.0 * self.shard.draw(
                torch.rand, obs.shape, generator=self.generator, dtype=dtype,
                device=self.device) - 1.0
            obs = obs + noise * self._noise_scale_vec()
        clip_obs = cfg.normalization.clip_observations
        obs = torch.clamp(obs, -clip_obs, clip_obs)

        new_state = EnvState(
            phys=phys_reset,
            episode_length=episode_length,
            commands=commands,
            actions=actions,
            dof_pos=dof_pos,
            dof_vel=dof_vel,
            feet_air_time=feet_air_time_new,
            last_contacts=last_contacts,
            last_contacts_filt=last_contacts_filt,
            episode_sums=episode_sums,
            obs=obs,
            reset_buf=reset,
            time_out_buf=time_out,
        )
        return StepOut(new_state, obs, reward, reset, time_out, reward_terms,
                       finished_sums, phys.qpos, phys.qvel)

    def _noise_scale_vec(self) -> torch.Tensor:
        """Noise vector (:109-119).  NB the reference's dof index ranges are
        stale 12-DoF offsets (12:24, 24:36) — reproduced verbatim since the
        noise path is inert by default (add_noise=False)."""
        cfg = self.cfg
        s = cfg.normalization.obs_scales
        ns = cfg.noise.noise_scales
        lvl = cfg.noise.noise_level
        v = np.zeros(self.num_obs, dtype=np.float32)
        v[0:3] = ns.lin_vel * lvl * s.lin_vel
        v[3:6] = ns.ang_vel * lvl * s.ang_vel
        v[6:9] = ns.gravity * lvl
        v[12:24] = ns.dof_pos * lvl * s.dof_pos
        v[24:36] = ns.dof_vel * lvl * s.dof_vel
        return torch.tensor(v, dtype=self.dtype, device=self.device)

    def reset(self, seed: int | None = None) -> Tuple[EnvState, torch.Tensor]:
        """Fresh batch; like the reference reset(): a zero-action step for
        the initial obs (:392-396).  ``seed`` reseeds the env's generator."""
        if seed is not None:
            self.generator.manual_seed(seed)
        state = self.init()
        out = self.step(state, torch.zeros(self.num_envs, self.num_actions,
                                           dtype=self.dtype, device=self.device))
        return out.state, out.obs
