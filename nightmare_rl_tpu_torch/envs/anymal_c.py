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

The step's task half (everything around the physics) is ``ops/task.py``'s:
its plain version on the CPU, two kernels on the card.

The Newton line search needs full float32 products: the step runs its
matrix products without TF32, whatever the process-wide setting.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nightmare_rl_tpu_torch.ops import task
from nightmare_rl_tpu_torch.parallel.shard import Shard, local_envs
from nightmare_rl_tpu_torch.physics import loader, pipeline
from nightmare_rl_tpu_torch.physics import system as S
from nightmare_rl_tpu_torch.utils import trace
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

    # the model's tables, the kernels' plans and the PGS form's probe
    @trace.spanned("setup.env")
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
        # the task kernels' parameters; refuses a config they do not take
        self.task_plan = task.anymal_c_plan(self)

    def _draw(self, n: int) -> torch.Tensor:
        return self.shard.draw(torch.rand, (n,), generator=self.generator,
                               dtype=self.dtype, device=self.device)

    def _command_draws(self, n: int) -> Tuple[torch.Tensor, ...]:
        """A step's command draws: vx, vy and ωz for the resample, then for
        the reset."""
        return tuple(self._draw(n) for _ in range(6))

    def _sample_commands(self, n: int) -> torch.Tensor:
        """vx ∈ ±max_lin_vel_x, vy ∈ ±max_lin_vel_y, ωz ∈ ±max_ang_vel;
        xy commands with norm ≤ 0.05 are zeroed."""
        return task.anymal_c_commands(self, self._draw(n), self._draw(n),
                                      self._draw(n))

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
        # the task half runs as two kernels on the card (ops/task.py)
        actions, ctrl = task.pre(self, state, raw_actions)
        phys = pipeline.step(self.sys, state.phys, ctrl, self.cfg.decimation)
        draws = self._command_draws(raw_actions.shape[0])
        o = task.post(self, state, actions, phys, draws)
        new_state = EnvState(
            phys=phys.replace(qpos=o.qpos, qvel=o.qvel),
            episode_length=o.episode_length, commands=o.commands,
            actions=actions, dof_vel=o.dof_vel,
            feet_air_time=o.feet_air_time, last_contacts=o.last_contacts,
            episode_sums=o.episode_sums, obs=o.obs, reset_buf=o.reset,
            time_out_buf=o.time_out,
        )
        return StepOut(new_state, o.obs, o.reward, o.reset, o.time_out,
                       o.reward_terms, o.finished, phys.qpos, phys.qvel)

    def reset(self, seed: Optional[int] = None) -> Tuple[EnvState, torch.Tensor]:
        """Fresh batch and a zero-action step for the initial obs.  ``seed``
        reseeds the env's generator."""
        if seed is not None:
            self.generator.manual_seed(seed)
        state = self.init()
        out = self.step(state, torch.zeros(self.num_envs, self.num_actions,
                                           dtype=self.dtype, device=self.device))
        return out.state, out.obs
