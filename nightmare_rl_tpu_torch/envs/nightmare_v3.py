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

The step's task half (everything around the physics) is ``ops/task.py``'s:
its plain version on the CPU, two kernels on the card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from nightmare_rl_tpu_torch.core.config import NightmareV3Cfg
from nightmare_rl_tpu_torch.ops import task
from nightmare_rl_tpu_torch.parallel.shard import Shard, local_envs
from nightmare_rl_tpu_torch.physics import loader, pipeline, solver
from nightmare_rl_tpu_torch.physics import system as S
from nightmare_rl_tpu_torch.utils import trace
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

    # the model's tables, the kernels' plans and the PGS form's probe
    @trace.spanned("setup.env")
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
        # the task kernels' parameters; refuses a config they do not take
        self.task_plan = task.nightmare_v3_plan(self)

    # ------------------------------------------------------------------

    def _draw(self, shape) -> torch.Tensor:
        return self.shard.draw(torch.rand, shape, generator=self.generator,
                               dtype=self.dtype, device=self.device)

    def _command_draws(self, n: int) -> Tuple[torch.Tensor, ...]:
        """A step's command draws: vx and ωz for the resample, then for the
        reset."""
        return tuple(self._draw((n,)) for _ in range(4))

    def _sample_commands(self, n: int) -> torch.Tensor:
        """_resample_commands (:321-333): vx ∈ ±max_lin_vel_x, vy ≡ 0,
        ωz ∈ ±max_ang_vel; zero xy commands with norm ≤ 0.02."""
        return task.nightmare_v3_commands(self, self._draw((n,)),
                                          self._draw((n,)))

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
        # the task half runs as two kernels on the card (ops/task.py):
        # actions and the control law before the physics (:183-188), the
        # readings, resampling, terminations, resets, rewards and
        # observations after it (:216-311)
        actions, ctrl = task.pre(self, state, raw_actions)
        phys = pipeline.step(self.sys, state.phys, ctrl,
                             self.cfg.control.decimation)
        N = raw_actions.shape[0]
        draws = self._command_draws(N)
        noise = (self._draw((N, self.num_obs)) if self.cfg.noise.add_noise
                 else None)
        o = task.post(self, state, actions, phys, draws, noise)
        new_state = EnvState(
            phys=phys.replace(qpos=o.qpos, qvel=o.qvel),
            episode_length=o.episode_length,
            commands=o.commands,
            actions=actions,
            dof_pos=o.dof_pos,
            dof_vel=o.dof_vel,
            feet_air_time=o.feet_air_time,
            last_contacts=o.last_contacts,
            last_contacts_filt=o.last_contacts_filt,
            episode_sums=o.episode_sums,
            obs=o.obs,
            reset_buf=o.reset,
            time_out_buf=o.time_out,
        )
        return StepOut(new_state, o.obs, o.reward, o.reset, o.time_out,
                       o.reward_terms, o.finished, phys.qpos, phys.qvel)

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
