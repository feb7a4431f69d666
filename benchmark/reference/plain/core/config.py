# A frozen copy of the port's core/config.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
"""Config trees for env and PPO, mirroring the reference's class-tree configs
(nightmare_rl ``envs/nightmare_v3_config.py`` / ``envs/base_config.py``) as
frozen, hashable dataclasses.

A copy of ``nightmare_rl_tpu/core/config.py``: the PyTorch port keeps its own
so that it never imports the JAX package.  All default values are verbatim
from ``NightmareV3Config`` / ``NightmareV3ConfigPPO`` (file:line cited per
block).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _f(default_factory):
    return field(default_factory=default_factory)


# ---------------------------------------------------------------------------
# Env config (NightmareV3Config, envs/nightmare_v3_config.py:4-100)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EnvCfg:
    # envs/nightmare_v3_config.py:8-22
    model_name: str = "nightmare_v3"
    num_envs: int = 8192
    num_obs: int = 66
    num_privileged_obs: int = 0
    num_actions: int = 18
    episode_length_s: float = 20.0
    send_timeouts: bool = True
    body_name: str = "base_link"
    tibia_contact_mode: int = 1  # 0 none, 1 penalize, 2 terminate
    tibia_max_contact_force: float = 2.0
    body_contact_mode: int = 1
    body_max_contact_force: float = 2.0
    termination_contact_force: float = 160.0


@dataclass(frozen=True)
class ViewerCfg:
    # envs/nightmare_v3_config.py:31-33
    render: bool = False
    record_states: bool = True
    # the robot's MJCF, which render-during-training opens in mujoco.viewer
    # (the port has no default: the reference's models are not in the tree)
    xml_path: Optional[str] = None


@dataclass(frozen=True)
class ControlCfg:
    # envs/nightmare_v3_config.py:35-46
    p_gain: float = 20.0
    default_pos: Tuple[float, ...] = tuple([0.0, math.pi / 5, 0.0] * 6)
    decimation: int = 2
    action_scale: float = 0.2


@dataclass(frozen=True)
class NoiseScalesCfg:
    # envs/nightmare_v3_config.py:51-57
    lin_vel: float = 1.0
    ang_vel: float = 1.0
    gravity: float = 1.0
    dof_pos: float = 1.0
    dof_vel: float = 1.0
    height_measurements: float = 1.0


@dataclass(frozen=True)
class NoiseCfg:
    # envs/nightmare_v3_config.py:48-50
    add_noise: bool = False
    noise_level: float = 0.1
    noise_scales: NoiseScalesCfg = _f(NoiseScalesCfg)


@dataclass(frozen=True)
class CommandRangesCfg:
    # envs/nightmare_v3_config.py:61-64
    max_lin_vel_x: float = 0.5
    max_lin_vel_y: float = 0.5
    max_ang_vel: float = 0.8


@dataclass(frozen=True)
class CommandsCfg:
    # envs/nightmare_v3_config.py:59-64
    resampling_time: float = 10.0
    ranges: CommandRangesCfg = _f(CommandRangesCfg)


@dataclass(frozen=True)
class ObsScalesCfg:
    # envs/nightmare_v3_config.py:67-72
    lin_vel: float = 2.0
    ang_vel: float = 0.25
    dof_pos: float = 1.0
    dof_vel: float = 0.05
    height_measurements: float = 5.0


@dataclass(frozen=True)
class NormalizationCfg:
    # envs/nightmare_v3_config.py:66-74
    obs_scales: ObsScalesCfg = _f(ObsScalesCfg)
    clip_observations: float = 100.0
    clip_actions: float = 1.0


@dataclass(frozen=True)
class RewardScalesCfg:
    # envs/nightmare_v3_config.py:77-96 (verbatim, including the inactive 0s)
    termination: float = -200.0
    tracking_lin_vel: float = 8.0
    tracking_ang_vel: float = 6.0
    dof_acc: float = -2.5e-5
    action_rate: float = -0.02
    body_contact_forces: float = -5.0
    default_position: float = -0.01
    orientation: float = -5.0
    lin_vel_z: float = 0.0
    ang_vel_xy: float = 0.0
    feet_air_time: float = 0.0
    torques: float = 0.0
    base_height: float = 0.0
    feet_contact_forces: float = 0.0
    dof_vel: float = 0.0
    stand_still: float = 0.0


@dataclass(frozen=True)
class RewardsCfg:
    # envs/nightmare_v3_config.py:76-100
    scales: RewardScalesCfg = _f(RewardScalesCfg)
    tracking_sigma: float = 0.008
    base_height_target: float = 0.1
    max_contact_force: float = 10.0


@dataclass(frozen=True)
class SolverCfg:
    """TPU-specific physics solver knobs (the reference hardcodes these in
    the MJCF <option>, models/nightmare_v3/mjmodel.xml:3).  None = use the
    compiled model's values."""

    iterations: Optional[int] = None
    noslip_iterations: Optional[int] = None
    # top-K deepest candidate contact points entering the solver per step
    # (-1 = all).  Measured (tests/test_contact_cap.py, PARITY.md §5):
    # steady walking peaks at 19 penetrating candidates (stance feet carry
    # 3-4 support vertices each) and belly-collapse states at 24-25, so 24
    # is force-complete for the walking regime with margin and drops at
    # most one ~0.3 mm candidate in transitional crouches; 16 (the old
    # default) silently dropped up to 9 candidates at 13 mm depth there.
    max_contacts: int = 24


@dataclass(frozen=True)
class NightmareV3Cfg:
    env: EnvCfg = _f(EnvCfg)
    viewer: ViewerCfg = _f(ViewerCfg)
    control: ControlCfg = _f(ControlCfg)
    noise: NoiseCfg = _f(NoiseCfg)
    commands: CommandsCfg = _f(CommandsCfg)
    normalization: NormalizationCfg = _f(NormalizationCfg)
    rewards: RewardsCfg = _f(RewardsCfg)
    solver: SolverCfg = _f(SolverCfg)

    def replace(self, **kw) -> "NightmareV3Cfg":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# PPO config (NightmareV3ConfigPPO, envs/nightmare_v3_config.py:102-146)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PolicyCfg:
    # envs/nightmare_v3_config.py:105-113
    init_noise_std: float = 1.0
    # NOT in the reference (rsl_rl has no exploration floor).  Flag-gated
    # deviation: >0 clamps the sampling std at this value to prevent the
    # standing-local-optimum collapse documented in docs/BENCH_NOTES.md
    # rounds 3-4.  Default 0.0 = exact parity config.
    std_floor: float = 0.0
    actor_hidden_dims: Tuple[int, ...] = (54, 42, 30)
    critic_hidden_dims: Tuple[int, ...] = (54, 42, 30)
    activation: str = "elu"
    # only for 'ActorCriticRecurrent'
    rnn_type: str = "lstm"
    rnn_hidden_size: int = 512
    rnn_num_layers: int = 1


@dataclass(frozen=True)
class AlgorithmCfg:
    # envs/nightmare_v3_config.py:117-130
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    entropy_coef: float = 0.0015
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    learning_rate: float = 1.0e-3
    schedule: str = "adaptive"  # 'adaptive' | 'fixed'
    gamma: float = 0.99
    lam: float = 0.95
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0


@dataclass(frozen=True)
class RunnerCfg:
    # envs/nightmare_v3_config.py:132-146
    policy_class_name: str = "ActorCritic"
    algorithm_class_name: str = "PPO"
    num_steps_per_env: int = 80
    max_iterations: int = 1_000_000_000
    save_interval: int = 50
    experiment_name: str = "test"
    run_name: str = ""
    resume: bool = False
    load_run: int = -1
    checkpoint: int = -1
    resume_path: Optional[str] = None


@dataclass(frozen=True)
class PPOCfg:
    seed: int = 1
    runner_class_name: str = "OnPolicyRunner"
    policy: PolicyCfg = _f(PolicyCfg)
    algorithm: AlgorithmCfg = _f(AlgorithmCfg)
    runner: RunnerCfg = _f(RunnerCfg)

    def replace(self, **kw) -> "PPOCfg":
        return dataclasses.replace(self, **kw)


def config_to_dict(cfg) -> dict:
    """Flatten a config dataclass to nested dicts (the reference's
    class_to_dict, envs/helpers.py:3-18)."""
    if dataclasses.is_dataclass(cfg):
        return {
            f.name: config_to_dict(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)
        }
    if isinstance(cfg, tuple):
        return list(cfg)
    return cfg
