"""PPO driven by a host-stepped external environment (port of
``nightmare_rl_tpu/rl/external.py``).

The fused trainer (rl/ppo.py) steps the port's env inside its rollout; this
driver replaces only that env call with a host callback and reuses PPO's
policy step, GAE, permutation and minibatch update as they are: the same
timeout bootstrapping, the same generator draws, the same adaptive-KL
schedule.  Any VecEnv-shaped simulator (host-side, hardware in the loop,
...) can train the port's policy this way, at the cost of a device↔host
round trip per control step.  The feed-forward policy only, as in the JAX
package.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from nightmare_rl_tpu_torch.core.config import PPOCfg
from nightmare_rl_tpu_torch.rl.ppo import PPO, Transition
from nightmare_rl_tpu_torch.utils.device import resolve_device


class ExternalPPO:
    """PPO whose rollout steps an external env through a host callback.

    env_step_fn(actions: np.ndarray (N, A)) ->
        (obs (N, O), reward (N,), done (N,), time_out (N,)) as numpy.

    Runs on the card unless ``device="cpu"`` is asked for.
    """

    def __init__(self, num_obs: int, num_actions: int, num_envs: int,
                 cfg: PPOCfg, device=None):
        if cfg.runner.policy_class_name != "ActorCritic":
            raise ValueError("the external driver takes the feed-forward "
                             "policy")
        shim = SimpleNamespace(num_obs=num_obs, num_actions=num_actions,
                               device=resolve_device(device),
                               dtype=torch.float32)
        self.ppo = PPO(shim, cfg)
        self.cfg = cfg
        self.num_envs = num_envs

    def init(self, seed: int, obs0: np.ndarray) -> None:
        """The train state of ``seed`` (weights, optimizer, learning rate
        and iteration, as ``PPO.init`` makes them), the action-noise
        generator seeded, and the first observations."""
        self.ppo.init_params(seed)
        self.ppo.generator.manual_seed(seed)
        self.ppo.obs = self._tensor(obs0)

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=self.ppo.dtype,
                               device=self.ppo.device)

    def learn_iteration(
        self, env_step_fn: Callable[[np.ndarray], Tuple[np.ndarray, ...]],
    ) -> Dict[str, float]:
        ppo = self.ppo
        T = self.cfg.runner.num_steps_per_env
        gamma = self.cfg.algorithm.gamma
        obs = ppo.obs
        rows = []
        reward_sum, dones_sum = 0.0, 0
        for _ in range(T):
            action, mu, std, value, logp, _ = ppo.act(obs, ())
            obs_next, reward, done, time_out = env_step_fn(
                action.cpu().numpy())
            # timeout bootstrap exactly as the fused rollout
            reward_b = (self._tensor(reward)
                        + gamma * value * self._tensor(time_out))
            done_t = torch.as_tensor(np.asarray(done) != 0,
                                     device=ppo.device)
            rows.append(Transition(obs, action, reward_b, done_t, value,
                                   logp, mu, std))
            reward_sum += float(np.mean(reward))
            dones_sum += int(np.sum(np.asarray(done) != 0))
            obs = self._tensor(obs_next)
        traj = Transition(*[torch.stack(xs) for xs in zip(*rows)])
        ppo.obs = obs
        _, returns, norm_adv = ppo.gae(traj, ppo.last_value(obs, ()))
        stats = ppo.update(traj, returns, norm_adv,
                           ppo.draw_perm(T, self.num_envs))
        ppo.iteration += 1
        stats.update(mean_reward=reward_sum / T,  # pre-bootstrap
                     dones=dones_sum, mean_noise_std=ppo.mean_noise_std())
        return stats
