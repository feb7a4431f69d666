"""Actor-critic matching rsl_rl's ActorCritic module (port of the
feed-forward half of ``nightmare_rl_tpu/models/actor_critic.py``).

MLP actor + MLP critic (hidden dims [54, 42, 30], elu) and a
state-independent std vector that is itself the parameter.  The module
layout is rsl_rl's: ``nn.Sequential(Linear, act, ..., Linear)`` under
``actor`` and ``critic`` plus ``std``, so a reference ``model_*.pt``
state_dict loads with ``load_state_dict``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

_ACTIVATIONS = {
    "elu": nn.ELU,
    "relu": nn.ReLU,
    "selu": nn.SELU,
    "lrelu": nn.LeakyReLU,
    "tanh": nn.Tanh,
    "sigmoid": nn.Sigmoid,
}


def _mlp(n_in: int, hidden: Sequence[int], n_out: int,
         activation: str) -> nn.Sequential:
    layers = []
    dims = [n_in, *hidden]
    for a, b in zip(dims[:-1], dims[1:]):
        layers += [nn.Linear(a, b), _ACTIVATIONS[activation]()]
    layers.append(nn.Linear(dims[-1], n_out))
    for m in layers:
        if isinstance(m, nn.Linear):
            # flax Dense's default init (the JAX package's): lecun-normal
            # truncated at 2σ, zero bias
            std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std)
            nn.init.zeros_(m.bias)
    return nn.Sequential(*layers)


class ActorCritic(nn.Module):
    def __init__(self, num_obs: int, num_actions: int,
                 actor_hidden: Sequence[int] = (54, 42, 30),
                 critic_hidden: Sequence[int] = (54, 42, 30),
                 activation: str = "elu", init_noise_std: float = 1.0,
                 std_floor: float = 0.0):
        super().__init__()
        self.actor = _mlp(num_obs, actor_hidden, num_actions, activation)
        self.critic = _mlp(num_obs, critic_hidden, 1, activation)
        # the raw parameter (rsl_rl keeps it positive only implicitly)
        self.std = nn.Parameter(torch.full((num_actions,), init_noise_std))
        # exploration floor (flag-gated deviation from rsl_rl; 0 = parity):
        # >0 clamps the std used for sampling and likelihood
        self.std_floor = std_floor

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (mu, std, value)."""
        mu = self.actor(obs)
        v = self.critic(obs)[..., 0]
        std = self.std.expand_as(mu)
        if self.std_floor > 0.0:
            std = torch.clamp_min(std, self.std_floor)
        return mu, std, v

    def act_inference(self, obs: torch.Tensor) -> torch.Tensor:
        return self.actor(obs)


def sample_action(mu: torch.Tensor, std: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    noise = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                        device=mu.device)
    return mu + std * noise


def log_prob(mu, std, action) -> torch.Tensor:
    """Diagonal Gaussian log-density, summed over the action dim."""
    lp = -0.5 * (torch.square(action - mu) / torch.square(std)
                 + 2.0 * torch.log(std) + math.log(2.0 * math.pi))
    return torch.sum(lp, dim=-1)


def entropy(std) -> torch.Tensor:
    return torch.sum(0.5 * (1.0 + math.log(2.0 * math.pi)) + torch.log(std),
                     dim=-1)


def gaussian_kl(mu_old, std_old, mu_new, std_new) -> torch.Tensor:
    """rsl_rl's adaptive-lr KL: sum over dims of
    log(σ'/σ) + (σ² + (μ−μ')²)/(2σ'²) − ½."""
    return torch.sum(
        torch.log(std_new / std_old)
        + (torch.square(std_old) + torch.square(mu_old - mu_new))
        / (2.0 * torch.square(std_new))
        - 0.5,
        dim=-1,
    )
