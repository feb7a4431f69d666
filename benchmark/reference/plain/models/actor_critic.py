# A frozen copy of the port's models/actor_critic.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
"""Actor-critics matching rsl_rl's ActorCritic and ActorCriticRecurrent
modules (port of ``nightmare_rl_tpu/models/actor_critic.py``).

MLP actor + MLP critic (hidden dims [54, 42, 30], elu) and a
state-independent std vector that is itself the parameter.  The module
layout is rsl_rl's: ``nn.Sequential(Linear, act, ..., Linear)`` under
``actor`` and ``critic`` plus ``std``, so a reference ``model_*.pt``
state_dict loads with ``load_state_dict``.  The recurrent net puts one LSTM
in front of each MLP, under ``memory_a.rnn`` and ``memory_c.rnn`` as rsl_rl
does.

Hidden-state order: the port carries ``((h_a, c_a), (h_c, c_c))``, torch's
``(h, c)`` per LSTM, each (batch, rnn_hidden).  The JAX package's flax cells
carry ``(c, h)``; swap the pair where a state crosses over.

Both nets run at full float32 precision whatever the caller's TF32 flags
(torch lets cuDNN's RNNs use TF32 by default, and
``torch.set_float32_matmul_precision("high")`` would put the MLPs'
products in TF32): ``ActorCritic.forward``, ``act_inference`` and
``Memory.forward`` run under ``utils.device.full_float32``, and so must
every backward pass through them (``rl/ppo.py`` wraps its
``loss.backward()``).

``reset_parameters(generator)`` draws every weight anew from its init
distribution with a CPU generator, so a seed fixes the weights
(``rl/ppo.py::PPO.init_params``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from benchmark.reference.plain.parallel.shard import Shard
from benchmark.reference.plain.utils.device import full_float32

_ACTIVATIONS = {
    "elu": nn.ELU,
    "relu": nn.ReLU,
    "selu": nn.SELU,
    "lrelu": nn.LeakyReLU,
    "tanh": nn.Tanh,
    "sigmoid": nn.Sigmoid,
}


def _draw_(param: torch.Tensor, init_fn, generator=None, **kw) -> None:
    """Draw ``param`` from ``init_fn`` (an ``nn.init`` function) with
    ``generator`` (a CPU generator; torch's global RNG when None), through
    a float32 CPU tensor: one seed gives the same weights on every device
    and dtype, and the global-RNG draws are those of an in-place init."""
    tmp = torch.empty(param.shape, dtype=torch.float32)
    init_fn(tmp, generator=generator, **kw)
    with torch.no_grad():
        param.copy_(tmp)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> None:
    """flax's default kernel init (the JAX package's): lecun-normal
    truncated at 2σ."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    _draw_(w, nn.init.trunc_normal_, generator, std=std, a=-2 * std,
           b=2 * std)


def _init_linear_(m: nn.Linear, generator=None) -> None:
    """flax Dense's default init: lecun-normal kernel, zero bias."""
    _lecun_normal_(m.weight, m.in_features, generator)
    with torch.no_grad():
        m.bias.zero_()


def _init_mlp_(mlp: nn.Sequential, generator=None) -> None:
    for m in mlp:
        if isinstance(m, nn.Linear):
            _init_linear_(m, generator)


def _mlp(n_in: int, hidden: Sequence[int], n_out: int,
         activation: str) -> nn.Sequential:
    layers = []
    dims = [n_in, *hidden]
    for a, b in zip(dims[:-1], dims[1:]):
        layers += [nn.Linear(a, b), _ACTIVATIONS[activation]()]
    layers.append(nn.Linear(dims[-1], n_out))
    mlp = nn.Sequential(*layers)
    _init_mlp_(mlp)
    return mlp


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
        self.init_noise_std = init_noise_std
        # exploration floor (flag-gated deviation from rsl_rl; 0 = parity):
        # >0 clamps the std used for sampling and likelihood
        self.std_floor = std_floor

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter anew from its init distribution with
        ``generator`` (a CPU generator), in place."""
        _init_mlp_(self.actor, generator)
        _init_mlp_(self.critic, generator)
        with torch.no_grad():
            self.std.fill_(self.init_noise_std)

    @full_float32()
    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (mu, std, value)."""
        mu = self.actor(obs)
        v = self.critic(obs)[..., 0]
        std = self.std.expand_as(mu)
        if self.std_floor > 0.0:
            std = torch.clamp_min(std, self.std_floor)
        return mu, std, v

    @full_float32()
    def act_inference(self, obs: torch.Tensor) -> torch.Tensor:
        return self.actor(obs)


Carry = Tuple[torch.Tensor, torch.Tensor]   # torch's (h, c)
Hidden = Tuple[Carry, Carry]                # (actor carry, critic carry)


class Memory(nn.Module):
    """rsl_rl's Memory: a one-layer ``nn.LSTM`` under ``rnn``, stepped one
    time step per call (a done-mask between steps rules out a sequence
    call).  Initialised as flax's ``OptimizedLSTMCell``: per gate, input
    kernels lecun-normal, recurrent kernels orthogonal, zero biases.  The
    flax cell has one bias per gate, so ``bias_ih`` is frozen (it stays in
    the state dict, at zero unless a file sets it): training both biases
    would move each gate's bias by two optimizer steps."""

    def __init__(self, n_in: int, hidden: int):
        super().__init__()
        self.rnn = nn.LSTM(n_in, hidden, num_layers=1)
        self.reset_parameters()
        self.rnn.bias_ih_l0.requires_grad_(False)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Draw the LSTM's weights with ``generator`` (torch's global RNG
        when None), in place."""
        rnn = self.rnn
        _lecun_normal_(rnn.weight_ih_l0, rnn.input_size, generator)
        for w in rnn.weight_hh_l0.chunk(4):
            _draw_(w, nn.init.orthogonal_, generator)
        with torch.no_grad():
            rnn.bias_ih_l0.zero_()
            rnn.bias_hh_l0.zero_()

    def forward(self, x: torch.Tensor, carry: Carry) -> Tuple[torch.Tensor, Carry]:
        h, c = carry
        with full_float32():
            out, (h, c) = self.rnn(x[None], (h[None], c[None]))
        return out[0], (h[0], c[0])


class ActorCriticRecurrent(nn.Module):
    """rsl_rl's ActorCriticRecurrent: an LSTM memory in front of the actor
    MLP and another in front of the critic MLP, whose inputs are the LSTM
    outputs (width ``rnn_hidden``)."""

    def __init__(self, num_obs: int, num_actions: int,
                 actor_hidden: Sequence[int] = (54, 42, 30),
                 critic_hidden: Sequence[int] = (54, 42, 30),
                 activation: str = "elu", init_noise_std: float = 1.0,
                 rnn_hidden: int = 512, std_floor: float = 0.0):
        super().__init__()
        self.memory_a = Memory(num_obs, rnn_hidden)
        self.memory_c = Memory(num_obs, rnn_hidden)
        self.actor = _mlp(rnn_hidden, actor_hidden, num_actions, activation)
        self.critic = _mlp(rnn_hidden, critic_hidden, 1, activation)
        self.std = nn.Parameter(torch.full((num_actions,), init_noise_std))
        self.init_noise_std = init_noise_std
        self.std_floor = std_floor  # as in ActorCritic
        self.rnn_hidden = rnn_hidden

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every parameter anew from its init distribution with
        ``generator`` (a CPU generator), in place."""
        self.memory_a.reset_parameters(generator)
        self.memory_c.reset_parameters(generator)
        _init_mlp_(self.actor, generator)
        _init_mlp_(self.critic, generator)
        with torch.no_grad():
            self.std.fill_(self.init_noise_std)

    def initial_state(self, batch: int) -> Hidden:
        """Zero carries for ``batch`` envs, on the net's device and dtype."""
        z = self.std.new_zeros(batch, self.rnn_hidden)
        return ((z, z), (z, z))

    def memory(self, obs: torch.Tensor, hidden: Hidden
               ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Hidden]:
        """The LSTMs' step: ``(actor MLP's input, critic MLP's input),
        new_hidden``."""
        out_a, carry_a = self.memory_a(obs, hidden[0])
        out_c, carry_c = self.memory_c(obs, hidden[1])
        return (out_a, out_c), (carry_a, carry_c)

    def forward(self, obs: torch.Tensor, hidden: Hidden
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Hidden]:
        """One step: ``(mu, std, value), new_hidden``; obs (batch, num_obs)."""
        (out_a, out_c), (carry_a, carry_c) = self.memory(obs, hidden)
        mu = self.actor(out_a)
        v = self.critic(out_c)[..., 0]
        std = self.std.expand_as(mu)
        if self.std_floor > 0.0:
            std = torch.clamp_min(std, self.std_floor)
        return (mu, std, v), (carry_a, carry_c)


def reset_hidden(hidden: Hidden, done: torch.Tensor) -> Hidden:
    """Zero the carries of finished envs (done: (batch,) bool)."""
    keep = (~done)[:, None]
    return tuple(tuple(x * keep for x in carry) for carry in hidden)


def sample_action(mu: torch.Tensor, std: torch.Tensor,
                  generator: torch.Generator,
                  shard: Shard = Shard()) -> torch.Tensor:
    """mu + std·ε with ε drawn at the global batch shape (parallel/shard.py)."""
    noise = shard.draw(torch.randn, mu.shape, generator=generator,
                       dtype=mu.dtype, device=mu.device)
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
