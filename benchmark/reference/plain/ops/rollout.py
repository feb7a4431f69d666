# A frozen copy of the port's ops/rollout.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
"""Plain versions of the port's ``ops/rollout.py``."""

from __future__ import annotations
import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple
import torch
from torch import nn
from benchmark.reference.plain.models import actor_critic as ac
from benchmark.reference.plain.utils.device import full_float32


MAX_LAYERS = 8        # rollout_env.cuh kMaxLayers, Linear layers per net


ACTIVATIONS = (nn.ELU, nn.ReLU, nn.SELU, nn.LeakyReLU, nn.Tanh, nn.Sigmoid)


class ActOut(NamedTuple):
    """What ``act`` returns: the action for ``env.step`` and the value for
    the bootstrap; mu, std and logp where no trajectory was given (with
    one, its rows hold them and these are None)."""

    action: torch.Tensor
    mu: Optional[torch.Tensor]
    std: Optional[torch.Tensor]
    value: torch.Tensor
    logp: Optional[torch.Tensor]


ACT_ROWS = ("obs", "action", "value", "logp", "mu", "sigma")


@dataclasses.dataclass
class Plan:
    """A net's layout for the kernels: its ``Linear`` layers (the actor's,
    then the critic's), the activation's id and parameter, the net (whose
    std and std_floor act reads)."""

    net: nn.Module
    actor: List[nn.Linear]
    critic: List[nn.Linear]
    kind: int
    alpha: float

    @property
    def layers(self) -> List[nn.Linear]:
        return self.actor + self.critic


def _refuse(why: str):
    raise ValueError(f"the rollout kernels do not take this net: {why}")


def _linears(mlp: nn.Module, name: str) -> Tuple[List[nn.Linear], list]:
    """An MLP's Linear layers and its activation modules: Linear,
    activation, ..., Linear."""
    mods = list(mlp) if isinstance(mlp, nn.Sequential) else None
    if not mods or len(mods) % 2 == 0:
        _refuse(f"{name} is not a Sequential of Linear, activation, ..., "
                "Linear")
    lins, acts = mods[0::2], mods[1::2]
    odd = [type(m).__name__ for m in lins if not isinstance(m, nn.Linear)]
    if odd:
        _refuse(f"{name} has a {odd[0]} where a Linear layer should be")
    if any(m.bias is None for m in lins):
        _refuse(f"{name} has a Linear layer without a bias")
    if len(lins) > MAX_LAYERS:
        _refuse(f"{name} has {len(lins)} Linear layers, more than "
                f"{MAX_LAYERS}")
    return lins, acts


def plan(net: nn.Module) -> Plan:
    """The kernels' layout of an ``ActorCritic`` or ``ActorCriticRecurrent``
    (its actor and critic MLPs; the recurrent net's LSTMs are not the
    kernels'); raises ValueError for a net they do not take."""
    for attr in ("actor", "critic", "std", "std_floor"):
        if not hasattr(net, attr):
            _refuse(f"it has no {attr}")
    actor, a_acts = _linears(net.actor, "the actor")
    critic, c_acts = _linears(net.critic, "the critic")
    acts = a_acts + c_acts
    kinds = {type(m) for m in acts}
    if len(kinds) > 1:
        _refuse(f"it mixes the activations {sorted(k.__name__ for k in kinds)}")
    kind, alpha = 0, 1.0
    if acts:
        m = acts[0]
        if type(m) not in ACTIVATIONS:
            _refuse(f"the activation {type(m).__name__}")
        kind = ACTIVATIONS.index(type(m))
        params = {(getattr(x, "alpha", None), getattr(x, "negative_slope", None))
                  for x in acts}
        if len(params) > 1:
            _refuse("its activations differ in their parameter")
        alpha = float(getattr(m, "alpha", getattr(m, "negative_slope", 1.0)))
    A = net.std.shape[0]
    if actor[-1].out_features != A or critic[-1].out_features != 1:
        _refuse(f"the heads are {actor[-1].out_features} and "
                f"{critic[-1].out_features} wide, not {A} and 1")
    return Plan(net, actor, critic, kind, alpha)


def _std(net, mu: torch.Tensor) -> torch.Tensor:
    std = net.std.expand_as(mu)
    if net.std_floor > 0.0:
        std = torch.clamp_min(std, net.std_floor)
    return std


def plain_act(pl: Plan, obs: torch.Tensor, x_a: torch.Tensor,
              x_c: torch.Tensor, eps: torch.Tensor, traj=None,
              t: Optional[torch.Tensor] = None) -> ActOut:
    """The policy step: mu, value, std, action = mu + std * eps, logp; with
    ``traj`` (a Transition of (T, N, ...) buffers) row ``t`` of its obs,
    action, value, logp, mu and sigma."""
    net = pl.net
    with full_float32():
        mu = net.actor(x_a)
        value = net.critic(x_c)[..., 0]
    std = _std(net, mu)
    action = mu + std * eps
    logp = ac.log_prob(mu, std, action)
    if traj is None:
        return ActOut(action, mu, std, value, logp)
    for name, x in zip(ACT_ROWS, (obs, action, value, logp, mu, std)):
        getattr(traj, name).index_copy_(0, t, x[None])
    return ActOut(action, None, None, value, None)


def plain_store(traj, t: torch.Tensor, reward: torch.Tensor,
                time_out: torch.Tensor, done: torch.Tensor,
                value: torch.Tensor, finished: torch.Tensor,
                n_done: torch.Tensor, term_sums: torch.Tensor, gamma: float,
                rec: Optional[torch.Tensor] = None,
                record: Optional[Sequence[torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The timeout bootstrap (rsl_rl PPO.process_env_step) and done into
    row ``t`` of ``traj``; with ``rec``, env 0's row of ``record`` =
    (qpos, qvel, action, done, commands) into its row ``t``; returns t + 1
    and the running count and term sums of the finished episodes
    (``finished``: their sums, NaN where an env did not finish)."""
    reward = reward + gamma * value * time_out.to(value.dtype)
    traj.reward.index_copy_(0, t, reward[None])
    traj.done.index_copy_(0, t, done[None])
    if rec is not None:
        row = torch.cat([x[0].reshape(-1).to(rec.dtype) for x in record])
        rec.index_copy_(0, t, row[None])
    n_done = n_done + torch.sum(~torch.isnan(finished[:, 0]))
    term_sums = term_sums + torch.nansum(finished, dim=0)
    return t + 1, n_done, term_sums


act = plain_act
store = plain_store
