"""The plain reference of a training cell: the env, the actor-critic and
PPO's learning half from ``reference/plain`` (a frozen copy of the port's
plain PyTorch path), float32 with TF32 off, built from a configuration
file's dicts.  It imports nothing of the program.

- ``start(seed)``: the train state that ``PPO.init(seed)`` and
  ``randomize_episode_lengths`` make: the weights from the seed, the envs'
  reset state and observations, the episode lengths.
- ``rollout_step(...)``: one rollout step (``act``, ``env.step``, ``store``)
  from a given state, weights and generator states: the program's step
  followed one step at a time from the program's own state.
- ``Learner``: PPO's learning half (the last value, GAE, the normalization,
  5 x 4 minibatch gradients and Adam steps with the adaptive lr) on given
  trajectories and permutations, from its own weights and Adam state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from benchmark.reference.plain.core import config as C
from benchmark.reference.plain.models import actor_critic as ac
from benchmark.reference.plain.ops import learn as L
from benchmark.reference.plain.ops import rollout as R
from benchmark.reference.plain.parallel.shard import Shard


class Transition(NamedTuple):
    """A rollout's trajectory (T, N, ...), in the program's field order."""
    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    value: torch.Tensor
    logp: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor


def from_dict(default, values: dict):
    """``default`` (a dataclass instance) with the fields that ``values``
    names replaced, nested dataclasses recursively; a list becomes a tuple
    where the default holds one.  An unknown key raises."""
    names = {f.name for f in dataclasses.fields(default)}
    kw = {}
    for k, v in values.items():
        if k not in names:
            raise KeyError(f"{type(default).__name__} has no field {k!r}")
        cur = getattr(default, k)
        if dataclasses.is_dataclass(cur):
            v = from_dict(cur, v)
        elif isinstance(cur, tuple):
            v = tuple(v)
        kw[k] = v
    return dataclasses.replace(default, **kw)


def make_env(config: dict, num_envs: int, device):
    """The reference env of a configuration file at ``num_envs`` envs."""
    env_cfg = dict(config["env"])
    if config["robot"] == "anymal_c":
        from benchmark.reference.plain.envs.anymal_c import (AnymalCCfg,
                                                             AnymalCEnv)
        env_cfg["num_envs"] = num_envs
        return AnymalCEnv(from_dict(AnymalCCfg(), env_cfg), device=device)
    from benchmark.reference.plain.envs.nightmare_v3 import NightmareV3Env
    env_cfg["env"] = dict(env_cfg["env"], num_envs=num_envs)
    return NightmareV3Env(from_dict(C.NightmareV3Cfg(), env_cfg),
                          device=device)


def params_from_seed(net: torch.nn.Module, seed: int) -> None:
    """The weights that ``PPO.init_params(seed)`` draws: their init
    distributions on a CPU generator seeded from (seed, 1)."""
    state = np.random.SeedSequence([seed, 1]).generate_state(2)
    gen = torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))
    net.reset_parameters(gen)


class Reference:
    """One configuration at one cell's size: the env, the net and PPO's
    config, on ``device``."""

    def __init__(self, config: dict, num_envs: int, device):
        self.device = torch.device(device)
        self.env = make_env(config, num_envs, self.device)
        self.cfg = from_dict(C.PPOCfg(), config["ppo"])
        p = self.cfg.policy
        if self.cfg.runner.policy_class_name != "ActorCritic":
            raise ValueError("the reference takes the feed-forward "
                             "actor-critic only")
        self.net = ac.ActorCritic(
            self.env.num_obs, self.env.num_actions,
            actor_hidden=tuple(p.actor_hidden_dims),
            critic_hidden=tuple(p.critic_hidden_dims),
            activation=p.activation, init_noise_std=p.init_noise_std,
            std_floor=p.std_floor).to(self.device)
        self.plan = R.plan(self.net)
        self.params = list(self.net.parameters())
        self.N = num_envs

    def load(self, params) -> None:
        with torch.no_grad():
            for p, x in zip(self.params, params):
                p.copy_(x)

    def start(self, seed: int) -> Dict[str, object]:
        """The train state of ``seed`` as ``PPO.init`` and
        ``randomize_episode_lengths`` make it."""
        params_from_seed(self.net, seed)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        state, obs = self.env.reset(seed)
        state.episode_length.copy_(Shard().randint(
            self.env.max_episode_length, self.N, generator=gen,
            device=self.device, dtype=torch.int32))
        return dict(params=[p.detach().clone() for p in self.params],
                    state=state, obs=obs)

    @torch.no_grad()
    def rollout_step(self, params, state, obs, gen_ppo, gen_env,
                     record: bool) -> Dict[str, object]:
        """One rollout step from ``state`` and ``obs`` with the weights
        ``params``; ``gen_ppo`` and ``gen_env`` are the states of the
        action noise's and the env's generators before the step.  Returns
        the next state and observations, the trajectory's row and env 0's
        record row."""
        self.load(params)
        N, A, dt = self.N, self.env.num_actions, obs.dtype
        g = torch.Generator(device=self.device)
        g.set_state(gen_ppo)
        eps = Shard().draw(torch.randn, (N, A), generator=g, dtype=dt,
                           device=self.device)
        row = Transition(*[torch.empty(1, N, *s, dtype=d, device=self.device)
                             for s, d in ((obs.shape[1:], dt), ((A,), dt),
                                          ((), dt), ((), torch.bool), ((), dt),
                                          ((), dt), ((A,), dt), ((A,), dt))])
        t0 = torch.zeros(1, dtype=torch.long, device=self.device)
        pol = R.plain_act(self.plan, obs, obs, obs, eps, row, t0)
        self.env.generator.set_state(gen_env)
        out = self.env.step(state, pol.action)
        rec, rec_row = None, None
        if record:
            src = (out.record_qpos, out.record_qvel, pol.action, out.done,
                   out.state.commands)
            rec = torch.empty(1, sum(x[0].numel() for x in src), dtype=dt,
                              device=self.device)
            rec_row = src
        zero = torch.zeros((), dtype=dt, device=self.device)
        R.plain_store(row, t0, out.reward, out.time_out, out.done, pol.value,
                      out.finished_episode_sums, zero,
                      torch.zeros(out.finished_episode_sums.shape[1],
                                  dtype=dt, device=self.device),
                      self.cfg.algorithm.gamma, rec, rec_row)
        return dict(state=out.state, obs=out.obs,
                    row=Transition(*[x[0] for x in row]),
                    record=None if rec is None else rec[0])


class Learner:
    """PPO's learning half in plain PyTorch, from its own weights (the
    reference's, from the seed) and a fresh Adam state: ``first_steps``
    runs the first minibatch steps of an iteration on a given trajectory,
    last observations and permutation, as ``PPO._learn`` does (the last
    value, GAE, the normalization, a minibatch's losses and gradients, the
    adaptive lr, the clip, Adam's step).  ``half`` plants a fault for the
    control's readings: each minibatch's mean taken over half its samples.
    """

    def __init__(self, ref: Reference, half: bool = False):
        self.ref = ref
        self.half = half
        self.cfg = ref.cfg
        dev = ref.device
        self.lr = torch.tensor(self.cfg.algorithm.learning_rate,
                               dtype=torch.float32, device=dev)
        self.opt = torch.optim.Adam(ref.params, lr=self.lr,
                                    betas=(0.9, 0.999), eps=1e-8, fused=True,
                                    capturable=dev.type == "cuda")
        self.flat = torch.zeros(sum(p.numel() for p in ref.params) + 1,
                                dtype=torch.float32, device=dev)
        i = 0
        for p in ref.params:
            p.grad = self.flat[i:i + p.numel()].view_as(p)
            i += p.numel()
        for p in ref.params:
            self.opt.state[p] = {
                "step": torch.zeros((), dtype=torch.float32, device=dev),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}

    def exp_avg(self) -> List[torch.Tensor]:
        return [self.opt.state[p]["exp_avg"] for p in self.ref.params]

    def first_steps(self, traj: Transition, obs: torch.Tensor,
                    perm: torch.Tensor, lrs: List[float]) -> Dict[str, object]:
        """The iteration's first ``len(lrs)`` minibatch steps.  Step j
        decides its lr by the adaptive rule from its own KL (``rule_lr``,
        with the KL it read) and then steps with ``lrs[j]``, the lr that the
        program's step took: a decision taken on the rule's round-off floor
        (a KL of 0 to rounding, at the first step, where the policy has not
        moved) may go either way in two sound programs, and the weights
        would part by it.  Returns each step's (loss, surrogate, value
        loss, kl), the rule's lr, Adam's first moments after the first step
        and the weights after the last."""
        a = self.cfg.algorithm
        net = self.ref.net
        with torch.no_grad():
            last_value = net(obs)[2]
            adv, returns, mean = L.plain_gae(traj.reward, traj.value,
                                             traj.done, last_value, a.gamma,
                                             a.lam)
            var = torch.square(adv - mean).sum() / max(adv.numel() - 1, 1)
            norm_adv = (adv - mean) / (torch.sqrt(var) + 1e-8)
        rows, rule, params, exp_avg1 = [], [], [], None
        for j, idx in enumerate(perm.reshape(a.num_mini_batches, -1)):
            if j == len(lrs):
                break
            if self.half:  # the planted fault of the readings
                idx = idx[:idx.numel() // 2]
            losses = L.plain_grads(self.ref.plan, a, traj, returns, norm_adv,
                                   idx, self.flat)
            with torch.no_grad():
                rule.append(float(L.adapt_lr(a, self.lr, self.flat[-1])))
                self.lr.fill_(lrs[j])
            L.clip_by_global_norm(self.ref.params, a.max_grad_norm)
            self.opt.step()
            rows.append(torch.cat([losses, self.flat[-1:]]).tolist())
            params.append([p.detach().clone() for p in self.ref.params])
            if j == 0:
                exp_avg1 = [x.detach().clone() for x in self.exp_avg()]
        return dict(rows=rows, rule_lr=rule, exp_avg1=exp_avg1, params=params)
