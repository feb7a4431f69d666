# A frozen copy of the port's ops/learn.py (its plain path only), the
# benchmark's reference: imports point at this copy, and what ran as
# a CUDA kernel calls the plain version.
"""Plain versions of the port's ``ops/learn.py``."""

from __future__ import annotations
import torch
from benchmark.reference.plain.models import actor_critic as ac
from benchmark.reference.plain.ops.rollout import Plan
from benchmark.reference.plain.utils.device import constant, full_float32


def plain_gae(reward: torch.Tensor, value: torch.Tensor, done: torch.Tensor,
              last_value: torch.Tensor, gamma: float, lam: float):
    """GAE's recursion from V of the rollout's last observations:
    (advantages, returns, the mean advantage)."""
    next_values = torch.cat([value[1:], last_value[None]], dim=0)
    adv = torch.zeros_like(last_value)
    advantages = torch.empty_like(value)
    for t in reversed(range(value.shape[0])):
        nonterminal = 1.0 - done[t].to(value.dtype)
        delta = (reward[t] + gamma * next_values[t] * nonterminal
                 - value[t])
        adv = delta + gamma * lam * nonterminal * adv
        advantages[t] = adv
    return advantages, advantages + value, advantages.mean()


def loss_terms(algo, mb, mb_ret, mb_adv, mu, std, value):
    """The PPO losses of a minibatch ``mb`` (a Transition) from the net's
    fresh outputs: (loss, surrogate, value loss, KL)."""
    logp = ac.log_prob(mu, std, mb.action)
    ratio = torch.exp(logp - mb.logp)
    surr1 = -mb_adv * ratio
    surr2 = -mb_adv * torch.clamp(ratio, 1.0 - algo.clip_param,
                                  1.0 + algo.clip_param)
    surrogate = torch.maximum(surr1, surr2).mean()
    if algo.use_clipped_value_loss:
        v_clip = mb.value + torch.clamp(value - mb.value, -algo.clip_param,
                                        algo.clip_param)
        v_loss = torch.maximum(torch.square(value - mb_ret),
                               torch.square(v_clip - mb_ret)).mean()
    else:
        v_loss = torch.square(value - mb_ret).mean()
    ent = ac.entropy(std).mean()
    loss = surrogate + algo.value_loss_coef * v_loss - algo.entropy_coef * ent
    kl = ac.gaussian_kl(mb.mu, mb.sigma, mu, std).mean()
    return loss, surrogate, v_loss, kl


def _gathered(traj, returns, norm_adv, idx):
    """The minibatch's rows ``idx`` of the (T·N, ·) trajectory, returns and
    normalized advantages."""
    B = returns.numel()
    mb = type(traj)(*[x.reshape((B,) + x.shape[2:])[idx] for x in traj])
    return mb, returns.reshape(B)[idx], norm_adv.reshape(B)[idx]


def plain_grads(pl: Plan, algo, traj, returns: torch.Tensor,
                norm_adv: torch.Tensor, idx: torch.Tensor,
                flat: torch.Tensor) -> torch.Tensor:
    """The losses on the samples ``idx`` and their gradients, by autograd,
    into the parameters' gradients (views of ``flat``, zeroed first),
    the KL into ``flat``'s last element.  Returns (loss, surrogate loss,
    value loss)."""
    mb, mb_ret, mb_adv = _gathered(traj, returns, norm_adv, idx)
    mu, std, value = pl.net(mb.obs)
    loss, surr, v_loss, kl = loss_terms(algo, mb, mb_ret, mb_adv, mu, std,
                                        value)
    # in place: backward accumulates into the flat buffer's views
    pl.net.zero_grad(set_to_none=False)
    with full_float32():
        loss.backward()
    with torch.no_grad():
        flat[-1].copy_(kl)
    return torch.stack([loss.detach(), surr.detach(), v_loss.detach()])


def adapt_lr(algo, lr: torch.Tensor, kl: torch.Tensor) -> torch.Tensor:
    """rsl_rl's adaptive rule on the device (the JAX ``_adapt_lr``):
    lr ÷ 1.5 (at least 1e-5) where kl > 2·desired, lr × 1.5 (at most
    1e-2) where 0 < kl < desired / 2, else lr."""
    if algo.schedule != "adaptive":
        return lr
    # a 0-dim tensor: the card divides by a Python scalar as a product
    # with its reciprocal, which rounds differently
    by = constant((1.5,), lr.dtype, lr.device)[0]
    return torch.where(
        kl > algo.desired_kl * 2.0, torch.clamp_min(lr / by, 1e-5),
        torch.where((kl < algo.desired_kl / 2.0) & (kl > 0.0),
                    torch.clamp_max(lr * 1.5, 1e-2), lr))


def clip_by_global_norm(params, max_norm: float) -> None:
    """optax.clip_by_global_norm on the .grad of params, in place:
    g ← g where ‖g‖ < max_norm, else g / ‖g‖ · max_norm.  (torch's
    clip_grad_norm_ adds 1e-6 to the norm and so differs.)"""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def plain_adam(optimizer: torch.optim.Adam, flat: torch.Tensor,
               lr: torch.Tensor, world: int, algo,
               losses: torch.Tensor) -> torch.Tensor:
    """The flat buffer's mean over the ranks (in place), the adaptive lr
    from its KL (written into ``lr``, the optimizer's), the clip by global
    norm and the optimizer's step.  Returns (loss, surrogate loss, value
    loss, kl)."""
    with torch.no_grad():
        flat /= world
        lr.copy_(adapt_lr(algo, lr, flat[-1]))
    clip_by_global_norm(optimizer.param_groups[0]["params"],
                        algo.max_grad_norm)
    optimizer.step()
    return torch.cat([losses, flat[-1:]])


gae = plain_gae
