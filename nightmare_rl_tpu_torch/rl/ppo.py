"""PPO for the feed-forward actor-critic (port of the feed-forward path of
``nightmare_rl_tpu/rl/ppo.py``), mirroring rsl_rl v1.0.2's PPO:

- 80-step rollout per iteration, storage of
  (obs, action, reward, done, value, logp, mu, sigma);
- timeout bootstrapping: reward += γ·V(s)·timeout;
- GAE(γ=0.99, λ=0.95), advantages normalized over the whole batch (ddof=1);
- 5 epochs × 4 minibatches over ONE random permutation shared by all epochs;
- clipped surrogate (0.2) + clipped value loss + entropy bonus (0.0015);
- adaptive learning rate from each minibatch's KL (×1.5 / ÷1.5, clamped to
  [1e-5, 1e-2]), applied to that same minibatch's step;
- gradients clipped to global norm 1.0 by optax's rule, then Adam (eps 1e-8).

The rollout runs eagerly on the env's device; its action noise comes from
one ``torch.Generator``.  With ``record_states`` the rollout also keeps env
0's pre-reset ``(qpos, qvel, action, done, commands)`` each step on the
device and copies the stacked rows to the host once per iteration
(``stats["record"]``), for the trajectory recorder.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nightmare_rl_tpu_torch.core.config import PPOCfg
from nightmare_rl_tpu_torch.models import actor_critic as ac


class Transition(NamedTuple):
    obs: torch.Tensor     # (T, N, num_obs)
    action: torch.Tensor  # (T, N, A)
    reward: torch.Tensor  # (T, N) timeout-bootstrapped
    done: torch.Tensor    # (T, N) bool
    value: torch.Tensor   # (T, N)
    logp: torch.Tensor    # (T, N)
    mu: torch.Tensor      # (T, N, A)
    sigma: torch.Tensor   # (T, N, A)


def clip_by_global_norm(params, max_norm: float) -> None:
    """optax.clip_by_global_norm on the .grad of params, in place:
    g ← g where ‖g‖ < max_norm, else g / ‖g‖ · max_norm.  (torch's
    clip_grad_norm_ adds 1e-6 to the norm and so differs.)"""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _record_to_host(rows) -> Tuple[np.ndarray, ...]:
    """Env 0's per-step rows [(qpos, qvel, action, done, commands)] → the
    (T, ·) numpy arrays of each, in ONE device→host copy."""
    widths = [r.numel() for r in rows[0]]
    flat = torch.stack([torch.cat([x.reshape(-1).to(rows[0][0].dtype)
                                   for x in r]) for r in rows]).cpu().numpy()
    cols = np.split(flat, np.cumsum(widths)[:-1], axis=1)
    qpos, qvel, act, done, cmd = cols
    return qpos, qvel, act, done[:, 0] > 0.5, cmd


class PPO:
    def __init__(self, env, cfg: PPOCfg, record_states: bool = False):
        if cfg.runner.policy_class_name != "ActorCritic":
            raise NotImplementedError("only the feed-forward ActorCritic is ported")
        self.env = env
        self.cfg = cfg
        self.device = env.device
        self.dtype = env.dtype
        p, a = cfg.policy, cfg.algorithm
        self.net = ac.ActorCritic(
            env.num_obs, env.num_actions,
            actor_hidden=tuple(p.actor_hidden_dims),
            critic_hidden=tuple(p.critic_hidden_dims),
            activation=p.activation, init_noise_std=p.init_noise_std,
            std_floor=p.std_floor,
        ).to(device=self.device, dtype=self.dtype)
        self.lr = a.learning_rate
        self.optimizer = torch.optim.Adam(self.net.parameters(), lr=self.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.generator = torch.Generator(device=self.device)
        self.env_state = None
        self.obs = None
        self.iteration = 0
        self.record_states = record_states

    # ------------------------------------------------------------------

    def init(self, seed: int | None = None) -> None:
        seed = self.cfg.seed if seed is None else seed
        self.generator.manual_seed(seed)
        self.env_state, self.obs = self.env.reset(seed)

    def randomize_episode_lengths(self) -> None:
        """init_at_random_ep_len=True (train.py:54): spread initial episode
        lengths uniformly so resets decorrelate."""
        self.env_state.episode_length = torch.randint(
            0, self.env.max_episode_length, (self.env.num_envs,),
            generator=self.generator, device=self.device, dtype=torch.int32)

    # ------------------------------------------------------------------

    @torch.no_grad()
    def rollout(self):
        """One rollout of num_steps_per_env steps from the current state.
        Returns the trajectory, the episode metrics and env 0's recorded
        rows (host arrays, or None without ``record_states``)."""
        T = self.cfg.runner.num_steps_per_env
        gamma = self.cfg.algorithm.gamma
        env = self.env
        rows, rec = [], []
        n_done = torch.zeros((), device=self.device)
        term_sums = None
        state, obs = self.env_state, self.obs
        for _ in range(T):
            mu, std, value = self.net(obs)
            action = ac.sample_action(mu, std, self.generator)
            logp = ac.log_prob(mu, std, action)
            out = env.step(state, action)
            # timeout bootstrap (rsl_rl PPO.process_env_step)
            reward = out.reward + gamma * value * out.time_out.to(value.dtype)
            rows.append(Transition(obs, action, reward, out.done, value, logp,
                                   mu, std))
            if self.record_states:
                rec.append((out.record_qpos[0], out.record_qvel[0], action[0],
                            out.done[0], out.state.commands[0]))
            fin = out.finished_episode_sums
            n_done = n_done + torch.sum(~torch.isnan(fin[:, 0]))
            s = torch.nansum(fin, dim=0)
            term_sums = s if term_sums is None else term_sums + s
            state, obs = out.state, out.obs
        self.env_state, self.obs = state, obs
        traj = Transition(*[torch.stack(xs) for xs in zip(*rows)])
        record: Optional[tuple] = _record_to_host(rec) if rec else None
        return traj, n_done, term_sums, record

    def gae(self, traj: Transition, last_value: torch.Tensor):
        """Returns (advantages, returns, normalized advantages), each (T, N)."""
        a = self.cfg.algorithm
        next_values = torch.cat([traj.value[1:], last_value[None]], dim=0)
        adv = torch.zeros_like(last_value)
        advantages = torch.empty_like(traj.value)
        for t in reversed(range(traj.value.shape[0])):
            nonterminal = 1.0 - traj.done[t].to(traj.value.dtype)
            delta = (traj.reward[t] + a.gamma * next_values[t] * nonterminal
                     - traj.value[t])
            adv = delta + a.gamma * a.lam * nonterminal * adv
            advantages[t] = adv
        returns = advantages + traj.value
        n = advantages.numel()
        mean = advantages.mean()
        var = torch.square(advantages - mean).sum() / max(n - 1, 1)
        norm_adv = (advantages - mean) / (torch.sqrt(var) + 1e-8)
        return advantages, returns, norm_adv

    def _loss_terms(self, mb: Transition, mb_ret, mb_adv, mu, std, value):
        a = self.cfg.algorithm
        logp = ac.log_prob(mu, std, mb.action)
        ratio = torch.exp(logp - mb.logp)
        surr1 = -mb_adv * ratio
        surr2 = -mb_adv * torch.clamp(ratio, 1.0 - a.clip_param, 1.0 + a.clip_param)
        surrogate = torch.maximum(surr1, surr2).mean()
        if a.use_clipped_value_loss:
            v_clip = mb.value + torch.clamp(value - mb.value, -a.clip_param,
                                            a.clip_param)
            v_loss = torch.maximum(torch.square(value - mb_ret),
                                   torch.square(v_clip - mb_ret)).mean()
        else:
            v_loss = torch.square(value - mb_ret).mean()
        ent = ac.entropy(std).mean()
        loss = surrogate + a.value_loss_coef * v_loss - a.entropy_coef * ent
        kl = ac.gaussian_kl(mb.mu, mb.sigma, mu, std).mean()
        return loss, surrogate, v_loss, kl

    def _adapt_lr(self, kl: float) -> float:
        a = self.cfg.algorithm
        if a.schedule != "adaptive":
            return self.lr
        if kl > a.desired_kl * 2.0:
            return max(1e-5, self.lr / 1.5)
        if a.desired_kl / 2.0 > kl > 0.0:
            return min(1e-2, self.lr * 1.5)
        return self.lr

    def update(self, traj: Transition, returns: torch.Tensor,
               norm_adv: torch.Tensor, perm: torch.Tensor) -> Dict[str, float]:
        """The 5×4 minibatch update over the permutation ``perm`` of the
        T·N samples, shared by every epoch."""
        a = self.cfg.algorithm
        B = returns.numel()
        flat = Transition(*[x.reshape((B,) + x.shape[2:]) for x in traj])
        returns, norm_adv = returns.reshape(B), norm_adv.reshape(B)
        nmb = a.num_mini_batches
        idxs = perm.reshape(nmb, B // nmb)
        params = list(self.net.parameters())
        losses, surrs, v_losses, kls = [], [], [], []
        for _ in range(a.num_learning_epochs):
            for idx in idxs:
                mb = Transition(*[x[idx] for x in flat])
                mu, std, value = self.net(mb.obs)
                loss, surr, v_loss, kl = self._loss_terms(
                    mb, returns[idx], norm_adv[idx], mu, std, value)
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                # adaptive lr from this minibatch's KL, applied to its step
                self.lr = self._adapt_lr(float(kl.detach()))
                for group in self.optimizer.param_groups:
                    group["lr"] = self.lr
                clip_by_global_norm(params, a.max_grad_norm)
                self.optimizer.step()
                losses.append(loss.detach())
                surrs.append(surr.detach())
                v_losses.append(v_loss.detach())
                kls.append(kl.detach())
        return {
            "loss": float(torch.stack(losses).mean()),
            "surrogate_loss": float(torch.stack(surrs).mean()),
            "value_loss": float(torch.stack(v_losses).mean()),
            "kl": float(torch.stack(kls).mean()),
            "lr": self.lr,
        }

    def learn_step(self) -> Dict[str, object]:
        """One PPO iteration (rollout + update)."""
        t0 = time.perf_counter()
        traj, n_done, term_sums, record = self.rollout()
        with torch.no_grad():
            _, _, last_value = self.net(self.obs)
        _, returns, norm_adv = self.gae(traj, last_value)
        _sync(self.device)
        t1 = time.perf_counter()
        B = returns.numel()
        perm = torch.randperm(B, generator=self.generator, device=self.device)
        stats = self.update(traj, returns, norm_adv, perm)
        _sync(self.device)
        t2 = time.perf_counter()
        self.iteration += 1
        # mean finished-episode sums per reward term, per episode second
        n = float(n_done)
        ep_means = (term_sums / max(n, 1.0) / self.env.max_episode_length_s
                    if n > 0 else torch.zeros_like(term_sums))
        stats.update(
            mean_reward=float(traj.reward.mean()),
            dones=int(traj.done.sum()),
            episode_reward_means=ep_means.cpu().tolist(),
            mean_noise_std=float(torch.clamp_min(
                torch.abs(self.net.std.detach()),
                self.cfg.policy.std_floor).mean()),
            rollout_s=t1 - t0,
            update_s=t2 - t1,
        )
        if record is not None:
            # (qpos, qvel, action, done, commands), each (T, ·)
            stats["record"] = record
        return stats
