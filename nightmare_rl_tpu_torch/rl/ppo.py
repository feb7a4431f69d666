"""PPO for the feed-forward and recurrent actor-critics (port of
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

The recurrent policy (``cfg.runner.policy_class_name ==
"ActorCriticRecurrent"``, one LSTM layer) carries its hidden state through
the rollout, zeroed where an env is done, and takes the last value from one
extra LSTM step whose carry is discarded.  Its minibatches are groups of
whole-env trajectories, replayed through the LSTM for all T steps from the
rollout-start hidden state with the same done-masked resets, and
back-propagated through all T steps.

A rollout step (the policy step and its sample, ``env.step``, the
recurrent reset, the timeout bootstrap, the episode accumulations and the
step's rows) is one function, ``_rollout_step``: around the env's step,
two launches of the port's own kernels on the card (``ops/rollout.py``:
``act`` before it, ``store`` after it; the plain versions on the CPU).  On
the card it is captured once as a CUDA graph (``utils/graph.py``) and
replayed T times, the
counterpart of the JAX package's ``lax.scan`` inside ``jax.jit``, for both
robots' envs (``graph_step``; an env without it is called directly).  The
step writes its rows into preallocated
(T, N, ...) trajectory buffers at an index that it keeps on the device, so
a replay needs nothing from the host; the trajectory that ``rollout``
returns is those buffers, which the next rollout overwrites.  The env
state, observations and hidden state that the rollout carries are the
graph's static buffers: ``init``, ``randomize_episode_lengths`` and a
checkpoint restore write into them with ``copy_``.  The action noise comes
from one ``torch.Generator``, drawn at the global batch shape
(``parallel/shard.py``).  With ``record_states`` the rollout also keeps env
0's pre-reset ``(qpos, qvel, action, done, commands)`` each step on the
device and copies the rows to the host once per iteration
(``stats["record"]``), for the trajectory recorder.

The learning half of an iteration (``_learn``: the last value, GAE, the
update's permutation and the 5×4 minibatch steps) is split at its
reductions over the ranks into five parts (``Parts``): the prologue's
``head`` (last value, GAE's recursion, the local mean advantage), ``spread``
(the sum of squares about the global mean) and ``tail`` (normalization,
permutation), and a minibatch step's ``grads`` (losses, backward, the KL)
and ``step`` (the mean over the ranks, the adaptive lr, the clip, Adam).
On the card each part runs as a CUDA graph (``CapturedLearn``, through
``utils/graph.py::CapturedUpdate``), captured once and replayed, the
prologue's once per iteration and a step's once per minibatch with its
indices copied in, as the JAX update's ``lax.scan`` runs its compiled
body: the rest of the JAX package's ``jax.jit(self._iteration)``, whose
``shard_map`` holds the reductions that here run eagerly between the
replays (``_all_sum``, in place on the tensor one part wrote and the next
reads; the identity on one process).  As that scan carries ``(params,
opt_state, lr)``, nothing of it leaves the device: the learning rate is a
0-dim tensor that the adaptive rule updates with ``torch.where`` and Adam
reads (``fused=True``, and ``capturable=True`` on the card), the gradients
are views of one flat buffer (its last element a minibatch's KL) zeroed in
place, Adam's state is made with the optimizer and reset in place, and the
statistics (loss, surrogate, value loss, KL, lr) come back as one tensor
that ``learn_step`` reads with its episode sums, the iteration's one read.
On the card GAE's recursion, a minibatch's losses and gradients (the
feed-forward net's; the recurrent net's LSTM replay stays plain) and a
minibatch's step are launches of the port's own kernels
(``ops/learn.py``: ``gae``, ``grads``, ``adam``; the plain versions on the
CPU).
The hooks ``_all_sum``, ``gather_envs`` and ``any_rank`` are the identity
here; ``parallel/mesh.py::ShardedPPO`` makes them collectives, and its
learning half replays the same graphs.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nightmare_rl_tpu_torch.core.config import PPOCfg
from nightmare_rl_tpu_torch.models import actor_critic as ac
from nightmare_rl_tpu_torch.ops import learn as L
from nightmare_rl_tpu_torch.ops import rollout as R
from nightmare_rl_tpu_torch.ops.learn import clip_by_global_norm  # noqa: F401
from nightmare_rl_tpu_torch.parallel.shard import Shard
from nightmare_rl_tpu_torch.utils import graph as G
from nightmare_rl_tpu_torch.utils import trace
from nightmare_rl_tpu_torch.utils.device import full_float32
from nightmare_rl_tpu_torch.utils.graph import (
    CapturedStep, CapturedUpdate, assign, clone, leaves,
)

# the update's statistics, in the order of the tensor that ``_update`` returns
STAT_KEYS = ("loss", "surrogate_loss", "value_loss", "kl", "lr")


class Transition(NamedTuple):
    obs: torch.Tensor     # (T, N, num_obs)
    action: torch.Tensor  # (T, N, A)
    reward: torch.Tensor  # (T, N) timeout-bootstrapped
    done: torch.Tensor    # (T, N) bool
    value: torch.Tensor   # (T, N)
    logp: torch.Tensor    # (T, N)
    mu: torch.Tensor      # (T, N, A)
    sigma: torch.Tensor   # (T, N, A)


def _sync(device: torch.device) -> None:
    trace.count("host.syncs")
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _record_to_host(rows: torch.Tensor, widths) -> Tuple[np.ndarray, ...]:
    """Env 0's rows (T, Σ widths) of [qpos | qvel | action | done |
    commands] → the (T, ·) numpy arrays of each, in ONE device→host copy."""
    trace.count("host.syncs")
    cols = np.split(rows.cpu().numpy(), np.cumsum(widths)[:-1], axis=1)
    qpos, qvel, act, done, cmd = cols
    return qpos, qvel, act, done[:, 0] > 0.5, cmd


class PPO:
    distributed = False  # ShardedPPO reduces over the ranks of a mesh
    # the learning half of the iteration runs as captured graphs on the card
    # (``CapturedLearn``), at any world size
    graph_update = True

    def __init__(self, env, cfg: PPOCfg, record_states: bool = False):
        self.env = env
        self.cfg = cfg
        self.device = env.device
        self.dtype = env.dtype
        self.shard = getattr(env, "shard", Shard())
        if self.shard.world > 1 and not self.distributed:
            raise ValueError("an env sharded over several ranks needs "
                             "parallel.mesh.ShardedPPO")
        p = cfg.policy
        kind = cfg.runner.policy_class_name
        self.recurrent = kind == "ActorCriticRecurrent"
        if self.recurrent:
            if p.rnn_type != "lstm" or p.rnn_num_layers != 1:
                raise NotImplementedError("the recurrent policy is a "
                                          "single-layer LSTM")
            self.net = ac.ActorCriticRecurrent(
                env.num_obs, env.num_actions,
                actor_hidden=tuple(p.actor_hidden_dims),
                critic_hidden=tuple(p.critic_hidden_dims),
                activation=p.activation, init_noise_std=p.init_noise_std,
                rnn_hidden=p.rnn_hidden_size, std_floor=p.std_floor)
        elif kind == "ActorCritic":
            self.net = ac.ActorCritic(
                env.num_obs, env.num_actions,
                actor_hidden=tuple(p.actor_hidden_dims),
                critic_hidden=tuple(p.critic_hidden_dims),
                activation=p.activation, init_noise_std=p.init_noise_std,
                std_floor=p.std_floor)
        else:
            raise ValueError(f"unknown policy_class_name {kind!r}")
        self.net.to(device=self.device, dtype=self.dtype)
        # the rollout kernels' layout of the net (ValueError for one they do
        # not take, on every device)
        self.act_plan = R.plan(self.net)
        # the trained parameters (the LSTMs' bias_ih stays frozen)
        self.params = [p for p in self.net.parameters() if p.requires_grad]
        self.optimizer: Optional[torch.optim.Adam] = None
        self._reset_optimizer()
        self.generator = torch.Generator(device=self.device)
        self.env_state = None
        self.obs = None
        # recurrent carry ((h_a, c_a), (h_c, c_c)) of this shard's envs, or ()
        self.hidden: ac.Hidden | tuple = ()
        self.iteration = 0
        self.record_states = record_states
        self._stepper = None     # the (captured) rollout step and its key
        self._stepper_key = None
        self._learner_obj = None  # the (captured) learning half and its key
        self._learner_key = None
        # the permutation of the last update (inside a graph: the tensor
        # that each replay draws into)
        self.last_perm: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    # collective hooks: the identity on one process

    def _all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the ranks, in place (x is returned): the learning
        half's reductions write the tensor that the next of its parts reads
        (``CapturedLearn``)."""
        return x

    def gather_envs(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor of this shard's envs (env axis first) → the global one."""
        return x

    def any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank."""
        return flag

    # ------------------------------------------------------------------

    def init_params(self, seed: int) -> None:
        """Draw the weights from ``seed`` (their init distributions, on a
        CPU generator of their own, as the JAX package splits k_net off
        PRNGKey(seed)), and reset Adam's state, the learning rate and the
        iteration count."""
        state = np.random.SeedSequence([seed, 1]).generate_state(2)
        gen = torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))
        self.net.reset_parameters(gen)
        self._reset_optimizer()
        self.iteration = 0

    def _reset_optimizer(self) -> None:
        """Adam from a fresh state at the configured learning rate.  The
        first call makes the optimizer, the learning rate (a 0-dim tensor
        that Adam reads), zero gradients and Adam's state (zero moments,
        step 0: what Adam would make at its first step); later calls reset
        them in place, so that a captured update keeps its tensors."""
        lr = self.cfg.algorithm.learning_rate
        if self.optimizer is None:
            self._lr = torch.tensor(lr, dtype=self.dtype, device=self.device)
            self.optimizer = torch.optim.Adam(
                self.params, lr=self._lr, betas=(0.9, 0.999), eps=1e-8,
                fused=True, capturable=self.device.type == "cuda")
            # the gradients are views of one flat buffer whose last element
            # holds a minibatch's KL: the buffer that the ranks' all_reduce
            # averages in place (``_update``)
            self._flat = torch.zeros(sum(p.numel() for p in self.params) + 1,
                                     dtype=self.dtype, device=self.device)
            i = 0
            for p in self.params:
                p.grad = self._flat[i:i + p.numel()].view_as(p)
                i += p.numel()
            for p in self.params:
                self.optimizer.state[p] = {
                    "step": torch.zeros((), dtype=torch.float32,
                                        device=self.device),
                    "exp_avg": torch.zeros_like(p),
                    "exp_avg_sq": torch.zeros_like(p)}
            return
        self.lr = lr
        self.reset_adam_state()

    def reset_adam_state(self) -> None:
        """Adam's state as at its first step (zero moments, step 0),
        written in place; the learning rate stays as it is."""
        with torch.no_grad():
            for st in self.optimizer.state.values():
                for x in st.values():
                    x.zero_()

    @property
    def lr(self) -> torch.Tensor:
        """The adaptive learning rate: a 0-dim tensor on the PPO's device,
        the ``lr`` of Adam's param group.  Assigning a number (or a 0-dim
        tensor) writes it in place."""
        return self._lr

    @lr.setter
    def lr(self, value) -> None:
        with torch.no_grad():
            self._lr.fill_(value)

    def load_optimizer_state(self, sd: Dict) -> None:
        """Restore an Adam ``state_dict`` (rsl_rl's ``optimizer_state_dict``)
        in place: each parameter's moments and step count (a fresh state
        where the file holds none) and the learning rate."""
        groups = sd["param_groups"]
        if len(groups) != 1 or len(groups[0]["params"]) != len(self.params):
            raise ValueError("the optimizer state is not of this PPO's "
                             "parameters")
        with torch.no_grad():
            for i, p in enumerate(self.params):
                saved = sd["state"].get(groups[0]["params"][i])
                for k, x in self.optimizer.state[p].items():
                    if saved is None:
                        x.zero_()
                    else:
                        x.copy_(saved[k])
        self.lr = groups[0]["lr"]

    def optimizer_state(self) -> Dict:
        """Adam's ``state_dict`` as rsl_rl writes it: the learning rate a
        number."""
        sd = self.optimizer.state_dict()
        for g in sd["param_groups"]:
            g["lr"] = float(g["lr"])
        return sd

    def init(self, seed: int | None = None) -> None:
        """The train state of ``seed`` (the config's seed when None): fresh
        weights, optimizer, learning rate and iteration (``init_params``),
        the action-noise generator seeded, the envs reset."""
        seed = self.cfg.seed if seed is None else seed
        self.init_params(seed)
        self.generator.manual_seed(seed)
        state, obs = self.env.reset(seed)
        self.set_rollout_state(state, obs, self.net.initial_state(
            self.env.num_envs) if self.recurrent else ())

    def set_rollout_state(self, env_state, obs, hidden) -> None:
        """Write the env state, observations and recurrent hidden state that
        the next rollout starts from into the rollout's buffers (``copy_``;
        a first call, or one with other shapes, takes the given tensors)."""
        self.env_state = assign(self.env_state, env_state)
        self.obs = assign(self.obs, obs)
        self.hidden = assign(self.hidden, hidden)

    def randomize_episode_lengths(self) -> None:
        """init_at_random_ep_len=True (train.py:54): spread initial episode
        lengths uniformly so resets decorrelate."""
        self.env_state.episode_length.copy_(self.shard.randint(
            self.env.max_episode_length, self.env.num_envs,
            generator=self.generator, device=self.device, dtype=torch.int32))

    # ------------------------------------------------------------------

    def _forward(self, obs, hidden):
        """(mu, std, value), new hidden (unchanged for the feed-forward net)."""
        if self.recurrent:
            return self.net(obs, hidden)
        return self.net(obs), hidden

    def _policy_inputs(self, obs, hidden):
        """The actor's and critic's MLP inputs (the observations; the
        recurrent net's LSTM outputs) and the new hidden state."""
        if self.recurrent:
            (x_a, x_c), hidden = self.net.memory(obs, hidden)
            return x_a, x_c, hidden
        return obs, obs, hidden

    def _noise(self, n: int) -> torch.Tensor:
        """The action noise of ``n`` envs, drawn at the global batch shape
        (``ac.sample_action``'s draw)."""
        return self.shard.draw(torch.randn, (n, self.net.std.shape[0]),
                               generator=self.generator, dtype=self.dtype,
                               device=self.device)

    @torch.no_grad()
    def act(self, obs, hidden):
        """One policy step (``ops/rollout.py::act``): action, mu, std,
        value, logp and the new hidden."""
        x_a, x_c, hidden = self._policy_inputs(obs, hidden)
        out = R.act(self.act_plan, obs, x_a, x_c, self._noise(obs.shape[0]))
        return (*out, hidden)

    @torch.no_grad()
    def last_value(self, obs: torch.Tensor, hidden) -> torch.Tensor:
        """V of the observations ``obs`` (the rollout's last); a recurrent
        net takes one extra LSTM step from ``hidden`` whose carry is
        discarded."""
        (_, _, value), _ = self._forward(obs, hidden)
        return value

    def _rollout_buffers(self, T: int) -> None:
        """The (T, N, ...) trajectory buffers, env 0's (T, ·) record rows,
        and the zeros that a rollout's step index and sums start from."""
        N, A, dt, dev = (self.env.num_envs, self.env.num_actions, self.dtype,
                         self.device)

        def buf(*shape, dtype=dt):
            return torch.empty(T, N, *shape, dtype=dtype, device=dev)

        self._traj = Transition(buf(self.env.num_obs), buf(A), buf(), buf(
            dtype=torch.bool), buf(), buf(), buf(A), buf(A))
        self._rec, self._rec_widths = None, None
        if self.record_states:
            phys = self.env_state.phys
            self._rec_widths = (phys.qpos.shape[1], phys.qvel.shape[1], A, 1,
                                self.env_state.commands.shape[1])
            self._rec = torch.empty(T, sum(self._rec_widths), dtype=dt,
                                    device=dev)
        n_terms = self.env_state.episode_sums.shape[1]
        self._zeros = (torch.zeros(1, dtype=torch.long, device=dev),
                       torch.zeros((), dtype=dt, device=dev),
                       torch.zeros(n_terms, dtype=dt, device=dev))

    @torch.no_grad()
    def _rollout_step(self, carry):
        """One rollout step: the policy step and its sample with row t of
        the trajectory's obs, action, value, logp, mu and sigma
        (``ops/rollout.py::act``), env.step, the recurrent reset, the
        timeout bootstrap and done into row t, env 0's record row, the
        finished episodes' count and term sums (``ops/rollout.py::store``).
        carry = (env state, obs, hidden, t (1,), n_done, term_sums) → the
        next carry."""
        state, obs, hidden, t, n_done, term_sums = carry
        x_a, x_c, hidden = self._policy_inputs(obs, hidden)
        pol = R.act(self.act_plan, obs, x_a, x_c, self._noise(obs.shape[0]),
                    self._traj, t)
        out = self.env.step(state, pol.action)
        if self.recurrent:
            hidden = ac.reset_hidden(hidden, out.done)
        record = None if self._rec is None else (
            out.record_qpos, out.record_qvel, pol.action, out.done,
            out.state.commands)
        t, n_done, term_sums = R.store(
            self._traj, t, out.reward, out.time_out, out.done, pol.value,
            out.finished_episode_sums, n_done, term_sums,
            self.cfg.algorithm.gamma, self._rec, record)
        return out.state, out.obs, hidden, t, n_done, term_sums

    def _rollout_stepper(self, T: int):
        """The rollout step as the rollout calls it: captured (once per
        shape of the carry and T) where the env's step can be captured,
        else the plain function."""
        key = (T, tuple((tuple(x.shape), x.dtype) for x in leaves(
            (self.env_state, self.obs, self.hidden))))
        if key != self._stepper_key:
            self._rollout_buffers(T)
            carry = (self.env_state, self.obs, self.hidden, *self._zeros)
            self._stepper = (CapturedStep(self._rollout_step, carry, generators=(
                self.generator, getattr(self.env, "generator", None)))
                if getattr(self.env, "graph_step", False)
                else self._rollout_step)
            self._stepper_key = key
        return self._stepper

    @torch.no_grad()
    def rollout(self):
        """One rollout of num_steps_per_env steps from the current state.
        Returns the trajectory (the rollout's buffers), the episode metrics
        and env 0's recorded rows (host arrays, or None without
        ``record_states``)."""
        T = self.cfg.runner.num_steps_per_env
        step = self._rollout_stepper(T)
        carry = (self.env_state, self.obs, self.hidden, *self._zeros)
        for _ in range(T):
            carry = step(carry)
        self.env_state, self.obs, self.hidden, _, n_done, term_sums = carry
        record: Optional[tuple] = None
        if self._rec is not None:
            with trace.span("ppo.record"):
                record = _record_to_host(self._rec, self._rec_widths)
        return self._traj, n_done.clone(), term_sums.clone(), record

    def _advantages(self, traj: Transition, last_value: torch.Tensor):
        """GAE's recursion from V of the rollout's last observations
        (``ops/learn.py::gae``): (advantages, returns, this shard's mean
        advantage)."""
        a = self.cfg.algorithm
        return L.gae(traj.reward, traj.value, traj.done, last_value, a.gamma,
                     a.lam)

    def _spread(self, advantages: torch.Tensor, mean_sum: torch.Tensor):
        """The global mean advantage (from the ranks' summed means) and this
        shard's sum of squares about it: the two passes of the JAX
        package's mean-then-variance, kept apart."""
        mean = mean_sum / self.shard.world
        return mean, torch.square(advantages - mean).sum()

    def _normalize(self, advantages: torch.Tensor, mean: torch.Tensor,
                   sq_sum: torch.Tensor) -> torch.Tensor:
        """The advantages normalized by the global batch's mean and variance
        (ddof=1; ``sq_sum`` summed over the ranks)."""
        n = advantages.numel() * self.shard.world
        var = sq_sum / max(n - 1, 1)
        return (advantages - mean) / (torch.sqrt(var) + 1e-8)

    def _normalized(self, advantages: torch.Tensor, mean: torch.Tensor,
                    spread, normalize):
        """The advantages normalized by the global batch's mean and
        variance, as ``normalize`` gives them: this shard's mean advantage
        ``mean`` summed over the ranks, ``spread`` (this shard's sum of
        squares about the global mean), that sum summed over the ranks;
        each reduction in place on the tensor that the next function reads
        (``spread`` and ``normalize``: plain functions or their graphs)."""
        mean, sq = spread(advantages, self._all_sum(mean))
        return normalize(advantages, mean, self._all_sum(sq))

    def gae(self, traj: Transition, last_value: torch.Tensor):
        """Returns (advantages, returns, normalized advantages), each (T, N);
        the normalization's mean and variance are over the global batch."""
        advantages, returns, mean = self._advantages(traj, last_value)
        return advantages, returns, self._normalized(
            advantages, mean, self._spread, self._normalize)

    def _adapt_lr(self, lr: torch.Tensor, kl: torch.Tensor) -> torch.Tensor:
        """rsl_rl's adaptive rule on the device (``ops/learn.py::adapt_lr``,
        the JAX ``_adapt_lr``)."""
        return L.adapt_lr(self.cfg.algorithm, lr, kl)

    def _replay(self, mb: Transition, hidden):
        """The recurrent net over a minibatch of whole trajectories (T, n),
        from ``hidden`` with the rollout's done-masked resets."""
        outs = []
        for t in range(mb.obs.shape[0]):
            out, hidden = self.net(mb.obs[t], hidden)
            hidden = ac.reset_hidden(hidden, mb.done[t])
            outs.append(out)
        return [torch.stack(x) for x in zip(*outs)]

    def draw_perm(self, T: int, N: int) -> torch.Tensor:
        """The update's permutation: of this shard's T·N samples, or of its
        N envs for the recurrent update (parallel/shard.py)."""
        return self.shard.perm(1 if self.recurrent else T, N, self.generator,
                               self.device)

    def update(self, traj: Transition, returns: torch.Tensor,
               norm_adv: torch.Tensor, perm: torch.Tensor,
               hidden0=None) -> Dict[str, float]:
        """``_update``, its statistics read to the host by name."""
        return dict(zip(STAT_KEYS, self._update(
            traj, returns, norm_adv, perm, hidden0).tolist()))

    def _parts(self) -> "Parts":
        """The learning half's parts as plain functions."""
        return Parts(self._head, self._spread, self._tail, self._grads,
                     self._step)

    def _update(self, traj: Transition, returns: torch.Tensor,
                norm_adv: torch.Tensor, perm: torch.Tensor,
                hidden0=None, parts: Optional["Parts"] = None) -> torch.Tensor:
        """The 5×4 minibatch update over the permutation ``perm``, shared by
        every epoch: of the T·N samples, or for the recurrent net of the N
        envs, whose trajectories replay from ``hidden0`` (the rollout-start
        hidden state).  A minibatch is ``parts.grads`` (the losses and the
        gradients), the gradients and KL summed over the ranks in place,
        and ``parts.step`` (their mean, the lr, the clip, Adam's step);
        ``parts`` are the plain functions or their captured graphs.
        Returns the statistics (``STAT_KEYS``) as one tensor; nothing is
        read to the host."""
        a = self.cfg.algorithm
        parts = parts or self._parts()
        idxs = perm.reshape(a.num_mini_batches, -1)
        rows = []
        for _ in range(a.num_learning_epochs):
            for idx in idxs:
                losses = parts.grads(traj, returns, norm_adv, hidden0, idx)
                self._all_sum(self._flat)
                # clones: a captured part's result is overwritten by its
                # next replay
                rows.append(parts.step(losses).clone())
        rows = torch.stack(rows)
        m = self._all_sum(rows[:, :3].mean(dim=0)) / self.shard.world
        return torch.cat([m, rows[:, 3].mean().reshape(1),
                          self._lr.reshape(1).to(m.dtype)])

    def _grads(self, traj: Transition, returns: torch.Tensor,
               norm_adv: torch.Tensor, hidden0,
               idx: torch.Tensor) -> torch.Tensor:
        """A minibatch step's first part, the first half of the body of the
        JAX update's ``lax.scan``: the losses on the samples ``idx`` (for
        the recurrent net the envs ``idx``, replayed from ``hidden0``), the
        gradients (into the flat buffer, whose last element takes the KL).
        Returns (loss, surrogate loss, value loss)."""
        if not self.recurrent:
            return L.grads(self.act_plan, self.cfg.algorithm, traj, returns,
                           norm_adv, idx, self._flat)
        mb = Transition(*[x[:, idx] for x in traj])
        h0 = tuple(tuple(h[idx] for h in carry) for carry in hidden0)
        mb_ret, mb_adv = returns[:, idx], norm_adv[:, idx]
        mu, std, value = self._replay(mb, h0)
        loss, surr, v_loss, kl = L.loss_terms(self.cfg.algorithm, mb, mb_ret,
                                              mb_adv, mu, std, value)
        # in place: backward accumulates into the flat buffer's views
        self.optimizer.zero_grad(set_to_none=False)
        with full_float32():  # the LSTM's backward, no TF32
            loss.backward()
        with torch.no_grad():
            self._flat[-1].copy_(kl)
        return torch.stack([loss.detach(), surr.detach(), v_loss.detach()])

    def _step(self, losses: torch.Tensor) -> torch.Tensor:
        """A minibatch step's second part, after the gradients and KL were
        summed over the ranks (``ops/learn.py::adam``): their mean, the
        adaptive lr from this minibatch's KL (Adam's param group holds the
        lr tensor), the clip by global norm and Adam's step.  Returns
        (loss, surrogate loss, value loss, kl)."""
        return L.adam(self.optimizer, self._flat, self._lr, self.shard.world,
                      self.cfg.algorithm, losses)

    def _head(self, traj: Transition, obs: torch.Tensor, hidden):
        """The prologue's first part: V of the rollout's last observations
        ``obs`` and GAE's recursion (``_advantages``)."""
        return self._advantages(traj, self.last_value(obs, hidden))

    def _tail(self, advantages: torch.Tensor, mean: torch.Tensor,
              sq_sum: torch.Tensor):
        """The prologue's last part: the normalized advantages and the
        update's permutation."""
        T, N = advantages.shape
        return (self._normalize(advantages, mean, sq_sum),
                self.draw_perm(T, N))

    def _learn(self, traj: Transition, obs: torch.Tensor, hidden,
               hidden0, parts: Optional["Parts"] = None) -> torch.Tensor:
        """The learning half of an iteration, all on the device: V of the
        rollout's last observations, GAE, the update's permutation and the
        update from the rollout-start hidden state ``hidden0``, as
        ``parts`` (the plain functions, or ``CapturedLearn``'s graphs) with
        the reductions over the ranks between them.  Returns the update's
        statistics (``_update``)."""
        parts = parts or self._parts()
        advantages, returns, mean = parts.head(traj, obs, hidden)
        norm_adv, self.last_perm = self._normalized(advantages, mean,
                                                    parts.spread, parts.tail)
        return self._update(traj, returns, norm_adv, self.last_perm, hidden0,
                            parts)

    def _held(self):
        """Every tensor that a minibatch step writes and that outlives it:
        the trained parameters, their gradients, Adam's state and the lr."""
        return [*self.params, *(p.grad for p in self.params),
                *(x for p in self.params
                  for x in self.optimizer.state[p].values()), self._lr]

    def _learner(self, *inputs):
        """``_learn`` as the iteration calls it: captured (``CapturedLearn``,
        once per shape of its inputs and set of held tensors) where
        ``graph_update`` holds, else the plain function."""
        if not self.graph_update:
            return self._learn
        held = self._held()
        key = (tuple((tuple(x.shape), x.dtype) for x in leaves(inputs)),
               tuple(x.data_ptr() for x in held))
        if key != self._learner_key:
            self._learner_obj = CapturedLearn(self, *inputs)
            self._learner_key = key
        return self._learner_obj

    def learn_step(self) -> Dict[str, object]:
        """One PPO iteration (rollout + update); the statistics are read to
        the host once, at its end.  Its spans (``utils/trace.py``):
        ``ppo.iteration`` over all of it, and in it ``ppo.rollout`` (the
        rollout and the sync after it: ``rollout_s``), ``ppo.learn`` (the
        learning half and the sync after it: ``update_s``) and
        ``ppo.stats`` (the reductions, the readback, the statistics).
        ``graph_captures`` counts the graphs captured in the iteration."""
        captures = G.captures
        with trace.span("ppo.iteration"):
            # the rollout-start hidden state (the rollout updates its buffers)
            hidden0 = clone(self.hidden)
            with trace.timed("ppo.rollout") as rollout:
                traj, n_done, term_sums, record = self.rollout()
                _sync(self.device)
            with trace.timed("ppo.learn") as learn:
                inputs = (traj, self.obs, self.hidden, hidden0)
                learned = self._learner(*inputs)(*inputs)
                _sync(self.device)
            with trace.span("ppo.stats"):
                stats = self._stats(learned, traj, n_done, term_sums)
        stats.update(rollout_s=rollout.seconds, update_s=learn.seconds,
                     graph_captures=G.captures - captures)
        if record is not None:
            # (qpos, qvel, action, done, commands), each (T, ·)
            stats["record"] = record
        return stats

    def _stats(self, learned: torch.Tensor, traj: Transition,
               n_done: torch.Tensor, term_sums: torch.Tensor) -> Dict:
        """The iteration's statistics: the update's (``learned``) and the
        episode and rollout metrics over the global batch, in one reduction
        and one read to the host."""
        self.iteration += 1
        red = self._all_sum(torch.cat([
            n_done.reshape(1).to(term_sums.dtype), term_sums,
            (traj.reward.mean() / self.shard.world).reshape(1),
            traj.done.sum().reshape(1).to(term_sums.dtype)]))
        trace.count("host.syncs")
        host = torch.cat([learned.to(red.dtype), self._noise_std().reshape(
            1).to(red.dtype), red]).cpu()
        k = len(STAT_KEYS)
        stats = dict(zip(STAT_KEYS, host[:k].tolist()))
        n, term_sums = float(host[k + 1]), host[k + 2:-2]
        # mean finished-episode sums per reward term, per episode second
        ep_means = (term_sums / max(n, 1.0) / self.env.max_episode_length_s
                    if n > 0 else torch.zeros_like(term_sums))
        stats.update(
            mean_reward=float(host[-2]),
            dones=int(host[-1]),
            episode_reward_means=ep_means.tolist(),
            mean_noise_std=float(host[k]),
        )
        return stats

    def _noise_std(self) -> torch.Tensor:
        return torch.clamp_min(torch.abs(self.net.std.detach()),
                               self.cfg.policy.std_floor).mean()

    def mean_noise_std(self) -> float:
        """The std that sampling sees (the std_floor clamp applied)."""
        return float(self._noise_std())


class Parts(NamedTuple):
    """The learning half split at its reductions over the ranks: the
    prologue's ``head`` (V of the last observations, GAE's recursion, the
    local mean advantage), ``spread`` (the local sum of squares about the
    global mean) and ``tail`` (the normalized advantages, the permutation);
    a minibatch step's ``grads`` (the losses and the gradients with the
    KL) and ``step`` (their mean, the lr, the clip, Adam's step)."""
    head: object
    spread: object
    tail: object
    grads: object
    step: object


class CapturedLearn:
    """``PPO._learn`` as CUDA graphs (``utils/graph.py::CapturedUpdate``):
    each of its ``Parts`` captured once; a call runs ``_learn`` on them,
    replaying the prologue's three parts once and a minibatch step's two
    parts per minibatch, its indices copied in, as the JAX update's
    ``lax.scan`` runs its compiled body.  The reductions over the ranks
    (``PPO._all_sum``: the mean and the sum of squares of the advantages,
    the gradients and KL of each minibatch) run between the replays, in
    place on the tensor that a part wrote and the next reads: a part's
    outputs are the next part's input buffers, and the gradients and KL
    live in the PPO's flat buffer.  No part holds a collective, so every
    rank captures its parts alone and the same code serves gloo and NCCL;
    on one process the reductions are the identity.  (One graph of the
    whole update holds every minibatch's kernels, ~235k for the recurrent
    net, whose capture took minutes; a step's parts are a twentieth of
    it.)  Called like ``_learn``; on the CPU every part runs eagerly.
    ``graph`` is the minibatch step's last part's (None on the CPU);
    ``warmup_s``, ``capture_s``, ``record_s`` and ``pool_bytes`` sum the
    parts'."""

    def __init__(self, ppo: PPO, traj: Transition, obs: torch.Tensor, hidden,
                 hidden0):
        self.ppo = ppo

        def out(part, like):
            # a part's outputs are the next part's buffers: the graph's own
            # tensors on the card; on the CPU, which has no graph, tensors of
            # their shape
            return part._result if part.graph is not None else like

        adv = torch.zeros_like(traj.reward)
        scalar = traj.reward.new_zeros(())
        head = CapturedUpdate(ppo._head, traj, obs, hidden, held=())
        adv, returns, mean = out(head, (adv, torch.zeros_like(adv), scalar))
        spread = CapturedUpdate(ppo._spread, adv, mean, held=())
        mean, sq = out(spread, (scalar, scalar.clone()))
        tail = CapturedUpdate(ppo._tail, adv, mean, sq, held=(),
                              generators=(ppo.generator,))
        norm_adv, _ = out(tail, (torch.zeros_like(adv), None))
        # indices of a minibatch's size (valid ones: the warm-up indexes
        # with them)
        samples = traj.reward.shape[1] if ppo.recurrent else traj.reward.numel()
        idx = torch.arange(samples // ppo.cfg.algorithm.num_mini_batches,
                           device=traj.reward.device)
        held = ppo._held()
        grads = CapturedUpdate(ppo._grads, traj, returns, norm_adv, hidden0,
                               idx, held=held)
        losses = out(grads, traj.reward.new_zeros(3))
        step = CapturedUpdate(ppo._step, losses, held=held)
        self.parts = Parts(head, spread, tail, grads, step)
        self.graph = step.graph
        for k in ("warmup_s", "capture_s", "record_s", "pool_bytes"):
            setattr(self, k, sum(getattr(x, k) for x in self.parts))

    def __call__(self, traj: Transition, obs: torch.Tensor, hidden,
                 hidden0) -> torch.Tensor:
        return self.ppo._learn(traj, obs, hidden, hidden0, self.parts)
