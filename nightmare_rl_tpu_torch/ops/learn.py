"""The learning half of a PPO iteration (``rl/ppo.py``'s GAE and minibatch
steps) as three CUDA kernel launches: ``gae`` once an iteration, ``grads``
and ``adam`` once a minibatch.

``gae`` walks GAE's recursion backwards over the rollout's steps from V of
its last observations: the advantages, the returns and this shard's mean
advantage.  ``grads`` runs the feed-forward actor-critic over the
minibatch's rows of the (T·N, ·) trajectory (gathered by ``idx`` as they
are read), the PPO loss (the clipped surrogate, the clipped value loss,
the entropy bonus) and its backward pass, and writes every gradient and
the minibatch's KL (last) into the flat buffer whose views are the
parameters' gradients (``PPO._flat``, the buffer the ranks reduce), and
(loss, surrogate, value loss).  ``adam`` takes that buffer summed over the
ranks: the mean over them, the adaptive learning rate from the KL, the
clip by global norm (optax's rule) and Adam's step (torch's fused Adam's
formula), in place on the parameters, Adam's state and its step counts,
and the lr tensor; it returns (loss, surrogate, value loss, KL).  They port
the JAX package's compiled update (``nightmare_rl_tpu/rl/ppo.py``: _gae
:187-203, _loss_terms :222-242, _adapt_lr :244-255, minibatch_step
:323-359 with the optax chain :100-103).

CPU tensors go to the plain versions ``plain_gae``, ``plain_grads`` and
``plain_adam`` (the update's old code: GAE's loop over the steps, the
net's forward pass, the losses and autograd's backward, the clip and
torch's fused Adam; ~820 launches for GAE and ~360 a minibatch on the
card), CUDA tensors to the kernels ``csrc/learn.cu`` (the arithmetic is
``csrc/learn_env.cuh``), and a failed build or launch raises.
``gae.launches``, ``grads.launches`` and ``adam.launches`` count kernel
launches.

``grads`` takes the nets that ``ops/rollout.py::plan`` takes (its plan,
which refuses the others on every device), fed the observations: the
recurrent net's update (its LSTMs' replay) stays plain; ``gae`` and
``adam`` serve both nets.  The kernels read the weights, the std and
Adam's state by pointer at launch, so a captured graph reads and writes
the tensors the PPO holds.  ``grads``'s grid sums its blocks' partial sums
in a fixed order, with integer tickets in a zeroed buffer that the
kernels leave zeroed (``_counters``), so a replay gives the eager call's
bits.  ``adam`` is one call of two launches over each tensor's chunks of
ADAM_CHUNK elements (``adam_chunks``; a block a chunk): the chunks' sums
of squares, which the last block to arrive (a ticket) adds in chunk order
into the norm and the lr, then the step; every block count gives the same
bits.

``host_gae``, ``host_grads`` and ``host_adam`` run the same arithmetic on
CPU tensors through the host driver ``csrc/learn_host.cpp`` (built with
g++), for the tests.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
import math
from typing import Dict, List, Optional, Tuple

import torch

from nightmare_rl_tpu_torch.models import actor_critic as ac
from nightmare_rl_tpu_torch.ops import build
from nightmare_rl_tpu_torch.ops.rollout import Plan, _blocks, _check
from nightmare_rl_tpu_torch.utils.device import constant, full_float32

GAE_LANES = 256      # learn_env.cuh kGaeLanes: envs a block of gae
TILE = 64            # learn_env.cuh kTile: samples of a grads tile
MAX_TENSORS = 64     # learn_env.cuh kMaxTensors: adam's parameter tensors
ADAM_CHUNK = 1024    # learn_env.cuh kAdamChunk: elements of an adam chunk
MAX_TEAM = 64        # learn_env.cuh kMaxTeam
SMEM_ABOVE_LIMIT = -1  # learn.cu kSmemAboveLimit: a launch's return code
HOST_BLOCKS = 3      # host_grads' default blocks a net (the card: its SMs)


def _refuse(why: str):
    raise ValueError(f"the learn kernels do not take this net: {why}")


# ---------------------------------------------------------------------------
# the plain versions (the update's code)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _lib(host: bool):
    return build.load_host("learn_host") if host else build.load("learn")


@functools.lru_cache(maxsize=None)
def _names(host: bool, which: str) -> Tuple[Tuple[str, ...], ...]:
    lib = _lib(host)
    out = []
    for kind in ("int", "real", "ptr"):
        fn = getattr(lib, f"learn_{which}_{kind}_names")
        fn.restype = ctypes.c_char_p
        out.append(tuple(k for k in fn().decode().split(",") if k))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _fn(name: str, dtype: torch.dtype, host: bool):
    suffix = "_f32" if dtype == torch.float32 else "_f64"
    fn = getattr(_lib(host), name + ("_host" if host else "") + suffix)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int if host else ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _call(which: str, dtype, dev, host: bool, team: int, args) -> None:
    last = team if host else torch.cuda.current_stream(dev).cuda_stream
    ctx = (torch.cuda.device(dev) if not host else contextlib.nullcontext())
    with ctx:
        err = _fn(f"learn_{which}", dtype, host)(*args, last)
    if err == SMEM_ABOVE_LIMIT and not host:
        _refuse(f"its {which} tiles take more shared memory a block than "
                "the card allows")
    if err != 0:
        raise RuntimeError(
            f"the learn {which} host driver refused its arguments ({err})"
            if host else f"learn {which} kernel launch failed: cudaError_t "
            f"{err}")


_COUNTERS: Dict[Tuple[str, str], torch.Tensor] = {}


def _counters(which: str, n: int, dev: torch.device) -> torch.Tensor:
    """A kernel's grid tickets on ``dev``: zeros that the kernel leaves
    zeroed, made once (outside any capture: a wrapper's first call is
    eager) and kept."""
    key = (which, str(dev))
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
        _COUNTERS[key] = buf
    return buf


def _dtype_ok(dt) -> None:
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"the learn kernels take float32 or float64, not {dt}")


def _run_gae(reward, value, done, last_value, gamma, lam, host: bool,
             team: int = 1):
    dt, dev = value.dtype, value.device
    _dtype_ok(dt)
    T, N = value.shape
    reward = _check(reward, "reward", (T, N), dt, dev)
    value = _check(value, "value", (T, N), dt, dev)
    done = _check(done, "done", (T, N), torch.bool, dev)
    last_value = _check(last_value, "last_value", (N,), dt, dev)
    blocks = -(-N // GAE_LANES)
    outs = dict(o_adv=torch.empty(T, N, dtype=dt, device=dev),
                o_ret=torch.empty(T, N, dtype=dt, device=dev),
                o_mean=torch.empty((), dtype=dt, device=dev),
                part=torch.empty(blocks, dtype=dt, device=dev))
    counter = (torch.zeros(1, dtype=torch.int32) if host
               else _counters("gae", 1, dev))
    args = _blocks(_names(host, "gae"), dict(T=T, N=N, blocks=blocks),
                   dict(gamma=float(gamma), lam=float(lam)),
                   dict(reward=reward, value=value, done=done,
                        last_value=last_value, counter=counter, **outs))
    _call("gae", dt, dev, host, team, args)
    return outs["o_adv"], outs["o_ret"], outs["o_mean"]


def gae(reward: torch.Tensor, value: torch.Tensor, done: torch.Tensor,
        last_value: torch.Tensor, gamma: float, lam: float):
    """GAE (``plain_gae``): the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    dev = value.device
    if dev.type == "cpu":
        return plain_gae(reward, value, done, last_value, gamma, lam)
    if dev.type != "cuda":
        raise ValueError(f"gae runs on cpu or cuda, not {dev}")
    out = _run_gae(reward, value, done, last_value, gamma, lam, host=False)
    _gae_counted.launches += 1
    return out


gae.launches = 0
_gae_counted = gae  # counts on, where a caller wraps the module's name


def _flat_offset(t: Optional[torch.Tensor], flat: torch.Tensor,
                 name: str) -> int:
    """Where the gradient ``t`` (a contiguous view of ``flat``) starts in
    it."""
    if t is None or t.data_ptr() < flat.data_ptr() or not t.is_contiguous():
        _refuse(f"{name}'s gradient is not a view of the flat buffer")
    off = (t.data_ptr() - flat.data_ptr()) // flat.element_size()
    if off + t.numel() > flat.numel() - 1:
        _refuse(f"{name}'s gradient is not a view of the flat buffer")
    return off


def grads_geometry(pl: Plan, B: int, blocks: int) -> dict:
    """grads' grid on a minibatch of ``B`` samples with up to ``blocks``
    blocks a net: the blocks of each net, the blocks a group of the grid's
    sum, the width of a block's sums per net (its scratch row padded to a
    multiple of 4), the scratch's elements and the grid's tickets (each
    group's, each net's and the losses')."""
    tiles = -(-B // TILE)
    n = max(1, min(blocks, tiles))
    group = max(1, math.isqrt(n - 1) + 1)
    groups = -(-n // group)
    A = pl.net.std.shape[0]
    widths = [sum(m.in_features * m.out_features + m.out_features
                  for m in layers) + extra
              for layers, extra in ((pl.actor, A + 2), (pl.critic, 1))]
    return dict(blocks=n, group=group, groups=groups, widths=widths,
                scratch=sum((n + groups) * (-(-w // 4) * 4) for w in widths),
                counters=2 * groups + 3)


def _grads_operands(pl: Plan, algo, traj, returns, norm_adv, idx, flat,
                    blocks: int):
    net = pl.net
    dt, dev = flat.dtype, flat.device
    _dtype_ok(dt)
    if net.std.dtype != dt:
        _refuse(f"its dtype {net.std.dtype} is not the flat buffer's {dt}")
    T, N = returns.shape
    TN, B, A = T * N, idx.shape[0], net.std.shape[0]
    nobs = traj.obs.shape[2]
    if pl.actor[0].in_features != nobs or pl.critic[0].in_features != nobs:
        _refuse("grads feeds both MLPs the observations (the recurrent net's "
                "update stays plain)")
    ps = [_check(p, "a Linear layer's parameter", p.shape, dt, dev, True)
          for m in pl.layers for p in (m.weight, m.bias)]
    std = _check(net.std, "std", (A,), dt, dev, True)
    offsets, spans = [], []
    for k, m in enumerate(pl.layers):
        for p, name in ((m.weight, f"layer {k}'s weight"),
                        (m.bias, f"layer {k}'s bias")):
            off = _flat_offset(p.grad, flat, name)
            offsets.append(off)
            spans.append((off, p.numel()))
    std_off = _flat_offset(net.std.grad, flat, "std")
    spans.append((std_off, A))
    spans.sort()
    if spans[0][0] != 0 or any(a + n != b for (a, n), (b, _) in zip(
            spans, spans[1:])) or spans[-1][0] + spans[-1][1] != flat.numel() - 1:
        _refuse("the flat buffer holds gradients that grads does not write")

    def row(x, name, width=()):
        return _check(x.reshape((TN,) + width), name, (TN,) + width, dt, dev,
                      True)

    geo = grads_geometry(pl, B, blocks)
    ptrs = dict(
        obs=row(traj.obs, "traj.obs", (nobs,)),
        action=row(traj.action, "traj.action", (A,)),
        mu=row(traj.mu, "traj.mu", (A,)),
        sigma=row(traj.sigma, "traj.sigma", (A,)),
        logp=row(traj.logp, "traj.logp"), value=row(traj.value, "traj.value"),
        returns=row(returns, "returns"), adv=row(norm_adv, "norm_adv"),
        idx=_check(idx, "idx", (B,), torch.int64, dev), std=std,
        flat=_check(flat, "flat", flat.shape, dt, dev, True),
        losses=torch.empty(3, dtype=dt, device=dev),
        scratch=torch.empty(geo["scratch"], dtype=dt, device=dev))
    ints = dict(B=B, A=A, nobs=nobs, n_actor=len(pl.actor),
                n_critic=len(pl.critic), act=pl.kind, blocks_a=geo["blocks"],
                blocks_c=geo["blocks"], group=geo["group"],
                clipped=int(bool(algo.use_clipped_value_loss)),
                P=flat.numel() - 1, scratch=geo["scratch"], std_off=std_off)
    reals = dict(std_floor=float(net.std_floor), alpha=pl.alpha,
                 clip=float(algo.clip_param),
                 value_coef=float(algo.value_loss_coef),
                 entropy_coef=float(algo.entropy_coef))
    extra = []
    for k, m in enumerate(pl.layers):
        extra += [m.in_features, m.out_features, offsets[2 * k],
                  offsets[2 * k + 1]]
    return ints, reals, ptrs, extra, ps, geo


def _grads_args(pl: Plan, algo, traj, returns, norm_adv, idx, flat,
                host: bool, blocks: Optional[int] = None):
    """grads' argument blocks for the host driver's or the kernel's C
    interface (less the last argument), and the tensors they point to (the
    caller keeps them alive through the call; "losses": what it writes)."""
    dev = flat.device
    if blocks is None:
        blocks = (HOST_BLOCKS if host else
                  torch.cuda.get_device_properties(dev).multi_processor_count)
    ints, reals, ptrs, extra, ps, geo = _grads_operands(
        pl, algo, traj, returns, norm_adv, idx, flat, blocks)
    ptrs["counters"] = (torch.zeros(geo["counters"], dtype=torch.int32)
                        if host else _counters("grads", geo["counters"], dev))
    return _blocks(_names(host, "grads"), ints, reals, ptrs, extra, ps), ptrs


def _run_grads(pl: Plan, algo, traj, returns, norm_adv, idx, flat,
               host: bool, team: int = 1, blocks: Optional[int] = None,
               ) -> torch.Tensor:
    args, ptrs = _grads_args(pl, algo, traj, returns, norm_adv, idx, flat,
                             host, blocks)
    _call("grads", flat.dtype, flat.device, host, team, args)
    return ptrs["losses"]


def grads(pl: Plan, algo, traj, returns: torch.Tensor,
          norm_adv: torch.Tensor, idx: torch.Tensor,
          flat: torch.Tensor) -> torch.Tensor:
    """A minibatch's losses and gradients (``plain_grads``): the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    dev = flat.device
    if dev.type == "cpu":
        return plain_grads(pl, algo, traj, returns, norm_adv, idx, flat)
    if dev.type != "cuda":
        raise ValueError(f"grads runs on cpu or cuda, not {dev}")
    out = _run_grads(pl, algo, traj, returns, norm_adv, idx, flat, host=False)
    _grads_counted.launches += 1
    return out


grads.launches = 0
_grads_counted = grads  # counts on, where a caller wraps the module's name


def grads_smem_bytes(pl: Plan, algo, traj, returns, norm_adv, idx,
                     flat) -> int:
    """The shared memory of one of grads' blocks on these operands, as the
    kernel's library computes it (0: operands it does not take)."""
    ints, reals, ptrs, extra, ps, geo = _grads_operands(
        pl, algo, traj, returns, norm_adv, idx, flat, 1)
    ptrs["counters"] = 1  # not read
    args = _blocks(_names(False, "grads"), ints, reals, ptrs, extra, ps)
    suffix = "_f32" if flat.dtype == torch.float32 else "_f64"
    fn = getattr(_lib(False), "learn_grads_smem" + suffix)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(*args)


def grads_blocks_per_sm(smem: int, dtype: torch.dtype) -> int:
    """grads' blocks one SM of the current card holds with ``smem`` bytes
    of shared memory each (the occupancy query)."""
    fn = _lib(False).learn_grads_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(torch.tensor([], dtype=dtype).element_size(), smem,
             ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"learn grads occupancy query: cudaError_t {err}")
    return blocks.value


def adam_chunks(numels) -> int:
    """adam's chunks of tensors of ``numels`` elements: each tensor's
    elements from its start in chunks of ADAM_CHUNK."""
    return sum(-(-n // ADAM_CHUNK) for n in numels)


def _adam_args(optimizer, flat, lr, world, algo, losses, host: bool,
               blocks: Optional[int] = None):
    """adam's argument blocks for the host driver's or the kernel's C
    interface (less the last argument) over up to ``blocks`` blocks (by
    default one a chunk), and the tensors they point to (the caller keeps
    them alive through the call; "stats": what it returns)."""
    dt, dev = flat.dtype, flat.device
    _dtype_ok(dt)
    group = optimizer.param_groups
    if len(group) != 1:
        raise ValueError("adam takes one parameter group")
    g = group[0]
    if (g.get("weight_decay", 0) != 0 or g.get("amsgrad") or g.get("maximize")
            or g["lr"] is not lr):
        raise ValueError("adam takes Adam without weight decay, amsgrad or "
                         "maximize, whose lr is the given tensor")
    params: List[torch.Tensor] = g["params"]
    if not 1 <= len(params) <= MAX_TENSORS:
        raise ValueError(f"adam takes 1 to {MAX_TENSORS} parameter tensors")
    # the tensors in the flat buffer's order, which they must tile
    at = sorted((_flat_offset(p.grad, flat, f"parameter {k}"), k)
                for k, p in enumerate(params))
    ends = list(itertools.accumulate(params[k].numel() for _, k in at))
    if ([off for off, _ in at] != [0] + ends[:-1]
            or ends[-1] != flat.numel() - 1):
        _refuse("the flat buffer holds gradients that adam does not step")
    extra_i, extra_p = [], []
    for off, k in at:
        p = params[k]
        st = optimizer.state[p]
        extra_i += [p.numel(), off]
        extra_p += [_check(p, f"parameter {k}", p.shape, dt, dev, True),
                    _check(st["exp_avg"], "exp_avg", p.shape, dt, dev, True),
                    _check(st["exp_avg_sq"], "exp_avg_sq", p.shape, dt, dev,
                           True),
                    _check(st["step"], "step", (), torch.float32, dev, True)]
    chunks = adam_chunks(p.numel() for p in params)
    blocks = chunks if blocks is None else max(1, min(blocks, chunks))
    b1, b2 = g["betas"]
    ptrs = dict(flat=_check(flat, "flat", flat.shape, dt, dev, True),
                lr=_check(lr, "lr", (), dt, dev, True),
                losses=_check(losses, "losses", (3,), dt, dev),
                stats=torch.empty(4, dtype=dt, device=dev),
                scratch=torch.empty(2 + 2 * len(params) + chunks, dtype=dt,
                                    device=dev),
                counter=(torch.zeros(1, dtype=torch.int32) if host
                         else _counters("adam", 1, dev)))
    args = _blocks(
        _names(host, "adam"),
        dict(P=flat.numel() - 1, ntensors=len(params),
             adaptive=int(algo.schedule == "adaptive"), world=int(world),
             chunks=chunks, blocks=blocks),
        dict(desired_kl=float(algo.desired_kl),
             max_grad_norm=float(algo.max_grad_norm), beta1=float(b1),
             beta2=float(b2), eps=float(g["eps"]), lr_min=1e-5, lr_max=1e-2,
             lr_factor=1.5),
        ptrs, extra_i, extra_p)
    return args, ptrs


def _run_adam(optimizer, flat, lr, world, algo, losses, host: bool,
              team: int = 1, blocks: Optional[int] = None) -> torch.Tensor:
    args, keep = _adam_args(optimizer, flat, lr, world, algo, losses, host,
                            blocks)
    _call("adam", flat.dtype, flat.device, host, team, args)
    return keep["stats"]


def adam(optimizer: torch.optim.Adam, flat: torch.Tensor, lr: torch.Tensor,
         world: int, algo, losses: torch.Tensor) -> torch.Tensor:
    """A minibatch step after the ranks' sum (``plain_adam``): the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    dev = flat.device
    if dev.type == "cpu":
        return plain_adam(optimizer, flat, lr, world, algo, losses)
    if dev.type != "cuda":
        raise ValueError(f"adam runs on cpu or cuda, not {dev}")
    out = _run_adam(optimizer, flat, lr, world, algo, losses, host=False)
    _adam_counted.launches += 1
    return out


adam.launches = 0
_adam_counted = adam  # counts on, where a caller wraps the module's name


def _host_team(team: int, x: torch.Tensor, name: str) -> None:
    if not 1 <= team <= MAX_TEAM:
        raise ValueError(f"{name} runs teams of 1 to {MAX_TEAM}, not {team}")
    if x.device.type != "cpu":
        raise ValueError(f"{name} takes CPU tensors")


def host_gae(reward, value, done, last_value, gamma, lam, team: int = 1):
    """``gae``'s arithmetic (``csrc/learn_env.cuh``) on CPU tensors, through
    the host driver ``csrc/learn_host.cpp`` built with g++: a team of
    ``team`` threads (1 to 64) as a block's threads, the blocks in series.
    For the tests; raises RuntimeError where g++ is missing."""
    _host_team(team, value, "host_gae")
    return _run_gae(reward, value, done, last_value, gamma, lam, host=True,
                    team=team)


def host_grads(pl: Plan, algo, traj, returns, norm_adv, idx, flat,
               team: int = 1, blocks: int = HOST_BLOCKS) -> torch.Tensor:
    """``grads``'s arithmetic on CPU tensors through the host driver, as
    ``host_gae``, with up to ``blocks`` blocks a net (the card's: its
    SMs), their sums added group by group as the kernel adds them."""
    _host_team(team, flat, "host_grads")
    return _run_grads(pl, algo, traj, returns, norm_adv, idx, flat, host=True,
                      team=team, blocks=blocks)


def host_adam(optimizer, flat, lr, world, algo, losses, team: int = 1,
              blocks: Optional[int] = None) -> torch.Tensor:
    """``adam``'s arithmetic on CPU tensors through the host driver, as
    ``host_gae``, over up to ``blocks`` blocks (by default one a chunk, as
    the card's grid)."""
    _host_team(team, flat, "host_adam")
    return _run_adam(optimizer, flat, lr, world, algo, losses, host=True,
                     team=team, blocks=blocks)
