"""The rollout step's policy half and trajectory stores (everything of
``rl/ppo.py``'s rollout step around ``env.step``) as two CUDA kernel
launches per step.

``act`` runs before ``env.step``: the actor's and the critic's MLPs on
their inputs (the observations for ``ActorCritic``; the two LSTMs' outputs
for ``ActorCriticRecurrent``, whose cuDNN cells stay library calls), the
sampling std (clamped by ``std_floor`` where it is above 0), the action
``mu + std * eps`` and its diagonal Gaussian log-probability; it writes row
``t`` of the trajectory's obs, action, value, logp, mu and sigma buffers.
``store`` runs after it: the timeout bootstrap ``reward + gamma * value *
time_out`` into row ``t`` of the rewards, the done flags into theirs, env
0's record row (``[qpos | qvel | action | done | commands]``, the layout
``rl/ppo.py::_record_to_host`` reads), the finished episodes' count and the
NaN-skipping sums of their terms added to the running sums, and ``t + 1``.
They port the JAX package's compiled rollout step around the env
(``nightmare_rl_tpu/rl/ppo.py:153-185`` with ``models/actor_critic.py``'s
``sample_action`` and ``log_prob``, :133-143).

CPU tensors go to the plain versions ``plain_act`` and ``plain_store`` (the
rollout step's old code: cuBLAS or CPU products, the activations, the
elementwise ops, ``index_copy_``; ~45 small launches per step on the card),
CUDA tensors to the kernels ``csrc/rollout.cu`` (the arithmetic is
``csrc/rollout_env.cuh``), and a failed build or launch raises.
``act.launches`` and ``store.launches`` count kernel launches.

The noise ``eps`` is the caller's ``torch.randn`` draw, at the place and in
the order of the plain version's, so every run draws the numbers it drew
before.  The kernels read the weights, biases and std by pointer at launch:
Adam updates them in place, and a captured graph reads the new values.

``plan(net)`` reads a net's layout once (``PPO`` makes it at construction):
its actor and critic ``Linear`` layers, their activation, the std and its
floor.  A net the kernels do not take is refused there with ValueError, on
every device.

``host_act`` and ``host_store`` run the same arithmetic on CPU tensors
through the host driver ``csrc/rollout_host.cpp`` (built with g++), for the
tests.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from nightmare_rl_tpu_torch.models import actor_critic as ac
from nightmare_rl_tpu_torch.ops import build
from nightmare_rl_tpu_torch.utils.device import full_float32

MAX_LAYERS = 8        # rollout_env.cuh kMaxLayers, Linear layers per net
MAX_CHUNKS = 48       # rollout_env.cuh kMaxChunks, staged weight chunks
MAX_TERMS = 16        # rollout_env.cuh kMaxTerms
MAX_TEAM = 64         # rollout_env.cuh kMaxTeam
ENV_TILE = 4          # rollout_env.cuh kEnvTile: a block's envs are a multiple
ENVS_PER_BLOCK = 16   # act's tile of envs a block
# act's weight budget: the shared memory a block stages weights in
WEIGHT_BYTES = 64 * 1024
# the most shared memory a block of act takes (the H100 allows 227 KB)
MAX_SMEM = 200 * 1024
# rollout_env.cuh Activation, by torch module
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


# the trajectory buffers that act writes a row of, in Transition's names
ACT_ROWS = ("obs", "action", "value", "logp", "mu", "sigma")


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# the plain versions (the rollout step's code)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _lib(host: bool):
    return build.load_host("rollout_host") if host else build.load("rollout")


@functools.lru_cache(maxsize=None)
def _names(host: bool, which: str) -> Tuple[Tuple[str, ...], ...]:
    lib = _lib(host)
    out = []
    for kind in ("int", "real", "ptr"):
        fn = getattr(lib, f"rollout_{which}_{kind}_names")
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


def _blocks(names, ints: dict, reals: dict, ptrs: dict, extra_ints=(),
            extra_ptrs=()):
    """The C interface's blocks in the library's field order (then the
    extra entries); a pointer is a tensor, an address or None."""
    ik, rk, pk = names
    i = [ints[k] for k in ik] + list(extra_ints)
    r = [reals[k] for k in rk]
    p = [ptrs[k] for k in pk] + list(extra_ptrs)
    return ((ctypes.c_int * len(i))(*i), len(i),
            (ctypes.c_double * len(r))(*r), len(r),
            (ctypes.c_void_p * len(p))(*[
                x if x is None or isinstance(x, int) else x.data_ptr()
                for x in p]), len(p))


def _check(x: torch.Tensor, name: str, shape, dtype, device,
           contiguous: bool = False) -> torch.Tensor:
    """``x`` checked; made contiguous unless ``contiguous`` asks that it be
    so already (a tensor the kernel reads or writes in place: a copy
    would be read or written in its stead)."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(x.shape)}")
    if x.dtype != dtype or x.device != device:
        raise ValueError(f"{name} must be {dtype} on {device}, got {x.dtype} "
                         f"on {x.device}")
    if not x.is_contiguous():
        if contiguous:
            raise ValueError(f"{name} must be contiguous")
        x = x.contiguous()
    return x


def _failed(which: str, host: bool, err: int) -> str:
    if host:
        return f"the rollout {which} host driver refused its arguments ({err})"
    return f"rollout {which} kernel launch failed: cudaError_t {err}"


def _budget(pl: Plan, itemsize: int) -> int:
    """act's weight budget (elements): every layer's rows padded to an
    odd length, or WEIGHT_BYTES' worth where they take more."""
    return min(sum(m.out_features * (m.in_features | 1) for m in pl.layers),
               WEIGHT_BYTES // itemsize)


def _chunks(pl: Plan, budget: int) -> int:
    """The weight chunks of rollout_env.cuh's plan_chunks."""
    n = 0
    for m in pl.layers:
        if m.out_features > budget:
            _refuse(f"a layer of more than {budget} units")
        rows = min(m.in_features, budget // m.out_features)
        while rows > 1 and m.out_features * (rows | 1) > budget:
            rows -= 1
        n += -(-m.in_features // rows)
    return n


def _act_operands(pl: Plan, obs, x_a, x_c, eps, traj, t, envs_per_block,
                  budget):
    net = pl.net
    dt, dev = net.std.dtype, eps.device
    N, A = eps.shape[0], net.std.shape[0]
    if dt not in (torch.float32, torch.float64):
        _refuse(f"dtype {dt}")
    eps = _check(eps, "eps", (N, A), dt, dev)
    in_a, in_c = pl.actor[0].in_features, pl.critic[0].in_features
    xa = _check(x_a, "x_a", (N, in_a), dt, dev)
    xc = xa if x_c is x_a else _check(x_c, "x_c", (N, in_c), dt, dev)
    ps = [_check(p, "a Linear layer's parameter", p.shape, dt, dev, True)
          for m in pl.layers for p in (m.weight, m.bias)]
    std = _check(net.std, "std", (A,), dt, dev, True)
    rows = 1
    outs = dict(o_obs=None, r_action=None, r_value=None)
    if traj is None:
        for k in ("o_action", "o_mu", "o_sigma"):
            outs[k] = torch.empty(N, A, dtype=dt, device=dev)
        outs["o_value"] = torch.empty(N, dtype=dt, device=dev)
        outs["o_logp"] = torch.empty(N, dtype=dt, device=dev)
        obs, t = None, None
    else:
        rows = traj.obs.shape[0]
        obs = _check(obs, "obs", (N, traj.obs.shape[2]), dt, dev)
        t = _check(t, "t", (1,), torch.int64, dev, True)
        for name in ACT_ROWS:
            buf = getattr(traj, name)
            outs["o_" + name] = _check(buf, f"traj.{name}",
                                       (rows, N) + tuple(buf.shape[2:]), dt,
                                       dev, True)
        outs["r_action"] = torch.empty(N, A, dtype=dt, device=dev)
        outs["r_value"] = torch.empty(N, dtype=dt, device=dev)
    itemsize = torch.empty((), dtype=dt).element_size()
    E = envs_per_block
    if E < ENV_TILE or E % ENV_TILE:
        raise ValueError(f"act takes envs a block in multiples of "
                         f"{ENV_TILE}, not {E}")
    budget = budget or _budget(pl, itemsize)
    chunks = _chunks(pl, budget)
    if chunks > MAX_CHUNKS:
        _refuse(f"its weights take {chunks} chunks of {budget} elements, "
                f"more than {MAX_CHUNKS}")
    hmax = max([1] + [m.out_features for m in pl.actor[:-1] + pl.critic[:-1]])

    def smem(E):
        return itemsize * (budget + E * (in_a + (0 if xc is xa else in_c)
                                         + 2 * hmax + 2 * A + 1))

    while smem(E) > MAX_SMEM and E > ENV_TILE:
        E = max(ENV_TILE, E // 2 // ENV_TILE * ENV_TILE)
    if smem(E) > MAX_SMEM:
        _refuse(f"{ENV_TILE} envs' activations take {smem(ENV_TILE)} B of "
                f"shared memory, more than {MAX_SMEM}")
    ints = dict(N=N, E=E, A=A, nobs=0 if obs is None else obs.shape[1],
                in_a=in_a, in_c=in_c, n_actor=len(pl.actor),
                n_critic=len(pl.critic), act=pl.kind, budget=budget,
                rows=rows)
    dims = [d for m in pl.layers for d in (m.in_features, m.out_features)]
    reals = dict(std_floor=float(net.std_floor), alpha=pl.alpha)
    ptrs = dict(obs=obs, xa=xa, xc=xc, eps=eps, std=std, t=t, **outs)
    return ints, reals, ptrs, dims, ps, outs, traj is None


def _run_act(pl: Plan, obs, x_a, x_c, eps, traj, t, host: bool,
             team: int = 1, envs_per_block: int = ENVS_PER_BLOCK,
             budget: Optional[int] = None) -> ActOut:
    ints, reals, ptrs, dims, ps, outs, fresh = _act_operands(
        pl, obs, x_a, x_c, eps, traj, t, envs_per_block, budget)
    dev = eps.device
    args = _blocks(_names(host, "act"), ints, reals, ptrs, dims, ps)
    last = team if host else torch.cuda.current_stream(dev).cuda_stream
    ctx = (torch.cuda.device(dev) if not host else contextlib.nullcontext())
    with ctx:
        err = _fn("rollout_act", pl.net.std.dtype, host)(*args, last)
    if err != 0:
        raise RuntimeError(_failed("act", host, err))
    if fresh:
        return ActOut(outs["o_action"], outs["o_mu"], outs["o_sigma"],
                      outs["o_value"], outs["o_logp"])
    return ActOut(outs["r_action"], None, None, outs["r_value"], None)


def act(pl: Plan, obs: torch.Tensor, x_a: torch.Tensor, x_c: torch.Tensor,
        eps: torch.Tensor, traj=None,
        t: Optional[torch.Tensor] = None) -> ActOut:
    """The policy step (``plain_act``): the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    dev = eps.device
    if dev.type == "cpu":
        return plain_act(pl, obs, x_a, x_c, eps, traj, t)
    if dev.type != "cuda":
        raise ValueError(f"act runs on cpu or cuda, not {dev}")
    out = _run_act(pl, obs, x_a, x_c, eps, traj, t, host=False)
    _act_counted.launches += 1
    return out


act.launches = 0
_act_counted = act  # counts on, where a caller wraps the module's name


def _store_operands(traj, t, reward, time_out, done, value, finished, n_done,
                    term_sums, gamma, rec, record):
    dt, dev = reward.dtype, reward.device
    N = reward.shape[0]
    rows = traj.reward.shape[0]
    nterms = finished.shape[1] if finished.dim() == 2 else -1
    if not 1 <= nterms <= MAX_TERMS:
        raise ValueError(f"store takes 1 to {MAX_TERMS} reward terms, not "
                         f"{tuple(finished.shape)}")

    def c(x, name, shape, dtype=dt, contiguous=False):
        return _check(x, name, shape, dtype, dev, contiguous)

    ptrs = dict(
        reward=c(reward, "reward", (N,)),
        time_out=c(time_out, "time_out", (N,), torch.bool),
        done=c(done, "done", (N,), torch.bool),
        value=c(value, "value", (N,)),
        finished=c(finished, "finished", (N, nterms)),
        t=c(t, "t", (1,), torch.int64),
        n_done=c(n_done, "n_done", ()),
        term_sums=c(term_sums, "term_sums", (nterms,)),
        o_reward=c(traj.reward, "traj.reward", (rows, N), contiguous=True),
        o_done=c(traj.done, "traj.done", (rows, N), torch.bool, True),
        o_t=torch.empty_like(t), o_n_done=torch.empty_like(n_done),
        o_term_sums=torch.empty_like(term_sums))
    widths = [0, 0, 0, 0]
    names = ("rec_qpos", "rec_qvel", "rec_action", "rec_done", "rec_cmd")
    if rec is None:
        ptrs.update(dict.fromkeys(names), o_rec=None)
    else:
        if len(record) != 5:
            raise ValueError("the record is (qpos, qvel, action, done, "
                             "commands)")
        for k, (name, x) in enumerate(zip(names, record)):
            row = x[0].reshape(-1)
            ptrs[name] = c(row, name, row.shape,
                           torch.bool if name == "rec_done" else dt)
            if name == "rec_done":
                if row.numel() != 1:
                    raise ValueError("the record's done is one flag an env")
            else:
                widths[min(k, 3)] = row.numel()
        width = sum(widths) + 1
        ptrs["o_rec"] = c(rec, "rec", (rows, width), contiguous=True)
    ints = dict(N=N, nterms=nterms, rows=rows, record=int(rec is not None),
                nq=widths[0], nv=widths[1], A=widths[2], ncmd=widths[3])
    return ints, dict(gamma=float(gamma)), ptrs


def _run_store(traj, t, reward, time_out, done, value, finished, n_done,
               term_sums, gamma, rec, record, host: bool, team: int = 1):
    ints, reals, ptrs = _store_operands(traj, t, reward, time_out, done,
                                        value, finished, n_done, term_sums,
                                        gamma, rec, record)
    dev = reward.device
    args = _blocks(_names(host, "store"), ints, reals, ptrs)
    last = team if host else torch.cuda.current_stream(dev).cuda_stream
    ctx = (torch.cuda.device(dev) if not host else contextlib.nullcontext())
    with ctx:
        err = _fn("rollout_store", reward.dtype, host)(*args, last)
    if err != 0:
        raise RuntimeError(_failed("store", host, err))
    return ptrs["o_t"], ptrs["o_n_done"], ptrs["o_term_sums"]


def store(traj, t: torch.Tensor, reward: torch.Tensor,
          time_out: torch.Tensor, done: torch.Tensor, value: torch.Tensor,
          finished: torch.Tensor, n_done: torch.Tensor,
          term_sums: torch.Tensor, gamma: float,
          rec: Optional[torch.Tensor] = None,
          record: Optional[Sequence[torch.Tensor]] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rollout step's stores and sums (``plain_store``): the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    dev = reward.device
    if dev.type == "cpu":
        return plain_store(traj, t, reward, time_out, done, value, finished,
                           n_done, term_sums, gamma, rec, record)
    if dev.type != "cuda":
        raise ValueError(f"store runs on cpu or cuda, not {dev}")
    out = _run_store(traj, t, reward, time_out, done, value, finished,
                     n_done, term_sums, gamma, rec, record, host=False)
    _store_counted.launches += 1
    return out


store.launches = 0
_store_counted = store  # counts on, where a caller wraps the module's name


def act_smem_bytes(pl: Plan, obs, x_a, x_c, eps, traj=None, t=None) -> int:
    """The shared memory of one of act's blocks on these operands, as the
    kernel's library computes it (0: operands it does not take)."""
    ints, reals, ptrs, dims, ps, _, _ = _act_operands(
        pl, obs, x_a, x_c, eps, traj, t, ENVS_PER_BLOCK, None)
    args = _blocks(_names(False, "act"), ints, reals, ptrs, dims, ps)
    suffix = "_f32" if pl.net.std.dtype == torch.float32 else "_f64"
    fn = getattr(_lib(False), "rollout_act_smem" + suffix)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(*args)


def host_act(pl: Plan, obs, x_a, x_c, eps, traj=None, t=None, team: int = 1,
             envs_per_block: int = ENVS_PER_BLOCK,
             budget: Optional[int] = None) -> ActOut:
    """``act``'s arithmetic (``csrc/rollout_env.cuh``) on CPU tensors,
    through the host driver ``csrc/rollout_host.cpp`` built with g++: a
    team of ``team`` threads (1 to 64) as a block's threads, tiles of
    ``envs_per_block`` envs (a multiple of 4) in series, the weights staged
    ``budget`` elements at a time (default: as the kernel stages them).  For the
    tests; raises RuntimeError where g++ is missing."""
    if not 1 <= team <= MAX_TEAM:
        raise ValueError(f"host_act runs teams of 1 to {MAX_TEAM}, not {team}")
    if eps.device.type != "cpu":
        raise ValueError("host_act takes CPU tensors")
    return _run_act(pl, obs, x_a, x_c, eps, traj, t, host=True, team=team,
                    envs_per_block=envs_per_block, budget=budget)


def host_store(traj, t, reward, time_out, done, value, finished, n_done,
               term_sums, gamma, rec=None, record=None, team: int = 1):
    """``store``'s arithmetic on CPU tensors through the host driver, as
    ``host_act``."""
    if not 1 <= team <= MAX_TEAM:
        raise ValueError(f"host_store runs teams of 1 to {MAX_TEAM}, not "
                         f"{team}")
    if reward.device.type != "cpu":
        raise ValueError("host_store takes CPU tensors")
    return _run_store(traj, t, reward, time_out, done, value, finished,
                      n_done, term_sums, gamma, rec, record, host=True,
                      team=team)
