"""Where the time of a PPO iteration's learning half goes on the card:
``PPO._learn`` (V of the rollout's last observations, GAE, the update's
permutation and the 5×4 minibatch steps), called eagerly with the plain
parts and replayed from its captured parts (``rl/ppo.py::CapturedLearn``,
as ``PPO.learn_step`` runs it).

    python -m nightmare_rl_tpu_torch.tools.profile_learn [-e 2048]
        [--robot nightmare_v3|anymal_c] [--against DIR]

For a PPO on the robot's env at ``-e`` envs in float32 (the training
slice's setting; NIGHTMARE_PGS=legs unless set), after one rollout of the
config's 80 steps (its trajectory is the update's input), it measures the
learning half from one state (parameters, gradients, Adam's state, the lr
and the generator restored in place before every run):

- its seconds an iteration, eager and as graph replays, in turns (eager,
  graph, graph, eager), each a synchronized run on the host's clock;
- each part's span on the device (``head``, ``spread``, ``tail``;
  ``grads`` and ``step`` summed over the 20 minibatches), from a pair of
  CUDA events around each call, eager and replayed;
- eager, with ``torch.profiler``: kernels and device ms an iteration by
  part (each part's calls in a range of this tool's; the reductions over
  the ranks and the statistics' stack fall outside every part), and within
  a part by the top-level op that launched them (the autograd engine's
  backward ops included: an op belongs to the part whose range held its
  start); the port's own kernels, which the profiler links to no op, go to
  their part by name;
- replayed, with ``torch.profiler``: the kernels and device busy ms of an
  iteration.

It runs on trees of the port from before ``ops/learn.py`` too.

``--grads-blocks G ...`` instead times the tree's ``grads`` kernel alone
(each launch behind a spin kernel and an L2 flush, ``chip_smoke.py``'s
``_kernel_ms``) on the first minibatch of the PPO's update at each number
of blocks a net, the sizes in turns (in order, then in reverse): how the
kernel's time splits between a block's walk over its tiles and the grid's
sums.  ``--timeline`` builds the tree's ``learn.cu`` with
``-DLEARN_TIMELINE`` (thread 0 of each block stamps the card's global
timer and its SM's cycle counter at the end of each phase of one tile,
its block's second: the rows' gather, each forward layer, the loss
stage's phases, each backward layer's; at the end of the block's walk and
of the grid's sums, ``learn_env.cuh``'s ``Stamp``), runs it once on that
minibatch and prints, per net, each phase's µs (mean and largest over the
blocks) and cycles; a tree whose source has no stamps gives none.
``--against DIR`` (the root of another tree of the port, e.g. a ``git
archive`` of an earlier commit) measures that tree's package the same way,
in turns with this one's (this, other, other, this), each run a process of
its own with its tree's package first on the path (with ``--timeline``,
each tree's first run gives its timeline).  The last line is one JSON
object with these numbers and the card's name.  A missing card raises.

    python -m nightmare_rl_tpu_torch.tools.profile_learn [-e 2048]
        --grads-blocks 132 [--timeline] [--against DIR]

``--adam`` instead times the tree's ``adam`` alone (L2 flushed) on the
parameters of each of nightmare_v3's nets at the config's widths (the
feed-forward net's 15,043 in 17 tensors, the recurrent net's 2,434,795 in
23), weights from a seed and Adam a few steps in (``_adam_inputs``), in
turns, and its calls back to back on the host's clock; with
``--timeline`` it also launches the stamped build's adam once on each
(cold L2) and prints adam's phases by block from its own stamps
(``adam_start``, ``adam_squares``: a block's sums of squares;
``adam_tree``: the last block's norm and lr; ``adam_pass``, ``adam_wait``,
``adam_first``, ``adam_last``: the step's start, the end of its wait for
the sums, its first and last chunks; a design without a phase does not
stamp it); with ``--against``, in turns with the other tree's.  ``--recurrent`` measures
the learning half of the recurrent net's PPO (its seconds and spans by
part, eager and replayed, without the profiler's splits).

    python -m nightmare_rl_tpu_torch.tools.profile_learn --adam
        [--timeline] [--against DIR]
    python -m nightmare_rl_tpu_torch.tools.profile_learn --recurrent
        [--against DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PREFIX = "learn:"  # this tool's ranges around the parts
# the port's own kernels (linked to no op) by their part
_LAUNCHED_BY = (("learn_gae", "head"), ("learn_grads", "grads"),
                ("learn_adam", "step"))


def _ranged(parts, fields):
    """Each part in a ``record_function`` range named after it."""
    def wrap(fn, name):
        def call(*args):
            with record_function(PREFIX + name):
                return fn(*args)
        return call
    return [wrap(fn, name) for fn, name in zip(parts, fields)]


def _timed(parts, fields, pairs: Dict[str, list]):
    """Each part between a pair of CUDA events (kept in ``pairs``)."""
    def wrap(fn, name):
        def call(*args):
            a, b = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            a.record()
            out = fn(*args)
            b.record()
            pairs.setdefault(name, []).append((a, b))
            return out
        return call
    return [wrap(fn, name) for fn, name in zip(parts, fields)]


def _spans(pairs: Dict[str, list]) -> Dict[str, dict]:
    torch.cuda.synchronize()
    return {k: {"calls": len(v), "ms": sum(a.elapsed_time(b) for a, b in v)}
            for k, v in pairs.items()}


def _split(prof) -> Dict[str, dict]:
    """Kernels and device µs by part and by top-level op (see the module's
    docstring)."""
    events = prof.events()
    windows = [(e.name[len(PREFIX):], e.time_range.start, e.time_range.end)
               for e in events if e.name.startswith(PREFIX)
               and e.device_type == DeviceType.CPU]

    def part_of(t) -> str:
        for name, a, b in windows:
            if a <= t <= b:
                return name
        return "(outside the parts)"

    def top(e):
        while e.cpu_parent is not None and not e.cpu_parent.name.startswith(
                PREFIX):
            e = e.cpu_parent
        return e

    acc: Dict[str, dict] = {}

    def add(part: str, op: str, n: int, us: float) -> None:
        p = acc.setdefault(part, {"kernels": 0, "device_us": 0.0, "calls": 0,
                                  "ops": {}})
        p["kernels"] += n
        p["device_us"] += us
        o = p["ops"].setdefault(op, [0, 0.0])
        o[0] += n
        o[1] += us

    linked: Dict[str, int] = {}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        add(part_of(e.time_range.start), top(e).name, len(e.kernels),
            sum(k.duration for k in e.kernels))
        for k in e.kernels:
            linked[k.name] = linked.get(k.name, 0) + 1
    for e in events:
        # the ranges' and the optimizer's annotations on the device's
        # timeline are not kernels
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False) or e.name.startswith(
                    (PREFIX, "Optimizer.")):
            continue
        if linked.get(e.name, 0) > 0:
            linked[e.name] -= 1
            continue
        part = next((p for key, p in _LAUNCHED_BY if key in e.name),
                    "(unlinked)")
        add(part, e.name, 1, e.time_range.elapsed_us())
    for name, _, _ in windows:
        acc.setdefault(name, {"kernels": 0, "device_us": 0.0, "calls": 0,
                              "ops": {}})["calls"] += 1
    return acc


def _recurrent_ppo(envs: int, dev):
    """The training slice's PPO (``profile_rollout._ppo``, whose older
    versions ``--against`` may import take no policy) with the recurrent
    net (nightmare_v3 only)."""
    import dataclasses

    from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
    from nightmare_rl_tpu_torch.core.config import PPOCfg
    from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
    from nightmare_rl_tpu_torch.rl.ppo import PPO

    env = NightmareV3Env(NightmareV3Cfg().replace(
        env=EnvCfg(num_envs=envs)), device=dev, dtype=torch.float32)
    cfg = PPOCfg()
    cfg = cfg.replace(runner=dataclasses.replace(
        cfg.runner, policy_class_name="ActorCriticRecurrent"))
    ppo = PPO(env, cfg, record_states=True)
    ppo.init(0)
    ppo.randomize_episode_lengths()
    return ppo


def measure(robot: str, envs: int, recurrent: bool = False) -> dict:
    """This process's tree, measured (see the module's docstring); the
    recurrent net's without the profiler's splits."""
    from nightmare_rl_tpu_torch.rl.ppo import PPO, Parts
    from nightmare_rl_tpu_torch.tools.profile_rollout import _ppo
    from nightmare_rl_tpu_torch.utils.device import full_float32
    from nightmare_rl_tpu_torch.utils.graph import clone

    dev = torch.device("cuda")
    ppo = _recurrent_ppo(envs, dev) if recurrent else _ppo(robot, envs, dev)
    with torch.no_grad():
        ppo.rollout()
    inputs = (ppo._traj, ppo.obs, ppo.hidden, clone(ppo.hidden))
    held = ppo._held()
    start = [h.detach().clone() for h in held]
    gen0 = ppo.generator.get_state()
    fields = Parts._fields

    def restore():
        with torch.no_grad():
            for h, x in zip(held, start):
                h.copy_(x)
        ppo.generator.set_state(gen0)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    cap = ppo._learner(*inputs)
    capture_s = time.perf_counter() - t0

    def run(who: str, parts=None):
        if who == "eager":
            with full_float32():
                return ppo._learn(*inputs, parts=Parts(*(
                    parts or ppo._parts())))
        return ppo._learn(*inputs, parts=Parts(*(parts or cap.parts)))

    out = {"device": torch.cuda.get_device_name(dev), "robot": robot,
           "recurrent": recurrent, "envs": envs,
           "steps": ppo.cfg.runner.num_steps_per_env,
           "samples_per_minibatch": (ppo.cfg.runner.num_steps_per_env * envs
                                     // ppo.cfg.algorithm.num_mini_batches),
           "capture_s": capture_s,
           "tree": os.path.dirname(os.path.dirname(os.path.abspath(
               inspect.getfile(PPO))))}
    for who in ("eager", "graph"):
        restore()
        run(who)
    secs: Dict[str, List[float]] = {"eager": [], "graph": []}
    for who in ("eager", "graph", "graph", "eager"):
        restore()
        w0 = time.perf_counter()
        run(who)
        torch.cuda.synchronize()
        secs[who].append(time.perf_counter() - w0)
    out["update_s"] = secs
    for who in ("eager", "graph"):
        pairs: Dict[str, list] = {}
        base = ppo._parts() if who == "eager" else cap.parts
        restore()
        run(who, _timed(base, fields, pairs))
        out[f"{who}_span_ms"] = _spans(pairs)
    restore()
    if recurrent:
        return out
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run("eager", _ranged(ppo._parts(), fields))
        torch.cuda.synchronize()
    split = _split(prof)
    out["eager_parts"] = {
        k: {"calls": v["calls"], "kernels": v["kernels"],
            "device_ms": v["device_us"] / 1e3,
            "ops": {op: {"kernels": n, "device_ms": us / 1e3}
                    for op, (n, us) in sorted(v["ops"].items(),
                                              key=lambda kv: -kv[1][1])}}
        for k, v in split.items()}
    restore()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run("graph")
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out["graph_profile"] = {
        "kernels": sum(e.count for e in evts),
        "device_busy_ms": sum(e.self_device_time_total for e in evts) / 1e3,
        "by_kernel": {e.key: {"count": e.count,
                              "device_ms": e.self_device_time_total / 1e3}
                      for e in sorted(evts, key=lambda e:
                                      -e.self_device_time_total)[:12]}}
    restore()
    return out


def _grads_inputs(robot: str, envs: int):
    """The first minibatch of a PPO's update after one rollout at ``envs``
    envs, as ``grads`` takes it (every argument but the blocks)."""
    from nightmare_rl_tpu_torch.ops import learn as L
    from nightmare_rl_tpu_torch.tools.profile_rollout import _ppo

    ppo = _ppo(robot, envs, torch.device("cuda"))
    with torch.no_grad():
        traj = ppo.rollout()[0]
        adv, ret, mean = L.gae(traj.reward, traj.value, traj.done,
                               ppo.last_value(ppo.obs, ppo.hidden),
                               ppo.cfg.algorithm.gamma, ppo.cfg.algorithm.lam)
        norm_adv = ppo._normalize(adv, *ppo._spread(adv, mean))
    a = ppo.cfg.algorithm
    T = traj.reward.shape[0]
    idx = ppo.draw_perm(T, envs).reshape(a.num_mini_batches, -1)[0]
    return (ppo.act_plan, a, traj, ret, norm_adv, idx, ppo._flat)


def _ptxas(log: str, label: str, kernel: str = "grads") -> None:
    """ptxas's registers, stack and spills of ``kernel``'s float32 kernels
    from a build log of ``learn.cu``."""
    from nightmare_rl_tpu_torch.tools.profile_smooth import ptxas

    for f in ptxas(log):
        if f"learn_{kernel}" in f["function"] and "kernelIf" in f["function"]:
            print(f"profile-learn: {label}: {f['function']} "
                  f"{f.get('registers')} registers, stack {f.get('stack')} B, "
                  f"spill {f.get('spill_stores')}/{f.get('spill_loads')} B")


def grads_blocks(robot: str, envs: int, sizes: Sequence[int]) -> dict:
    """``grads`` alone by blocks a net, in turns (see the module's
    docstring)."""
    from nightmare_rl_tpu_torch.ops import learn as L
    from nightmare_rl_tpu_torch.tools.profile_smooth import alone_us

    args = _grads_inputs(robot, envs)
    _ptxas(L.build.build("learn")["log"], "learn.cu")
    us: Dict[int, List[float]] = {G: [] for G in sizes}
    for order in (sizes, sizes[::-1]):
        for G in order:
            us[G].append(alone_us(lambda G=G: L._run_grads(
                *args, host=False, blocks=G)))
    name = torch.cuda.get_device_name(0)
    tree = os.path.dirname(os.path.dirname(os.path.abspath(L.__file__)))
    print(f"profile-learn: {name}, {tree}: {robot} {envs} envs float32, grads "
          f"alone (L2 flushed) on a minibatch of {args[5].numel()} by blocks a "
          "net, in turns: " + "; ".join(
              f"{G}: {', '.join(f'{x:.2f}' for x in t)} us"
              for G, t in us.items()))
    return {"device": name, "robot": robot, "envs": envs, "tree": tree,
            "grads_us": us}


def _phase_split(t: torch.Tensor, c: torch.Tensor, names: Sequence[str],
                 rows: range) -> dict:
    """The stamps of blocks ``rows`` (global timer ns ``t``, cycles ``c``;
    0: not stamped) as phases: each present stamp's time since the stamp
    before it in its block, in µs and in cycles, the mean and the largest
    over the blocks, in the order of the blocks' mean times."""
    acc: Dict[str, list] = {}
    span = t[rows.start:rows.stop]
    t0 = float(span[span > 0].min())
    for b in rows:
        have = [k for k in range(len(names)) if t[b, k] > 0]
        have.sort(key=lambda k: float(t[b, k]))
        for k0, k1 in zip(have, have[1:]):
            acc.setdefault(names[k1], []).append(
                (float(t[b, k1] - t[b, k0]) / 1e3, float(c[b, k1] - c[b, k0]),
                 (float(t[b, k1]) - t0) / 1e3))
    out = {}
    for name, v in sorted(acc.items(), key=lambda kv: sum(
            x[2] for x in kv[1]) / len(kv[1])):
        us = [x[0] for x in v]
        cyc = [x[1] for x in v]
        out[name] = {"blocks": len(v), "mean_us": sum(us) / len(us),
                     "max_us": max(us), "mean_cycles": sum(cyc) / len(cyc),
                     "end_us": max(x[2] for x in v)}
    return out


def grads_timeline(robot: str, envs: int, args=None) -> Optional[dict]:
    """The stamped build of this process's tree (``learn.cu`` with
    ``-DLEARN_TIMELINE``), launched through its own C entry on the
    wrapper's argument blocks, on the first minibatch: each role's phases
    of one tile (a block's second), its walk and the grid's sums; None
    where the tree's source has no stamps."""
    from nightmare_rl_tpu_torch.ops import learn as L
    from nightmare_rl_tpu_torch.tools.profile_smooth import _nvcc_lib, alone_us

    src = os.path.join(os.path.dirname(os.path.abspath(L.__file__)), "csrc",
                       "learn.cu")
    with open(src) as fh:
        if "LEARN_TIMELINE" not in fh.read():
            return None
    args = args or _grads_inputs(robot, envs)
    built = _nvcc_lib(src, ["LEARN_TIMELINE"])
    lib = built["lib"]
    _ptxas(built["log"], "learn.cu -DLEARN_TIMELINE")
    launch = getattr(lib, "learn_grads_" + (
        "f32" if args[6].dtype == torch.float32 else "f64"))
    launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
    launch.restype = ctypes.c_int

    def run():
        blocks, keep = L._grads_args(*args, host=False)
        err = launch(*blocks, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"stamped grads launch: cudaError_t {err}")
        return keep

    stamped = alone_us(run)
    lib.learn_timeline_names.restype = ctypes.c_char_p
    names = lib.learn_timeline_names().decode().split(",")
    nst = lib.learn_timeline_stamps()
    if lib.learn_timeline_clear() != 0:
        raise RuntimeError("learn_timeline_clear failed")
    run()
    torch.cuda.synchronize()
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    G = L.grads_geometry(args[0], args[5].numel(), blocks)["blocks"]
    tile = L.TILE
    get = lib.learn_timeline
    get.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    get.restype = ctypes.c_int
    n = 2 * G * nst
    out = []
    for cycles in (0, 1):
        buf = (ctypes.c_longlong * n)()
        if get(buf, n, cycles) != 0:
            raise RuntimeError("learn_timeline failed")
        out.append(torch.tensor(list(buf), dtype=torch.float64).view(
            2 * G, nst))
    t, c = out
    launch0 = float(t[:, 0][t[:, 0] > 0].min())
    res = {"stamped_alone_us": stamped, "blocks": G,
           "tile": tile, "tiles": -(-args[5].numel() // tile),
           "end_us": float(t.max() - launch0) / 1e3}
    name = torch.cuda.get_device_name(0)
    print(f"profile-learn: {name}, timeline of grads (the stamped build "
          f"{stamped:.2f} us alone; {G} blocks a net, {res['tiles']} tiles of "
          f"{tile} samples; the last stamp {res['end_us']:.2f} us after the "
          f"first block starts)")
    for k, role in enumerate(("actor", "critic")):
        split = _phase_split(t, c, names, range(k * G, (k + 1) * G))
        res[role] = split
        print(f"  {role} (us mean / max over blocks, cycles mean; the "
              f"phase's last end, us): " + ", ".join(
                  f"{p} {v['mean_us']:.2f}/{v['max_us']:.2f} "
                  f"({v['mean_cycles']:.0f} cyc; {v['end_us']:.1f})"
                  for p, v in split.items()))
    return res


ADAM_NETS = ("ActorCritic", "ActorCriticRecurrent")


def _adam_inputs(kind: str, seed: int = 0, kl: float = 1.0):
    """adam's arguments for a PPO with ``kind``'s net at the config's widths
    (nightmare_v3's 66 observations and 18 actions) on the card in float32:
    ``init_params(seed)``'s weights, Adam a few steps in (step counts 3,
    moments drawn from the seed), gradients drawn at 1e-2 (their norm above
    max_grad_norm: the clip engaged), the KL at ``kl`` times its target (by
    default the lr kept), world 1."""
    import dataclasses
    import types

    from nightmare_rl_tpu_torch.core.config import PPOCfg
    from nightmare_rl_tpu_torch.rl.ppo import PPO

    dev = torch.device("cuda")
    cfg = PPOCfg()
    cfg = cfg.replace(runner=dataclasses.replace(cfg.runner,
                                                 policy_class_name=kind))
    env = types.SimpleNamespace(device=dev, dtype=torch.float32, num_obs=66,
                                num_actions=18)
    ppo = PPO(env, cfg)
    ppo.init_params(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for st in ppo.optimizer.state.values():
            st["step"].fill_(3.0)
            st["exp_avg"].normal_(0.0, 1e-3, generator=g)
            st["exp_avg_sq"].uniform_(0.0, 1e-5, generator=g)
        ppo._flat.normal_(0.0, 1e-2, generator=g)
        ppo._flat[-1] = cfg.algorithm.desired_kl * kl
    losses = torch.zeros(3, device=dev)
    return (ppo.optimizer, ppo._flat, ppo._lr, 1, cfg.algorithm, losses)


def _host_us(fn, calls: int = 200) -> float:
    """µs of the host's clock per call of ``fn`` over ``calls`` calls back
    to back (the device's queue drained before and after): the wrapper's
    host time where it exceeds the kernel's."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def adam_alone() -> dict:
    """``adam`` alone (L2 flushed) on each of ADAM_NETS' parameters, twice
    in turns, and its calls back to back on the host's clock."""
    from nightmare_rl_tpu_torch.ops import learn as L
    from nightmare_rl_tpu_torch.tools.profile_smooth import alone_us

    _ptxas(L.build.build("learn")["log"], "learn.cu", "adam")
    ins = {k: _adam_inputs(k) for k in ADAM_NETS}
    us: Dict[str, List[float]] = {k: [] for k in ADAM_NETS}
    for order in (ADAM_NETS, ADAM_NETS[::-1]):
        for k in order:
            us[k].append(alone_us(lambda k=k: L.adam(*ins[k])))
    host = {k: _host_us(lambda k=k: L.adam(*ins[k])) for k in ADAM_NETS}
    sizes = {k: ins[k][1].numel() - 1 for k in ADAM_NETS}
    name = torch.cuda.get_device_name(0)
    tree = os.path.dirname(os.path.dirname(os.path.abspath(L.__file__)))
    print(f"profile-learn: {name}, {tree}: adam alone (L2 flushed), in "
          "turns: " + "; ".join(
              f"{k} (P = {sizes[k]:,}) {', '.join(f'{x:.2f}' for x in t)} us"
              for k, t in us.items()) + "; back to back on the host's clock "
          + ", ".join(f"{k} {v:.2f} us a call" for k, v in host.items()))
    return {"device": name, "tree": tree, "P": sizes, "adam_us": us,
            "host_us": host}


def adam_timeline() -> Optional[dict]:
    """The stamped build of this process's tree launched through its own C
    entry on ``_adam_args``' blocks, on each of ADAM_NETS' parameters:
    adam's phases by block; None where the tree's source has no adam
    stamps."""
    from nightmare_rl_tpu_torch.ops import learn as L
    from nightmare_rl_tpu_torch.tools.profile_smooth import (
        L2_FLUSH_BYTES, SPIN_CYCLES, _nvcc_lib, alone_us)

    src = os.path.join(os.path.dirname(os.path.abspath(L.__file__)), "csrc",
                       "learn.cu")
    with open(src) as fh:
        if "LEARN_TIMELINE" not in fh.read() or not hasattr(L, "_adam_args"):
            return None
    built = _nvcc_lib(src, ["LEARN_TIMELINE"])
    lib = built["lib"]
    lib.learn_timeline_names.restype = ctypes.c_char_p
    names = lib.learn_timeline_names().decode().split(",")
    if "adam_start" not in names:
        return None
    _ptxas(built["log"], "learn.cu -DLEARN_TIMELINE", "adam")
    nst = lib.learn_timeline_stamps()
    launch = lib.learn_adam_f32
    launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
    launch.restype = ctypes.c_int
    get = lib.learn_timeline
    get.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    get.restype = ctypes.c_int
    rows = 1024  # learn.cu's kTimelineBlocks (the library caps a read)
    name = torch.cuda.get_device_name(0)
    res = {}
    for kind in ADAM_NETS:
        a_in = _adam_inputs(kind)

        def run():
            blocks, keep = L._adam_args(*a_in, host=False)
            err = launch(*blocks, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"stamped adam launch: cudaError_t {err}")
            return keep

        stamped = alone_us(run)
        if lib.learn_timeline_clear() != 0:
            raise RuntimeError("learn_timeline_clear failed")
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)  # alone and cold, as alone_us's calls
        flush.zero_()
        run()
        torch.cuda.synchronize()
        out = []
        for cycles in (0, 1):
            buf = (ctypes.c_longlong * (rows * nst))()
            if get(buf, rows * nst, cycles) != 0:
                raise RuntimeError("learn_timeline failed")
            out.append(torch.tensor(list(buf), dtype=torch.float64).view(
                rows, nst))
        t, c = out
        used = [b for b in range(rows) if bool((t[b] > 0).any())]
        t0 = float(t[used][t[used] > 0].min())
        split = _phase_split(t, c, names, range(used[0], used[-1] + 1))
        r = {"P": a_in[1].numel() - 1, "stamped_alone_us": stamped,
             "blocks": len(used), "end_us": float(t.max() - t0) / 1e3,
             "phases": split}
        res[kind] = r
        print(f"profile-learn: {name}, timeline of adam on {kind}'s "
              f"parameters (P = {r['P']:,}; the stamped build {stamped:.2f} "
              f"us alone; {len(used)} blocks stamped; the last stamp "
              f"{r['end_us']:.2f} us after the first): " + ", ".join(
                  f"{p} {v['mean_us']:.2f}/{v['max_us']:.2f} us in "
                  f"{v['blocks']} blocks ({v['mean_cycles']:.0f} cyc; "
                  f"{v['end_us']:.1f})" for p, v in split.items()))
    return res


def _worker(root: str, argv: Sequence[str]) -> dict:
    """``measure`` in a process of its own, ``root``'s package first on the
    path; its last line of output, JSON."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    code = ("import runpy, sys; sys.argv = sys.argv[1:]; "
            f"runpy.run_path({os.path.abspath(__file__)!r}, "
            "run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code, __file__, "--worker",
                           *argv], cwd=root, env=env, capture_output=True,
                          text=True, check=False, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"profile_learn on {root} failed:\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _print(label: str, r: dict) -> None:
    s = r["update_s"]
    net = " recurrent" if r.get("recurrent") else ""
    print(f"profile-learn: {r['device']}, {label} ({r['tree']}), "
          f"{r['robot']}{net} {r['envs']} envs x {r['steps']} steps float32 "
          f"({r['samples_per_minibatch']} samples a minibatch): the learning "
          f"half in turns (eager, graph, graph, eager) "
          f"{s['eager'][0]:.4f}, {s['graph'][0]:.4f}, {s['graph'][1]:.4f}, "
          f"{s['eager'][1]:.4f} s; capture {r['capture_s']:.2f} s")
    for who in ("eager", "graph"):
        print(f"  {who} spans by part: " + "; ".join(
            f"{k} {v['ms']:.3f} ms in {v['calls']} calls"
            for k, v in r[f"{who}_span_ms"].items()))
    if "eager_parts" not in r:
        return
    print(f"  graph replays {r['graph_profile']['kernels']} kernels, device "
          f"busy {r['graph_profile']['device_busy_ms']:.3f} ms")
    parts = r["eager_parts"]
    total = [sum(p[k] for p in parts.values()) for k in ("kernels",
                                                         "device_ms")]
    print(f"  eager by part and op: {total[0]} kernels, {total[1]:.3f} "
          f"device ms an iteration")
    for name, p in sorted(parts.items(), key=lambda kv: -kv[1]["device_ms"]):
        print(f"  {p['kernels']:7d} kernels {p['device_ms']:9.3f} ms  {name} "
              f"({p['calls']} calls)")
        for op, o in list(p["ops"].items())[:8]:
            print(f"      {o['kernels']:7d} {o['device_ms']:9.3f} ms  {op[:90]}")
    print("  graph replays' kernels: " + "; ".join(
        f"{k[:60]} {v['count']}x {v['device_ms']:.3f} ms"
        for k, v in r["graph_profile"]["by_kernel"].items()))


def _kernel_runs(args) -> dict:
    """``--grads-blocks``, ``--adam`` and ``--timeline`` in this process's
    tree."""
    r = {}
    if args.grads_blocks:
        r["blocks"] = grads_blocks(args.robot, args.envs, args.grads_blocks)
    if args.adam:
        r["adam"] = adam_alone()
    if args.timeline and args.adam:
        r["adam_timeline"] = adam_timeline()
    if args.timeline and (args.grads_blocks or not args.adam):
        r["timeline"] = grads_timeline(args.robot, args.envs)
    return r


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--envs", type=int, default=2048)
    p.add_argument("--robot", default="nightmare_v3",
                   choices=["nightmare_v3", "anymal_c"])
    p.add_argument("--against", default=None)
    p.add_argument("--grads-blocks", type=int, nargs="+", default=None,
                   help="time grads alone at each number of blocks a net")
    p.add_argument("--adam", action="store_true",
                   help="time adam alone on both nets' parameters")
    p.add_argument("--timeline", action="store_true",
                   help="the phases of grads (or, with --adam, adam) from a "
                   "build with its timer stamps")
    p.add_argument("--recurrent", action="store_true",
                   help="the learning half of the recurrent net")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_learn measures the card: CUDA is not "
                           "available")
    os.environ.setdefault("NIGHTMARE_PGS", "legs")
    kernel = bool(args.grads_blocks or args.timeline or args.adam)
    sub = ["-e", str(args.envs), "--robot", args.robot]
    if args.grads_blocks:
        sub += ["--grads-blocks", *map(str, args.grads_blocks)]
    if args.adam:
        sub += ["--adam"]
    if args.recurrent:
        sub += ["--recurrent"]
    if args.worker:
        r = (_kernel_runs(args) if kernel
             else measure(args.robot, args.envs, args.recurrent))
        print(json.dumps(r))
        return r
    if kernel and args.against is None:
        r = _kernel_runs(args)
        print(json.dumps(r))
        return r
    if args.against is None:
        runs = [("this", measure(args.robot, args.envs, args.recurrent))]
    else:
        other = os.path.abspath(args.against)
        runs, seen = [], set()
        for who in ("this", "other", "other", "this"):
            extra = ["--timeline"] if args.timeline and who not in seen else []
            seen.add(who)
            runs.append((who, _worker(REPO if who == "this" else other,
                                      sub + extra)))
    if kernel:
        result = {"device": torch.cuda.get_device_name(0),
                  "against": args.against,
                  "runs": [dict(r, who=who) for who, r in runs]}
        if args.grads_blocks:
            print("profile-learn: grads alone in turns (this, other, other, "
                  "this), us by blocks a net: " + "; ".join(
                      f"{G}: " + ", ".join(
                          f"{sum(r['blocks']['grads_us'][str(G)]) / 2:.2f}"
                          for _, r in runs)
                      for G in args.grads_blocks))
        if args.adam:
            print("profile-learn: adam alone in turns (this, other, other, "
                  "this), us: " + "; ".join(
                      f"{k}: " + ", ".join(
                          f"{sum(r['adam']['adam_us'][k]) / 2:.2f}"
                          for _, r in runs)
                      for k in ADAM_NETS)
                  + "; back to back on the host's clock, us a call: "
                  + "; ".join(f"{k}: " + ", ".join(
                      f"{r['adam']['host_us'][k]:.2f}" for _, r in runs)
                      for k in ADAM_NETS))
        print(json.dumps(result))
        return result
    for who, r in runs:
        _print(who, r)
    result = {"device": runs[0][1]["device"], "against": args.against,
              "runs": [dict(r, who=who) for who, r in runs]}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
