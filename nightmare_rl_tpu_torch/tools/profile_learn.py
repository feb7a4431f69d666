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

``--grads-blocks G ...`` instead times this tree's ``grads`` kernel alone
(each launch behind a spin kernel and an L2 flush, ``chip_smoke.py``'s
``_kernel_ms``) on the first minibatch of the PPO's update at each number
of blocks a net (the card's SMs by default), the sizes in turns (in order,
then in reverse): how the kernel's time splits between a block's walk over
its tiles and the grid's sums.
``--against DIR`` (the root of another tree of the port, e.g. a ``git
archive`` of an earlier commit) measures that tree's package the same way,
in turns with this one's (this, other, other, this), each run a process of
its own with its tree's package first on the path.  The last line is one
JSON object with these numbers and the card's name.  A missing card
raises.
"""

from __future__ import annotations

import argparse
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


def measure(robot: str, envs: int) -> dict:
    """This process's tree, measured (see the module's docstring)."""
    from nightmare_rl_tpu_torch.rl.ppo import PPO, Parts
    from nightmare_rl_tpu_torch.tools.profile_rollout import _ppo
    from nightmare_rl_tpu_torch.utils.device import full_float32
    from nightmare_rl_tpu_torch.utils.graph import clone

    dev = torch.device("cuda")
    ppo = _ppo(robot, envs, dev)
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
           "envs": envs, "steps": ppo.cfg.runner.num_steps_per_env,
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


def grads_blocks(robot: str, envs: int, sizes: Sequence[int]) -> dict:
    """``grads`` alone by blocks a net (see the module's docstring)."""
    from nightmare_rl_tpu_torch.ops import learn as L
    from nightmare_rl_tpu_torch.tools.profile_rollout import _ppo
    from nightmare_rl_tpu_torch.tools.profile_smooth import alone_us

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
    us: Dict[int, List[float]] = {G: [] for G in sizes}
    for order in (list(sizes), list(sizes)[::-1]):
        for G in order:
            us[G].append(alone_us(lambda G=G: L._run_grads(
                ppo.act_plan, a, traj, ret, norm_adv, idx, ppo._flat,
                host=False, blocks=G)))
    name = torch.cuda.get_device_name(0)
    print(f"profile-learn: {name}, {robot} {envs} envs float32, grads alone "
          f"(L2 flushed) on a minibatch of {idx.numel()} by blocks a net, in "
          f"turns: " + "; ".join(f"{G}: {', '.join(f'{x:.2f}' for x in v)} "
                                 f"us" for G, v in us.items()))
    return {"device": name, "robot": robot, "envs": envs, "grads_us": us}


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
    print(f"profile-learn: {r['device']}, {label} ({r['tree']}), "
          f"{r['robot']} {r['envs']} envs x {r['steps']} steps float32 "
          f"({r['samples_per_minibatch']} samples a minibatch): the learning "
          f"half in turns (eager, graph, graph, eager) "
          f"{s['eager'][0]:.4f}, {s['graph'][0]:.4f}, {s['graph'][1]:.4f}, "
          f"{s['eager'][1]:.4f} s; capture {r['capture_s']:.2f} s; graph "
          f"replays {r['graph_profile']['kernels']} kernels, device busy "
          f"{r['graph_profile']['device_busy_ms']:.3f} ms")
    for who in ("eager", "graph"):
        print(f"  {who} spans by part: " + "; ".join(
            f"{k} {v['ms']:.3f} ms in {v['calls']} calls"
            for k, v in r[f"{who}_span_ms"].items()))
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


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--envs", type=int, default=2048)
    p.add_argument("--robot", default="nightmare_v3",
                   choices=["nightmare_v3", "anymal_c"])
    p.add_argument("--against", default=None)
    p.add_argument("--grads-blocks", type=int, nargs="+", default=None,
                   help="time grads alone at each number of blocks a net")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_learn measures the card: CUDA is not "
                           "available")
    os.environ.setdefault("NIGHTMARE_PGS", "legs")
    if args.grads_blocks:
        r = grads_blocks(args.robot, args.envs, args.grads_blocks)
        print(json.dumps(r))
        return r
    sub = ["-e", str(args.envs), "--robot", args.robot]
    if args.worker:
        r = measure(args.robot, args.envs)
        print(json.dumps(r))
        return r
    if args.against is None:
        runs = [("this", measure(args.robot, args.envs))]
    else:
        other = os.path.abspath(args.against)
        runs = [(who, _worker(REPO if who == "this" else other, sub))
                for who in ("this", "other", "other", "this")]
    for who, r in runs:
        _print(who, r)
    result = {"device": runs[0][1]["device"], "against": args.against,
              "runs": [dict(r, who=who) for who, r in runs]}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
