"""Where the time of a rollout step goes on the card: the step that
``PPO.rollout`` replays, eager and as the replay of a CUDA graph.

    python -m nightmare_rl_tpu_torch.tools.profile_rollout [-e 2048]
        [--steps 80] [--robot nightmare_v3|anymal_c] [--by-module]
        [--against DIR] [--blocks 8 16 32 ...]

For a PPO on the robot's env at ``-e`` envs in float32 with recording on
(the training slice's setting; NIGHTMARE_PGS=legs unless set), it measures
``PPO._rollout_step`` called eagerly ("eager") and captured once as a CUDA
graph and replayed (``utils/graph.py::CapturedStep``, "graph", as
``PPO.rollout`` replays it), each a run of ``--steps`` steps from t = 0,
in turns (eager, graph, graph, eager):

- the wall time of a step (host clock around a synchronized run) in each
  turn, and the host's seconds per call (the same run, no sync between
  calls: for the graph, ``CapturedStep.__call__``, the copy of the carry
  given and the replay's launch);
- with ``torch.profiler`` over a run: the device's busy time per step (its
  kernels and copies), hence its idle share of the faster turn's wall
  time, and the kernels per step;
- the captured graph's nodes by type (``CapturedStep.node_counts``).

``--by-module`` instead profiles ``--steps`` eager steps split into parts,
each a ``torch.profiler.record_function`` range put on by this tool (the
port's code is not edited): the step's statements, each named by what it
does (the policy, ``env.step``, the recurrent reset, the bootstrap, the
trajectory's stores, the record row, the finished sums, ``t + 1``, the
rollout kernels' ``rollout.act`` and ``rollout.store``), by a line tracer
on ``PPO._rollout_step``; inside them the actor's and critic's MLPs, the
noise's draw (``Shard.draw``), ``sample_action`` and ``log_prob``, each
wrapped where the tree has them; and the carry's copies into the graph's
buffers, as ``CapturedStep`` makes them after a replayed step.  Each
kernel goes to the innermost range whose call launched it (the port's own
kernels, which the profiler links to no op, to the range of their
caller): kernels and device ms per step by range.  It runs on trees of
the port from before ``ops/rollout.py`` too.

``--blocks E ...`` instead times this tree's ``act`` kernel
(``ops/csrc/rollout.cu``) alone, each launch behind a spin kernel and an
L2 flush (``chip_smoke.py``'s ``_kernel_ms``), on the PPO's first
operands at each number of envs a block, the sizes in turns (in order,
then in reverse): how much of a launch is a block's fixed cost and how
much its envs'.

``--against DIR`` (the root of another tree of the port, e.g. a ``git
archive`` of an earlier commit) measures that tree's package the same
way, in turns with this one's (this, other, other, this), each run a
process of its own with its tree's package first on the path.  The last
line is one JSON object with these numbers and the card's name.  A missing
card raises.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import inspect
import json
import os
import subprocess
import sys
import textwrap
import time
from typing import Dict, List, Optional, Sequence

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the step's statements by what they do: the first key that a statement's
# source holds names its range
# (None: no range)
_STATEMENTS = (("= carry", None), ("R.store(", "rollout.store"),
               ("R.act(", "rollout.act"), ("self.act(", "policy"),
               ("_policy_inputs", "policy inputs"), ("env.step(", "env.step"),
               ("reset_hidden", "recurrent reset"), ("gamma", "bootstrap"),
               ("_rec", "record row"), ("index_copy_", "stores"),
               ("t + 1", "t + 1"), ("return ", None),
               ("finished_episode_sums", "finished sums"),
               ("n_done", "finished sums"), ("nansum", "finished sums"))
# the port's own kernels by the range of their caller
_LAUNCHED_BY = (("rollout_act_kernel", "rollout.act"),
                ("rollout_store_kernel", "rollout.store"),
                ("task_", "env.step"), ("smooth_kernel", "env.step"),
                ("integrate_kernel", "env.step"), ("assemble_kernel",
                                                   "env.step"),
                ("pgs_", "env.step"), ("newton_kernel", "env.step"))
# the issue's parts, by a range's path
_PARTS = (("actor MLP", "actor MLP"), ("critic MLP", "critic MLP"),
          ("LSTM", "LSTMs"), ("draw", "the noise's draw"),
          ("sample_action", "sample + log-prob"),
          ("log_prob", "sample + log-prob"))


def _part(path: str) -> str:
    """The named part of a range's path."""
    if path.startswith("env.step"):
        return "env.step"
    leaf = path.split("/")[-1]
    for key, name in _PARTS:
        if key in leaf:
            return name
    return leaf or "(outside every range)"


def _statement_ranges(fn) -> Dict[int, str]:
    """Each source line of ``fn`` (unwrapped) → the range of the
    top-level statement it belongs to (``_STATEMENTS``)."""
    fn = inspect.unwrap(fn)
    lines, start = inspect.getsourcelines(fn)
    tree = ast.parse(textwrap.dedent("".join(lines)))
    body = tree.body[0].body
    src = textwrap.dedent("".join(lines)).splitlines()
    out = {}
    for node in body:
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
            continue  # the docstring
        text = "\n".join(src[node.lineno - 1:node.end_lineno])
        name = next((n for key, n in _STATEMENTS if key in text), None)
        if name is None:
            continue
        for ln in range(node.lineno, node.end_lineno + 1):
            out[start + ln - 1] = name
    return out


@contextlib.contextmanager
def statement_ranges(fn):
    """While the block runs, every call of ``fn`` opens a
    ``record_function`` range per top-level statement (the same range
    kept across a statement's lines)."""
    code = inspect.unwrap(fn).__code__
    names = _statement_ranges(fn)

    def tracer(frame, event, arg):
        if frame.f_code is not code:
            return None
        state = {"name": None, "rf": None}

        def close():
            if state["rf"] is not None:
                state["rf"].__exit__(None, None, None)
            state["name"] = state["rf"] = None

        def local(frame, event, arg):
            if event == "line":
                name = names.get(frame.f_lineno)
                if name != state["name"]:
                    close()
                    if name is not None:
                        state["rf"] = record_function(name)
                        state["rf"].__enter__()
                        state["name"] = name
            elif event in ("return", "exception"):
                close()
            return local

        return local

    prev = sys.gettrace()
    sys.settrace(tracer)
    try:
        yield
    finally:
        sys.settrace(prev)


def _wrap(fn, label: str):
    def wrapped(*args, **kw):
        with record_function(label):
            return fn(*args, **kw)
    return wrapped


@contextlib.contextmanager
def function_ranges(ppo):
    """The actor's and critic's MLPs (and the recurrent net's LSTMs), the
    noise's draw, ``sample_action`` and ``log_prob`` in ranges of their
    own while the block runs, where the tree has them."""
    from nightmare_rl_tpu_torch.models import actor_critic as ac
    from nightmare_rl_tpu_torch.parallel.shard import Shard

    mods = [(ppo.net.actor, "actor MLP"), (ppo.net.critic, "critic MLP")]
    for name in ("memory_a", "memory_c"):
        if hasattr(ppo.net, name):
            mods.append((getattr(ppo.net, name), f"{name} LSTM"))
    saved = [(Shard, "draw", Shard.draw)]
    saved += [(ac, n, getattr(ac, n)) for n in ("sample_action", "log_prob")]
    try:
        for m, label in mods:
            m.forward = _wrap(m.forward, label)
        Shard.draw = _wrap(Shard.draw, "draw")
        for _, n, fn in saved[1:]:
            setattr(ac, n, _wrap(fn, n))
        yield
    finally:
        for m, _ in mods:
            del m.forward
        for owner, n, fn in saved:
            setattr(owner, n, fn)


def _by_range(prof, labels: set) -> Dict[str, List[float]]:
    """Kernels and device µs by the innermost of ``labels`` whose call
    launched them, keyed by the ranges' nesting."""
    acc: Dict[str, List[float]] = {}

    def walk(evt, path):
        if evt.name in labels:
            path = f"{path}/{evt.name}" if path else evt.name
        for k in evt.kernels:
            a = acc.setdefault(path, [0, 0.0])
            a[0] += 1
            a[1] += k.duration
        for child in evt.cpu_children:
            walk(child, path)

    for evt in prof.events():
        if evt.cpu_parent is None:
            walk(evt, "")

    def path_of(evt):
        names = []
        while evt is not None:
            if evt.name in labels:
                names.append(evt.name)
            evt = evt.cpu_parent
        return "/".join(reversed(names))

    paths = {path_of(e) for e in prof.events()
             if e.name in labels and e.device_type == DeviceType.CPU}
    linked: Dict[str, int] = {}
    for evt in prof.events():
        for k in evt.kernels:
            linked[k.name] = linked.get(k.name, 0) + 1
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        if linked.get(evt.name, 0) > 0:
            linked[evt.name] -= 1
            continue
        label = next((lbl for key, lbl in _LAUNCHED_BY if key in evt.name),
                     None)
        if label is None:
            continue
        path = min((p for p in paths if p.endswith(label)), key=len,
                   default=label)
        a = acc.setdefault(path, [0, 0.0])
        a[0] += 1
        a[1] += evt.time_range.elapsed_us()
    return acc


def _ppo(robot: str, envs: int, dev):
    """The training slice's PPO: the robot's env at ``envs`` envs in
    float32, recording on, ``init(0)``, spread episode lengths."""
    from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
    from nightmare_rl_tpu_torch.core.config import PPOCfg
    from nightmare_rl_tpu_torch.rl.ppo import PPO

    if robot == "anymal_c":
        from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv
        env = AnymalCEnv(AnymalCCfg(num_envs=envs), device=dev)
    else:
        from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
        env = NightmareV3Env(NightmareV3Cfg().replace(
            env=EnvCfg(num_envs=envs)), device=dev, dtype=torch.float32)
    ppo = PPO(env, PPOCfg(), record_states=True)
    ppo.init(0)
    ppo.randomize_episode_lengths()
    return ppo


def _device_ms(run, steps: int) -> tuple:
    """Device busy ms and kernels (and copies) per step of ``run()``, a run
    of ``steps`` steps, by torch.profiler."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evts) / 1e3 / steps
    return busy, sum(e.count for e in evts) / steps


def measure(robot: str, envs: int, steps: int, by_module: bool) -> dict:
    """This process's tree, measured (see the module's docstring)."""
    from nightmare_rl_tpu_torch.rl.ppo import PPO
    from nightmare_rl_tpu_torch.utils.graph import CapturedStep, clone, leaves

    dev = torch.device("cuda")
    ppo = _ppo(robot, envs, dev)
    ppo._rollout_buffers(steps)
    box = {"carry": (ppo.env_state, ppo.obs, ppo.hidden)}

    def start():
        return (*box["carry"], *(z.clone() for z in ppo._zeros))

    out = {"device": torch.cuda.get_device_name(dev), "robot": robot,
           "envs": envs, "steps": steps,
           "tree": os.path.dirname(os.path.dirname(os.path.abspath(
               inspect.getfile(PPO))))}
    if by_module:
        bufs = clone(leaves(start()))

        def split_run():
            carry = start()
            with torch.no_grad(), statement_ranges(PPO._rollout_step), \
                    function_ranges(ppo):
                for _ in range(steps):
                    carry = ppo._rollout_step(carry)
                    with record_function("carry copies"):
                        for d, s in zip(bufs, leaves(carry)):
                            d.copy_(s)
            box["carry"] = carry[:3]

        split_run()  # lazy set-up (kernel builds) outside the profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            split_run()
            torch.cuda.synchronize()
        labels = ({n for _, n in _STATEMENTS if n} | {"carry copies", "draw",
                                                  "sample_action", "log_prob",
                                                  "actor MLP", "critic MLP",
                                                  "memory_a LSTM",
                                                  "memory_c LSTM"})
        rows = {p: {"kernels": n / steps, "device_ms": us / 1e3 / steps,
                    "part": _part(p)}
                for p, (n, us) in _by_range(prof, labels).items()}
        parts: Dict[str, dict] = {}
        for r in rows.values():
            a = parts.setdefault(r["part"], {"kernels": 0.0, "device_ms": 0.0})
            a["kernels"] += r["kernels"]
            a["device_ms"] += r["device_ms"]
        out.update(by_module=rows, parts=parts)
        return out

    gens = (ppo.generator, getattr(ppo.env, "generator", None))
    t0 = time.perf_counter()
    captured = CapturedStep(ppo._rollout_step, start(), generators=gens,
                            debug=True)
    out["capture_s"] = time.perf_counter() - t0

    def run(who: str) -> float:
        """A run of ``steps`` steps; returns the host's seconds per call."""
        carry, host = start(), 0.0
        with torch.no_grad():
            for _ in range(steps):
                h0 = time.perf_counter()
                carry = (ppo._rollout_step(carry) if who == "eager"
                         else captured(carry))
                host += time.perf_counter() - h0
        # the graph's state buffers, as PPO.rollout keeps them
        box["carry"] = carry[:3]
        return host / steps

    for who in ("eager", "graph"):
        run(who)
    res = {who: {"wall_ms": [], "host_ms_per_call": []}
           for who in ("eager", "graph")}
    for who in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        host = run(who)
        torch.cuda.synchronize()
        res[who]["wall_ms"].append((time.perf_counter() - w0) * 1e3 / steps)
        res[who]["host_ms_per_call"].append(host * 1e3)
    for who in ("eager", "graph"):
        busy, kernels = _device_ms(lambda: run(who), steps)
        wall = min(res[who]["wall_ms"])
        res[who].update(device_busy_ms=busy, kernels_per_step=kernels,
                        idle_share=max(0.0, 1.0 - busy / wall))
    out.update(res, graph_nodes=captured.node_counts(),
               pool_mib=captured.pool_bytes / 2**20,
               graph_launches=captured.launches)
    return out


def blocks(robot: str, envs: int, sizes: Sequence[int]) -> dict:
    """``act`` alone by envs a block (see the module's docstring)."""
    from nightmare_rl_tpu_torch.ops import rollout as R
    from nightmare_rl_tpu_torch.tools.profile_smooth import alone_us

    dev = torch.device("cuda")
    ppo = _ppo(robot, envs, dev)
    ppo._rollout_buffers(2)
    t = torch.zeros(1, dtype=torch.long, device=dev)
    us: Dict[int, List[float]] = {E: [] for E in sizes}
    with torch.no_grad():
        x_a, x_c, _ = ppo._policy_inputs(ppo.obs, ppo.hidden)
        eps = ppo._noise(envs)
        for order in (list(sizes), list(sizes)[::-1]):
            for E in order:
                us[E].append(alone_us(lambda E=E: R._run_act(
                    ppo.act_plan, ppo.obs, x_a, x_c, eps, ppo._traj, t,
                    host=False, envs_per_block=E)))
    name = torch.cuda.get_device_name(dev)
    print(f"profile-rollout: {name}, {robot} {envs} envs float32, act alone "
          f"(L2 flushed) by envs a block, in turns: " + "; ".join(
              f"{E}: {', '.join(f'{x:.2f}' for x in v)} us"
              for E, v in us.items()))
    return {"device": name, "robot": robot, "envs": envs, "act_us": us}


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
        raise RuntimeError(f"profile_rollout on {root} failed:\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _print(label: str, r: dict) -> None:
    if "parts" in r:
        total = [sum(p[k] for p in r["parts"].values())
                 for k in ("kernels", "device_ms")]
        print(f"profile-rollout: {r['device']}, {label} ({r['tree']}), "
              f"{r['robot']} {r['envs']} envs float32, eager rollout step by "
              f"part: {total[0]:.0f} kernels, {total[1]:.3f} device ms")
        for path, p in sorted(r["by_module"].items(),
                              key=lambda kv: -kv[1]["device_ms"]):
            print(f"  {p['kernels']:6.1f} kernels {p['device_ms']:8.4f} ms  "
                  f"{path or '(outside every range)'}  [{p['part']}]")
        return
    print(f"profile-rollout: {r['device']}, {label} ({r['tree']}), "
          f"{r['robot']} {r['envs']} envs float32, recording on, "
          f"{r['steps']} steps a run: "
          + "; ".join(
              f"{who} wall {', '.join(f'{x:.4f}' for x in r[who]['wall_ms'])} "
              f"ms a step, host {', '.join(f'{x:.4f}' for x in r[who]['host_ms_per_call'])} "
              f"ms a call, device busy {r[who]['device_busy_ms']:.4f} ms in "
              f"{r[who]['kernels_per_step']:.1f} kernels and copies "
              f"(idle {100 * r[who]['idle_share']:.1f}% of the faster wall)"
              for who in ("eager", "graph"))
          + f"; graph nodes {r['graph_nodes']}, pool {r['pool_mib']:.1f} "
          f"MiB, capture {r['capture_s']:.2f} s")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--envs", type=int, default=2048)
    p.add_argument("--steps", type=int, default=80)
    p.add_argument("--robot", default="nightmare_v3",
                   choices=["nightmare_v3", "anymal_c"])
    p.add_argument("--by-module", action="store_true")
    p.add_argument("--against", default=None)
    p.add_argument("--blocks", type=int, nargs="+", default=None,
                   help="time act alone at each number of envs a block")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_rollout measures the card: CUDA is not "
                           "available")
    os.environ.setdefault("NIGHTMARE_PGS", "legs")
    if args.blocks:
        r = blocks(args.robot, args.envs, args.blocks)
        print(json.dumps(r))
        return r
    sub = ["-e", str(args.envs), "--steps", str(args.steps), "--robot",
           args.robot] + (["--by-module"] if args.by_module else [])
    if args.worker:
        r = measure(args.robot, args.envs, args.steps, args.by_module)
        print(json.dumps(r))
        return r
    if args.against is None:
        runs = [("this", measure(args.robot, args.envs, args.steps,
                                 args.by_module))]
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
