"""Where the time of the training path goes on the card: the env step,
eager and as the replay of a CUDA graph.

    python -m nightmare_rl_tpu_torch.tools.profile_step [-e 2048] [--steps 4]
        [--robot nightmare_v3|anymal_c] [--forms legs kernel] [--by-module]

For the robot's env at ``-e`` envs in float32 (the training CLI's
configuration), with the PGS form that the solver's dispatch picks
(``NIGHTMARE_PGS=legs|kernel`` forces one; unset, the probe's verdict; with
``--forms`` each named form in turn, in this one process), it measures the
plain ``env.step`` ("eager") and the same step captured once as a CUDA
graph and replayed (``utils/graph.py``, "graph") in turns (eager, graph,
graph, eager), because the host's time per launch varies between and
within calls:

- the wall time of one env step (host clock around synchronized steps) in
  each turn;
- with ``torch.profiler``: the device time inside those steps, hence the
  device's busy share (of the faster turn's wall time), the number of
  kernels one step and one physics substep run, the kernels that take the
  most device time, the PGS kernels' time (nightmare_v3), the Newton
  kernel's (``ops/csrc/newton.cu``, anymal_c's constraint solve) and the
  smooth, integrate and assemble kernels' (``ops/csrc/smooth.cu``,
  ``ops/csrc/integrate.cu``, ``ops/csrc/assemble.cu``) and the task
  kernels' (``ops/csrc/task.cu``: ``task_pre``, ``task_post``), each with
  its launches and its share of the step's device time;
- the host synchronizations that one step makes
  (``torch.cuda.set_sync_debug_mode``);
- the peak device memory of one step (``torch.cuda.max_memory_allocated``
  from a reset of the peak) and the graph's private pool (the memory its
  capture reserved);
- the wall time of one policy forward pass on the step's observations;
- the captured graph's nodes by type (``CapturedStep.node_counts``, from
  the graph's DOT dump): its kernel nodes are the kernels one replay
  launches, beside the profiler's count of the replays' kernels.

Both robots' steps are captured (anymal_c's since its Newton step makes no
host synchronization); an env without ``graph_step`` is measured eagerly
only.  ``capture_s`` is the capture and the graph's instantiation,
``warmup_s`` the eager warm-up step before it.  The last line is one JSON
object with these numbers (per form: ``eager`` and ``graph``,
``graph_nodes``, ``graph_pool_bytes``, ``capture_s``; with
``--forms``, a list ``forms`` of these objects) and the card's name: the
per-layer breakdown that PERF.md's "Where the time goes" quotes.  A missing
card raises.

``--by-module`` instead profiles ``--steps`` eager env steps with each
physics function that a step reaches wrapped, from this tool, in a
``torch.profiler.record_function`` range (the physics code is not edited; a
function the checkout lacks is left out, so the tool runs on earlier
versions of the port too) and gives each kernel to the innermost range
whose call launched it: per range, kernels and device ms per env step, the
ranges named by their nesting
(``pipeline.step/pipeline.forward/kinematics.kinematics``; the port's own
kernels, which the profiler links to no op, go to the range of the wrapper
that launches them); kernels outside every range are the env's own. Its
last line is one JSON object ``{"by_module": {path: {"kernels": n,
"device_ms": t, "ops": {op: {"kernels": n, "device_ms": t}}}}, ...}``,
where ``ops`` splits a range by the op that launched each kernel and the
kernel's name (the port's own kernels by name alone), so that a range's
pieces (a product, an add, each scatter) read apart.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import json
import os
import time
import warnings
from typing import Dict, Optional, Sequence

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.models.actor_critic import ActorCritic
from nightmare_rl_tpu_torch.ops import pgs as P
from nightmare_rl_tpu_torch.utils.device import resolve_device
from nightmare_rl_tpu_torch.utils.graph import CapturedStep


def _timed(fn, steps: int) -> float:
    """Milliseconds per call of fn, host clock, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def host_syncs(fn) -> int:
    """The host synchronizations that fn() makes, as counted by
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def _profiled(step, steps: int, substeps: int) -> dict:
    """Device time, kernels, PGS and Newton kernel time per env step of
    ``step``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    pgs_ms = sum(e.self_device_time_total for e in kernels
                 if "pgs_kernel" in e.key or "pgs_legs_kernel" in e.key
                 ) / 1e3 / steps
    out = {"device_busy_ms": device_ms, "kernels_per_step": launches,
           "kernels_per_substep": launches / substeps, "pgs_ms": pgs_ms}
    for name in ("newton", "smooth", "integrate", "assemble", "task_pre",
                 "task_post"):
        mine = [e for e in kernels if f"{name}_kernel" in e.key]
        ms = sum(e.self_device_time_total for e in mine) / 1e3 / steps
        out.update({f"{name}_ms": ms,
                    f"{name}_launches_per_step":
                        sum(e.count for e in mine) / steps,
                    f"{name}_share": ms / device_ms if device_ms else 0.0})
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {**out,
            "top_kernels": [
                {"device_ms_per_step": e.self_device_time_total / 1e3 / steps,
                 "launches_per_step": e.count / steps, "name": e.key}
                for e in top]}


def _measure(env, net, box, dev, steps: int, substeps: int) -> dict:
    """One PGS form's numbers, eager and graph: the env step's wall time in
    turns, its profiled device time and kernels, host syncs and peak
    memory, the graph's pool, the PGS form that ran, the policy forward."""
    g = torch.Generator(device=dev).manual_seed(0)

    def actions():
        return 0.5 * torch.randn(env.num_envs, env.num_actions, generator=g,
                                 device=dev)

    def eager():
        out = env.step(box["state"], actions())
        box["state"], box["obs"] = out.state, out.obs

    runs = {"eager": eager}
    if getattr(env, "graph_step", False):
        t0 = time.perf_counter()
        captured = CapturedStep(env.step, box["state"], actions(),
                                generators=[env.generator], state_field="state",
                                debug=True)
        capture_s = time.perf_counter() - t0

        def graph():
            out = captured(box["state"], actions())
            box["state"], box["obs"] = out.state, out.obs

        runs["graph"] = graph

    def policy():
        with torch.no_grad():
            net(box["obs"])

    for fn in runs.values():
        for _ in range(3):
            fn()
    res = {who: {"env_step_ms": []} for who in runs}
    for who in ("eager", "graph", "graph", "eager"):
        if who in runs:
            res[who]["env_step_ms"].append(_timed(runs[who], steps))
    launches0 = P.pgs.launches, P.pgs_legs.launches
    for who, fn in runs.items():
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize()
        res[who]["peak_mem_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
        res[who]["host_syncs_per_step"] = host_syncs(fn)
        res[who].update(_profiled(fn, steps, substeps))
        res[who]["device_busy_share"] = (res[who]["device_busy_ms"]
                                         / min(res[who]["env_step_ms"]))
    dense, legs = (n - n0 for n, n0 in zip((P.pgs.launches, P.pgs_legs.launches),
                                           launches0))
    form = "legs" if legs else "kernel" if dense else "newton"
    policy_ms = _timed(policy, 20)
    name = torch.cuda.get_device_name(dev)
    for who, r in res.items():
        print(f"profile: {name}, {env.num_envs} envs float32, PGS form {form}, "
              f"{who}: env step {', '.join(f'{x:.3f}' for x in r['env_step_ms'])} "
              f"ms wall; device busy {r['device_busy_ms']:.3f} ms "
              f"({100 * r['device_busy_share']:.1f}% of the faster turn) in "
              f"{r['kernels_per_step']:.0f} kernels "
              f"({r['kernels_per_substep']:.0f} per substep); pgs kernel "
              f"{r['pgs_ms']:.3f} ms; "
              + "; ".join(f"{k} kernel {r[k + '_ms']:.3f} ms in "
                          f"{r[k + '_launches_per_step']:.0f} launches "
                          f"({100 * r[k + '_share']:.1f}% of the device time)"
                          for k in ("newton", "smooth", "integrate",
                                    "assemble", "task_pre", "task_post"))
              + "; host syncs per step "
              f"{r['host_syncs_per_step']}; peak device memory "
              f"{r['peak_mem_mib']:.1f} MiB")
        for e in r["top_kernels"]:
            print(f"  {e['device_ms_per_step']:8.3f} ms  "
                  f"{e['launches_per_step']:6.0f}x  {e['name'][:90]}")
    out = {"pgs_form": form, "policy_ms": policy_ms, **res}
    if "graph" in runs:
        nodes = captured.node_counts()
        print(f"profile: the captured graph holds {nodes.get('KERNEL', 0)} "
              f"kernel nodes ({sum(nodes.values())} nodes: {nodes}); the "
              f"profiler counted {res['graph']['kernels_per_step']:.0f} "
              f"kernels per replayed step")
        out.update(graph_nodes=nodes, graph_pool_bytes=captured.pool_bytes,
                   capture_s=captured.capture_s, record_s=captured.record_s,
                   warmup_s=captured.warmup_s,
                   construct_s=capture_s, graph_launches=captured.launches)
        print(f"profile: graph pool {captured.pool_bytes / 2**20:.1f} MiB, "
              f"warm-up step {captured.warmup_s:.2f} s, capture and "
              f"instantiation {captured.capture_s:.2f} s (recording "
              f"{captured.record_s:.2f} s; {capture_s:.2f} s in all)")
    print(f"profile: policy forward {policy_ms:.3f} ms")
    return out


# the functions of one env step that --by-module wraps, by module of the
# port; a function that a checkout lacks is skipped
_MODULES = (
    ("physics.kinematics", ("kinematics", "com_vel")),
    ("physics.dynamics", ("crb", "rne_bias", "actuation", "passive")),
    ("physics.arrow", ("factor", "solve_vec", "solve_lt", "inv")),
    ("physics.collision", ("find_contacts", "find_pair_contacts")),
    ("physics.solver", ("solve_contacts", "solve_rows", "assemble",
                        "_legmeta", "solve", "minv", "newton_solve")),
    ("physics.pipeline", ("step", "forward", "_integrate_pos")),
    ("ops.smooth", ("smooth_forward",)),
    ("ops.integrate", ("integrate_update",)),
    ("ops.assemble", ("rows",)),
    ("ops.task", ("pre", "post")),
    ("ops.solve_out", ("outputs",)),
)


# the ranges of the wrappers that launch the port's own kernels
_LAUNCHED_BY = (("smooth_kernel", "smooth.smooth_forward"),
                ("integrate_kernel", "integrate.integrate_update"),
                ("assemble_kernel", "assemble.rows"),
                ("task_pre_kernel", "task.pre"),
                ("task_post_kernel", "task.post"),
                ("solve_out_kernel", "solve_out.outputs"),
                ("pgs_legs_kernel", "solver.solve"),
                ("pgs_kernel", "solver.solve"),
                ("newton_kernel", "solver.newton_solve"))


@contextlib.contextmanager
def module_ranges():
    """Each function of ``_MODULES`` wrapped in a ``record_function`` range
    named ``module.function`` while the block runs."""
    saved = []
    for modname, names in _MODULES:
        try:
            mod = importlib.import_module(f"nightmare_rl_tpu_torch.{modname}")
        except ImportError:
            continue
        for name in names:
            fn = getattr(mod, name, None)
            if fn is None:
                continue
            label = f"{modname.split('.')[-1]}.{name}"

            @functools.wraps(fn, updated=())
            def wrapped(*args, _fn=fn, _label=label, **kw):
                with record_function(_label):
                    return _fn(*args, **kw)

            saved.append((mod, name, fn))
            setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def by_module(step, steps: int) -> Dict[str, dict]:
    """Kernels and device ms per call of ``step`` by the innermost
    ``module_ranges`` range that launched them, keyed by the ranges'
    nesting ("" for kernels outside every range)."""
    step()
    with module_ranges():
        step()  # wrappers in place before the profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    labels = {f"{m.split('.')[-1]}.{n}" for m, ns in _MODULES for n in ns}
    acc: Dict[str, list] = {}
    ops: Dict[str, Dict[str, list]] = {}

    def add(path, op, us):
        for a in (acc.setdefault(path, [0, 0.0]),
                  ops.setdefault(path, {}).setdefault(op, [0, 0.0])):
            a[0] += 1
            a[1] += us

    def short(name):
        """A kernel's name without its templates, arguments and return
        type."""
        kept, depth = [], 0
        for ch in name.replace("(anonymous namespace)::", ""):
            depth += (ch == "<") - (ch == ">")
            if depth == 0 and ch not in "<>":
                kept.append(ch)
        head = "".join(kept).split("(")[0].strip()
        last = head.split()[-1] if head else head
        return last if "::" in last or "kernel" in last else head

    def walk(evt, path):
        if evt.name in labels:
            path = f"{path}/{evt.name}" if path else evt.name
        op = evt
        while op.name.startswith("cuda") and op.cpu_parent is not None:
            op = op.cpu_parent  # a runtime call: the op that made it
        for k in evt.kernels:
            add(path, f"{op.name} {short(k.name)}", k.duration)
        for child in evt.cpu_children:
            walk(child, path)

    for evt in prof.events():
        if evt.cpu_parent is None:
            walk(evt, "")
    # the port's own kernels launch through ctypes, which the profiler
    # links to no op: each goes to the range of the wrapper that launches it
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
        if label is None:  # a device activity that is no kernel of the step
            continue
        path = min((p for p in paths if p.endswith(label)), key=len,
                   default=label)
        add(path, short(evt.name), evt.time_range.elapsed_us())

    def per_step(n, us):
        return {"kernels": n / steps, "device_ms": us / 1e3 / steps}

    return {path: dict(per_step(n, us), ops={
        op: per_step(*v) for op, v in sorted(ops[path].items(),
                                             key=lambda kv: -kv[1][1])})
        for path, (n, us) in sorted(acc.items(), key=lambda kv: -kv[1][1])}


def _by_module_main(env, dev, steps: int) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    box = {"state": env.reset(0)[0]}

    def eager():
        acts = 0.5 * torch.randn(env.num_envs, env.num_actions, generator=g,
                                 device=dev)
        box["state"] = env.step(box["state"], acts).state

    rows = by_module(eager, steps)
    name = torch.cuda.get_device_name(dev)
    total = [sum(r[k] for r in rows.values()) for k in ("kernels", "device_ms")]
    print(f"by-module: {name}, {env.num_envs} envs float32, eager env step: "
          f"{total[0]:.0f} kernels, {total[1]:.3f} ms of device time")
    for path, r in rows.items():
        print(f"  {r['kernels']:7.0f} kernels {r['device_ms']:8.3f} ms  "
              f"{path or '(the env outside the physics)'}")
        for op, o in r["ops"].items():
            print(f"      {o['kernels']:5.0f} {o['device_ms']:8.4f} ms  {op}")
    return {"by_module": rows, "kernels": total[0], "device_ms": total[1]}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--envs", type=int, default=2048)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--robot", type=str, default="nightmare_v3",
                   choices=["nightmare_v3", "anymal_c"])
    p.add_argument("--forms", nargs="+", choices=("legs", "kernel"),
                   help="measure each PGS form in turn in this process "
                        "(NIGHTMARE_PGS set for each)")
    p.add_argument("--by-module", action="store_true",
                   help="kernels and device ms of an eager env step by "
                        "physics function")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")

    if args.robot == "anymal_c":
        env = AnymalCEnv(AnymalCCfg(num_envs=args.envs), device=dev)
        substeps = env.cfg.decimation
    else:
        env = NightmareV3Env(NightmareV3Cfg().replace(
            env=EnvCfg(num_envs=args.envs)), device=dev)
        substeps = env.cfg.control.decimation
    if args.by_module:
        result = {"device": torch.cuda.get_device_name(dev),
                  "robot": args.robot, "envs": args.envs,
                  **_by_module_main(env, dev, args.steps)}
        print(json.dumps(result))
        return result
    net = ActorCritic(env.num_obs, env.num_actions).to(dev)
    box = {}
    box["state"], box["obs"] = env.reset(0)

    result = {"device": torch.cuda.get_device_name(dev), "robot": args.robot,
              "envs": args.envs}
    if args.forms:
        prev = os.environ.get("NIGHTMARE_PGS")
        try:
            result["forms"] = []
            for form in args.forms:
                os.environ["NIGHTMARE_PGS"] = form
                result["forms"].append(_measure(env, net, box, dev, args.steps,
                                                substeps))
        finally:
            os.environ.pop("NIGHTMARE_PGS")
            if prev is not None:
                os.environ["NIGHTMARE_PGS"] = prev
    else:
        result.update(_measure(env, net, box, dev, args.steps, substeps))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
