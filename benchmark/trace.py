"""The traced stretch of a ``--trace 1`` run: a few iterations under
``torch.profiler`` after every capture, with the benchmark's own ranges
around the rollout (``bench.rollout``: the replays and env 0's record
copy) and the learning half (``bench.learn``); the rest of an iteration is
its boundary (the statistics' reductions and readback).  From the trace:
the seconds in which a kernel or a copy ran on the card, the device
operations that took most time, and the longest idle gaps labelled by what
the host was doing."""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGES = ("bench.rollout", "bench.learn")
TOP = 10


def traced(ppo, iterations: int) -> Dict[str, object]:
    """Runs ``iterations`` of ``ppo.learn_step()`` under the profiler and
    reduces the trace (``reduce``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    learner, rollout = ppo._learner, ppo.rollout

    def ranged_learner(*inputs):
        fn = learner(*inputs)

        def call(*args):
            with record_function("bench.learn"):
                return fn(*args)
        return call

    def ranged_rollout():
        with record_function("bench.rollout"):
            return rollout()

    ppo._learner, ppo.rollout = ranged_learner, ranged_rollout
    torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iterations):
                with record_function("bench.iteration"):
                    ppo.learn_step()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        del ppo._learner, ppo.rollout
        os.remove(path)
    return reduce(events)


def _merged(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce(events: List[dict]) -> Dict[str, object]:
    """busy_s, window_s, the device operations by time and the longest idle
    gaps of a chrome trace's events (times in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    iters = [e for e in xs if e.get("name") == "bench.iteration"
             and e.get("cat") == "user_annotation"]
    if not iters:
        return {}
    lo = min(e["ts"] for e in iters)
    hi = max(e["ts"] + e["dur"] for e in iters)
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    spans = _merged([(max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                     for e in dev if e["ts"] < hi and e["ts"] + e["dur"] > lo])
    busy = sum(b - a for a, b in spans)
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e["name"][:200]] += e["dur"] * 1e-6
    ranges = [e for e in xs if e.get("cat") == "user_annotation"
              and e.get("name") in RANGES]
    host = [e for e in xs if e.get("cat") in ("cpu_op", "cuda_runtime",
                                              "cuda_driver")]
    gaps = []
    edges = [(lo, lo)] + spans + [(hi, hi)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            gaps.append((b - a, a))
    gaps.sort(reverse=True)
    labelled = [[_label(t, ranges, host), d * 1e-6] for d, t in gaps[:TOP]]
    return dict(busy_s=busy * 1e-6, window_s=(hi - lo) * 1e-6,
                iterations=len(iters),
                device_ops=[[k, v] for k, v in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:TOP]],
                idle_gaps=labelled)


def _label(t: float, ranges: List[dict], host: List[dict]) -> str:
    """What the host was doing at time ``t``: the benchmark's range (else
    the iteration's boundary) and the innermost host operation."""
    def inside(e):
        return e["ts"] <= t < e["ts"] + e["dur"]

    rng = [e["name"][6:] for e in ranges if inside(e)]
    ops = [e for e in host if inside(e)]
    op = max(ops, key=lambda e: e["ts"])["name"] if ops else "python"
    return f"{rng[0] if rng else 'boundary'}: {op}"[:200]
