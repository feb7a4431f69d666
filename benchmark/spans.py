"""The card's idle time in a profiled stretch of PPO iterations, split by
the program's own spans and counters (``nightmare_rl_tpu_torch/utils/
trace.py``).  It reads the directory that ``tools/train.py --profile DIR``
writes: the profiler's chrome trace of iterations 2-4 (``trace.json``) and
the port's spans and counters of the same iterations (``spans.json``)::

    python -m nightmare_rl_tpu_torch.tools.train -e 2048 -n 5 --profile DIR
    python -m benchmark.spans DIR

The stretch runs from its first ``ppo.iteration`` to its last one's end;
the card is idle where neither a kernel, a copy nor a memset runs.  That
idle time is split: while ``ppo.rollout`` was open, while ``ppo.learn`` was
open, in the rest of ``ppo.iteration`` (``ppo.stats`` and learn_step's
head), and outside every ``ppo.iteration`` (the caller's share).  The four
parts tile the stretch, so they sum to its idle time."""

from __future__ import annotations

import json
import os
import sys
from typing import List, Optional, Tuple

from benchmark.trace import DEVICE_CATS, _merged

Intervals = List[Tuple[float, float]]


def _length(a: Intervals) -> float:
    return sum(y - x for x, y in a)


def _overlap(a: Intervals, b: Intervals) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _minus(a: Intervals, b: Intervals) -> Intervals:
    """The sorted disjoint intervals of ``a`` less those of ``b``."""
    out: Intervals = []
    for x, y in a:
        for u, v in b:
            if v <= x or u >= y:
                continue
            if u > x:
                out.append((x, u))
            x = max(x, v)
            if x >= y:
                break
        if x < y:
            out.append((x, y))
    return out


def _idle(part: Intervals, busy: Intervals) -> float:
    return _length(part) - _overlap(part, busy)


def reduce(events: List[dict], base_ns: int,
           rec: Optional[dict]) -> Optional[dict]:
    """A chrome trace's events (``ts`` microseconds after ``base_ns``) and
    the program's recording of the same iterations → the idle
    milliseconds in the stretch by the spans (totals and an iteration's),
    the host syncs and captures counted, and the trace's own synchronize
    calls; None without a recording or an iteration."""
    if not rec:
        return None
    shift = rec.get("offset_ns", 0) - base_ns

    def spans(name: str) -> Intervals:
        return _merged([((s["start"] + shift) * 1e-3, (s["end"] + shift) * 1e-3)
                        for s in rec["spans"]
                        if s["name"] == name and s["end"] is not None])

    iters = spans("ppo.iteration")
    n = sum(1 for s in rec["spans"]
            if s["name"] == "ppo.iteration" and s["end"] is not None)
    if not n:
        return None
    lo, hi = iters[0][0], iters[-1][1]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    busy = _merged([(max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                    for e in xs if e.get("cat") in DEVICE_CATS
                    and e["ts"] < hi and e["ts"] + e["dur"] > lo])
    rollout, learn = spans("ppo.rollout"), spans("ppo.learn")
    ms = {"rollout": _idle(rollout, busy) * 1e-3,
          "learn": _idle(learn, busy) * 1e-3,
          "stats": _idle(_minus(iters, _merged(rollout + learn)), busy) * 1e-3,
          "outside": _idle(_minus([(lo, hi)], iters), busy) * 1e-3}
    idle = _idle([(lo, hi)], busy) * 1e-3
    syncs = sum(1 for e in xs if e.get("cat") == "cuda_runtime"
                and "Synchronize" in e.get("name", "")
                and lo <= e["ts"] < hi)
    counters = rec.get("counters", {})
    return dict(
        iterations=n, window_ms=(hi - lo) * 1e-3, idle_ms=idle,
        **{f"{k}_idle_ms": v / n for k, v in ms.items()},
        sum_ms=sum(ms.values()),
        host_syncs=counters.get("host.syncs", 0),
        captures=counters.get("graph.captures", 0),
        trace_syncs=syncs, offset_ns=rec.get("offset_ns", 0))


def read(directory: str) -> Optional[dict]:
    """``reduce`` of a profile directory's ``trace.json`` and
    ``spans.json``."""
    with open(os.path.join(directory, "trace.json")) as fh:
        chrome = json.load(fh)
    with open(os.path.join(directory, "spans.json")) as fh:
        rec = json.load(fh)
    return reduce(chrome["traceEvents"], chrome.get("baseTimeNanoseconds", 0),
                  rec)


def main(argv: List[str]) -> int:
    """Prints ``read``'s numbers as JSON, then as two lines of text with
    the sum check: the four parts against the stretch's own idle time,
    within 2 %."""
    if len(argv) != 1:
        print("usage: python -m benchmark.spans PROFILE_DIR", file=sys.stderr)
        return 2
    st = read(argv[0])
    if st is None:
        print("no ppo.iteration span in the recording", file=sys.stderr)
        return 1
    n = st["iterations"]
    share = st["sum_ms"] / st["idle_ms"] - 1 if st["idle_ms"] else 0.0
    print(json.dumps(st))
    print(f"program spans, {n} iterations in {st['window_ms']:.3f} ms: "
          f"idle ms an iteration, rollout {st['rollout_idle_ms']:.4f}, "
          f"learn {st['learn_idle_ms']:.4f}, stats and head "
          f"{st['stats_idle_ms']:.4f}, outside the program (the caller) "
          f"{st['outside_idle_ms']:.4f}; in all {st['sum_ms']:.4f} ms "
          f"against the stretch's own idle {st['idle_ms']:.4f} ms "
          f"({share * 100:+.3f} %: "
          f"{'holds' if abs(share) <= 0.02 else 'FAILS'} within 2 %)")
    print(f"program counters: host syncs {st['host_syncs'] / n:g} an "
          f"iteration (the trace's synchronize calls "
          f"{st['trace_syncs'] / n:g}), captures in the stretch "
          f"{st['captures']}; the spans' clock against the trace's: "
          f"offset {st['offset_ns'] * 1e-3:.3f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
