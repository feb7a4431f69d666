"""Window means of learning curves written by compare_reference_curve, side
by side, and whether the port's curves lie within the seed spread of the
JAX package's.

    python -m nightmare_rl_tpu_torch.tools.curve_windows \
        [--root logs/curvecmp ...] [--port torch] [--jax tpu]

Reads ``<root>/<side>_s<seed>/metrics.jsonl`` for every side under every
root (``ref``: the reference env; ``tpu``: the JAX package's env;
``torch``: the port's).
Episodic ``rew_*`` metrics appear only on iterations where envs reset; they
are carried forward (each value is the latest finished-episode snapshot).
Each metric's iterations are cut into four windows.  For each window the
table gives every run's mean, then the port-vs-JAX gap (difference of the
two sides' seed means), the pooled seed spread of those two sides (the
standard deviation of the runs about their side's mean, times √2, as
scripts/analyze_curve_compare.py pools it) and whether each port run's mean
lies within the range of the JAX runs' means.  The verdict reads the last
two windows (iterations 50-100 of 100): a metric is within the seed spread
where gap / spread ≤ 2 in both, the rule of scripts/analyze_curve_compare.py.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np

METRICS = ("mean_reward,rew_tracking_lin_vel,rew_tracking_ang_vel,"
           "rew_orientation,rew_dof_acc,rew_action_rate,rew_default_position,"
           "rew_body_contact_forces,rew_termination,mean_noise_std,kl")
RATIO_OK = 2.0


def load(roots: Sequence[str]) -> dict:
    """side -> seed -> {metric: (iterations,) array, forward-filled}."""
    runs: dict = defaultdict(dict)
    paths = sorted(p for root in roots
                   for p in glob.glob(os.path.join(root, "*_s*", "metrics.jsonl")))
    for path in paths:
        side, seed = os.path.basename(os.path.dirname(path)).rsplit("_s", 1)
        with open(path) as fh:
            rows = [json.loads(ln) for ln in fh if ln.strip()]
        keys = set().union(*(r.keys() for r in rows))
        series = {}
        for k in keys:
            arr = np.full(len(rows), np.nan)
            last = np.nan
            for i, r in enumerate(rows):
                last = r.get(k, last)
                arr[i] = last
            series[k] = arr
        runs[side][int(seed)] = series
    return runs


def window_mean(arr: np.ndarray, lo: int, hi: int) -> float:
    w = arr[lo:hi]
    return float(np.nanmean(w)) if np.isfinite(w).any() else float("nan")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Prints the tables and verdict; returns {metric: worst ratio over the
    last two windows}."""
    p = argparse.ArgumentParser()
    p.add_argument("--root", action="append",
                   help="a directory of <side>_s<seed> runs (repeatable; "
                        "default logs/curvecmp)")
    p.add_argument("--port", default="torch", help="the port's side")
    p.add_argument("--jax", default="tpu", help="the JAX package's side")
    p.add_argument("--metrics", default=METRICS)
    args = p.parse_args(argv)

    roots = args.root or ["logs/curvecmp"]
    runs = load(roots)
    for side in (args.port, args.jax):
        if side not in runs:
            raise SystemExit(f"no {side}_s* runs under {roots}")
    sides = sorted(runs, key=lambda s: (s not in ("ref", args.jax), s))
    n_iter = min(len(s["iter"]) for side in sides for s in runs[side].values())
    q = n_iter // 4
    windows = [(0, q), (q, 2 * q), (2 * q, 3 * q), (3 * q, n_iter)]
    cols = [(side, seed) for side in sides for seed in sorted(runs[side])]
    print("runs: " + ", ".join(f"{side} seeds {sorted(runs[side])}"
                               for side in sides))
    print(f"iterations compared: {n_iter}\n")

    verdict = {}
    for metric in args.metrics.split(","):
        if not all(metric in runs[s][seed] for s, seed in cols):
            continue
        print(f"== {metric} (window means) ==")
        print("window   " + " ".join(f"{s + '_s' + str(seed):>10}"
                                     for s, seed in cols)
              + f" {'gap':>9} {'seed_sd':>9}  {args.port} in {args.jax} range")
        worst = 0.0
        for wi, (lo, hi) in enumerate(windows):
            vals = {s: [window_mean(runs[s][seed][metric], lo, hi)
                        for seed in sorted(runs[s])] for s in sides}
            port, jax_ = np.asarray(vals[args.port]), np.asarray(vals[args.jax])
            gap = abs(port.mean() - jax_.mean())
            spread = np.std(np.concatenate([port - port.mean(),
                                            jax_ - jax_.mean()]),
                            ddof=1) * np.sqrt(2.0)
            ratio = (gap / spread if spread > 0
                     else 0.0 if gap == 0 else float("inf"))
            if wi >= 2:
                worst = max(worst, ratio)
            inside = ["yes" if jax_.min() <= v <= jax_.max() else "no"
                      for v in port]
            cells = " ".join(f"{v:>10.4f}" for s in sides for v in vals[s])
            print(f"{lo:3d}-{hi:3d}  {cells} {gap:>9.4f} {spread:>9.4f}  "
                  + "/".join(inside))
        verdict[metric] = worst
        print()

    print(f"== verdict, iterations {2 * q}-{n_iter}: {args.port} vs "
          f"{args.jax}, gap / seed spread ==")
    for metric, ratio in verdict.items():
        flag = "within" if ratio <= RATIO_OK else "OUTSIDE"
        print(f"  {metric:28s} worst-window ratio {ratio:6.2f}  [{flag}]")
    return verdict


if __name__ == "__main__":
    main()
