"""The readings that a cell's limits are set from, in one process: the
compared numbers (``check.NUMBERS``) of sound runs of the program on many
seeds, and on the first seeds those of the low-precision control (the
reference computed with TF32, in the program's place) and of a planted
fault (half of the batch left out).  Training needs no measured window:
each seed runs the cell's set-up and its warm-up iterations.

    python3 benchmark/readings.py --workload nv3-train-2048 \
        --seeds 11 12 13 --control 3 --out readings.jsonl

One JSON line a seed on standard output and in ``--out``.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["NIGHTMARE_PROBE_CACHE"] = os.path.join(
    ROOT, "nightmare_rl_tpu_torch", "_build", "pgs_probe_torch.json")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3,
                   help="seeds (the first ones) that also read the control "
                        "and the planted fault")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from benchmark import guard, harness

    _, workload, config = harness.cell(args.workload)
    if args.device == "cuda":
        guard.cards(1)
    N = workload["num_envs"]
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        su = harness.set_up(args.workload, config, workload, seed,
                            args.device, harness.stderr)
        su.recorder.release()
        su.learn.release()
        su = su._replace(env=None, ppo=None, step=None)
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
        ref = harness.reference(su, config, N, seed, args.device)
        line = dict(workload=args.workload, seed=seed,
                    program=harness.compare(su, config, N, ref),
                    learn=dict(program_lr=su.learn.lrs,
                               rule_lr=ref["learn"]["rule_lr"],
                               kl=[r[3] for r in ref["learn"]["rows"]],
                               program_kl=[r[3] for r in su.learn.rows]))
        if i < args.control:
            for kind in ("control", "half"):
                side = harness.reference(su, config, N, seed, args.device,
                                         **{kind: True})
                line[kind] = harness.compare(su, config, N, ref, side)
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    if guard.forbidden_modules():
        print(f"loaded {guard.forbidden_modules()}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
