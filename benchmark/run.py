"""The benchmark of nightmare_rl_tpu_torch (the PyTorch and CUDA port):
PPO training throughput on the card, one cell of BENCHMARK.json a run.

    python3 benchmark/run.py --workload nv3-train-2048 --seed 7 \
        --seconds 30 --trace 0

Prints progress on standard error, the compared numbers beside their limits
as its last lines there, and one JSON line as the last line of standard
output.  Exits non-zero with no result where there is no card, where the
process loaded JAX or the JAX package, or where it wrote outside the
checkout, HOME, XDG_CACHE_HOME and TMPDIR.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the PGS form's probe keeps its verdict inside the checkout, beside the
# kernels the port builds there, so that a checkout's later runs reuse it
os.environ["NIGHTMARE_PROBE_CACHE"] = os.path.join(
    ROOT, "nightmare_rl_tpu_torch", "_build", "pgs_probe_torch.json")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from benchmark import harness

    def log(line: str) -> None:
        print(f"[{time.perf_counter() - T_START:8.2f} s] {line}",
              file=sys.stderr, flush=True)

    return harness.main(args, T_START, log)


if __name__ == "__main__":
    sys.exit(main())
