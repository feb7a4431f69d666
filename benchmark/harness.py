"""One cell of the port's benchmark: PPO training of
``nightmare_rl_tpu_torch`` as ``tools/train.py`` runs it.

A cell (``workloads/<name>.json``) names a configuration
(``configs/<name>.json``), its number of envs, the warm-up iterations, the
rollout steps a warm-up iteration has checked and the limits of the
compared numbers.  ``run_cell``:

1. set-up: builds the env and ``PPO`` from the configuration (the kernels
   build into the port's ``_build/`` on a checkout's first run), draws the
   weights and env state from the seed (``PPO.init``,
   ``randomize_episode_lengths``), captures the rollout step, and runs the
   warm-up iterations through ``PPO.learn_step()``, the window's own call,
   keeping what the reference will follow (``check.py``);
2. the window: ``learn_step()`` back to back, as ``OnPolicyRunner._learn``
   calls it (its file writes left out), until ``seconds`` have passed, at an
   iteration's end;
3. with ``trace``, a few more iterations under the profiler
   (``trace.py``);
4. the device's peak memory is read, the program freed, and the plain
   reference follows the warm-up iterations (``check.py``);
5. the cell's metrics are read by their readers (``metrics/<name>.py``):
   its end-to-end metrics, or with ``trace`` its per-layer ones.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional

from benchmark import check

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
TRACE_ITERATIONS = 3


def load(*parts: str) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def spec() -> dict:
    return load(ROOT, "BENCHMARK.json")


def cell(name: str):
    """(the cell's BENCHMARK.json entry, its workload file, its
    configuration file)."""
    entries = {w["name"]: w for w in spec()["workloads"]}
    if name not in entries:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    workload = load(BENCH, "workloads", name + ".json")
    return entries[name], workload, load(BENCH, "configs",
                                         workload["config"] + ".json")


def cell_metrics(name: str, trace: bool) -> List[dict]:
    """The metrics that this cell reports: its end-to-end ones, or with
    ``trace`` its per-layer ones (an entry's ``workloads`` limits it)."""
    s = spec()
    return [m for m in s["per_layer" if trace else "end_to_end"]
            if name in m.get("workloads", [name])]


class Iteration(NamedTuple):
    wall_s: float
    rollout_s: float
    update_s: float


class Run(NamedTuple):
    """What a metric reader reads (``metrics/<name>.py``)."""
    iters: List[Iteration]
    window_s: float
    setup_s: float
    steps_per_iter: int
    sizes: dict
    trace: Optional[dict]


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Setup(NamedTuple):
    """The program after set-up, and what the reference will follow."""
    env: object
    ppo: object
    step: object
    recorder: check.Recorder
    start: dict
    params: list
    iters: list
    learn: check.StepRecorder


def set_up(name: str, config: dict, workload: dict, seed: int, device,
           log: Callable[[str], None]) -> Setup:
    """Builds the program, draws its weights and env state from the seed,
    captures the rollout step and runs the warm-up iterations through
    ``learn_step``, keeping what the reference follows."""
    from benchmark import program

    N = workload["num_envs"]
    env, ppo = program.build(config, N, seed, device)
    log(f"{name}: {config['name']} at {N} envs, seed {seed}; the solve's "
        f"form: {program.pgs_form(env)}")
    ppo.init(seed)
    ppo.randomize_episode_lengths()
    start = dict(params=check.host(ppo.params),
                 state=check.host(ppo.env_state), obs=check.host(ppo.obs)[0])

    T = ppo.cfg.runner.num_steps_per_env
    W = workload["warmup_iterations"]
    step = ppo._rollout_stepper(T)
    recorder = check.Recorder(step, ppo, env, check.sample_steps(
        seed, W, T, workload["checked_steps"]))
    ppo._stepper = recorder
    params, iters = [], []
    launches = {}
    for k in range(W):
        params.append(check.host(ppo.params))
        if k == W - 1:
            launches = program.counted_launches()
        if k == 0:
            with program.recording_learner(ppo, check.StepRecorder) as learn:
                stats = ppo.learn_step()
        else:
            stats = ppo.learn_step()
        iters.append(check.program_iteration(ppo, stats))
    ppo._stepper = step
    after = program.counted_launches()
    per_iter = {k: after[k] - launches[k] for k in after
                if after[k] != launches[k]}
    log(f"kernel launches an iteration (the rollout's {T} replays and the "
        f"learning half): {per_iter}; the solve's launches a replay: "
        f"pgs_legs {per_iter.get('pgs_legs', 0) / T}, pgs "
        f"{per_iter.get('pgs', 0) / T}, newton_solve "
        f"{per_iter.get('newton_solve', 0) / T}")
    return Setup(env, ppo, step, recorder, start, params, iters, learn)


def reference(su: Setup, config: dict, N: int, seed: int, device,
              control: bool = False, half: bool = False) -> dict:
    """The reference's outputs for the program's warm-up
    (``check.reference_outputs``); with ``control`` or ``half``, those of
    the reference computed with TF32 or with half of the batch left out,
    to stand in the program's place."""
    return check.reference_outputs(config, N, seed, su.recorder, su.iters,
                                   su.params, su.learn.lrs, device,
                                   control=control, half=half)


def compare(su: Setup, config: dict, N: int, ref: dict,
            side: Optional[dict] = None) -> Dict[str, float]:
    """The compared numbers of the program's warm-up, or of ``side`` in
    its place, against the reference's outputs ``ref``."""
    if side is None:
        side = check.program_outputs(su.start, su.recorder, su.iters,
                                     su.learn)
    return check.numbers(side, ref, N, config["ppo"]["algorithm"])


def run_cell(name: str, config: dict, workload: dict, seed: int,
             seconds: float, trace: bool, device, t_start: float,
             log: Callable[[str], None], metrics: List[dict]) -> dict:
    """One run of a cell; returns the result's dict (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with ``trace`` its
    ``breakdown``, and the compared numbers under ``checks``)."""
    import torch

    from benchmark import trace as TR

    N = workload["num_envs"]
    su = set_up(name, config, workload, seed, device, log)
    ppo = su.ppo
    T = ppo.cfg.runner.num_steps_per_env
    _sync(device)
    setup_s = time.perf_counter() - t_start

    runs: List[Iteration] = []
    failed = 0
    w0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        stats = ppo.learn_step()
        b = time.perf_counter()
        runs.append(Iteration(b - a, stats["rollout_s"], stats["update_s"]))
        failed += not math.isfinite(stats["loss"])
        if b - w0 >= seconds:
            break
    window_s = b - w0
    log(f"window: {len(runs)} iterations in {window_s:.3f} s")

    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr = TR.traced(ppo, TRACE_ITERATIONS) if trace and cuda else None
    sizes = dict(config["sizes"], num_envs=N,
                 state_bytes=config["sizes"]["state_bytes_per_env"] * N,
                 record_bytes=4 * sum(ppo._rec_widths or ()))
    su.recorder.release()
    su.learn.release()
    su = su._replace(env=None, ppo=None, step=None)
    del ppo, stats
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    values = compare(su, config, N, reference(su, config, N, seed, device))
    limits = workload["limits"]
    log(f"reference: {time.perf_counter() - t_ref:.1f} s for "
        f"{len(su.recorder.kept)} steps and {len(su.iters)} iterations")

    run = Run(runs, window_s, setup_s, T * N, sizes, tr)
    out_metrics = {}
    for m in metrics:
        v = importlib.import_module(f"benchmark.metrics.{m['name']}").read(run)
        if v is not None:
            out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    # a window iteration whose loss is not finite is a wrong answer too:
    # the runner stops there, and the plain path gives finite ones
    result = {"correct": failed == 0 and check.judge(values, limits),
              "attempted": len(runs), "failed": failed,
              "metrics": out_metrics, "device": dev}
    if tr:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {k: {"value": values[k], "limit": limits[k]}
                        for k in check.NUMBERS}
    return result


def main(args, t_start: float, log: Callable[[str], None]) -> int:
    """The command: a cell's run on the card, its result as the last line
    of standard output."""
    from benchmark import guard

    entry, workload, config = cell(args.workload)
    writes = guard.WriteGuard(ROOT)
    kind, n, limit = guard.cards(entry["chips"])
    log(f"device: {kind}, {n} card(s); nvidia-smi name, power limit: "
        f"{limit}")
    result = run_cell(args.workload, config, workload, args.seed,
                      args.seconds, bool(args.trace), "cuda", t_start, log,
                      cell_metrics(args.workload, bool(args.trace)))
    found = guard.forbidden_modules()
    if found:
        log(f"refused: the process loaded {found}")
        return 1
    if writes.outside:
        log(f"refused: files written outside the checkout, HOME, "
            f"XDG_CACHE_HOME and TMPDIR: {sorted(set(writes.outside))}")
        return 1
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def stderr(line: str) -> None:
    print(line, file=sys.stderr, flush=True)
