"""The task kernels' time on the card by the shape of an env's team.

    python -m nightmare_rl_tpu_torch.tools.profile_task [-e 2048 4096]
        [--teams 8x64 32x128 ...]

For each robot (nightmare_v3, anymal_c) at each ``-e`` envs, float32, on
the inputs of ``chip_smoke.py``'s task-kernel phase (a state after a few
env steps, with resets, resamples, edge envs and sweeps across every
cut), it builds ``ops/csrc/task.cu`` once per team shape ``LxT`` (L lanes
of a warp per env, T threads a block: ``-DTASK_LANES=L -DTASK_THREADS=T``;
the first shape given is the repo's own, 8x64), holds each build's
``post`` against the plain version (envs whose flags, episode counts or
commands differ, the largest value error) and times ``pre`` and ``post``
alone (each launch behind a spin kernel and an L2 flush, as
``chip_smoke.py``'s ``_kernel_ms``), the shapes in turns (in order, then
in reverse); with ptxas's registers, stack and spills per kernel.  The
last line is one JSON object with these numbers and the card's name.  A
missing card raises.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import json
import os
from typing import Optional, Sequence

import torch

from nightmare_rl_tpu_torch.ops import build, task
from nightmare_rl_tpu_torch.tools.profile_smooth import (
    REPO, _nvcc_lib, alone_us, ptxas)
from nightmare_rl_tpu_torch.utils.device import resolve_device


def _smoke():
    """chip_smoke.py (the repo's root), for its task-kernel inputs."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def library(lib: ctypes.CDLL):
    """``ops/task.py``'s wrappers launching the kernels of ``lib``."""
    real = build.load
    build.load = lambda name: lib if name == "task" else real(name)
    task._fn.cache_clear()
    try:
        yield
    finally:
        build.load = real
        task._fn.cache_clear()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--envs", type=int, nargs="+", default=[2048, 4096])
    p.add_argument("--teams", nargs="+", default=["8x64", "32x128"],
                   help="team shapes LxT: L lanes per env, T threads a block")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    smoke = _smoke()
    src = os.path.join(build.CSRC_DIR, "task.cu")
    shapes = [tuple(int(x) for x in t.split("x")) for t in args.teams]
    libs = {}
    for L, T in shapes:
        b = _nvcc_lib(src, [f"TASK_LANES={L}", f"TASK_THREADS={T}"])
        libs[(L, T)] = b["lib"]
        for k in ptxas(b["log"]):
            if "task_post" in k["function"] or "task_pre" in k["function"]:
                kind = "post" if "task_post" in k["function"] else "pre"
                dt = "float" if "IfLi" in k["function"] else "double"
                robot = "anymal_c" if "Li1E" in k["function"] else "nightmare_v3"
                print(f"profile-task: {L}x{T} task_{kind}<{dt}, {robot}>: "
                      f"{k.get('registers')} registers, stack "
                      f"{k.get('stack')} B, spill stores/loads "
                      f"{k.get('spill_stores')}/{k.get('spill_loads')} B")
    cases = {}
    for robot in ("nightmare_v3", "anymal_c"):
        for N in args.envs:
            env = smoke._task_env(robot, N)
            cases[(robot, N)] = (env, smoke._task_inputs(env, N))
    runs = {}
    for order in (shapes, shapes[::-1]):
        for shape in order:
            with library(libs[shape]):
                for key, (env, (state, raw, actions, phys, draws,
                                noise)) in cases.items():
                    plan = env.task_plan

                    def post():
                        return task.post(env, state, actions, phys, draws,
                                         noise)

                    held = smoke._task_held(task.PLAIN_POST[plan.robot](
                        env, state, actions, phys, draws, noise), post())
                    r = runs.setdefault((shape, key), dict(
                        post_us=[], pre_us=[], bad=0, rel=0.0))
                    r["post_us"].append(alone_us(post))
                    r["pre_us"].append(alone_us(
                        lambda: task.pre(env, state, raw)))
                    r["bad"] = max(r["bad"], held["bad"])
                    r["rel"] = max(r["rel"], held["rel"])
    name = torch.cuda.get_device_name(dev)
    for ((L, T), (robot, N)), r in runs.items():
        print(f"profile-task: {name}, {robot} {N} envs float32, team "
              f"{L} lanes x {T} threads a block: post "
              + ", ".join(f"{x:.2f}" for x in r["post_us"]) + " us alone, pre "
              + ", ".join(f"{x:.2f}" for x in r["pre_us"]) + f" us; envs whose "
              f"decisions differ from the plain version's {r['bad']}, largest "
              f"value error {r['rel']:.2e}")
    if any(r["bad"] for r in runs.values()):
        raise AssertionError("a team shape's decisions differ from the plain "
                             "version's")
    result = {"device": name, "runs": [
        dict(lanes=L, threads=T, robot=robot, envs=N, **r)
        for ((L, T), (robot, N)), r in runs.items()]}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
