"""Where the time of the training path goes on the card.

    python -m nightmare_rl_tpu_torch.tools.profile_step [-e 2048] [--steps 4]
        [--robot nightmare_v3|anymal_c] [--forms legs kernel]

For the robot's env at ``-e`` envs in float32 (the training CLI's
configuration), with the PGS form that the solver's dispatch picks
(``NIGHTMARE_PGS=legs|kernel`` forces one; unset, the probe's verdict; with
``--forms`` each named form in turn, in this one process), it measures,
after warm-up:

- the wall time of one env step (host clock around synchronized steps);
- with ``torch.profiler``: the device time inside those steps, hence the
  device's busy share, the number of kernels one step and one physics
  substep launch, the kernels that take the most device time and the PGS
  kernels' share (zero for anymal_c, whose Newton solve runs no kernel of
  its own);
- the wall time of one policy forward pass on the step's observations;
- the peak device memory that the timed env steps allocate
  (``torch.cuda.max_memory_allocated`` from a reset of the peak).

The last line is one JSON object with these numbers, the top kernels, the
PGS form that ran (``pgs_form``: "legs", "kernel" for the dense form, or
"newton"; with ``--forms``, a list ``forms`` of these objects) and the
card's name: the per-layer breakdown that PERF.md's
"Where the time goes" quotes.  A missing card raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.models.actor_critic import ActorCritic
from nightmare_rl_tpu_torch.ops import pgs as P
from nightmare_rl_tpu_torch.utils.device import resolve_device


def _timed(fn, steps: int) -> float:
    """Milliseconds per call of fn, host clock, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def _measure(env, net, box, env_step, dev, steps: int, substeps: int) -> dict:
    """One form's numbers: env step wall, peak memory, the PGS form that
    ran, the profiled device time and kernels, the policy forward."""
    def policy():
        with torch.no_grad():
            net(box["obs"])

    for _ in range(3):
        env_step()
    launches0 = P.pgs.launches, P.pgs_legs.launches
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = _timed(env_step, steps)
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    dense, legs = (n - n0 for n, n0 in zip((P.pgs.launches, P.pgs_legs.launches),
                                           launches0))
    form = "legs" if legs else "kernel" if dense else "newton"
    policy_ms = _timed(policy, 20)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            env_step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    pgs_ms = sum(e.self_device_time_total for e in kernels
                 if "pgs_kernel" in e.key or "pgs_legs_kernel" in e.key
                 ) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile: {torch.cuda.get_device_name(dev)}, {env.num_envs} envs "
          f"float32, PGS form {form}: env step {step_ms:.3f} ms wall; device "
          f"busy {device_ms:.3f} ms ({100 * device_ms / step_ms:.1f}%) in "
          f"{launches:.0f} kernels ({launches / substeps:.0f} per substep); pgs "
          f"kernel {pgs_ms:.3f} ms; policy forward {policy_ms:.3f} ms; peak "
          f"device memory {peak_mb:.1f} MiB")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms  "
              f"{e.count / steps:6.0f}x  {e.key[:90]}")
    return {
        "pgs_form": form, "env_step_ms": step_ms, "device_busy_ms": device_ms,
        "device_busy_share": device_ms / step_ms, "kernels_per_step": launches,
        "kernels_per_substep": launches / substeps, "pgs_ms": pgs_ms,
        "policy_ms": policy_ms, "peak_mem_mib": peak_mb,
        "env_steps_per_s": env.num_envs / step_ms * 1e3,
        "top_kernels": [
            {"device_ms_per_step": e.self_device_time_total / 1e3 / steps,
             "launches_per_step": e.count / steps, "name": e.key}
            for e in top],
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--envs", type=int, default=2048)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--robot", type=str, default="nightmare_v3",
                   choices=["nightmare_v3", "anymal_c"])
    p.add_argument("--forms", nargs="+", choices=("legs", "kernel"),
                   help="measure each PGS form in turn in this process "
                        "(NIGHTMARE_PGS set for each)")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")

    if args.robot == "anymal_c":
        env = AnymalCEnv(AnymalCCfg(num_envs=args.envs), device=dev)
        substeps = env.cfg.decimation
    else:
        env = NightmareV3Env(NightmareV3Cfg().replace(
            env=EnvCfg(num_envs=args.envs)), device=dev)
        substeps = env.cfg.control.decimation
    net = ActorCritic(env.num_obs, env.num_actions).to(dev)
    box = {}
    box["state"], box["obs"] = env.reset(0)
    g = torch.Generator(device=dev).manual_seed(0)

    def env_step():
        acts = 0.5 * torch.randn(args.envs, env.num_actions, generator=g, device=dev)
        out = env.step(box["state"], acts)
        box["state"], box["obs"] = out.state, out.obs

    result = {"device": torch.cuda.get_device_name(dev), "robot": args.robot,
              "envs": args.envs}
    if args.forms:
        prev = os.environ.get("NIGHTMARE_PGS")
        try:
            result["forms"] = []
            for form in args.forms:
                os.environ["NIGHTMARE_PGS"] = form
                result["forms"].append(_measure(env, net, box, env_step, dev,
                                                args.steps, substeps))
        finally:
            os.environ.pop("NIGHTMARE_PGS")
            if prev is not None:
                os.environ["NIGHTMARE_PGS"] = prev
    else:
        result.update(_measure(env, net, box, env_step, dev, args.steps, substeps))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
