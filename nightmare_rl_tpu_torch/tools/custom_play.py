"""Drive the hexapod with the classical gait engine inside the port's
physics (port of ``nightmare_rl_tpu/tools/custom_play.py``).

Equivalent of the reference's custom_play.py (nikengine FSM instead of a
NN, action-rate limit + kp=12 proportional control, contact-force printouts,
FPS meter — custom_play.py:44-151) and custom_play_mult.py (the same engine
over many envs: ``--envs N``, one batched engine call per control step).

    python -m nightmare_rl_tpu_torch.tools.custom_play --steps 400 --lin 0.08 \\
        [--envs 4 [--lin 0.08 0.04 --ang 0 0.3]] [--gait tripod|ripple|wave] \\
        [--out gait.pkl] \\
        [--view --xml path/to/mjmodel.xml] [--device cpu]

The engine ticks once per control step (``engine_fps = 1/(dt·2)``) and the
physics runs 2 substeps per control step with ``max_contacts=16``.  Runs on
the card unless ``--device cpu``.  On the card the control step is captured
once as a CUDA graph (``utils/graph.py``) and replayed, the counterpart of
the JAX tool's ``@jax.jit`` step; the clock is a device input of the graph,
taken from a table of the step times made once; the CPU runs the step
eagerly.  The print every 100 steps reads the card and stays outside the
graph.
"""

from __future__ import annotations

import argparse
import dataclasses
import pickle
import time
from typing import Optional, Sequence

import numpy as np
import torch

from nightmare_rl_tpu_torch.engine import gait as G
from nightmare_rl_tpu_torch.physics import loader, pipeline
from nightmare_rl_tpu_torch.physics import system as S
from nightmare_rl_tpu_torch.utils.device import resolve_device
from nightmare_rl_tpu_torch.utils.graph import CapturedStep

KP = 12.0
RATE_LIMIT = 0.08   # action-rate limit (custom_play.py:72-74)
DECIMATION = 2
MAX_CONTACTS = 16


def make(num_envs: int, gait: str = "tripod", device=None,
         dtype: torch.dtype = torch.float32):
    """The system, engine config and initial (physics, engine, rate-limited
    target) state of ``num_envs`` hexapods."""
    sys_ = loader.load_system("nightmare_v3", device=resolve_device(device))
    sys_ = dataclasses.replace(S.tree_cast(sys_, dtype), max_contacts=MAX_CONTACTS)
    dt = float(sys_.timestep)
    # the engine ticks once per control step
    cfg = G.make_cfg(gait=gait, engine_fps=1.0 / (dt * DECIMATION),
                     dtype=dtype, device=sys_.device)
    phys = pipeline.make_state(sys_, num_envs)
    es = G.init_state(cfg, num_envs)
    limited = torch.zeros(num_envs, 18, dtype=dtype, device=sys_.device)
    return sys_, cfg, phys, es, limited


def control_step(sys_, cfg, phys, es, limited, t, lin, ang):
    """One control step of every env: an engine tick (awake, walking at
    lin/ang, each (N,)), the rate limit, the P controller and the physics.
    ``t`` is the clock, a number or a 0-dim tensor of the physics dtype on
    its device (which keeps the step free of host copies)."""
    N = lin.shape[0]
    awake = torch.full((N,), G.CMD_AWAKE, dtype=torch.long, device=lin.device)
    walk = torch.full((N,), G.MODE_WALK, dtype=torch.long, device=lin.device)
    es, angles = G.update(cfg, es, t, lin, ang, awake, walk)
    limited = limited + torch.clamp(angles - limited, -RATE_LIMIT, RATE_LIMIT)
    ctrl = (limited - phys.qpos[:, 7:]) * KP
    phys = pipeline.step(sys_, phys, ctrl, DECIMATION)
    return phys, es, limited


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--lin", type=float, nargs="+", default=[0.08],
                   help="walk speed; with several values env i takes the "
                        "(i mod count)-th")
    p.add_argument("--ang", type=float, nargs="+", default=[0.0],
                   help="turn rate, spread over the envs as --lin is")
    p.add_argument("--envs", type=int, default=1)
    p.add_argument("--gait", type=str, default="tripod",
                   choices=["tripod", "ripple", "wave"])
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--view", action="store_true")
    p.add_argument("--xml", type=str, default=None,
                   help="the robot's MJCF, for --view")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    sys_, cfg, phys, es, limited = make(args.envs, args.gait, args.device)
    dtype, dev = sys_.dtype, sys_.device
    dt = float(sys_.timestep)
    N = args.envs
    env = torch.arange(N)
    lin = torch.tensor(args.lin, dtype=dtype)[env % len(args.lin)].to(dev)
    ang = torch.tensor(args.ang, dtype=dtype)[env % len(args.ang)].to(dev)

    ts, t = [], 0.0
    for _ in range(args.steps):
        t += dt * DECIMATION
        ts.append(t)
    # the clock of every step on the device, in one copy
    clock = torch.tensor(ts, dtype=dtype, device=dev)

    def tick(carry, t, lin, ang):
        return control_step(sys_, cfg, *carry, t, lin, ang)

    carry = (phys, es, limited)
    t0 = time.time()
    step = CapturedStep(tick, carry, clock[0], lin, ang)
    capture_s = time.time() - t0
    nq, nv = phys.qpos.shape[1], phys.qvel.shape[1]
    rows = torch.empty(args.steps, nq + nv, dtype=dtype, device=dev)
    t_wall = time.time()
    for k in range(args.steps):
        carry = step(carry, clock[k], lin, ang)
        phys, es, limited = carry
        # env 0's row; the captured step's buffers change on every replay
        rows[k, :nq].copy_(phys.qpos[0])
        rows[k, nq:].copy_(phys.qvel[0])
        if (k + 1) % 100 == 0:
            # the read waits for the card, so the rate counts finished steps
            forces = phys.sensordata[0].cpu().numpy()
            fps = (k + 1) / (time.time() - t_wall)
            print(f"step {k+1}: {fps:.1f} ctrl-steps/s  base z "
                  f"{float(phys.qpos[0, 2]):.3f}  feet forces "
                  f"{forces[6:12].round(2)}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t_wall
    host = rows.cpu().numpy().astype(np.float64)
    qpos, qvel = host[:, :nq], host[:, nq:]
    traj = [(ts[k], qpos[k], qvel[k], np.zeros(0)) for k in range(args.steps)]

    print(f"final base pos {qpos[-1, :3].round(3)}")
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(traj, f)
        print(f"saved {args.out}")
    if args.view:
        from nightmare_rl_tpu_torch.tools.play import replay_in_viewer

        replay_in_viewer(traj, xml=args.xml)
    return {"traj": traj, "qpos": phys.qpos.cpu().numpy(), "engine": es,
            "wall_s": wall, "ctrl_steps_per_s": args.steps / wall,
            "capture_s": capture_s, "graph": step.graph}


if __name__ == "__main__":
    main()
