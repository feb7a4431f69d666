"""Evaluate an anymal_c policy in the port: a fixed-command rollout with
gait statistics (port of ``scripts/eval_anymal.py``).

    python -m nightmare_rl_tpu_torch.tools.eval_anymal \\
        --ckpt nightmare_rl_tpu_torch/assets/anymal_model_122.pt \\
        [--vx 0.5] [--vy 0] [--wz 0] [--steps 400] [--stochastic] \\
        [--out traj.npz] [--device cpu]

``--ckpt`` takes a ``.pt``: rsl_rl's format or a checkpoint of the port's
trainer.  A JAX (orbax) checkpoint directory is refused; the JAX package's
exporter writes it as a ``.pt`` (``python -m nightmare_rl_tpu.tools.
export_torch --robot anymal_c --ckpt DIR --out model.pt``).

One ``AnymalCEnv`` of one env, reset from seed 0, stepped through
``tools/play.py::player``: the command is pinned before each step and, on
the card, each step is the replay of a captured CUDA graph.  The action is
the policy mean; ``--stochastic`` adds ``std · noise`` drawn from a
``torch.Generator`` seeded 11 (the noise is not the JAX script's
``PRNGKey(11)`` stream, so stochastic runs of the two tools differ).  The
trajectory comes to the host once, at the end of the rollout.  The
statistics are ``eval_stats``, with the JAX script's formulas; the two
printed lines have its format.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from nightmare_rl_tpu_torch.envs.anymal_c import AnymalCCfg, AnymalCEnv
from nightmare_rl_tpu_torch.tools import play
from nightmare_rl_tpu_torch.utils.device import resolve_device

NOISE_SEED = 11


def anymal_rows(out) -> dict:
    """A step's record rows: qpos, qvel, every sensor (anymal_c's are the
    four foot touch forces), done and time_out."""
    phys = out.state.phys
    return dict(qpos=phys.qpos, qvel=phys.qvel, sensordata=phys.sensordata,
                done=out.done, time_out=out.time_out)


def eval_stats(pos, sensordata, done, time_out, dt: float) -> dict:
    """``scripts/eval_anymal.py``'s statistics of a rollout: ``pos`` (T, 3)
    the base position after each step, ``sensordata`` (T, S), ``done`` and
    ``time_out`` (T,) booleans, ``dt`` the control step.  The first second
    (at most half the rollout) is left out of the velocity and the base
    height; the velocity is the displacement over the rest (world frame,
    which is the body frame while the heading stays near zero); a foot is
    down where its touch sensor reads above 1e-6."""
    pos = np.asarray(pos, np.float64)
    done, time_out = np.asarray(done, bool), np.asarray(time_out, bool)
    settle = min(int(1.0 / dt), len(pos) // 2)
    contact = np.asarray(sensordata) > 1e-6
    return dict(
        settle=settle,
        v_avg=(pos[-1] - pos[settle]) / ((len(pos) - settle) * dt),
        duty=contact.mean(axis=0),
        feet_down=contact.sum(axis=1).mean(),
        base_z_mean=pos[settle:, 2].mean(),
        base_z_min=pos[settle:, 2].min(),
        falls=int((done & ~time_out).sum()),
        timeouts=int((done & time_out).sum()))


def stat_lines(cmd, s: dict) -> tuple:
    """The JAX script's two lines: the command, the displacement velocity,
    falls and timeouts; the duty per sensor, feet down and base height."""
    vx, vy, wz = cmd
    v = s["v_avg"]
    return (f"eval: cmd ({vx:+.2f},{vy:+.2f},{wz:+.2f}) | "
            f"displacement v ({v[0]:+.3f},{v[1]:+.3f}) m/s | "
            f"falls={s['falls']} timeouts={s['timeouts']}",
            "gait: duty=" + "/".join(f"{d:.2f}" for d in s["duty"])
            + f" | feet_down mean={s['feet_down']:.2f}"
            + f" | base_z mean={s['base_z_mean']:.3f} "
            + f"min={s['base_z_min']:.3f}")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True,
                   help="policy .pt (rsl_rl format or a checkpoint of the "
                        "port's trainer)")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--vx", type=float, default=0.5)
    p.add_argument("--vy", type=float, default=0.0)
    p.add_argument("--wz", type=float, default=0.0)
    p.add_argument("--stochastic", action="store_true",
                   help="act with mu + std * noise (generator seeded 11); "
                        "default is the deterministic mean")
    p.add_argument("--out", type=str, default=None, help="npz trajectory")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    env = AnymalCEnv(AnymalCCfg(num_envs=1), device=device)
    net = play.load_policy(args.ckpt, env)
    it = torch.load(args.ckpt, map_location="cpu", weights_only=True).get("iter")
    print(f"loaded {args.ckpt} (iteration {it})")
    state, obs = env.reset(0)
    cmd = (args.vx, args.vy, args.wz)
    gen = (torch.Generator(device=device).manual_seed(NOISE_SEED)
           if args.stochastic else None)
    _, _, rec = play.rollout(env, net, state, obs, torch.tensor([cmd]),
                             args.steps, gen, rows=anymal_rows)
    qpos = rec["qpos"][:, 0].astype(np.float64)
    stats = eval_stats(qpos[:, :3], rec["sensordata"][:, 0], rec["done"][:, 0],
                       rec["time_out"][:, 0], env.dt)
    lines = stat_lines(cmd, stats)
    for line in lines:
        print(line)
    if args.out:
        from nightmare_rl_tpu_torch.tools.replay import save_npz

        qvel = rec["qvel"][:, 0].astype(np.float64)
        save_npz(args.out, [(k * env.dt, qpos[k], qvel[k], np.zeros(0))
                            for k in range(args.steps)])
        print(f"saved {args.out}")
    return {"stats": stats, "lines": lines, "record": rec, "dt": env.dt}


if __name__ == "__main__":
    main()
