"""Learning-curve cross-validation against the reference environment (port
of ``nightmare_rl_tpu/tools/compare_reference_curve.py``).

The port's PPO (rsl_rl v1.0.2 semantics, rl/ppo.py) trains through the
host-loop driver (rl/external.py) against

    --side ref   the reference env, imported from a checkout of the
                 reference repository named by --reference or
                 NIGHTMARE_REFERENCE_DIR (envs/nightmare_v3_env.py —
                 imported, not copied)
    --side tpu   this package's env (envs/nightmare_v3.py), on the card
                 unless ``--device cpu`` is asked for

and logs one row of metrics per iteration to <out>/metrics.jsonl, with the
JAX tool's keys: iter, mean_reward, loss, kl, lr, mean_noise_std, dones and
the per-term ``rew_*`` means of the episodes that ended in the iteration.
The PPO runs on ``--device`` for either side.  ``tools/curve_windows.py``
puts the runs' window means side by side.

    python -m nightmare_rl_tpu_torch.tools.compare_reference_curve \
        --side tpu --envs 256 --iters 100 --seed 1 --out logs/curvecmp/torch_s1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg, PPOCfg
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.rl.external import ExternalPPO
from nightmare_rl_tpu_torch.utils.device import resolve_device


def make_ref_env(num_envs: int, num_threads: int, reference: str):
    """Instantiate the reference env of the checkout ``reference`` headless
    (render/recording off) and wrap it into the external-driver callback
    protocol."""
    sys.path.insert(0, reference)
    from envs.nightmare_v3_config import NightmareV3Config  # noqa: E402
    from envs.nightmare_v3_env import NightmareV3Env as RefEnv  # noqa: E402

    cfg = NightmareV3Config()
    cfg.env.num_envs = num_envs
    cfg.env.model_path = os.path.join(reference, "models", "nightmare_v3",
                                      "mjmodel.xml")
    cfg.viewer.render = False
    cfg.viewer.record_states = False
    env = RefEnv(cfg, log_dir=None, num_threads=num_threads)
    obs = env.reset()[0].numpy()

    def step(actions: np.ndarray):
        obs, _, rew, dones, extras = env.step(
            torch.from_numpy(np.asarray(actions, np.float32)))
        time_out = extras.get("time_outs")
        time_out = (time_out.numpy() if time_out is not None
                    else np.zeros(num_envs, np.float32))
        # per-term means over envs that reset this step (reset_idx :363-367)
        n_reset = int((dones.numpy() != 0).sum())
        ep = {k: float(v) for k, v in extras.get("episode", {}).items()
              } if n_reset else {}
        return (obs.numpy(), rew.numpy(), dones.numpy(), time_out,
                (n_reset, ep))

    return env, obs, step


def make_tpu_env(num_envs: int, device=None):
    """This package's env on ``device`` (the card unless "cpu"), wrapped
    into the same callback protocol: numpy in, numpy out."""
    dev = resolve_device(device)
    env = NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(num_envs=num_envs)),
                         device=dev)
    state, obs = env.reset(0)
    box = {"state": state}

    def step(actions: np.ndarray):
        out = env.step(box["state"], torch.as_tensor(
            np.asarray(actions, np.float32), device=dev))
        box["state"] = out.state
        fin = out.finished_episode_sums.cpu().numpy()  # (N, nterms) nan=open
        finished = ~np.isnan(fin[:, 0])
        n_reset = int(finished.sum())
        ep = {}
        if n_reset:
            means = fin[finished].mean(axis=0) / env.max_episode_length_s
            ep = {f"rew_{name}": float(v)
                  for name, v in zip(env.active_rewards, means)}
        return (out.obs.cpu().numpy(), out.reward.cpu().numpy(),
                out.done.cpu().numpy(), out.time_out.cpu().numpy(),
                (n_reset, ep))

    return env, obs.cpu().numpy(), step


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Returns the path of the metrics file it wrote."""
    p = argparse.ArgumentParser()
    p.add_argument("--side", choices=["ref", "tpu"], required=True)
    p.add_argument("--envs", type=int, default=256)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu: the PPO's, and the env's "
                        "for --side tpu")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--reference", default=os.environ.get("NIGHTMARE_REFERENCE_DIR"),
                   help="checkout of the reference repository (--side ref; "
                        "default: $NIGHTMARE_REFERENCE_DIR)")
    args = p.parse_args(argv)
    if args.side == "ref" and not args.reference:
        p.error("--side ref needs --reference or NIGHTMARE_REFERENCE_DIR")

    np.random.seed(args.seed)  # the reference env uses global np.random

    if args.side == "ref":
        env, obs0, step = make_ref_env(args.envs, args.threads, args.reference)
    else:
        env, obs0, step = make_tpu_env(args.envs, args.device)

    trainer = ExternalPPO(env.num_obs, env.num_actions, args.envs,
                          PPOCfg().replace(seed=args.seed), device=args.device)
    trainer.init(args.seed, obs0)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "metrics.jsonl")
    f = open(path, "w")

    # per-iteration episode metrics: reset-count-weighted means of the
    # per-step per-term episode means both sides emit identically
    ep_acc: dict = {}
    ep_n = 0

    def step_and_collect(actions):
        nonlocal ep_acc, ep_n
        obs, rew, done, time_out, (n_reset, ep) = step(actions)
        if n_reset:
            ep_n += n_reset
            for k, v in ep.items():
                ep_acc[k] = ep_acc.get(k, 0.0) + v * n_reset
        return obs, rew, done, time_out

    t0 = time.time()
    for it in range(1, args.iters + 1):
        ep_acc, ep_n = {}, 0
        stats = trainer.learn_iteration(step_and_collect)
        row = {
            "iter": it,
            "mean_reward": float(stats["mean_reward"]),
            "loss": float(stats["loss"]),
            "kl": float(stats["kl"]),
            "lr": float(stats["lr"]),
            "mean_noise_std": float(stats["mean_noise_std"]),
            "dones": int(stats["dones"]),
        }
        for k, v in ep_acc.items():
            row[k] = v / max(ep_n, 1)
        f.write(json.dumps(row) + "\n")
        f.flush()
        if it % 10 == 0 or it == 1:
            rate = it * trainer.cfg.runner.num_steps_per_env * args.envs / (
                time.time() - t0)
            print(f"[{args.side}] iter {it}: reward "
                  f"{row['mean_reward']:+.4f} kl {row['kl']:.4f} "
                  f"std {row['mean_noise_std']:.3f} ({rate:,.0f} steps/s)")
    f.close()
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
