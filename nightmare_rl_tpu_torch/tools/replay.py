"""Replay recorded trajectories in the host-side MuJoCo viewer (port of
``nightmare_rl_tpu/tools/replay.py``).

Equivalent of the reference's open_custom_play.py (pkl glob, state-injection
replay at timestep pacing — open_custom_play.py:21-108), plus the npz format
and the native ring-log format (utils/binlog.py).

    python -m nightmare_rl_tpu_torch.tools.replay [--dir logs/...] \\
        [--file x.pkl] [--rate 4] [--xml path/to/mjmodel.xml] [--no-view]
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
from typing import List, Optional, Sequence

import numpy as np


def load_any(path: str):
    """Return a list of (t, qpos, qvel, act) tuples from pkl (the reference
    format), npz (the shareable format: no pickle deserialization of
    untrusted files), or ringlog."""
    if path.endswith(".ring"):
        from nightmare_rl_tpu_torch.utils.binlog import TrajectoryLog

        # geometry comes from the file header; nq/nv args are placeholders
        log = TrajectoryLog(path, nq=25, nv=24)
        t, q, v = log.read()
        return [(float(t[i]), q[i].astype(np.float64),
                 v[i].astype(np.float64), np.zeros(0)) for i in range(len(t))]
    if path.endswith(".npz"):
        d = np.load(path)
        act = d["act"] if "act" in d else np.zeros((len(d["t"]), 0))
        return [(float(d["t"][i]), d["qpos"][i], d["qvel"][i], act[i])
                for i in range(len(d["t"]))]
    with open(path, "rb") as f:
        return pickle.load(f)


def save_npz(path: str, traj) -> None:
    """Write a (t, qpos, qvel, act) trajectory as npz."""
    np.savez_compressed(
        path,
        t=np.asarray([s[0] for s in traj]),
        qpos=np.stack([s[1] for s in traj]),
        qvel=np.stack([s[2] for s in traj]),
        act=np.stack([np.asarray(s[3]) for s in traj]),
    )


def main(argv: Optional[Sequence[str]] = None) -> List[tuple]:
    p = argparse.ArgumentParser()
    p.add_argument("--dir", type=str, default=None,
                   help="replay every recording in this directory, oldest first")
    p.add_argument("--file", type=str, default=None)
    p.add_argument("--rate", type=float, default=4.0,
                   help="playback speed multiplier (reference used 4x)")
    p.add_argument("--xml", type=str, default=None,
                   help="the robot's MJCF, for the viewer")
    p.add_argument("--no-view", action="store_true",
                   help="just print trajectory stats (headless check)")
    args = p.parse_args(argv)

    paths = []
    if args.file:
        paths = [args.file]
    elif args.dir:
        paths = sorted(
            glob.glob(os.path.join(args.dir, "*.pkl"))
            + glob.glob(os.path.join(args.dir, "*.npz"))
            + glob.glob(os.path.join(args.dir, "*.ring"))
        )
    if not paths:
        raise SystemExit("nothing to replay (use --file or --dir)")

    seen = []
    for path in paths:
        traj = load_any(path)
        print(f"{path}: {len(traj)} frames, "
              f"t=[{traj[0][0]:.2f}, {traj[-1][0]:.2f}]s")
        seen.append((path, len(traj)))
        if args.no_view:
            continue
        from nightmare_rl_tpu_torch.tools.play import replay_in_viewer

        replay_in_viewer(traj, xml=args.xml, rate=args.rate)
    return seen


if __name__ == "__main__":
    main()
