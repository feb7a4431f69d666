"""Export a checkpoint of the port's trainer to the reference's torch format
(port of ``nightmare_rl_tpu/tools/export_torch.py``).

Writes a ``.pt`` holding only rsl_rl's ``model_state_dict`` and ``iter``,
loadable by the reference's own play.py (play.py:65-72:
``ActorCritic(...).load_state_dict(torch.load(path)['model_state_dict'])``),
without the port's optimizer and full train state.

    python -m nightmare_rl_tpu_torch.tools.export_torch \\
        --ckpt logs/nightmare_v3/<run>/model_1000.pt --out model_1000.pt
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch


def export(ckpt: str, out: str) -> int:
    """Write ``ckpt``'s weights to ``out``; returns the iteration."""
    blob = torch.load(ckpt, map_location="cpu", weights_only=True)
    it = int(blob.get("iter", 0))
    torch.save({"model_state_dict": blob["model_state_dict"], "iter": it}, out)
    return it


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(
        description="Checkpoint of the port's trainer -> rsl_rl .pt.  The "
                    "port cannot read the JAX package's orbax checkpoints: "
                    "a JAX checkpoint reaches the port through the JAX "
                    "package's exporter, python -m "
                    "nightmare_rl_tpu.tools.export_torch --ckpt DIR --out "
                    "model.pt, whose .pt the port's play and train -r load.")
    p.add_argument("--ckpt", required=True,
                   help="model_<iter>.pt written by the port's trainer")
    p.add_argument("--out", required=True, help="output .pt path")
    args = p.parse_args(argv)
    it = export(args.ckpt, args.out)
    print(f"wrote {args.out} (iteration {it}) — loadable by the reference "
          "play.py")


if __name__ == "__main__":
    main()
