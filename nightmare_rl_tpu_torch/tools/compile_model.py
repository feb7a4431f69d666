"""Compile MJCF robot models into System archives (host-side, needs mujoco).

    python -m nightmare_rl_tpu_torch.tools.compile_model --xml PATH [--out PATH]
        [--max-points N]
    python -m nightmare_rl_tpu_torch.tools.compile_model [--reference DIR]

With ``--xml`` it compiles one MJCF file into an ``.npz`` archive (beside the
file unless ``--out`` is given) that both packages' ``load_system`` read.
Without it, it compiles the bundled robot set (the JAX tool's table) from
the MJCF files of a checkout of the reference repository, named by
``--reference`` or ``NIGHTMARE_REFERENCE_DIR``, into
``nightmare_rl_tpu_torch/assets/``.  The compiler runs on the CPU (mujoco is
a host-side compiler); the runtime only loads the archives.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from nightmare_rl_tpu_torch.physics import loader

_DEFAULT_MODELS = {
    # name -> (xml path in the reference checkout, max contact support points
    # per geom): the base gets more points (a wide flat underside); the
    # tibias need the tip (through the foot-site priority direction) and a
    # few shaft and extreme vertices
    "nightmare_v3": (
        "models/nightmare_v3/mjmodel.xml",
        {"base_link": 10, "*": 5},
    ),
    "nightmare_v3_mjx": (
        "models/nightmare_v3/mjmodel_mjx.xml",
        {"base_link": 10, "*": 5},
    ),
    # quadruped with primitive collision geoms (sphere feet, cylinder and
    # box shells): no mesh support points
    "anymal_c": ("models/anymal_c/scene.xml", {"*": 4}),
}

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--xml", default=None, help="single MJCF file to compile")
    p.add_argument("--out", default=None, help="output .npz path")
    p.add_argument("--max-points", type=int, default=6)
    p.add_argument("--reference", default=os.environ.get("NIGHTMARE_REFERENCE_DIR"),
                   help="checkout of the reference repository whose models "
                        "the bundled set is compiled from (default: "
                        "$NIGHTMARE_REFERENCE_DIR)")
    args = p.parse_args(argv)

    if args.xml:
        sys_ = loader.system_from_mjcf(args.xml, args.max_points, device="cpu")
        out = args.out or os.path.splitext(args.xml)[0] + ".npz"
        loader.save_system(sys_, out)
        print(f"{args.xml} -> {out}  (ncp={sys_.ncp}, nv={sys_.nv})")
        return

    if not args.reference:
        p.error("the bundled set needs --reference or NIGHTMARE_REFERENCE_DIR")
    os.makedirs(_ASSET_DIR, exist_ok=True)
    for name, (xml, maxp) in _DEFAULT_MODELS.items():
        sys_ = loader.system_from_mjcf(os.path.join(args.reference, xml), maxp,
                                       device="cpu")
        out = os.path.join(_ASSET_DIR, name + ".npz")
        loader.save_system(sys_, out)
        print(f"{name}: ncp={sys_.ncp} nv={sys_.nv} nu={sys_.nu} -> {out}")


if __name__ == "__main__":
    main()
