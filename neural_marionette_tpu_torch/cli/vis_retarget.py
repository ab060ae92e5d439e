"""Motion retargeting demo CLI (the JAX package's ``vis_retarget.py``).

    python -m neural_marionette_tpu_torch.cli.vis_retarget \\
        --exp_dir pretrained/aist [--platform cpu]

Replays a source clip's motion on a target shape via the learned skeleton
(skinning weights from the nearest bones, FK with the target's bone
offsets and the source's rotations, linear blend skinning) and writes the
``.npy`` outputs and the render sets (``apps.retarget.save_outputs``:
source, target stills, smooth, textured, skeleton and overlay, drawn on
the card). Falls back to synthetic
clips when the source ``.npy`` or the target file is absent.
"""
import argparse
import os
import sys

import numpy as np

from ..api import Marionette
from ..apps.common import load_clip, synthetic_clip
from ..apps.retarget import load_target_points, run_retarget, save_outputs
from . import platform_device


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--exp_dir", type=str, default="pretrained/aist")
    parser.add_argument("--source_file", type=str,
                        default="data/demo/source/"
                                "gHO_sBM_cAll_d20_mHO1_ch05.npy")
    parser.add_argument("--target_file", type=str,
                        default="data/demo/target/ninja/target.obj")
    parser.add_argument("--Ttot", type=int, default=40)
    parser.add_argument("--hardness", type=float, default=8.0)
    parser.add_argument("--is_bind", type=int, default=0)
    parser.add_argument("--mode", type=str, default="ours",
                        choices=["ours", "baseline"])
    parser.add_argument("--target_scale", type=float, default=0.8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out_dir", type=str,
                        default="output/demo/retarget")
    parser.add_argument("--platform", type=str, default="",
                        help="cpu runs on the CPU; otherwise the card")
    args = parser.parse_args(argv)
    device = platform_device(args.platform)

    np.random.seed(args.seed)
    m = Marionette.load(args.exp_dir, device=device, Ttot=args.Ttot)
    if os.path.exists(args.source_file):
        source_vox, _ = load_clip(args.source_file, m.cfg)
    else:
        print(f"{args.source_file} not found; using a synthetic clip")
        source_vox, _ = synthetic_clip(m.cfg, seed=args.seed)

    target_mesh = None
    if os.path.exists(args.target_file):
        target_points, target_mesh = load_target_points(
            args.target_file, scale=args.target_scale,
            is_bind=bool(args.is_bind), return_mesh=True)
    else:
        print(f"{args.target_file} not found; using a synthetic target")
        _, pts = synthetic_clip(m.cfg, seed=args.seed + 7)
        target_points = pts[0]

    out = run_retarget(m, source_vox, target_points, hardness=args.hardness,
                       mode=args.mode, seed=args.seed)
    save_outputs(out, args.out_dir, source_vox=source_vox,
                 target_mesh=target_mesh, target_points=target_points,
                 device=device)
    print(f"wrote retargeted motion to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
