"""Motion generation demo CLI (the JAX package's ``vis_generation.py``).

    python -m neural_marionette_tpu_torch.cli.vis_generation \\
        --exp_dir pretrained/aist [--platform cpu]

Loads an experiment directory through ``Marionette.load`` (the port's
checkpoints or the reference's ``.pth``), conditions on ``Tcond`` frames of
the source clip, rolls out ``Tgen`` prior steps for ``sample_num``
trajectories, decodes them and writes the ``.npy`` outputs and the renders
(``apps.generation.save_outputs``: surfel PNGs and GIFs, keypoint and
recon GIFs, drawn on the card). Falls back to a synthetic clip when
the source ``.npy`` is absent.
"""
import argparse
import os
import sys

import numpy as np

from ..api import Marionette
from ..apps.common import load_clip, synthetic_clip
from ..apps.generation import run_generation, save_outputs
from . import platform_device


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--exp_dir", type=str, default="pretrained/aist")
    parser.add_argument("--source_file", type=str,
                        default="data/demo/source/"
                                "gHO_sBM_cAll_d20_mHO1_ch05.npy")
    parser.add_argument("--Tcond", type=int, default=5)
    parser.add_argument("--Tgen", type=int, default=25)
    parser.add_argument("--sample_num", type=int, default=3)
    parser.add_argument("--seed", type=int, default=2)
    parser.add_argument("--out_dir", type=str,
                        default="output/demo/generation")
    parser.add_argument("--platform", type=str, default="",
                        help="cpu runs on the CPU; otherwise the card")
    args = parser.parse_args(argv)
    device = platform_device(args.platform)

    np.random.seed(args.seed)
    m = Marionette.load(args.exp_dir, device=device, Ttot=args.Tcond)
    if os.path.exists(args.source_file):
        vox, _ = load_clip(args.source_file, m.cfg)
    else:
        print(f"{args.source_file} not found; using a synthetic clip")
        vox, _ = synthetic_clip(m.cfg, seed=args.seed)

    result = run_generation(m, vox, Tcond=args.Tcond, Tgen=args.Tgen,
                            sample_num=args.sample_num, seed=args.seed)
    save_outputs(result, args.out_dir, vox_cond=vox[:args.Tcond],
                 Tcond=args.Tcond, device=device)
    print(f"wrote {args.sample_num} generated motions to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
