"""Minimal end-to-end example of the PyTorch/CUDA port: generate a synthetic
projected-pattern scene, match it, and export every artifact the reference
CLI produces.

Run from the repository root (the card by default; ``--device cpu`` runs
the plain PyTorch versions on the CPU)::

    PYTHONPATH=. python examples/torch/quickstart.py [outdir] [--device cpu]
"""

import argparse
import os

import numpy as np

import libbicos_tpu_torch as bicos
from libbicos_tpu_torch import io as bio
from libbicos_tpu_torch import profiling


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir", nargs="?", default="bicos-quickstart")
    ap.add_argument("--device", default=None,
                    help="the current CUDA device by default, or 'cpu'")
    args = ap.parse_args(argv)
    outdir = args.outdir
    os.makedirs(outdir, exist_ok=True)

    # A 9-shot stereo pair with known ground truth.
    stack0, stack1, true_disp = bio.synthetic_stack_pair(9, 120, 160)

    cfg = bicos.Config(
        nxcorr_threshold=0.6,
        subpixel_step=0.25,
        min_variance=1.0,
        mode=bicos.TransformMode.LIMITED,
        variant=bicos.Consistency(max_lr_diff=1, no_dupes=True),
    )
    disp, corr = bicos.match(stack0, stack1, cfg, corrmap=True,
                             device=args.device)
    disp, corr = disp.cpu().numpy(), corr.cpu().numpy()

    print(profiling.metrics(disp))
    bio.save_image(disp, f"{outdir}/disparity.png")
    bio.save_image(corr, f"{outdir}/corrmap.png")

    q = np.array([[1, 0, 0, -80.0], [0, 1, 0, -60.0],
                  [0, 0, 0, 200.0], [0, 0, 1 / 30.0, 0]])
    points = bio.reproject_image_to_3d(disp, q)
    bio.save_pointcloud(points, disp, f"{outdir}/cloud.xyz")

    valid = np.isfinite(disp)
    cols = np.arange(disp.shape[1])[None, :]
    interior = valid & (cols >= true_disp)
    err = np.abs(disp - true_disp)[interior]
    print(f"valid: {valid.mean():.1%}, max |err| on valid interior: "
          f"{err.max() if err.size else float('nan')}")


if __name__ == "__main__":
    main()
