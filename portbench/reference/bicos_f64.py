"""Plain BICOS matching with float64 NXCORR, the reference of the DOUBLE
configurations.

The configurations under ``portbench/configs`` that name ``"reference":
"bicos_f64"`` run upstream libBICOS with ``--double``
(``Precision::DOUBLE``). This module runs :mod:`portbench.reference.bicos`
(the same descriptors, scan and agree stage, worked out again from the
input stacks; nothing of the program under test) with another compute
type:

* in float64: the shot sums, means and deviations, the variances, the
  covariance and the NXCORR, the ``min_variance`` test, the threshold
  test and the best NXCORR of the subpixel sweep;
* in float32, as in the SINGLE reference: the parabola through columns
  ``col1 - 1 .. col1 + 1``, the x grid of the sweep (accumulated in
  float32 from -1) and the rounding of the interpolated samples before
  their modular cast to the input width;
* the corrmap is returned in float32, as the program returns it: each
  float64 NXCORR rounded once.

A SINGLE program computes its NXCORR in float32 and lands a few float32
ulps off this reference's corrmap, which the cell's ``corr_gap`` limit
catches.
"""

from __future__ import annotations

import torch

from portbench.reference import bicos
from portbench.reference.bicos import INVALID_I16, subpixel_grid

__all__ = ["INVALID_I16", "match", "subpixel_grid"]


def match(stack0: torch.Tensor, stack1: torch.Tensor, cfg: dict,
          dtype=torch.float64):
    """``(search disparity, disparity, corrmap)`` of one pair under a
    DOUBLE configuration file's settings: :func:`portbench.reference.bicos
    .match` with the compute type ``dtype`` (float64; the calibration's
    control passes a lower one)."""
    if cfg.get("precision") != "DOUBLE":
        raise ValueError(f"bicos_f64 is the reference of DOUBLE "
                         f"configurations, not {cfg.get('precision')!r}")
    return bicos.match(stack0, stack1, cfg, dtype)
