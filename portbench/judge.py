"""The comparison that decides ``correct``.

An answer is the maps one call returned for one input pair: the disparity
(float with NaN invalid, or int16 with -32768 invalid) and the NXCORR map
(NaN where no match was checked). Each is compared with the plain
reference's maps of the same pair. The numbers, over every compared
answer:

* ``pixel_mismatch_pct``: the share of the compared pixels, in %, whose
  disparity differs (valid on one side only, or valid on both with
  different values) or whose corrmap is NaN on one side only (a match
  checked that the reference did not check);
* ``corr_gap``: the largest corrmap difference where both are numbers.

Sound runs differ from the reference in a few pixels per million: where
two x of the subpixel sweep give NXCORR values within rounding of each
other, the program's and the reference's orders of operations pick
different ones (a disparity 0.1 or 0.2 apart).

Each number passes at or under the cell's limit (``workloads/<cell>.json``).
"""

from __future__ import annotations

import torch

NUMBERS = ("pixel_mismatch_pct", "corr_gap")
INVALID_I16 = -32768


def _invalid(disp: torch.Tensor) -> torch.Tensor:
    if disp.is_floating_point():
        return torch.isnan(disp)
    return disp == INVALID_I16


def compare(pairs) -> dict:
    """``pairs``: ``(disp, corr, ref_disp, ref_corr)`` tensors on one
    device, one tuple per answer. Returns the numbers."""
    mismatch = pixels = 0
    out = {"corr_gap": 0.0}
    for disp, corr, rdisp, rcorr in pairs:
        if disp.shape != rdisp.shape or corr.shape != rcorr.shape:
            raise ValueError(f"answer of shape {tuple(disp.shape)}, "
                             f"reference {tuple(rdisp.shape)}")
        inv, rinv = _invalid(disp), _invalid(rdisp)
        cnan, rcnan = torch.isnan(corr), torch.isnan(rcorr)
        both = ~inv & ~rinv
        mismatch += int(((inv != rinv) | (cnan != rcnan)
                         | (both & (disp.double() != rdisp.double()))).sum())
        pixels += disp.numel()
        cgap = (corr.double() - rcorr.double()).abs()[~cnan & ~rcnan]
        if cgap.numel():
            out["corr_gap"] = max(out["corr_gap"], float(cgap.max()))
    out["pixel_mismatch_pct"] = 100 * mismatch / pixels if pixels else 0.0
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(passed, checks)``: each number beside its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
