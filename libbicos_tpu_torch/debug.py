"""``BICOS_DEBUG`` runtime invariant checks.

The counterpart of ``libbicos_tpu.debug``: the reference traps bitfield
overflow and bad register indexing in its debug builds; here, with
``BICOS_DEBUG=1`` (any value but empty or "0", read at call time),
:func:`pipeline.match` checks every result:

* disparities are the invalid sentinel or inside ``(-W, W)`` (plus the
  subpixel refinement's margin of 1),
* NXCORR values are NaN (not computed) or inside ``[-1, 1]`` up to
  :data:`CORR_SLACK` (the variance prefilter's -1 included),

and the CLI's ``--dump-descriptors`` checks that the packed descriptor
words carry no bit at or beyond the descriptor width. A violation raises
:class:`BicosDebugError`. The checks take tensors or numpy arrays and fetch
them to the host: a debug and CI tool, not a production path.
"""

from __future__ import annotations

import os

import numpy as np

# |NXCORR| <= 1 up to rounding: the sums of near-constant series may
# exceed 1 by a little.
CORR_SLACK = 1e-3


class BicosDebugError(AssertionError):
    """A BICOS_DEBUG invariant was violated."""


def enabled() -> bool:
    """Whether ``BICOS_DEBUG`` is set, read at call time so that tests and
    sessions can toggle it."""
    return os.environ.get("BICOS_DEBUG", "") not in ("", "0")


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a tensor, on any device
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def check_descriptor_words(words, nbits: int) -> None:
    """Bitfield-overflow check: the bits at or beyond ``nbits`` of the
    packed 32-bit words (LSB first, ``(..., nw)``, signed or unsigned) must
    be zero."""
    w = _host(words)
    if w.dtype == np.int32:
        w = w.view(np.uint32)
    nw = w.shape[-1]
    if nbits > 32 * nw:
        raise BicosDebugError(
            f"descriptor width {nbits} exceeds packed capacity {32 * nw}")
    full, rem = divmod(nbits, 32)
    bad = 0
    if full < nw and rem:
        bad += int((w[..., full] >> np.uint32(rem)).astype(bool).sum())
    if full + 1 < nw or (full < nw and not rem):
        start = full + (1 if rem else 0)
        bad += int(w[..., start:].astype(bool).sum())
    if bad:
        raise BicosDebugError(
            f"{bad} packed descriptor word(s) carry bits >= the declared "
            f"width {nbits} (bitfield overflow)")


def check_match_output(disp, corr, w: int, subpixel: bool) -> None:
    """Check a ``match`` result against its geometric and numeric
    ranges."""
    d = _host(disp)
    if d.dtype == np.int16:
        invalid = d == np.int16(-32768)
        vals = d[~invalid].astype(np.int64)
        lo, hi = -(w - 1), w - 1
    else:
        invalid = np.isnan(d)
        vals = d[~invalid]
        margin = 1.0 if subpixel else 0.0
        lo, hi = -(w - 1) - margin, (w - 1) + margin
    if vals.size and (vals.min() < lo or vals.max() > hi):
        raise BicosDebugError(
            f"disparity out of range [{lo}, {hi}]: "
            f"min={vals.min()} max={vals.max()}")
    if corr is not None:
        c = _host(corr)
        cv = c[~np.isnan(c)]
        if cv.size and (cv.min() < -1.0 - CORR_SLACK
                        or cv.max() > 1.0 + CORR_SLACK):
            raise BicosDebugError(
                f"NXCORR out of [-1, 1] (+/-{CORR_SLACK}): "
                f"min={cv.min()} max={cv.max()}")
