"""W-band ring step kernels (``csrc/band.cu``).

The Hopper counterparts of the Pallas ``libbicos_tpu/kernels/hamming.py``
kernels ``_minima_kernel_band`` (via ``row_minima_words_band``) and, after
the transform kernel on each band, ``_minima_kernel_band_stack`` (via
``row_minima_stack_band``):

* :func:`row_minima_band`, the NoDuplicates step (launch key ``band``);
  its plain version is
  :func:`libbicos_tpu_torch.search.row_minima_band_torch_words`;
* :func:`row_minima_consistency_band`, the fused Consistency step (launch
  key ``band_consistency``), which folds the forward minima of the held
  band and the reverse minima of the visiting band from one pass over the
  pairs, where the TPU runs a second ring; its plain version is
  :func:`libbicos_tpu_torch.search.row_minima_consistency_band_torch_words`.

``sharding._ring_minima`` and ``sharding._ring_consistency`` choose
between each kernel and its plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import PACK_K
from . import _build
from .hamming import check_words, range_args


def row_minima_band(words0: torch.Tensor, words1: torch.Tensor, off0: int,
                    off1: int, mf: torch.Tensor, ml: Optional[torch.Tensor],
                    *, w1_total: int, drange=None) -> None:
    """Fold one visiting right band into a left band's running minima, in
    place: ``mf = min(mf, cost * PACK_K + gcol)`` and, unless ``ml`` is
    None, ``ml = min(ml, cost * PACK_K + (w1_total-1-gcol))``.

    ``words0``: ``(H, W0b, nw)`` int32 left band at global column ``off0``;
    ``words1``: ``(H, band, nw)`` int32 right band at global column
    ``off1``; ``mf``/``ml``: ``(H, W0b)`` int32, started from
    ``config.BIG``, all on one CUDA device. Right columns at or past
    ``w1_total`` and pairs whose global ``col0 - col1`` lies outside
    ``drange`` are skipped."""
    accs = [t for t in (mf, ml) if t is not None]
    h, w0, band, nw = check_words("row_minima_band", words0, words1)
    _build.require_cuda("row_minima_band", words0, *accs)
    if any(t.dtype != torch.int32 or tuple(t.shape) != (h, w0)
           for t in accs):
        raise ValueError(f"mf/ml must be ({h}, {w0}) int32 tensors")
    if off1 < 0 or w1_total > PACK_K:
        raise ValueError(
            f"need off1 >= 0 and w1_total <= {PACK_K}, got {off1}, "
            f"{w1_total}")
    wid1 = max(0, min(band, w1_total - off1))
    # The global col0 - col1 = (off0 - off1) + (c0 - j) in band coordinates.
    shift = off0 - off1
    has_range, dmin, dmax = range_args(
        None if drange is None else (drange[0] - shift, drange[1] - shift),
        w0, wid1)
    rc = _build.library().bicos_row_minima_band(
        words0.device.index, words0.data_ptr(), words1.data_ptr(),
        mf.data_ptr(), None if ml is None else ml.data_ptr(), h, w0, band,
        wid1, nw, off1, w1_total, has_range, dmin, dmax,
        _build.stream_of(words0))
    _build.check(rc, "band")
    _build.count_launch("band")


def row_minima_consistency_band(words0: torch.Tensor, words1: torch.Tensor,
                                off0: int, off1: int, mf: torch.Tensor,
                                ml: Optional[torch.Tensor], rf: torch.Tensor,
                                rl: Optional[torch.Tensor], *, w_total: int,
                                drange=None) -> None:
    """Fold one visiting right band into a held left band's forward minima
    and into the reverse minima of the right columns, in place, from the
    same pairs: ``mf``/``ml`` as :func:`row_minima_band`, and ``rf = min(rf,
    cost * PACK_K + gcol0)``, ``rl = min(rl, cost * PACK_K + (w_total - 1 -
    gcol0))`` at the global right column ``gcol1``.

    ``words0``: ``(H, W0b, nw)`` int32 left band at global column ``off0``;
    ``words1``: ``(H, band, nw)`` int32 right band at global column
    ``off1``; ``mf``/``ml``: ``(H, W0b)`` int32; ``rf``/``rl``: ``(H, N)``
    int32 with ``N >= off1 + band`` (``ml`` and ``rl`` both None without
    last), all started from ``config.BIG`` on one CUDA device. Columns at
    or past ``w_total`` and pairs whose global ``col0 - col1`` lies outside
    ``drange`` are skipped."""
    fwd = [t for t in (mf, ml) if t is not None]
    rev = [t for t in (rf, rl) if t is not None]
    h, w0, band, nw = check_words("row_minima_consistency_band", words0,
                                  words1)
    _build.require_cuda("row_minima_consistency_band", words0, *fwd, *rev)
    if (ml is None) != (rl is None):
        raise ValueError("ml and rl must both be given or both be None")
    if any(t.dtype != torch.int32 or tuple(t.shape) != (h, w0) for t in fwd):
        raise ValueError(f"mf/ml must be ({h}, {w0}) int32 tensors")
    stride = rf.shape[1] if rf.dim() == 2 else -1
    if any(t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != h
           or t.shape[1] != stride for t in rev) or stride < off1 + band:
        raise ValueError(
            f"rf/rl must be ({h}, >= {off1 + band}) int32 tensors")
    if min(off0, off1) < 0 or w_total > PACK_K:
        raise ValueError(
            f"need off0, off1 >= 0 and w_total <= {PACK_K}, got {off0}, "
            f"{off1}, {w_total}")
    wid0 = max(0, min(w0, w_total - off0))
    wid1 = max(0, min(band, w_total - off1))
    shift = off0 - off1
    has_range, dmin, dmax = range_args(
        None if drange is None else (drange[0] - shift, drange[1] - shift),
        wid0, wid1)
    rc = _build.library().bicos_consistency_band(
        words0.device.index, words0.data_ptr(), words1.data_ptr(),
        mf.data_ptr(), None if ml is None else ml.data_ptr(), rf.data_ptr(),
        None if rl is None else rl.data_ptr(), h, w0, band, nw, off0, off1,
        w_total, stride, has_range, dmin, dmax, _build.stream_of(words0))
    _build.check(rc, "band_consistency")
    _build.count_launch("band_consistency")
