"""Hamming row-scan kernel (``csrc/hamming.cu``).

:func:`row_minima_words` is the Hopper counterpart of the Pallas
``libbicos_tpu/kernels/hamming.py::_minima_kernel`` and its int8 twin
``_minima_kernel_i8`` (via ``row_minima_pallas_words``), and after the
transform kernel on both stacks, of the fused ``_minima_kernel_bf16_stack``,
its twin ``_minima_kernel_i8_stack`` and ``_minima_kernel_bf16_stack_range``
(via ``row_minima_stack`` and ``row_minima_stack_range``). Its plain version
is :func:`libbicos_tpu_torch.search.row_minima_torch_words`;
``search._scan`` (behind :func:`libbicos_tpu_torch.search.search_words`)
chooses between them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build


def check_words(name: str, words0: torch.Tensor, words1: torch.Tensor):
    """Check two CUDA word tensors for the scan kernels; returns
    ``(h, w0, w1, nw)``."""
    _build.require_cuda(name, words0, words1)
    if (words0.dim() != 3 or words1.dim() != 3
            or words0.dtype != torch.int32 or words1.dtype != torch.int32):
        raise ValueError("words must be (H, W, nw) int32 tensors")
    h, w0, nw = words0.shape
    if words1.shape[0] != h or words1.shape[2] != nw:
        raise ValueError(
            f"words shapes disagree: {tuple(words0.shape)} vs "
            f"{tuple(words1.shape)}")
    w1 = words1.shape[1]
    if not 1 <= nw <= 8:
        raise ValueError(f"{nw} descriptor words: the kernel takes 1 to 8")
    if h * w0 * w1 == 0:
        raise ValueError(f"{name} needs non-empty rows")
    if max(w0, w1) > 1 << 22:
        raise ValueError(f"image width {max(w0, w1)} > {1 << 22}")
    return h, w0, w1, nw


def range_args(drange, w0: int, w1: int) -> Tuple[int, int, int]:
    """``(has_range, dmin, dmax)`` for a kernel, with the bounds clamped
    into ``[-w1, w0]``: every pair has ``-w1 < col0 - col1 < w0``, so the
    clamp keeps the set of in-range pairs (empty ones stay empty) and keeps
    the kernels' window arithmetic inside int32."""
    if drange is None:
        return 0, 0, 0
    dmin, dmax = (int(v) for v in drange)
    if dmin > dmax:
        raise ValueError(f"drange needs dmin <= dmax, got {drange!r}")
    return 1, min(max(dmin, -w1), w0), min(max(dmax, -w1), w0)


def row_minima_words(
    words0: torch.Tensor, words1: torch.Tensor, need_last: bool,
    drange=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """First (and, with ``need_last``, last) right column of least Hamming
    distance for every left pixel: ``(H, W0)`` int32 each; ``last`` is None
    without ``need_last``. ``drange = (dmin, dmax)`` restricts the search to
    ``dmin <= col0 - col1 <= dmax``; a pixel with no candidate gets
    ``first = -1, last = -2``.

    ``words0``: ``(H, W0, nw)`` int32, ``words1``: ``(H, W1, nw)`` int32,
    on one CUDA device. Without a range the scan runs on the 1-bit tensor
    cores (launch key ``hamming_mma`` beside ``hamming``); with one, on the
    popcount pipe."""
    h, w0, w1, nw = check_words("row_minima_words", words0, words1)
    has_range, dmin, dmax = range_args(drange, w0, w1)
    first = torch.empty((h, w0), dtype=torch.int32, device=words0.device)
    last = torch.empty_like(first) if need_last else None
    rc = _build.library().bicos_row_minima(
        words0.device.index, words0.data_ptr(), words1.data_ptr(),
        first.data_ptr(), last.data_ptr() if need_last else None,
        h, w0, w1, nw, int(need_last), has_range, dmin, dmax,
        _build.stream_of(words0))
    _build.check(rc, "hamming")
    _build.count_launch("hamming")
    if not has_range:
        _build.count_launch("hamming_mma")
    return first, last
