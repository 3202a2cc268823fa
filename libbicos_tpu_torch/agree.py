"""NXCORR validation ("agree") and subpixel refinement, plain PyTorch.

Same semantics as ``libbicos_tpu.agree`` (and the reference's
``agree.hpp``):

* NXCORR at the matched column ``col1 = col - d``; a variance below
  ``minvar`` (already scaled by n) gives -1; pixels below the threshold
  become invalid; out-of-bounds matches are invalid and leave the corrmap
  NaN.
* A zero-variance series without ``minvar`` gives NaN, and ``NaN <
  threshold`` is false, so the pixel is kept.
* Subpixel: a per-shot parabola through the right samples at col1-1, col1,
  col1+1, swept over the f32-accumulated x grid; samples are rounded half
  to even and cast modularly to the input width before NXCORR; only a
  strictly better NXCORR moves the best x; border columns fall back to the
  integer check.

Every sum is a Python loop over shots, so it runs serially in shot order,
each product rounded before its add (the JAX XLA path's arithmetic).
``precision`` picks the compute type of the statistics, the NXCORR, the
minvar and the threshold tests: float32 (SINGLE) or float64 (DOUBLE, as
``libbicos_tpu.agree``'s XLA path). The parabola, the x grid, the rounding
and the modular cast stay float32 in both, and the corrmap is returned as
float32.

:func:`chunk_window_bases` computes the dynamic-window bases the agree
kernel's windowed variant reads (``libbicos_tpu.kernels.agree
._chunk_window_bases``). This module is the plain version beside the agree
and bases kernels (``kernels/agree.py``, ``kernels/bases.py``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .config import Precision
from .profiling import span

INVALID_I16 = -32768


def subpixel_xgrid(step: float) -> List[float]:
    """The reference's f32-accumulated sweep ``for (x = -1; x <= 1; x +=
    step)``; at step 0.1 the drift drops x = 1.0 (20 values)."""
    xs = []
    x = np.float32(-1.0)
    while x <= np.float32(1.0):
        xs.append(float(x))
        x = np.float32(x + np.float32(step))
    return xs


def _compute_dtype(precision: Precision) -> torch.dtype:
    return torch.float64 if precision == Precision.DOUBLE else torch.float32


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to ``like``'s dtype, as a 0-d tensor on its device."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32, device=device)


def _stats(series: torch.Tensor):
    """``(n, H, W)`` float series -> (diff ``(n, H, W)``, var ``(H, W)``),
    in the series' dtype."""
    n = series.shape[0]
    mean = torch.zeros_like(series[0])
    for t in range(n):
        mean = mean + series[t]
    mean = mean / _const(n, series)
    diff = series - mean
    var = torch.zeros_like(mean)
    for t in range(n):
        var = var + diff[t] * diff[t]
    return diff, var


def _nxcorr_from(diff0, var0, series1, minvar: Optional[float]):
    """NXCORR of cached left stats against a right series, in ``var0``'s
    dtype (``series1`` is cast to it)."""
    diff1, var1 = _stats(series1.to(var0.dtype))
    covar = torch.zeros_like(var0)
    for t in range(diff0.shape[0]):
        covar = covar + diff0[t] * diff1[t]
    nxc = covar / torch.sqrt(var0 * var1)
    if minvar is not None:
        mv = _const(minvar, var0)
        nxc = torch.where((var0 < mv) | (var1 < mv), _const(-1.0, var0), nxc)
    return nxc


def _matched(disp: torch.Tensor, w: int, w1: int):
    d = disp.to(torch.int32)
    col = torch.arange(w, dtype=torch.int32, device=disp.device)[None, :]
    col1 = col - d
    keep = (disp != INVALID_I16) & (col1 >= 0) & (col1 < w1)
    return d, keep, col1.clamp(0, w1 - 1)


def _gather_cols(stack_i32: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``stack[t, r, cols[r, c]]`` for every shot -> ``(n, H, W)`` int32."""
    idx = cols.to(torch.int64)[None].expand(stack_i32.shape[0], -1, -1)
    return torch.gather(stack_i32, 2, idx)


def agree_integer(disp: torch.Tensor, stack0: torch.Tensor,
                  stack1: torch.Tensor, threshold: float,
                  minvar: Optional[float], col_offset: int = 0,
                  precision: Precision = Precision.SINGLE):
    """Integer-disparity NXCORR validation.

    ``disp``: ``(H, W)`` int16 (-32768 invalid); ``stack0`` ``(n, H, W)``
    and ``stack1`` ``(n, H, W1)`` u8/u16 (``W1 > W`` for a left column
    band against the whole right row). ``col_offset`` is added to each
    kept disparity (see :func:`agree_subpixel`). Returns (int16
    disparity, f32 corrmap with NaN where not computed)."""
    dt = _compute_dtype(precision)
    _, h, w = stack0.shape
    w1 = stack1.shape[2]
    d, keep, col1c = _matched(disp, w, w1)
    s1sel = _gather_cols(stack1.to(torch.int32), col1c).to(dt)
    diff0, var0 = _stats(stack0.to(torch.int32).to(dt))
    nxc = _nxcorr_from(diff0, var0, s1sel, minvar)
    nan = _f32(float("nan"), disp.device)
    corr = torch.where(keep, nxc.to(torch.float32), nan)
    with span("bicos.agree_finish"):
        final = keep & ~(nxc < _const(threshold, nxc))
        out = torch.where(final, d + col_offset, INVALID_I16).to(torch.int16)
    return out, corr


def agree_subpixel(disp: torch.Tensor, stack0: torch.Tensor,
                   stack1: torch.Tensor, threshold: float, step: float,
                   minvar: Optional[float], col_offset: int = 0,
                   precision: Precision = Precision.SINGLE):
    """Subpixel parabola-sweep NXCORR validation.

    ``col_offset``: the global column of ``disp``'s band on the W-banded
    path, where ``disp`` is band-local (``col - disp`` indexes the whole
    right row ``stack1``). The output is ``float32(d + col_offset) -
    best_x``, the offset added in exact integers before the one float
    rounding, as ``libbicos_tpu.agree.agree_subpixel`` does: adding it to
    the float output rounds twice and can land 1 ulp off the single-card
    value (step 0.1).

    Returns (f32 disparity with NaN invalid, f32 corrmap)."""
    dt = _compute_dtype(precision)
    dev = disp.device
    mod = 0xFFFF if stack0.dtype == torch.uint16 else 0xFF
    _, h, w = stack0.shape
    w1 = stack1.shape[2]
    d, keep, col1c = _matched(disp, w, w1)
    border = (col1c == 0) | (col1c == w1 - 1)

    s1 = stack1.to(torch.int32)
    y1 = _gather_cols(s1, col1c).to(torch.float32)
    y0 = _gather_cols(s1, (col1c - 1).clamp(0, w1 - 1)).to(torch.float32)
    y2 = _gather_cols(s1, (col1c + 1).clamp(0, w1 - 1)).to(torch.float32)
    diff0, var0 = _stats(stack0.to(torch.int32).to(dt))

    half, two = _f32(0.5, dev), _f32(2.0, dev)
    pa = half * (y0 - two * y1 + y2)
    pb = half * (y2 - y0)

    best = torch.full((h, w), -1.0, dtype=dt, device=dev)
    best_x = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for x in subpixel_xgrid(step):
        xf = _f32(x, dev)
        # (a*x)*x, left to right like the reference; round half to even,
        # then the modular cast to the input width.
        v = torch.round(((pa * xf) * xf + pb * xf) + y1)
        interp = (v.to(torch.int32) & mod).to(torch.float32)
        nxc = _nxcorr_from(diff0, var0, interp, minvar)
        upd = best < nxc
        best = torch.where(upd, nxc, best)
        best_x = torch.where(upd, xf, best_x)

    nxc_border = _nxcorr_from(diff0, var0, y1, minvar)
    corr_val = torch.where(border, nxc_border, best)
    nan = _f32(float("nan"), dev)
    corr = torch.where(keep, corr_val.to(torch.float32), nan)
    final = keep & ~(corr_val < _const(threshold, corr_val))
    dg = (d + col_offset).to(torch.float32)  # exact int add, one rounding
    ret = torch.where(border, dg, dg - best_x)
    out = torch.where(final, ret, nan)
    return out, corr


def chunk_window_bases(disp: torch.Tensor, w: int, wp: int, wcap: int,
                       chunk: int) -> torch.Tensor:
    """Per (row, ``chunk`` left columns) dynamic-window base, or -1.

    ``disp``: ``(H, W)`` int16 (-32768 invalid), ``W <= wp``; columns past
    ``W`` count as invalid. Over the kept pixels of a chunk (valid and
    ``0 <= col1 < w``, ``col1 = col - d``) take ``lo = min(col1)`` and ``hi
    = max(col1)`` (``w - 1`` and 0 where none is kept); the base is
    ``min(lo, wp - wcap) & ~127``, or -1 unless ``hi <= base + wcap - 1``.
    Returns ``(H, wp // chunk)`` int32. Integer torch ops only; the same
    values as ``libbicos_tpu.kernels.agree._chunk_window_bases``."""
    h, wd = disp.shape
    if wd > wp or wp % chunk:
        raise ValueError(f"need W <= wp and wp % chunk == 0, got W={wd}, "
                         f"wp={wp}, chunk={chunk}")
    d = torch.full((h, wp), INVALID_I16, dtype=torch.int32,
                   device=disp.device)
    d[:, :wd] = disp.to(torch.int32)
    col = torch.arange(wp, dtype=torch.int32, device=disp.device)[None, :]
    col1 = col - d
    keep = (d != INVALID_I16) & (col1 >= 0) & (col1 < w)
    col1c = col1.clamp(0, w - 1)
    nc = wp // chunk
    lo = torch.where(keep, col1c, w - 1).view(h, nc, chunk).amin(dim=2)
    hi = torch.where(keep, col1c, 0).view(h, nc, chunk).amax(dim=2)
    base = torch.minimum(lo, torch.tensor(wp - wcap, dtype=torch.int32,
                                          device=disp.device)) & ~127
    return torch.where(hi <= base + (wcap - 1), base, -1).to(torch.int32)
