"""NXCORR validation kernel (``csrc/agree.cu``).

The Hopper counterpart of the Pallas ``libbicos_tpu/kernels/agree.py``
kernels ``_agree_kernel`` and ``_agree_window_kernel`` (via
``agree_pallas``). Its plain versions are
:func:`libbicos_tpu_torch.agree.agree_integer` and
:func:`~libbicos_tpu_torch.agree.agree_subpixel`;
:func:`libbicos_tpu_torch.pipeline.agree_stage` chooses between them. The
kernel computes in float32 (SINGLE) or float64 (DOUBLE, ``precision``),
and reads the right series from global memory or, with per (row, chunk)
``bases`` (the dynamic window, ``BICOS_AGREE_DYNWIN``), from a window of
them staged in shared memory; both variants run the same arithmetic, so
their results are equal bit for bit. Each thread caches its pixel's
per-shot terms in shared memory (``csrc/agree.cu``); the windowed block
puts them beside its window. The subpixel sweep computes each
interpolated sample once and keeps it packed in registers for the
covariance pass, in an instance per shot bucket (:func:`packed_bucket`);
the integer variant and the shapes past the buckets take the recomputing
sweep.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ..agree import subpixel_xgrid
from ..config import Precision
from . import _build

MAX_SHOTS = 65  # the LIMITED maximum (4n-7 <= 256)
# The packed sweep's shot buckets by sample type, as agree.cu instantiates
# them: a bucket's instance takes n from the bucket before it (exclusive)
# to its own (inclusive). DOUBLE has the u8 bucket 33 alone.
PACKED_BUCKETS = {torch.uint8: (16, 33, 65), torch.uint16: (16, 33)}
DOUBLE_BUCKETS = {torch.uint8: (33,), torch.uint16: ()}
DEFAULT_WINDOW = 640  # columns, for BICOS_AGREE_DYNWIN < 0
DEFAULT_CHUNK = 256  # left columns per window


def resolve_chunk_wcap(w: int, dynwin: int, chunk: int = 0
                       ) -> Tuple[int, int]:
    """``(chunk, wcap)`` of the dynamic window at image width ``w``;
    ``wcap == 0`` means off. The counterpart of ``libbicos_tpu.kernels
    .agree.resolve_chunk_wcap`` without its gather test: the window is on
    when ``dynwin`` is nonzero (``< 0``: 640 columns) and ``chunk`` (0: 256)
    fits it, ``wcap % 128 == 0``, ``wcap >= chunk + 128`` and the padded
    width ``wp = pad(w, chunk)`` exceeds ``wcap``."""
    c = chunk or DEFAULT_CHUNK
    if dynwin:
        wcap = dynwin if dynwin > 0 else DEFAULT_WINDOW
        wp = -(-w // c) * c
        if wcap % 128 == 0 and wcap >= c + 128 and wp > wcap:
            return c, wcap
    return c, 0


def agree_window(w: int) -> Tuple[int, int]:
    """:func:`resolve_chunk_wcap` from the environment, read at call time:
    ``BICOS_AGREE_DYNWIN`` (``"auto"`` or 0: off; columns, or < 0 for 640)
    and ``BICOS_AGREE_CHUNK`` (the window's chunk; 0: 256), with the JAX
    package's names and values."""
    dw = os.environ.get("BICOS_AGREE_DYNWIN", "auto")
    dynwin = 0 if dw == "auto" else int(dw)
    return resolve_chunk_wcap(w, dynwin,
                              int(os.environ.get("BICOS_AGREE_CHUNK", "0")))


def packed_bucket(n: int, dtype: torch.dtype, precision: Precision,
                  step: Optional[float]) -> int:
    """The shot bucket of ``agree.cu``'s packed sweep for ``n`` shots of
    ``dtype`` (the smallest in :data:`PACKED_BUCKETS` that holds ``n``), or
    0 for the recomputing sweep: with no ``step`` (the integer variant
    stores no samples), past the buckets (u16 above 33 shots, whose samples
    would not fit the registers), and in DOUBLE but in
    :data:`DOUBLE_BUCKETS` (the other instances spilled registers)."""
    if step is None:
        return 0
    bucket = next((b for b in PACKED_BUCKETS[dtype] if n <= b), 0)
    if precision == Precision.DOUBLE and bucket not in DOUBLE_BUCKETS[dtype]:
        return 0
    return bucket


def agree_cuda(disp: torch.Tensor, stack0: torch.Tensor,
               stack1: torch.Tensor, threshold: float,
               step: Optional[float], minvar: Optional[float],
               col_offset: int = 0, *, bases: Optional[torch.Tensor] = None,
               chunk: int = 0, wcap: int = 0,
               precision: Precision = Precision.SINGLE):
    """Returns (f32 disparity with NaN where invalid, f32 corrmap with NaN
    where not computed); ``step=None`` is the integer variant, whose
    disparities stay integer-valued.

    ``disp``: ``(H, W)`` int16 (-32768 invalid); ``stack0``: ``(n, H, W)``
    and ``stack1``: ``(n, H, W1)``, u8/u16 of one dtype; ``W1 > W`` and
    ``col_offset`` serve a left column band on the W-banded path (see
    :func:`libbicos_tpu_torch.agree.agree_subpixel`). ``bases``: ``(H, wp //
    chunk)`` int32 from :func:`~libbicos_tpu_torch.agree.chunk_window_bases`
    for the windowed variant (``W1 == W``, ``col_offset == 0``); a chunk
    whose base is -1 reads global memory. Every tensor lies on one CUDA
    device."""
    _build.require_cuda("agree_cuda", disp, stack0, stack1,
                        *(() if bases is None else (bases,)))
    if (stack0.dim() != 3 or stack1.dim() != 3
            or stack0.shape[:2] != stack1.shape[:2]):
        raise ValueError("stacks must be (n, H, W) and (n, H, W1)")
    if stack0.dtype != stack1.dtype or stack0.dtype not in (torch.uint8,
                                                            torch.uint16):
        raise ValueError("stacks must both be uint8 or both uint16")
    n, h, w = stack0.shape
    w1 = stack1.shape[2]
    u16 = stack0.dtype == torch.uint16
    if disp.dtype != torch.int16 or tuple(disp.shape) != (h, w):
        raise ValueError(f"disp must be an ({h}, {w}) int16 tensor")
    if not 2 <= n <= MAX_SHOTS:
        raise ValueError(f"n={n} shots: the kernel takes 2 to {MAX_SHOTS}")
    if abs(col_offset) >= 1 << 30:
        raise ValueError(f"col_offset {col_offset} overflows the kernel's int")
    dev = disp.device
    nc = 0
    if bases is not None:
        if w1 != w or col_offset:
            raise ValueError("the windowed agree takes W1 == W and "
                             "col_offset == 0 only")
        if not 1 <= chunk <= 1024 or wcap % 128 or wcap < chunk + 128:
            raise ValueError(f"bad window: chunk={chunk}, wcap={wcap}")
        nc = -(-w // chunk)
        if bases.dtype != torch.int32 or tuple(bases.shape) != (h, nc):
            raise ValueError(f"bases must be an ({h}, {nc}) int32 tensor")
        # One block stages n shots of the columns [base - 1, base + wcap]
        # (padded to 16 bytes) beside at least one thread's cached shot
        # terms (16 bytes a shot, 24 in DOUBLE).
        window = -(-n * (wcap + 2) * stack0.element_size() // 16) * 16
        need = window + n * (24 if precision == Precision.DOUBLE else 16)
        limit = _build.library().bicos_smem_optin(dev.index)
        if limit < 0:
            _build.check(-limit, "agree")
        if need > limit:
            raise RuntimeError(
                f"the agree window needs {need} bytes of shared memory "
                f"(n={n}, wcap={wcap}); the device allows {limit}")
    packed = packed_bucket(n, stack0.dtype, precision, step)
    xs = torch.tensor(subpixel_xgrid(step) if step is not None else [],
                      dtype=torch.float32, device=dev)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    corr = torch.empty_like(out)
    if h * w == 0:
        return out, corr
    rc = _build.library().bicos_agree(
        dev.index, disp.data_ptr(), stack0.data_ptr(), stack1.data_ptr(),
        xs.data_ptr() if xs.numel() else None, xs.numel(),
        out.data_ptr(), corr.data_ptr(), n, h, w, w1, int(col_offset),
        int(u16), float(threshold),
        0.0 if minvar is None else float(minvar), int(minvar is not None),
        int(precision == Precision.DOUBLE), packed,
        None if bases is None else bases.data_ptr(), nc, int(chunk),
        int(wcap), _build.stream_of(disp))
    _build.check(rc, "agree")
    _build.count_launch("agree")
    if packed:
        _build.count_launch("agree_packed")
    if precision == Precision.DOUBLE:
        _build.count_launch("agree_double")
    return out, corr
