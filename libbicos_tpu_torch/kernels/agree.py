"""NXCORR validation kernel (``csrc/agree.cu``).

The Hopper counterpart of the Pallas ``libbicos_tpu/kernels/agree.py``
kernels ``_agree_kernel`` and ``_agree_window_kernel`` (via
``agree_pallas``). Its plain versions are
:func:`libbicos_tpu_torch.agree.agree_integer` and
:func:`~libbicos_tpu_torch.agree.agree_subpixel`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import agree as _agree
from . import _build

MAX_SHOTS = 65  # the LIMITED maximum (4n-7 <= 256)


def agree_cuda(disp: torch.Tensor, stack0: torch.Tensor,
               stack1: torch.Tensor, threshold: float,
               step: Optional[float], minvar: Optional[float],
               col_offset: int = 0):
    """Returns (f32 disparity with NaN where invalid, f32 corrmap with NaN
    where not computed); ``step=None`` is the integer variant, whose
    disparities stay integer-valued.

    ``disp``: ``(H, W)`` int16 (-32768 invalid); ``stack0``: ``(n, H, W)``
    and ``stack1``: ``(n, H, W1)``, u8/u16 of one dtype; ``W1 > W`` and
    ``col_offset`` serve a left column band on the W-banded path (see
    :func:`libbicos_tpu_torch.agree.agree_subpixel`). CPU tensors go
    through the plain versions; CUDA tensors launch the kernel."""
    if all(t.device.type == "cpu" for t in (disp, stack0, stack1)):
        if step is not None:
            return _agree.agree_subpixel(disp, stack0, stack1, threshold,
                                         step, minvar, col_offset)
        out, corr = _agree.agree_integer(disp, stack0, stack1, threshold,
                                         minvar, col_offset)
        nan = torch.tensor(float("nan"), dtype=torch.float32)
        return torch.where(out == _agree.INVALID_I16, nan,
                           out.to(torch.float32)), corr
    _build.require_cuda("agree_cuda", disp, stack0, stack1)
    if (stack0.dim() != 3 or stack1.dim() != 3
            or stack0.shape[:2] != stack1.shape[:2]):
        raise ValueError("stacks must be (n, H, W) and (n, H, W1)")
    if stack0.dtype != stack1.dtype or stack0.dtype not in (torch.uint8,
                                                            torch.uint16):
        raise ValueError("stacks must both be uint8 or both uint16")
    n, h, w = stack0.shape
    w1 = stack1.shape[2]
    if disp.dtype != torch.int16 or tuple(disp.shape) != (h, w):
        raise ValueError(f"disp must be an ({h}, {w}) int16 tensor")
    if not 2 <= n <= MAX_SHOTS:
        raise ValueError(f"n={n} shots: the kernel takes 2 to {MAX_SHOTS}")
    if abs(col_offset) >= 1 << 30:
        raise ValueError(f"col_offset {col_offset} overflows the kernel's int")
    dev = disp.device
    xs = torch.tensor(_agree.subpixel_xgrid(step) if step is not None else [],
                      dtype=torch.float32, device=dev)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    corr = torch.empty_like(out)
    if h * w == 0:
        return out, corr
    rc = _build.library().bicos_agree(
        dev.index, disp.data_ptr(), stack0.data_ptr(), stack1.data_ptr(),
        xs.data_ptr() if xs.numel() else None, xs.numel(),
        out.data_ptr(), corr.data_ptr(), n, h, w, w1, int(col_offset),
        int(stack0.dtype == torch.uint16), float(np.float32(threshold)),
        0.0 if minvar is None else float(np.float32(minvar)),
        int(minvar is not None), _build.stream_of(disp))
    _build.check(rc, "agree")
    _build.count_launch("agree")
    return out, corr
