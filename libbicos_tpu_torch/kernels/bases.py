"""Dynamic-window bases kernel (``csrc/bases.cu``).

The Hopper counterpart of the Pallas
``libbicos_tpu/kernels/agree.py::_bases_kernel`` (via
``_chunk_window_bases_pallas``), which also stands for the same values
emitted by the TPU search kernel's epilogue and the agree kernel's
in-kernel mode. Its plain version is
:func:`libbicos_tpu_torch.agree.chunk_window_bases`.
"""

from __future__ import annotations

import functools

import torch

from . import _build


@functools.cache
def _entry():
    """The C entry point, looked up once: the kernel takes a few
    microseconds, so the wrapper's own host work counts."""
    return _build.library().bicos_chunk_window_bases


def chunk_window_bases_cuda(disp: torch.Tensor, w: int, wp: int, wcap: int,
                            chunk: int) -> torch.Tensor:
    """Per (row, ``chunk`` columns) window base or -1: ``(H, wp // chunk)``
    int32 for an ``(H, W)`` int16 CUDA disparity (see
    :func:`libbicos_tpu_torch.agree.chunk_window_bases`)."""
    _build.require_cuda("chunk_window_bases_cuda", disp)
    if disp.dtype != torch.int16 or disp.dim() != 2:
        raise ValueError("disp must be an (H, W) int16 tensor")
    h, wd = disp.shape
    if chunk < 1 or wp % chunk or wd > wp or not 1 <= w <= 1 << 30:
        raise ValueError(f"bad window: W={wd}, w={w}, wp={wp}, "
                         f"chunk={chunk}")
    out = torch.empty((h, wp // chunk), dtype=torch.int32, device=disp.device)
    if out.numel() == 0:
        return out
    rc = _entry()(
        disp.device.index, disp.data_ptr(), out.data_ptr(), h, wd, w, wp,
        wcap, chunk, _build.stream_of(disp))
    _build.check(rc, "bases")
    _build.count_launch("bases")
    return out
