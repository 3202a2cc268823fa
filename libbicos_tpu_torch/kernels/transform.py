"""Descriptor transform kernel (``csrc/transform.cu``).

The Hopper counterpart of ``libbicos_tpu/kernels/transform.py``
(``_transform_kernel``) and of the descriptor half of the fused Pallas
stack search (``kernels/hamming.py::_minima_kernel_bf16_stack``). Its plain
version is :func:`libbicos_tpu_torch.descriptor.descriptor_words`;
:func:`libbicos_tpu_torch.search.transform_words` chooses between them.
"""

from __future__ import annotations

import torch

from ..config import TransformMode, validate_stack
from ..descriptor import n_words_for
from . import _build


def descriptor_words_cuda(stack: torch.Tensor,
                          mode: TransformMode) -> torch.Tensor:
    """``(n, H, W)`` u8/u16 CUDA stack -> ``(H, W, nw)`` int32 packed
    words."""
    _build.require_cuda("descriptor_words_cuda", stack)
    if stack.dim() != 3 or stack.dtype not in (torch.uint8, torch.uint16):
        raise ValueError("stack must be an (n, H, W) uint8 or uint16 tensor")
    n, h, w = stack.shape
    nw = n_words_for(validate_stack(n, mode))
    words = torch.empty((h, w, nw), dtype=torch.int32, device=stack.device)
    if h * w == 0:
        return words
    rc = _build.library().bicos_transform(
        stack.device.index, stack.data_ptr(), words.data_ptr(), n, h, w,
        int(stack.dtype == torch.uint16), int(mode == TransformMode.FULL),
        nw, _build.stream_of(stack))
    _build.check(rc, "transform")
    _build.count_launch("transform")
    return words
