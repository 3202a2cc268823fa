"""Fused forward + reverse scan kernel for the Consistency search
(``csrc/consistency.cu``).

:func:`row_minima_consistency_words` is the Hopper counterpart of the
Pallas ``_consistency_kernel`` and its int8 twin ``_consistency_kernel_i8``
in ``libbicos_tpu/kernels/hamming.py`` (via
``row_minima_consistency_words``), and after the transform kernel on both
stacks, of ``_consistency_kernel_bf16_stack``, its twin
``_consistency_kernel_i8_stack`` and ``_consistency_kernel_bf16_stack_range``
(via ``row_minima_consistency_stack`` and
``row_minima_consistency_stack_range``).

It returns ``((None, first0, last0), (None, rc0, rc0_last))`` as the JAX
wrappers do: ``rc0[h, c0]`` is the reverse first argmin of right column
``first0[h, c0]``; ``last0`` and ``rc0_last`` are None without
``no_dupes``. Where the forward side has no candidate in range,
``first0, last0, rc0, rc0_last`` are ``-1, -2, -1, -2``. The plain version
is :func:`libbicos_tpu_torch.search.row_minima_consistency_torch_words`;
``search._scan`` (behind :func:`libbicos_tpu_torch.search.search_words`)
chooses between them.
"""

from __future__ import annotations

import torch

from . import _build
from .hamming import check_words, range_args


def row_minima_consistency_words(words0: torch.Tensor, words1: torch.Tensor,
                                 *, no_dupes: bool, drange=None):
    """Consistency scan from ``(H, W0, nw)`` and ``(H, W1, nw)`` int32
    words on one CUDA device."""
    h, w0, w1, nw = check_words("row_minima_consistency_words", words0,
                                words1)
    has_range, dmin, dmax = range_args(drange, w0, w1)
    dev = words0.device
    lib = _build.library()
    need = lib.bicos_consistency_needs_scratch(dev.index, w1, nw,
                                               int(no_dupes))
    if need < 0:
        _build.check(-need, "consistency")
    scratch = (torch.empty((h, 2, w1), dtype=torch.int32, device=dev)
               if need else None)
    first0 = torch.empty((h, w0), dtype=torch.int32, device=dev)
    rc0 = torch.empty_like(first0)
    last0 = torch.empty_like(first0) if no_dupes else None
    rc0_last = torch.empty_like(first0) if no_dupes else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.bicos_consistency(
        dev.index, words0.data_ptr(), words1.data_ptr(), ptr(first0),
        ptr(last0), ptr(rc0), ptr(rc0_last), ptr(scratch), h, w0, w1, nw,
        int(no_dupes), has_range, dmin, dmax, _build.stream_of(words0))
    _build.check(rc, "consistency")
    _build.count_launch("consistency")
    return (None, first0, last0), (None, rc0, rc0_last)
