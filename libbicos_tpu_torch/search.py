"""Binary correspondence search: per-row Hamming-distance argmin.

For every left pixel, scan the whole right epipolar row and take the
column of least Hamming distance between packed descriptors; NoDuplicates
invalidates a pixel whose minimum is not unique, i.e. whose first and last
argmin differ. Same semantics as ``libbicos_tpu.search``.

:func:`row_minima_torch_words` is the plain scan, the version beside the
kernel in ``kernels/hamming.py``. Torch has no popcount op: the XOR-ed
int32 words are viewed as bytes and summed through a 256-entry table. The
argmin packs ``cost * K + col`` (first) and ``cost * K + (W1-1-col)``
(last) into int32 and takes plain minima; ``K = 32768``, widened to the
next power of two for wider rows, is exact in int32 up to a width of 2^22
(cost <= 256). Rows and, for very wide rows, columns are chunked so that
one ``(R, W0, C)`` int32 cost slab stays near 256 MiB.

Backends: ``"torch"`` is the plain version (CPU or GPU), ``"cuda"`` the
hand-written kernels, and ``"auto"`` picks ``"cuda"`` for CUDA tensors and
``"torch"`` otherwise.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .config import NoDuplicates, SearchVariant, TransformMode
from .descriptor import descriptor_words

INVALID_I16 = -32768
PACK_K = 32768
BACKENDS = ("auto", "torch", "cuda")
# Left-right pairs per chunk of the plain scan: a 256 MiB int32 cost slab.
PAIR_BUDGET = 1 << 26


def resolve_backend(backend: str, *tensors: torch.Tensor) -> str:
    """``"auto"`` -> ``"cuda"`` when the first tensor is on a CUDA device,
    else ``"torch"``. ``"cuda"`` raises unless every tensor lies on a CUDA
    device: it never carries on on the CPU."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "auto":
        return "cuda" if tensors[0].device.type == "cuda" else "torch"
    if backend == "cuda" and any(t.device.type != "cuda" for t in tensors):
        raise RuntimeError(
            "backend='cuda' needs CUDA tensors; got "
            f"{[str(t.device) for t in tensors]}")
    return backend


@functools.lru_cache(maxsize=None)
def _popcount_table(device: torch.device) -> torch.Tensor:
    return torch.tensor([bin(i).count("1") for i in range(256)],
                        dtype=torch.uint8, device=device)


def _hamming(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """``(R, W0, nw)`` x ``(R, C, nw)`` int32 words -> ``(R, W0, C)`` int32
    Hamming distances."""
    r, wid0, nw = w0.shape
    c = w1.shape[1]
    table = _popcount_table(w0.device)
    cost = torch.zeros((r, wid0, c), dtype=torch.int32, device=w0.device)
    for k in range(nw):
        x = w0[:, :, None, k] ^ w1[:, None, :, k]
        pop = table[x.view(torch.uint8).to(torch.int32)]
        cost += pop.view(r, wid0, c, 4).sum(dim=-1, dtype=torch.int32)
    return cost


def decode_packed_minima(mf, ml, w1: int, need_last: bool,
                         pack_k: int = PACK_K):
    """Decode ``mf = cost*pack_k + col`` and ``ml = cost*pack_k + (w1-1-col)``
    into ``(cost, first, last-or-None)``."""
    cost = mf // pack_k
    first = mf - cost * pack_k
    last = (w1 - 1) - (ml - (ml // pack_k) * pack_k) if need_last else None
    return cost, first, last


def row_minima_torch_words(
    words0: torch.Tensor, words1: torch.Tensor, need_last: bool,
    pair_budget: int = PAIR_BUDGET,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain scan: ``(cost, first, last-or-None)``, each ``(H, W0)`` int32,
    for ``(H, W0, nw)`` and ``(H, W1, nw)`` int32 words."""
    h, w0, _ = words0.shape
    w1 = words1.shape[1]
    pack_k = PACK_K if w1 <= PACK_K else 1 << (w1 - 1).bit_length()
    if pack_k > 1 << 22:
        raise ValueError(
            f"image width {w1} > {1 << 22} overflows the int32 cost packing")
    cols = w1 if w0 * w1 <= pair_budget else max(1, pair_budget // w0)
    rows = max(1, pair_budget // (w0 * cols))
    big = torch.iinfo(torch.int32).max
    mf = torch.full((h, w0), big, dtype=torch.int32, device=words0.device)
    ml = torch.full_like(mf, big)
    for r0 in range(0, h, rows):
        rs = slice(r0, min(h, r0 + rows))
        for c0 in range(0, w1, cols):
            cs = slice(c0, min(w1, c0 + cols))
            cost = _hamming(words0[rs], words1[rs, cs]) * pack_k
            col = torch.arange(cs.start, cs.stop, dtype=torch.int32,
                               device=words0.device)
            mf[rs] = torch.minimum(mf[rs], (cost + col).amin(dim=-1))
            if need_last:
                ml[rs] = torch.minimum(
                    ml[rs], (cost + (w1 - 1 - col)).amin(dim=-1))
    return decode_packed_minima(mf, ml, w1, need_last, pack_k)


def _finish_nodupes(first: torch.Tensor, last: torch.Tensor,
                    w0: int) -> torch.Tensor:
    col0 = torch.arange(w0, dtype=torch.int32, device=first.device)[None, :]
    valid = (first == last) & (first >= 0)
    disp = torch.where(valid, col0 - first, INVALID_I16)
    return disp.to(torch.int16)


def _check_variant(variant: SearchVariant) -> None:
    if not isinstance(variant, NoDuplicates):
        raise NotImplementedError(
            f"{type(variant).__name__} search is not ported yet; "
            "only NoDuplicates is")


def search_words(words0: torch.Tensor, words1: torch.Tensor, nbits: int,
                 variant: SearchVariant,
                 backend: str = "auto") -> torch.Tensor:
    """Correspondence search on packed int32 words -> ``(H, W0)`` int16
    disparity (-32768 invalid). ``nbits`` is kept for parity with the JAX
    surface; the words carry their bits."""
    _check_variant(variant)
    backend = resolve_backend(backend, words0, words1)
    if backend == "cuda":
        from .kernels.hamming import row_minima_words

        first, last = row_minima_words(words0, words1, True)
    else:
        _, first, last = row_minima_torch_words(words0, words1, True)
    return _finish_nodupes(first, last, words0.shape[1])


def search_stack(stack0: torch.Tensor, stack1: torch.Tensor,
                 mode: TransformMode, variant: SearchVariant,
                 backend: str = "auto") -> torch.Tensor:
    """Correspondence search straight from ``(n, H, W)`` stacks -> int16
    disparity: transform kernel + scan kernel on ``"cuda"``, the plain
    transform and scan on ``"torch"``."""
    _check_variant(variant)
    backend = resolve_backend(backend, stack0, stack1)
    if backend == "cuda":
        from .kernels.hamming import row_minima_stack

        _, first, last = row_minima_stack(stack0, stack1, mode=mode,
                                          need_last=True)
    else:
        _, first, last = row_minima_torch_words(
            descriptor_words(stack0, mode), descriptor_words(stack1, mode),
            True)
    return _finish_nodupes(first, last, stack0.shape[2])
