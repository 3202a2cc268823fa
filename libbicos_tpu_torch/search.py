"""Binary correspondence search: per-row Hamming-distance argmin.

For every left pixel, scan the whole right epipolar row and take the
column of least Hamming distance between packed descriptors; NoDuplicates
invalidates a pixel whose minimum is not unique, i.e. whose first and last
argmin differ. Consistency searches back from the best right column into
the left row and keeps the pixel iff the reverse argmin lands within
``max_lr_diff`` of it. ``drange = (dmin, dmax)`` (``Config.disparity_range``)
restricts both searches to the pairs with ``dmin <= col0 - col1 <= dmax``.
Same semantics as ``libbicos_tpu.search``.

:func:`row_minima_torch_words` is the plain scan, the version beside the
kernel in ``kernels/hamming.py``. Torch has no popcount op: the XOR-ed
int32 words are viewed as bytes and summed through a 256-entry table. The
argmin packs ``cost * K + col`` (first) and ``cost * K + (W1-1-col)``
(last) into int32 and takes plain minima; ``K = 32768``, widened to the
next power of two for wider rows, is exact in int32 up to a width of 2^22
(cost <= 256). Rows and, for very wide rows, columns are chunked so that
one ``(R, W0, C)`` int32 cost slab stays near 256 MiB. Out-of-range pairs
are replaced by ``BIG`` (decoded cost > 256), so a pixel with no candidate
decodes to the sentinels ``first = -1, last = -2``.

:func:`row_minima_consistency_torch_words` is the plain version beside the
fused forward + reverse kernel in ``kernels/consistency.py``: two plain
passes, the reverse one with the range reflected, then a gather at the
forward argmin.

Backends: ``"torch"`` is the plain version (CPU or GPU), ``"cuda"`` the
hand-written kernels, and ``"auto"`` picks ``"cuda"`` for CUDA tensors and
``"torch"`` otherwise. :func:`transform_words` and ``_scan`` (behind
:func:`search_words` and :func:`search_stack`) are where the transform and
the scan choose between the two, each inside its span (``bicos.transform``,
``bicos.scan``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .agree import chunk_window_bases
from .config import (
    BIG,
    PACK_K,
    Consistency,
    NoDuplicates,
    SearchVariant,
    TransformMode,
    validate_stack,
)
from .descriptor import descriptor_words, pack_bits
from .kernels.bases import chunk_window_bases_cuda
from .kernels.consistency import row_minima_consistency_words
from .kernels.hamming import row_minima_words
from .kernels.transform import descriptor_words_cuda
from .profiling import span

INVALID_I16 = -32768
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
        # reshape(-1): a size-1 last dim may carry any stride, which a
        # dtype view refuses.
        pop = table[x.reshape(-1).view(torch.uint8).to(torch.int32)]
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


def _fold_packed(words0, words1, mf, ml, *, off0: int, off1: int,
                 w1_total: int, pack_k: int, drange, pair_budget: int):
    """Fold ``cost * pack_k + gcol`` into ``mf`` and ``cost * pack_k +
    (w1_total-1-gcol)`` into ``ml`` (None: skipped) with a plain minimum,
    in place, for the left columns ``off0 + i`` and the right columns
    ``gcol = off1 + j < w1_total``. Pairs outside ``drange`` count as
    ``BIG``."""
    h, w0, _ = words0.shape
    w1 = min(words1.shape[1], w1_total - off1)
    if w1 <= 0:
        return
    dev = words0.device
    cols = w1 if w0 * w1 <= pair_budget else max(1, pair_budget // w0)
    rows = max(1, pair_budget // (w0 * cols))
    col0 = off0 + torch.arange(w0, dtype=torch.int32, device=dev)[:, None]
    for c0 in range(0, w1, cols):
        col = off1 + torch.arange(c0, min(w1, c0 + cols), dtype=torch.int32,
                                  device=dev)
        bad = None
        if drange is not None:
            d = col0 - col  # (W0, C) candidate disparity
            bad = (d < drange[0]) | (d > drange[1])
        for r0 in range(0, h, rows):
            rs = slice(r0, min(h, r0 + rows))
            cost = _hamming(words0[rs], words1[rs, c0:c0 + col.numel()])
            cost *= pack_k
            pf = cost + col
            if bad is not None:
                pf = torch.where(bad, BIG, pf)
            mf[rs] = torch.minimum(mf[rs], pf.amin(dim=-1))
            if ml is not None:
                pl = cost + (w1_total - 1 - col)
                if bad is not None:
                    pl = torch.where(bad, BIG, pl)
                ml[rs] = torch.minimum(ml[rs], pl.amin(dim=-1))


def decode_minima(mf, ml, w1: int, pack_k: int = PACK_K):
    """:func:`decode_packed_minima` (``ml`` None without last) with the
    no-candidate sentinels: where only ``BIG`` was folded in (decoded cost
    above 256), ``first = -1, last = -2``."""
    cost, first, last = decode_packed_minima(mf, ml, w1, ml is not None,
                                             pack_k)
    none = cost > 256
    first = torch.where(none, -1, first)
    if last is not None:
        last = torch.where(none, -2, last)
    return cost, first, last


def row_minima_torch_words(
    words0: torch.Tensor, words1: torch.Tensor, need_last: bool,
    pair_budget: int = PAIR_BUDGET, drange=None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain scan: ``(cost, first, last-or-None)``, each ``(H, W0)`` int32,
    for ``(H, W0, nw)`` and ``(H, W1, nw)`` int32 words. ``drange``:
    optional inclusive ``(dmin, dmax)`` on ``col0 - col1``; a pixel with no
    candidate in range gets ``first = -1, last = -2``."""
    h, w0, _ = words0.shape
    w1 = words1.shape[1]
    pack_k = PACK_K if w1 <= PACK_K else 1 << (w1 - 1).bit_length()
    if pack_k > 1 << 22:
        raise ValueError(
            f"image width {w1} > {1 << 22} overflows the int32 cost packing")
    mf = torch.full((h, w0), BIG, dtype=torch.int32, device=words0.device)
    ml = torch.full_like(mf, BIG) if need_last else None
    _fold_packed(words0, words1, mf, ml, off0=0, off1=0, w1_total=w1,
                 pack_k=pack_k, drange=drange, pair_budget=pair_budget)
    return decode_minima(mf, ml, w1, pack_k)


def row_minima_band_torch_words(
    words0: torch.Tensor, words1: torch.Tensor, off0: int, off1: int,
    mf: torch.Tensor, ml: Optional[torch.Tensor], *, w1_total: int,
    drange=None, pair_budget: int = PAIR_BUDGET,
) -> None:
    """Plain W-band ring step, in place: a left band ``(H, W0b, nw)`` at
    global column ``off0`` against one visiting right band ``(H, band,
    nw)`` at global column ``off1``, folded into the running ``(H, W0b)``
    int32 minima ``mf`` (``cost * PACK_K + gcol``) and ``ml`` (``cost *
    PACK_K + (w1_total-1-gcol)``; None without last). Right columns at or
    past ``w1_total`` (ring padding) and pairs outside ``drange`` (on the
    global ``col0 - col1``) are skipped. Start both from ``BIG``; decode
    with :func:`decode_minima`. The plain version beside
    ``kernels/band.py``."""
    if w1_total > PACK_K:
        raise ValueError(f"image width > {PACK_K} not supported")
    _fold_packed(words0, words1, mf, ml, off0=off0, off1=off1,
                 w1_total=w1_total, pack_k=PACK_K, drange=drange,
                 pair_budget=pair_budget)


def row_minima_consistency_band_torch_words(
    words0: torch.Tensor, words1: torch.Tensor, off0: int, off1: int,
    mf: torch.Tensor, ml: Optional[torch.Tensor], rf: torch.Tensor,
    rl: Optional[torch.Tensor], *, w_total: int, drange=None,
    pair_budget: int = PAIR_BUDGET,
) -> None:
    """Plain fused Consistency ring step, in place: a held left band ``(H,
    W0b, nw)`` at global column ``off0`` against one visiting right band
    ``(H, band, nw)`` at global column ``off1``, both directions from the
    same pairs. Forward, into the left band's ``(H, W0b)`` minima: ``mf``
    (``cost * PACK_K + gcol1``) and ``ml`` (``cost * PACK_K + (w_total - 1
    - gcol1)``). Reverse, into the ``(H, >= w_total)`` minima indexed by
    the global right column: ``rf`` (``cost * PACK_K + gcol0``) and ``rl``
    (``cost * PACK_K + (w_total - 1 - gcol0)``). ``ml`` and ``rl`` are None
    without last. Left and right columns at or past ``w_total`` (ring
    padding) and pairs outside ``drange`` (on the global ``col0 - col1``;
    reflected for the reverse side, the same pairs) are skipped. Start
    every accumulator from ``BIG``; decode with :func:`decode_minima`. The
    plain version beside ``kernels/band.py``."""
    if w_total > PACK_K:
        raise ValueError(f"image width > {PACK_K} not supported")
    wid0 = max(0, min(words0.shape[1], w_total - off0))
    wid1 = max(0, min(words1.shape[1], w_total - off1))
    if wid0 == 0 or wid1 == 0:
        return
    a, b = words0[:, :wid0], words1[:, :wid1]
    _fold_packed(a, b, mf[:, :wid0], None if ml is None else ml[:, :wid0],
                 off0=off0, off1=off1, w1_total=w_total, pack_k=PACK_K,
                 drange=drange, pair_budget=pair_budget)
    cols = slice(off1, off1 + wid1)
    _fold_packed(b, a, rf[:, cols], None if rl is None else rl[:, cols],
                 off0=off1, off1=off0, w1_total=w_total, pack_k=PACK_K,
                 drange=reflect_range(drange), pair_budget=pair_budget)


def _lookup_reverse(first1, last1, first0):
    """Reverse minima read at each left pixel's forward argmin: ``(rc0,
    rc0_last-or-None)``; ``-1 / -2`` where the forward side found no
    candidate (``first0 < 0``)."""
    idx = first0.clamp(min=0).to(torch.int64)
    none = first0 < 0
    rc0 = torch.where(none, -1, first1.gather(1, idx))
    rc0_last = (None if last1 is None
                else torch.where(none, -2, last1.gather(1, idx)))
    return rc0, rc0_last


def reflect_range(drange):
    """The reverse search swaps query and candidate, so ``(dmin, dmax)``
    becomes ``(-dmax, -dmin)``."""
    return None if drange is None else (-drange[1], -drange[0])


def _two_pass(words0, words1, no_dupes: bool, drange):
    """Forward ``(first0, last0)`` over right columns and reverse
    ``(first1, last1)`` over left columns, last ones None without
    ``no_dupes``."""
    _, first0, last0 = row_minima_torch_words(words0, words1, no_dupes,
                                              drange=drange)
    _, first1, last1 = row_minima_torch_words(words1, words0, no_dupes,
                                              drange=reflect_range(drange))
    return first0, last0, first1, last1


def row_minima_consistency_torch_words(words0: torch.Tensor,
                                       words1: torch.Tensor, no_dupes: bool,
                                       drange=None):
    """Plain Consistency scan: ``(first0, last0, rc0, rc0_last)``, each
    ``(H, W0)`` int32 (``last0``/``rc0_last`` None without ``no_dupes``).
    ``rc0[h, c0]`` is the reverse first argmin (the least left column of
    least cost) of right column ``first0[h, c0]``, ``rc0_last`` the reverse
    last argmin."""
    first0, last0, first1, last1 = _two_pass(words0, words1, no_dupes,
                                             drange)
    return (first0, last0) + _lookup_reverse(first1, last1, first0)


def _left_cols(w0: int, col_off: int, device) -> torch.Tensor:
    """Global left columns ``col_off + arange(w0)`` as a ``(1, W0)`` row
    (``col_off``: the band's offset on the W-banded path)."""
    return col_off + torch.arange(w0, dtype=torch.int32, device=device)[None]


def _finish_nodupes(first: torch.Tensor, last: torch.Tensor,
                    w0: int, col_off: int = 0) -> torch.Tensor:
    with span("bicos.search_finish"):
        col0 = _left_cols(w0, col_off, first.device)
        valid = (first == last) & (first >= 0)
        disp = torch.where(valid, col0 - first, INVALID_I16)
        return disp.to(torch.int16)


def _finish_gathered(variant: Consistency, first0, last0, rc0, rc0_last,
                     col_off: int = 0):
    """Decode from reverse minima already read at the forward argmin; with
    ``no_dupes`` both searches' minima must be unique (``first0 == last0``,
    ``rc0 == rc0_last``)."""
    with span("bicos.search_finish"):
        col0 = _left_cols(first0.shape[1], col_off, first0.device)
        # >= 0 guards the range sentinels (forward and reverse); both
        # operands of the floor division are >= 0 wherever the result is
        # kept.
        valid = ((first0 >= 0) & (rc0 >= 0)
                 & ((col0 - rc0).abs() <= variant.max_lr_diff))
        if variant.no_dupes:
            valid &= (first0 == last0) & (rc0 == rc0_last)
        disp = torch.div(col0 + rc0, 2, rounding_mode="floor") - first0
        return torch.where(valid, disp, INVALID_I16).to(torch.int16)


def transform_words(stack: torch.Tensor, mode: TransformMode,
                    backend: str) -> torch.Tensor:
    """``(n, H, W)`` stack -> ``(H, W, nw)`` int32 descriptor words: the
    transform kernel on ``backend="cuda"``, the plain transform on
    ``"torch"`` (a resolved backend, see :func:`resolve_backend`)."""
    with span("bicos.transform"):
        if backend == "cuda":
            return descriptor_words_cuda(stack, mode)
        return descriptor_words(stack, mode)


def _scan(words0, words1, variant: SearchVariant, backend: str, drange):
    """The scan of a search inside ``bicos.scan``: the scan kernel
    (``"cuda"``; the fused one for Consistency) or the plain scan
    (``"torch"``). Returns ``(first, last)`` for NoDuplicates, ``(first0,
    last0, rc0, rc0_last)`` for Consistency, as :func:`_finish` takes
    them."""
    with span("bicos.scan"):
        if isinstance(variant, NoDuplicates):
            if backend == "cuda":
                return row_minima_words(words0, words1, True, drange=drange)
            return row_minima_torch_words(words0, words1, True,
                                          drange=drange)[1:]
        if backend == "cuda":
            (_, first0, last0), (_, rc0, rc0_last) = (
                row_minima_consistency_words(words0, words1,
                                             no_dupes=variant.no_dupes,
                                             drange=drange))
            return first0, last0, rc0, rc0_last
        return row_minima_consistency_torch_words(words0, words1,
                                                  variant.no_dupes, drange)


def _finish(variant: SearchVariant, minima) -> torch.Tensor:
    """The int16 disparity from :func:`_scan`'s minima."""
    if isinstance(variant, NoDuplicates):
        first, last = minima
        return _finish_nodupes(first, last, first.shape[1])
    return _finish_gathered(variant, *minima)


def search_words(words0: torch.Tensor, words1: torch.Tensor, nbits: int,
                 variant: SearchVariant, backend: str = "auto",
                 drange=None) -> torch.Tensor:
    """Correspondence search on packed int32 words -> ``(H, W0)`` int16
    disparity (-32768 invalid): :func:`_scan`, then the decode. ``nbits``
    is kept for parity with the JAX surface; the words carry their bits.
    ``drange``: optional inclusive ``(dmin, dmax)`` disparity range."""
    backend = resolve_backend(backend, words0, words1)
    return _finish(variant, _scan(words0, words1, variant, backend, drange))


def search(bits0: torch.Tensor, bits1: torch.Tensor, variant: SearchVariant,
           backend: str = "auto") -> torch.Tensor:
    """Correspondence search on ``(H, W, B)`` bool bit planes -> ``(H, W0)``
    int16 disparity (-32768 invalid): :func:`search_words` on the packed
    planes. The pipeline calls :func:`search_words` or
    :func:`search_stack` directly."""
    return search_words(pack_bits(bits0), pack_bits(bits1), bits0.shape[-1],
                        variant, backend)


def search_stack(stack0: torch.Tensor, stack1: torch.Tensor,
                 mode: TransformMode, variant: SearchVariant,
                 backend: str = "auto", drange=None) -> torch.Tensor:
    """Correspondence search straight from ``(n, H, W)`` stacks -> int16
    disparity: :func:`transform_words` on both stacks, then the search of
    :func:`search_words`."""
    backend = resolve_backend(backend, stack0, stack1)
    validate_stack(stack0.shape[0], mode)
    # The words are freed when _scan returns, so the decode's temporaries
    # do not add to them in the call's peak device memory.
    minima = _scan(transform_words(stack0, mode, backend),
                   transform_words(stack1, mode, backend), variant, backend,
                   drange)
    return _finish(variant, minima)


def search_stack_nodupes_with_bases(stack0: torch.Tensor,
                                    stack1: torch.Tensor,
                                    mode: TransformMode, *, chunk: int,
                                    wcap: int, wp: int,
                                    backend: str = "auto"):
    """NoDuplicates search that also returns the agree stage's
    dynamic-window bases: ``(disparity, bases)``, ``bases`` the ``(H, wp //
    chunk)`` int32 :func:`agree.chunk_window_bases` of the disparity. The
    counterpart of ``libbicos_tpu.search.search_stack_nodupes_with_bases``:
    the TPU emits them from the search kernel's epilogue, here the bases
    kernel (``"cuda"``) or its plain version (``"torch"``) reads the
    disparity after the search. ``match`` does not call it: its agree stage
    computes the same bases from the disparity for every variant."""
    backend = resolve_backend(backend, stack0, stack1)
    disp = search_stack(stack0, stack1, mode, NoDuplicates(), backend)
    w = stack0.shape[2]
    if backend == "cuda":
        return disp, chunk_window_bases_cuda(disp, w, wp, wcap, chunk)
    return disp, chunk_window_bases(disp, w, wp, wcap, chunk)
