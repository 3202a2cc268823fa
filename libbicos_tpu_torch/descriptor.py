"""Temporal binary descriptor transform, plain PyTorch.

Bit-identical to ``libbicos_tpu.descriptor`` (and so to the reference's
``descriptor_transform.hpp``): the same comparisons in the same LSB-first
append order, packed into little-endian 32-bit words.

* Words are ``(H, W, nw)`` **int32 holding uint32 bit patterns** — torch's
  ``uint32`` lacks most ops. Compare them as ``.numpy().view(np.uint32)``.
* The mean bit ``s[t] < mean`` is evaluated in the exact integer form
  ``n * s[t] < sum`` (equivalence proven in
  ``libbicos_tpu.descriptor.compare_coeffs``), so no float divide is involved.
* LIMITED n<4 keeps its constant-true last bit.

This module is the plain version beside the transform kernel
(``kernels/transform.py``); it runs on CPU or GPU tensors.
"""

from __future__ import annotations

from typing import Iterator

import torch

from .config import TransformMode, actual_bits


def n_words_for(num_bits: int) -> int:
    return (num_bits + 31) // 32


def _series(stack: torch.Tensor):
    if stack.dim() != 3:
        raise ValueError("stack must have shape (n, H, W)")
    n = stack.shape[0]
    if n < 2:
        raise ValueError("need at least two images")
    if stack.dtype not in (torch.uint8, torch.uint16):
        raise ValueError("only uint8 and uint16 stacks are supported")
    s = stack.to(torch.int32)
    return n, s, s.sum(dim=0)


def _limited_bits(s: torch.Tensor, total: torch.Tensor) -> Iterator:
    """LIMITED bit planes in reference append order."""
    n = s.shape[0]
    pairsums = {}
    for t in range(n - 2):
        a, b, c = s[t], s[t + 1], s[t + 2]
        yield a < b
        yield a < c
        yield n * a < total
        cur = a + b
        if t >= 2:
            yield pairsums[t - 2] < cur
        pairsums[t] = cur
    a, b = s[n - 2], s[n - 1]
    yield a < b
    yield n * a < total
    yield n * b < total
    if n >= 4:
        yield pairsums[n - 4] < (a + b)
    else:
        # The reference's pairsum slot is still -1 here: (-1 < a+b) is
        # always true.
        yield torch.ones_like(a, dtype=torch.bool)


def _full_bits(s: torch.Tensor, total: torch.Tensor) -> Iterator:
    """FULL bit planes in reference append order."""
    n = s.shape[0]
    for t in range(n - 2):
        a, b, c = s[t], s[t + 1], s[t + 2]
        yield a < b
        yield a < c
        yield n * a < total
    a, b = s[n - 2], s[n - 1]
    yield a < b
    yield n * a < total
    yield n * b < total
    pairsums = [s[t] + s[t + 1] for t in range(n - 1)]
    for t in range(n - 1):
        for i in range(n - 1):
            if i in (t - 1, t, t + 1):
                continue
            yield pairsums[t] < pairsums[i]


def _planes(stack: torch.Tensor, mode: TransformMode):
    n, s, total = _series(stack)
    gen = _full_bits if mode == TransformMode.FULL else _limited_bits
    return actual_bits(n, mode), gen(s, total)


def descriptor_bits(stack: torch.Tensor, mode: TransformMode) -> torch.Tensor:
    """``(n, H, W)`` u8/u16 stack -> ``(H, W, B)`` bool bit planes; bit ``k``
    is the k-th bit the reference appends (LSB-first)."""
    nbits, planes = _planes(stack, mode)
    bits = torch.stack(list(planes), dim=-1)
    assert bits.shape[-1] == nbits, (bits.shape, nbits)
    return bits


def _to_int32_bits(acc: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32-bit pattern."""
    return torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)


def descriptor_words(stack: torch.Tensor, mode: TransformMode) -> torch.Tensor:
    """``(n, H, W)`` u8/u16 stack -> ``(H, W, nw)`` int32 packed words.

    The planes are OR-ed into their words as they are produced, so no
    ``(H, W, B)`` tensor is materialized."""
    nbits, planes = _planes(stack, mode)
    h, w = stack.shape[1], stack.shape[2]
    nw = n_words_for(nbits)
    acc = torch.zeros((nw, h, w), dtype=torch.int64, device=stack.device)
    k = 0
    for plane in planes:
        acc[k // 32] |= plane.to(torch.int64) << (k % 32)
        k += 1
    assert k == nbits, (k, nbits)
    return _to_int32_bits(acc).permute(1, 2, 0).contiguous()


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack ``(H, W, B)`` bool planes into ``(H, W, ceil(B/32))`` int32 words
    (bit k -> word k//32, position k%32)."""
    h, w, b = bits.shape
    nw = n_words_for(b)
    u = torch.zeros((h, w, nw * 32), dtype=torch.int64, device=bits.device)
    u[..., :b] = bits.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    acc = (u.reshape(h, w, nw, 32) << shifts).sum(dim=-1)
    return _to_int32_bits(acc)


def unpack_words(words: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits` -> ``(H, W, num_bits)`` bool."""
    h, w, nw = words.shape
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(h, w, nw * 32)[..., :num_bits].to(torch.bool)


def popcounts(bits: torch.Tensor) -> torch.Tensor:
    """Per-pixel descriptor popcount ``(H, W)`` int32 (sum of bit planes)."""
    return bits.to(torch.int32).sum(dim=-1, dtype=torch.int32)
