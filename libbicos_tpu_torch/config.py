"""Configuration types for the PyTorch/CUDA BICOS engine.

The same fields, defaults and helpers as ``libbicos_tpu.config``, so that a
configuration means the same thing in both packages:

* ``TransformMode`` — LIMITED / FULL
* ``Precision``     — SINGLE / DOUBLE
* ``NoDuplicates`` / ``Consistency`` search variants
* ``Config`` with the reference *library* defaults (nxcorr_threshold=0.5,
  LIMITED, NoDuplicates).

BICOS has no weights: the ``Config`` is its only state.
:func:`config_from_reference` builds this package's ``Config`` from any
object carrying the JAX ``Config``'s attributes, without importing it.

Invalid-disparity sentinels keep the reference values: NaN for floating
point, -32768 for int16.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import operator
from typing import Optional, Union

import numpy as np
import torch


class TransformMode(enum.Enum):
    LIMITED = 0
    FULL = 1


class Precision(enum.Enum):
    SINGLE = 0
    DOUBLE = 1


@dataclasses.dataclass(frozen=True)
class NoDuplicates:
    """Invalidate a pixel whose least Hamming cost is not unique in its
    row."""


@dataclasses.dataclass(frozen=True)
class Consistency:
    """Left/right consistency check: keep ``col0 -> best_col1`` only if the
    reverse search from ``best_col1`` lands within ``max_lr_diff`` of
    ``col0``; the disparity becomes ``(col0 + reverse_col0) // 2 - best_col1``.
    ``no_dupes`` also applies the NoDuplicates rule to both searches."""

    max_lr_diff: int = 1
    no_dupes: bool = False


SearchVariant = Union[NoDuplicates, Consistency]


@dataclasses.dataclass(frozen=True)
class Config:
    """Matching configuration; the defaults are the reference library's.

    ``disparity_range`` is an inclusive ``(dmin, dmax)`` bound on
    ``d = col0 - col1``; ``None`` keeps the full-row scan.
    """

    nxcorr_threshold: Optional[float] = 0.5
    subpixel_step: Optional[float] = None
    min_variance: Optional[float] = None
    mode: TransformMode = TransformMode.LIMITED
    precision: Precision = Precision.SINGLE
    variant: SearchVariant = NoDuplicates()
    disparity_range: Optional[tuple] = None

    def __post_init__(self):
        if self.subpixel_step is not None and self.subpixel_step <= 0:
            raise ValueError("subpixel_step must be positive")
        if self.disparity_range is not None:
            dr = self.disparity_range
            try:
                if len(dr) != 2 or any(isinstance(v, bool) for v in dr):
                    raise TypeError
                dr = (operator.index(dr[0]), operator.index(dr[1]))
            except TypeError:
                raise ValueError(
                    "disparity_range must be an integer (dmin, dmax) pair, "
                    f"got {self.disparity_range!r}") from None
            if dr[0] > dr[1]:
                raise ValueError(
                    f"disparity_range needs dmin <= dmax, got {dr!r}")
            object.__setattr__(self, "disparity_range", dr)


def config_from_reference(obj) -> Config:
    """This package's ``Config`` from any object with the JAX ``Config``'s
    attributes (enums are matched by name, variants by type name)."""
    variant = obj.variant
    if type(variant).__name__ == "Consistency":
        variant = Consistency(max_lr_diff=int(variant.max_lr_diff),
                              no_dupes=bool(variant.no_dupes))
    elif type(variant).__name__ == "NoDuplicates":
        variant = NoDuplicates()
    else:
        raise ValueError(f"unknown search variant {variant!r}")
    return Config(
        nxcorr_threshold=obj.nxcorr_threshold,
        subpixel_step=obj.subpixel_step,
        min_variance=obj.min_variance,
        mode=TransformMode[obj.mode.name],
        precision=Precision[obj.precision.name],
        variant=variant,
        disparity_range=obj.disparity_range,
    )


INVALID_DISP_INT16 = np.int16(-32768)
INVALID_DISP_FLOAT = float("nan")
# The scans' packed minima: ``cost * PACK_K + col`` (PACK_K widened to the
# next power of two for rows wider than it). BIG stands in for an
# out-of-range pair: above every real packing at every pack width up to
# 2^22 (decoded cost > 256), as in the JAX scan.
PACK_K = 32768
BIG = 0x7F000000


def invalid_disparity(dtype) -> float:
    """The invalid-disparity value of ``dtype`` (a torch or numpy dtype):
    NaN for floating point, -32768 for int16."""
    if isinstance(dtype, torch.dtype):
        if dtype.is_floating_point:
            return float("nan")
        if dtype == torch.int16:
            return int(INVALID_DISP_INT16)
    else:
        dt = np.dtype(dtype)
        if np.issubdtype(dt, np.floating):
            return float("nan")
        if dt == np.int16:
            return int(INVALID_DISP_INT16)
    raise ValueError(f"unsupported disparity dtype: {dtype}")


def is_invalid(disparity):
    """Elementwise invalid mask: NaN for float disparities, -32768 for int16.
    A tensor gives a bool tensor, anything else a numpy bool array."""
    if isinstance(disparity, torch.Tensor):
        if disparity.is_floating_point():
            return torch.isnan(disparity)
        return disparity == int(INVALID_DISP_INT16)
    arr = np.asarray(disparity)
    if np.issubdtype(arr.dtype, np.floating):
        return np.isnan(arr)
    return arr == INVALID_DISP_INT16


def required_bits(n: int, mode: TransformMode) -> int:
    """The reference's descriptor width formula: FULL n^2-2n+3, LIMITED 4n-7
    (the LIMITED transform emits one bit more, see :func:`actual_bits`)."""
    if mode == TransformMode.FULL:
        return n * n - 2 * n + 3
    return 4 * n - 7


def actual_bits(n: int, mode: TransformMode) -> int:
    """Exact number of descriptor bits the transform emits."""
    if mode == TransformMode.FULL:
        return n * n - 2 * n + 3
    if n == 2:
        return 4
    return 3 * (n - 2) + max(0, n - 4) + 4


MAX_BITS = 256


def validate_stack(n: int, mode: TransformMode) -> int:
    """Validate the stack size like the reference and return the actual
    descriptor bit count."""
    if n < 2:
        raise ValueError("need at least two images")
    req = required_bits(n, mode)
    if req > MAX_BITS:
        raise ValueError(
            f"input stacks too large, would require {req} bits (max {MAX_BITS})"
        )
    return actual_bits(n, mode)


def max_stacksize(mode: TransformMode, bits: int = MAX_BITS) -> int:
    """Largest n whose required_bits fit in ``bits``."""
    if mode == TransformMode.LIMITED:
        return (bits + 7) // 4
    return int((2 + math.isqrt(4 - 4 * (3 - bits))) // 2)
