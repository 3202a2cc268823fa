"""Synthetic stereo data (numpy), the same generator as
``libbicos_tpu.io.synthetic_stack_pair``: the same seed gives the same
stacks in both packages."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def synthetic_stack_pair(
    n: int,
    height: int,
    width: int,
    dtype=np.uint8,
    max_disp: Optional[int] = None,
    seed: int = 0x600DF00D,  # the reference bench seed
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Projected-pattern stereo simulator: a random per-shot pattern warped
    by a smooth disparity field. Returns (stack0, stack1, true_disparity)."""
    rng = np.random.default_rng(seed)
    if max_disp is None:
        max_disp = max(4, width // 16)
    hi = np.iinfo(dtype).max
    wide = width + max_disp
    pattern = rng.integers(0, hi + 1, size=(n, height, wide)).astype(dtype)
    # Smooth integer disparity field (>= 1) on LEFT pixel coordinates.
    yy = np.linspace(0, np.pi * 2, height)[:, None]
    xx = np.linspace(0, np.pi * 3, width)[None, :]
    field = (np.sin(yy) * np.cos(xx) + 1) / 2  # [0, 1]
    disp = (1 + field * (max_disp - 1)).astype(np.int32)
    cols = np.arange(width)[None, :]
    # right[c] = pattern[c + max_disp]; left[c] = pattern[c + max_disp - d]
    # => left[col0] == right[col0 - d]: disparity d = col0 - col1 > 0.
    right = pattern[:, :, max_disp : max_disp + width]
    src = cols + max_disp - disp
    left = np.take_along_axis(
        pattern, np.broadcast_to(src, (n, height, width)), axis=2
    )
    return (
        np.ascontiguousarray(left),
        np.ascontiguousarray(right),
        disp.astype(np.int16),
    )
