"""The yardstick of the benchmark's roofline metrics: published H100 peaks
and the work a kernel needs on an input, counted from shapes and, for the
agree stage, from the kept and swept pixels of the reference's search.

A roofline share is the least time the chip could take, the larger of
bytes over the memory rate and each kind of operation over its rate,
divided by the kernel's measured device time. Work is counted from what
the algorithm needs, never from what a kernel happens to do: each input
byte read once and each output byte written once.

One H100 SXM at its 700 W limit: HBM bytes/s from NVIDIA's data sheet,
and instructions/s from the 132 SMs, the 1.98 GHz boost clock and the
per-SM rates of the CUDA programming guide's throughput table for compute
capability 9.0: 128 FP32 add/mul/fma a clock, 64 FP64, 16 popcounts and
16 conversions (F2I, I2F) a clock.
"""

from __future__ import annotations

SM_CLOCKS = 132 * 1.98e9
PEAK = {"bytes": 3.35e12, "fp32": 128 * SM_CLOCKS, "fp64": 64 * SM_CLOCKS,
        "popc": 16 * SM_CLOCKS, "conv": 16 * SM_CLOCKS}
INVALID_I16 = -32768


def bound(nbytes: float, **ops) -> tuple:
    """``(ms, "bytes" | "operations")``: the larger of ``nbytes`` over the
    memory rate and each ``ops[kind]`` over ``PEAK[kind]``."""
    t = {"bytes": nbytes / PEAK["bytes"],
         "operations": max((v / PEAK[k] for k, v in ops.items()),
                           default=0.0)}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def transform_bound(n: int, h: int, w: int, itemsize: int, nw: int) -> tuple:
    """One stack's descriptor transform: the ``(n, H, W)`` stack read once
    and its ``(H, W, nw)`` 32-bit words written once."""
    return bound(n * h * w * itemsize + h * w * nw * 4)


def scan_bound(h: int, w: int, nw: int, drange, out_bytes: int) -> tuple:
    """A scan on an ``h x w`` pair of ``nw``-word descriptors: one popcount
    per (left pixel, right column in ``drange``, word); both word arrays
    read once, ``out_bytes`` written per pixel. A Consistency scan needs
    each popcount once for both directions."""
    if drange is None:
        pairs = w * w
    else:
        dmin, dmax = drange
        pairs = sum(max(0, min(c - dmin, w - 1) - max(c - dmax, 0) + 1)
                    for c in range(w))
    return bound(2 * h * w * nw * 4 + h * w * out_bytes,
                 popc=h * pairs * nw)


def agree_pixels(disp, w1: int) -> tuple:
    """``(swept, plain)``: the kept pixels of an ``(H, W)`` int16 search
    disparity (valid, matched column inside the right row) whose matched
    column has both neighbours (they sweep the parabola), and the kept
    border pixels (they take the integer check only)."""
    import torch

    col1 = (torch.arange(disp.shape[1], device=disp.device)[None]
            - disp.long())
    keep = (disp != INVALID_I16) & (col1 >= 0) & (col1 < w1)
    swept = int((keep & (col1 != 0) & (col1 != w1 - 1)).sum())
    return swept, int(keep.sum()) - swept


def agree_bound(n: int, h: int, w: int, w1: int, itemsize: int, swept: int,
                plain: int, nx: int, double: bool = False) -> tuple:
    """The agree stage on an ``(n, H, W)`` left and ``(n, H, W1)`` right
    stack with ``swept`` and ``plain`` kept pixels (:func:`agree_pixels`;
    with no subpixel sweep, ``nx == 0``, every kept pixel is plain). A
    swept pixel needs, per shot and x, 5 FP32 operations for the
    interpolated sample, 4 in the compute type for its NXCORR terms (mean
    add, difference, two fmas) and 2 roundings or casts; once per shot, 6
    FP32 operations (the parabola), 3 in the compute type (left
    statistics) and 4 casts. A plain pixel needs 7n operations in the
    compute type and 2n casts. The compute type is FP32, or FP64 with
    ``double``. The roundings and casts count as FP32 adds (``agree.cu``
    computes them so). Bytes: both stacks read once; per pixel the int16
    disparity read, the float disparity and the corrmap written."""
    if not nx:
        swept, plain = 0, swept + plain
    fp32 = swept * (5 * n * nx + 6 * n)
    comp = swept * (4 * n * nx + 3 * n) + plain * 7 * n
    conv = swept * (2 * n * nx + 4 * n) + plain * 2 * n
    nbytes = n * h * (w + w1) * itemsize + h * w * (2 + 4 + 4)
    if double:
        return bound(nbytes, fp32=fp32 + conv, fp64=comp)
    return bound(nbytes, fp32=fp32 + conv + comp)


def words_for(n: int, mode: str) -> int:
    """32-bit words of a descriptor: LIMITED ``3 (n - 2) + max(0, n - 4) +
    4`` bits, FULL ``n^2 - 2n + 3``."""
    if mode == "FULL":
        bits = n * n - 2 * n + 3
    else:
        bits = 4 if n == 2 else 3 * (n - 2) + max(0, n - 4) + 4
    return (bits + 31) // 32
