"""The yardstick of the benchmark's roofline metrics: H100 peaks, published
or measured, and the work a kernel needs on an input, counted from shapes
and, for the agree stage, from the kept and swept pixels of the
reference's search.

A roofline share is the least time the chip could take, the larger of
bytes over the memory rate and each kind of operation over its rate,
divided by the kernel's measured device time. Work is counted from what
the algorithm needs, never from what a kernel happens to do: each input
byte read once and each output byte written once.

One H100 SXM at its 700 W limit, clocked at ``SM_CLOCKS`` (132 SMs at the
1.98 GHz boost clock):

* ``bytes``: HBM bytes/s, NVIDIA's data sheet (3.35 TB/s).
* ``fp32``, ``fp64``, ``popc``, ``conv``: instructions/s from the per-SM
  rates of the CUDA programming guide's throughput table for compute
  capability 9.0: 128 FP32 add/mul/fma a clock, 64 FP64, 16 popcounts and
  16 conversions (F2I, I2F) a clock.
* ``b1_mma``: 1-bit AND products a second of the tensor cores
  (``wgmma`` m64nNk256 and ``mma.sync`` m16n8k256 ``.b1`` ``.and.popc`` on
  sm_90a), 32768 a clock an SM: 8 times the INT8 rate, which NVIDIA's
  H100 SXM data sheet gives as 1,979 dense TOPS, that is 1979e12 / 2 / 132
  SMs / 1.83 GHz = 4096 multiply-adds a clock an SM. NVIDIA publishes no
  1-bit rate for the H100; ``portbench/rate_probe.py`` measured it on an
  H100 SXM at 700 W: ``wgmma`` 1-bit 31,706-31,992 a clock an SM at the
  sampled 1815-1845 MHz, ``wgmma`` INT8 3,970-3,990 at 1770-1800 MHz (97%
  of 32768 and of 4096), ``mma.sync`` 1-bit 20,141-20,536 at 1980 MHz.
* ``bit_products``: exact products of two descriptor bits a second,
  summed over every unit that forms them at the same time. A Hamming
  distance is ``popc(a) + popc(b) - 2 popc(a & b)``, each descriptor's own
  popcount counted once: one 1-bit AND product a bit pair, ``b1_mma``.
  The popcount pipe counts 32 bit pairs an instruction (after an XOR on
  the ALU): 32 x ``popc``, 512 a clock an SM. No other unit adds bit
  products at a comparable rate: +-1 planes in INT8 (``ham = (bits - dot)
  / 2``), FP8 and FP16 run on the same tensor cores at an eighth of the
  1-bit rate or less, so they share it rather than add to it; the ALU (64
  logic instructions a clock an SM) needs two or three of them a 32-bit
  word for carry-save counting, at most about 700 bit pairs a clock, and
  it also runs the argmin.
* ``min``: 16-bit minima a second, 256 a clock an SM: the packed 3-input
  mins (``VIMNMX3``, ``VHMNMX``) take two minima in each of two 16-bit
  lanes, 64 instructions a clock an SM, and the integer and half forms
  share one pipe. The argmin of a scan takes at least one min a (pixel,
  column) pair and direction. ``rate_probe.py`` measured 248-249 a clock
  an SM at 1980 MHz for ``min.u16x2``, ``min.f16x2`` and the two
  interleaved.
"""

from __future__ import annotations

SM_CLOCKS = 132 * 1.98e9
PEAK = {"bytes": 3.35e12, "fp32": 128 * SM_CLOCKS, "fp64": 64 * SM_CLOCKS,
        "popc": 16 * SM_CLOCKS, "conv": 16 * SM_CLOCKS,
        "b1_mma": 32768 * SM_CLOCKS, "min": 256 * SM_CLOCKS}
PEAK["bit_products"] = PEAK["b1_mma"] + 32 * PEAK["popc"]
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


def scan_pairs(w: int, drange) -> int:
    """(left pixel, right column) pairs of one row of ``w`` pixels: every
    pair, or those whose disparity lies in ``drange = (dmin, dmax)``."""
    if drange is None:
        return w * w
    dmin, dmax = drange
    return sum(max(0, min(c - dmin, w - 1) - max(c - dmax, 0) + 1)
               for c in range(w))


def scan_bound(h: int, w: int, bits: int, drange,
               consistency: bool = False) -> tuple:
    """A scan of an ``h x w`` pair of ``bits``-bit descriptors over the
    pairs of :func:`scan_pairs`: ``pairs x bits`` bit products at
    ``PEAK["bit_products"]``, one 16-bit min a pair and direction (two
    for a Consistency scan, which takes the forward and reverse minima of
    the same distances) at ``PEAK["min"]``. Bytes: both 32-bit word arrays
    read once, and the minima written once, 8 bytes a pixel (16 with
    ``consistency``)."""
    pairs = h * scan_pairs(w, drange)
    nw = -(-bits // 32)
    return bound(2 * h * w * nw * 4 + h * w * (16 if consistency else 8),
                 bit_products=pairs * bits,
                 min=pairs * (2 if consistency else 1))


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


def bits_for(n: int, mode: str) -> int:
    """Bits of a descriptor of ``n`` shots: LIMITED ``3 (n - 2) + max(0,
    n - 4) + 4`` (4 at n = 2), FULL ``n^2 - 2n + 3``."""
    if mode == "FULL":
        return n * n - 2 * n + 3
    return 4 if n == 2 else 3 * (n - 2) + max(0, n - 4) + 4


def words_for(n: int, mode: str) -> int:
    """32-bit words of a descriptor: ``ceil(bits_for(n, mode) / 32)``."""
    return -(-bits_for(n, mode) // 32)
