"""Plain BICOS matching, the benchmark's reference.

Written from the semantics of upstream libBICOS (``descriptor_transform``,
``bicos``, ``agree``), in plain PyTorch, for the configurations under
``portbench/configs`` that name ``"reference": "bicos"``. It imports
nothing of the program under test and takes nothing it made: it works the
descriptors, the scan and the agree stage out again from the input stacks.

* **Descriptors.** The LIMITED transform's comparisons of a pixel's series
  (``s[t] < s[t+1]``, ``s[t] < s[t+2]``, ``s[t] < mean`` in the exact
  integer form ``n * s[t] < sum``, and pair sums two apart). The bits are
  kept as 0/1 planes; their order does not matter to a Hamming distance.
* **Scan.** ``ham(a, b) = pop(a) + pop(b) - 2 a.b``, the dot products by a
  batched matrix product over a block of rows. Every partial sum is an
  integer of at most 128, exact in float16 and float32 whatever the
  accumulation order. The least cost's first and last column come from
  minima of ``cost * K + col`` and ``cost * K + (W - 1 - col)``.
* **Variants.** NoDuplicates keeps a pixel whose first and last argmin
  agree; Consistency searches back from the matched right column and keeps
  the pixel iff the reverse argmin lands within ``max_lr_diff``; with
  ``no_dupes`` both searches must be unique.
* **Agree.** NXCORR of the left series against the right series at the
  matched column, every sum a serial loop over shots with each product
  rounded before its add; a variance under ``min_variance * n`` gives -1.
  With a subpixel step, a per-shot parabola through columns ``col1 - 1 ..
  col1 + 1`` is swept over the float32-accumulated grid from -1; samples
  are rounded half to even and cast modularly to the input width; only a
  strictly better NXCORR moves the best x; border columns keep the integer
  check. ``dtype`` is the compute type of the statistics, the NXCORR and
  the tests (float32 for SINGLE); the parabola stays float32.

The results: the search disparity (int16, -32768 invalid), the final
disparity (int16 without a subpixel step, float32 with NaN invalid with
it) and the NXCORR map (float32, NaN where no match was checked).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

INVALID_I16 = -32768
# Left rows per block of the scan: an int32 (rows, W, W) cost slab of
# about 1.4 GB at 3300 columns.
SCAN_ROWS = 32


def limited_planes(stack: torch.Tensor) -> List[torch.Tensor]:
    """The LIMITED transform's bit planes of an ``(n, H, W)`` stack, as
    ``(H, W)`` bool tensors: ``3 (n - 2) + max(0, n - 4) + 4`` of them."""
    s = stack.to(torch.int32)
    n = s.shape[0]
    if n < 3:
        raise ValueError("the reference transform needs n >= 3")
    total = s.sum(dim=0)
    pair = [s[t] + s[t + 1] for t in range(n - 1)]
    planes = []
    for t in range(n - 2):
        planes += [s[t] < s[t + 1], s[t] < s[t + 2], n * s[t] < total]
        if t >= 2:
            planes.append(pair[t - 2] < pair[t])
    planes += [s[n - 2] < s[n - 1], n * s[n - 2] < total,
               n * s[n - 1] < total]
    # With n < 4 upstream compares against an unset pair sum (always true).
    planes.append(pair[n - 4] < pair[n - 2] if n >= 4
                  else torch.ones_like(total, dtype=torch.bool))
    return planes


def _bit_matrix(stack: torch.Tensor):
    """``(H, W, P)`` 0/1 planes in the scan's matmul type (P padded to a
    multiple of 8 with zero planes) and the ``(H, W)`` int32 popcounts."""
    planes = limited_planes(stack)
    mm = torch.float16 if stack.device.type == "cuda" else torch.float32
    bits = torch.stack(planes, dim=0)
    pop = bits.sum(dim=0, dtype=torch.int32)
    pad = (-len(planes)) % 8
    bits = torch.nn.functional.pad(bits.to(mm).permute(1, 2, 0), (0, pad))
    return bits.contiguous(), pop


def scan(stack0: torch.Tensor, stack1: torch.Tensor, variant: dict,
         rows: int = SCAN_ROWS) -> torch.Tensor:
    """The full-row correspondence search: ``(H, W)`` int16 disparity
    ``col0 - col1``, -32768 invalid. ``variant``: ``{"kind":
    "NoDuplicates"}`` or ``{"kind": "Consistency", "max_lr_diff": m,
    "no_dupes": b}``."""
    kind = variant["kind"]
    if kind not in ("NoDuplicates", "Consistency"):
        raise ValueError(f"unknown search variant {kind!r}")
    cons = kind == "Consistency"
    b0, pop0 = _bit_matrix(stack0)
    b1, pop1 = _bit_matrix(stack1)
    h, w0, _ = b0.shape
    w1 = b1.shape[1]
    dev = b0.device
    k = 1 << max(w0, w1).bit_length()  # above every column index
    col0 = torch.arange(w0, dtype=torch.int32, device=dev)
    col1 = torch.arange(w1, dtype=torch.int32, device=dev)
    ffirst = torch.empty((h, w0), dtype=torch.int32, device=dev)
    flast = torch.empty_like(ffirst)
    if cons:
        rfirst = torch.empty((h, w1), dtype=torch.int32, device=dev)
        rlast = torch.empty_like(rfirst)
    for r0 in range(0, h, rows):
        rs = slice(r0, min(h, r0 + rows))
        cost = torch.bmm(b0[rs], b1[rs].transpose(1, 2)).to(torch.int32)
        cost.mul_(-2 * k)
        cost.add_((pop0[rs] * k)[:, :, None])
        cost.add_((pop1[rs] * k)[:, None, :])  # cost * k
        ffirst[rs] = (cost + col1).amin(dim=2)
        flast[rs] = (cost + (w1 - 1 - col1)).amin(dim=2)
        if cons:
            rfirst[rs] = (cost + col0[:, None]).amin(dim=1)
            rlast[rs] = (cost + (w0 - 1 - col0)[:, None]).amin(dim=1)
        del cost
    first = ffirst % k
    last = (w1 - 1) - flast % k
    if not cons:
        return torch.where(first == last, col0 - first,
                           INVALID_I16).to(torch.int16)
    idx = first.to(torch.int64)
    rc0 = (rfirst % k).gather(1, idx)
    rc0_last = ((w0 - 1) - rlast % k).gather(1, idx)
    valid = (col0 - rc0).abs() <= int(variant["max_lr_diff"])
    if variant.get("no_dupes", False):
        valid &= (first == last) & (rc0 == rc0_last)
    disp = torch.div(col0 + rc0, 2, rounding_mode="floor") - first
    return torch.where(valid, disp, INVALID_I16).to(torch.int16)


def subpixel_grid(step: float) -> List[float]:
    """The sweep ``for (x = -1; x <= 1; x += step)`` in float32 (at step 0.1
    the drift leaves out x = 1)."""
    xs, x = [], np.float32(-1.0)
    while x <= np.float32(1.0):
        xs.append(float(x))
        x = np.float32(x + np.float32(step))
    return xs


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _centred(series: torch.Tensor):
    """``(n, H, W)`` -> (deviations from the mean, variance sum), serial
    sums over shots in the series' type."""
    n = series.shape[0]
    acc = torch.zeros_like(series[0])
    for t in range(n):
        acc = acc + series[t]
    dev = series - acc / _c(n, series)
    var = torch.zeros_like(acc)
    for t in range(n):
        var = var + dev[t] * dev[t]
    return dev, var


def _nxcorr(dev0, var0, series1, minvar):
    dev1, var1 = _centred(series1.to(var0.dtype))
    cov = torch.zeros_like(var0)
    for t in range(dev0.shape[0]):
        cov = cov + dev0[t] * dev1[t]
    nxc = cov / torch.sqrt(var0 * var1)
    if minvar is not None:
        mv = _c(minvar, var0)
        nxc = torch.where((var0 < mv) | (var1 < mv), _c(-1.0, var0), nxc)
    return nxc


def agree(disp: torch.Tensor, stack0: torch.Tensor, stack1: torch.Tensor,
          threshold: float, step: Optional[float],
          min_variance: Optional[float], dtype=torch.float32):
    """NXCORR validation of an int16 search disparity, with the subpixel
    sweep when ``step`` is given: ``(disparity, corrmap)``."""
    n, h, w = stack0.shape
    w1 = stack1.shape[2]
    dev = disp.device
    minvar = None if min_variance is None else min_variance * n
    col = torch.arange(w, dtype=torch.int32, device=dev)[None]
    d = disp.to(torch.int32)
    col1 = col - d
    keep = (disp != INVALID_I16) & (col1 >= 0) & (col1 < w1)
    col1 = col1.clamp(0, w1 - 1).to(torch.int64)
    s1 = stack1.to(torch.int32)

    def at(cols):
        return torch.gather(s1, 2, cols[None].expand(n, -1, -1)).to(
            torch.float32)

    dev0, var0 = _centred(stack0.to(torch.int32).to(dtype))
    y1 = at(col1)
    nan = torch.tensor(float("nan"), device=dev)
    if step is None:
        nxc = _nxcorr(dev0, var0, y1, minvar)
        corr = torch.where(keep, nxc.to(torch.float32), nan)
        ok = keep & ~(nxc < _c(threshold, nxc))
        return torch.where(ok, d, INVALID_I16).to(torch.int16), corr
    border = (col1 == 0) | (col1 == w1 - 1)
    y0 = at((col1 - 1).clamp(min=0))
    y2 = at((col1 + 1).clamp(max=w1 - 1))
    f32 = torch.float32
    half = torch.tensor(0.5, dtype=f32, device=dev)
    two = torch.tensor(2.0, dtype=f32, device=dev)
    pa = half * (y0 - two * y1 + y2)
    pb = half * (y2 - y0)
    mod = 0xFFFF if stack0.dtype == torch.uint16 else 0xFF
    best = torch.full((h, w), -1.0, dtype=dtype, device=dev)
    best_x = torch.zeros((h, w), dtype=f32, device=dev)
    for x in subpixel_grid(step):
        xf = torch.tensor(x, dtype=f32, device=dev)
        v = torch.round(((pa * xf) * xf + pb * xf) + y1)
        nxc = _nxcorr(dev0, var0, (v.to(torch.int32) & mod).to(f32), minvar)
        better = best < nxc
        best = torch.where(better, nxc, best)
        best_x = torch.where(better, xf, best_x)
    score = torch.where(border, _nxcorr(dev0, var0, y1, minvar), best)
    corr = torch.where(keep, score.to(f32), nan)
    ok = keep & ~(score < _c(threshold, score))
    dg = d.to(f32)
    out = torch.where(border, dg, dg - best_x)
    return torch.where(ok, out, nan), corr


def match(stack0: torch.Tensor, stack1: torch.Tensor, cfg: dict,
          dtype=torch.float32):
    """``(search disparity, disparity, corrmap)`` of one pair under a
    configuration file's settings (``variant``, ``nxcorr_threshold``,
    ``subpixel_step``, ``min_variance``; LIMITED, full rows)."""
    if cfg.get("mode", "LIMITED") != "LIMITED":
        raise ValueError("the reference transform is LIMITED only")
    if cfg.get("disparity_range") is not None:
        raise ValueError("the reference scans full rows only")
    search = scan(stack0, stack1, cfg["variant"])
    disp, corr = agree(search, stack0, stack1, cfg["nxcorr_threshold"],
                       cfg.get("subpixel_step"), cfg.get("min_variance"),
                       dtype)
    return search, disp, corr
