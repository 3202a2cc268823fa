"""The CUDA kernels of the port against their plain PyTorch versions, on the
card. These tests need an NVIDIA GPU (marker ``cuda``) and skip without
one; run them there with ``python -m pytest tests/test_torch_cuda.py``.
``chip_smoke.py`` makes the same comparisons at the headline shapes."""

import numpy as np
import pytest
import torch

import libbicos_tpu_torch as tb
from libbicos_tpu_torch import agree as ta
from libbicos_tpu_torch import descriptor as td
from libbicos_tpu_torch import search as ts
from libbicos_tpu_torch.io import synthetic_stack_pair
from libbicos_tpu_torch.kernels import _build
from libbicos_tpu_torch.kernels.agree import agree_cuda, packed_bucket
from libbicos_tpu_torch.kernels.bases import chunk_window_bases_cuda
from libbicos_tpu_torch.kernels.consistency import (
    row_minima_consistency_words,
)
from libbicos_tpu_torch.kernels.hamming import row_minima_words
from libbicos_tpu_torch.kernels.transform import descriptor_words_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _pair(dev, n, h, w, dtype=np.uint8, seed=11):
    s0, s1, _ = synthetic_stack_pair(n, h, w, dtype=dtype, seed=seed)
    return torch.from_numpy(s0).to(dev), torch.from_numpy(s1).to(dev)


@pytest.mark.parametrize("n, mode, dtype", [
    (2, "LIMITED", np.uint8), (3, "LIMITED", np.uint16),
    (33, "LIMITED", np.uint8), (65, "LIMITED", np.uint16),
    (4, "FULL", np.uint8), (16, "FULL", np.uint16),
    # every other FULL kernel: n = 2..16, u8 and u16
    *((n, "FULL", dtype) for n in range(2, 17)
      for dtype in (np.uint8, np.uint16)
      if (n, dtype) not in ((4, np.uint8), (16, np.uint16))),
])
def test_transform_kernel_bit_identical(dev, n, mode, dtype):
    """The synthetic pattern; 2 and 3 gray levels, where ties between
    samples and between pair sums are common; 4 levels at the top of the
    dtype, where u16 pair sums pass 16 bits: bit-identical to the plain
    transform."""
    s, _, _ = synthetic_stack_pair(n, 9, 300, dtype=dtype, seed=11)
    top = np.iinfo(dtype).max
    m = tb.TransformMode[mode]
    for v in (s, s % 2, s % 3, top - s % 4):
        s0 = torch.from_numpy(np.ascontiguousarray(v, dtype=dtype)).to(dev)
        assert torch.equal(descriptor_words_cuda(s0, m),
                           td.descriptor_words(s0, m))


def _assert_scan_equal(w0, w1, drange=None):
    """``row_minima_words`` against the plain scan, first and last, with
    and without ``need_last``; ``hamming_mma`` counts the launches that
    took the tensor-core scan: every unranged one, no ranged one."""
    _build.reset_launch_counts()
    first, last = row_minima_words(w0, w1, True, drange=drange)
    _, pf, pl = ts.row_minima_torch_words(w0, w1, True, drange=drange)
    assert torch.equal(first, pf) and torch.equal(last, pl)
    f2, none = row_minima_words(w0, w1, False, drange=drange)
    assert none is None and torch.equal(f2, pf)
    counts = _build.launch_counts()
    assert counts["hamming"] == 2
    assert counts["hamming_mma"] == (2 if drange is None else 0)
    return first, last


# LIMITED n for each word count 1..8 (9, 17, ..., 65 shots: 30 to 254
# bits), FULL n 4, 8, 12, 16 (1, 2, 4, 8 words), and the first cases'
# widths: K = 128 bits for nw <= 4, 256 for 5-8.
@pytest.mark.parametrize("n, mode, w", [
    (2, "LIMITED", 70), (33, "LIMITED", 1100), (16, "FULL", 513),
    (65, "LIMITED", 129),
    *((n, "LIMITED", 1031) for n in (9, 17, 25, 41, 49, 57)),
    (34, "LIMITED", 3301),
    *((n, "FULL", 777) for n in (4, 8, 12)),
])
def test_scan_kernel_equal(dev, n, mode, w):
    s0, s1 = _pair(dev, n, 5, w)
    m = tb.TransformMode[mode]
    w0, w1 = td.descriptor_words(s0, m), td.descriptor_words(s1, m)
    _assert_scan_equal(w0, w1)
    _assert_scan_equal(w0, w1, drange=(0, 63))


def _scan_words(dev, case, nw, w0, w1, seed):
    """Left and right words for a scan edge case: ``random``; ``ties``,
    every column the same, so first = 0 and last = w1 - 1; ``dup``, the
    right row the left pixels, then an all-ones column, then the pixels
    again, so each best column has a twin; ``ones_zeros`` and
    ``zeros_ones``, all-ones words against all-zero ones and back, the
    greatest and least cost at each K; ``ones``, all ones both sides."""
    ones = torch.full((2, max(w0, w1), nw), -1, dtype=torch.int32,
                      device=dev)
    zeros = torch.zeros_like(ones)
    if case == "random":
        return (_random_words(dev, 2, w0, nw, seed),
                _random_words(dev, 2, w1, nw, seed + 1))
    if case == "ties":
        a = _random_words(dev, 2, w0, nw, seed)
        b = _random_words(dev, 2, 1, nw, seed + 1).expand(2, w1, nw)
        return a, b.contiguous()
    if case == "dup":
        a = _random_words(dev, 2, w0, nw, seed)
        return a, torch.cat([a, ones[:, :1], a], 1)
    if case == "ones_zeros":
        return ones[:, :w0].contiguous(), zeros[:, :w1].contiguous()
    if case == "zeros_ones":
        return zeros[:, :w0].contiguous(), ones[:, :w1].contiguous()
    return ones[:, :w0].contiguous(), ones[:, :w1].contiguous()


@pytest.mark.parametrize("case", ["random", "ties", "dup", "ones_zeros",
                                  "zeros_ones", "ones"])
@pytest.mark.parametrize("w0, w1", [
    (1, 1), (7, 63), (65, 129), (129, 7), (63, 3301), (3301, 65),
])
@pytest.mark.parametrize("nw", range(1, 9))
def test_scan_kernel_edges(dev, nw, w0, w1, case):
    """The tensor-core scan at every word count against the plain scan:
    ragged and unequal widths (a partial last tile of 8 columns, rows of
    one column, a stage and a chunk boundary inside the row), ties across
    the whole row, a duplicated best column, and the words that give the
    least and the greatest cost."""
    a, b = _scan_words(dev, case, nw, w0, w1, 17 * nw + w0)
    first, last = _assert_scan_equal(a, b)
    if case in ("ties", "ones_zeros", "zeros_ones", "ones"):
        assert bool((first == 0).all())
        assert bool((last == b.shape[1] - 1).all())
    if case == "dup":
        assert bool((last - first == w0 + 1).all())


# agree.cu's packed sweep at each edge of its shot buckets
# (kernels/agree.PACKED_BUCKETS: u8 16 / 33 / 65, u16 16 / 33, the
# recomputing sweep past them), in u8 and u16, at steps whose x tiles have
# remainders (20, 40 and 7 x values).
BUCKET_EDGES = [(n, dtype, step, 2.0 * n)
                for n in (2, 3, 8, 9, 16, 17, 33, 34, 65)
                for dtype in (np.uint8, np.uint16)
                for step in (0.1, 0.05, 0.3)]


@pytest.mark.parametrize("n, dtype, step, minvar", [
    (33, np.uint8, 0.1, 66.0), (33, np.uint8, None, None),
    (9, np.uint16, 0.25, 18.0), (65, np.uint16, 0.5, None),
    (2, np.uint8, None, 4.0), *BUCKET_EDGES,
])
def test_agree_kernel_matches_plain(dev, n, dtype, step, minvar):
    """The agree kernel against the plain agree; ``agree_packed`` counts
    the launch where the packed sweep ran (a step and a bucket that holds
    n: not u16 past 33 shots), and only there."""
    s0, s1 = _pair(dev, n, 6, 200, dtype)
    disp = ts.search_stack(s0, s1, tb.TransformMode.LIMITED,
                           tb.NoDuplicates(), backend="torch")
    _build.reset_launch_counts()
    out, corr = agree_cuda(disp, s0, s1, 0.5, step, minvar)
    packed = step is not None and (dtype == np.uint8 or n <= 33)
    assert bool(packed_bucket(n, s0.dtype, tb.Precision.SINGLE,
                              step)) == packed
    assert _build.launch_counts()["agree"] == 1
    assert _build.launch_counts()["agree_packed"] == int(packed)
    assert _build.launch_counts()["agree_double"] == 0
    if step is None:
        po, pc = ta.agree_integer(disp, s0, s1, 0.5, minvar)
        po = torch.where(po == ta.INVALID_I16,
                         torch.tensor(float("nan"), device=dev), po.float())
    else:
        po, pc = ta.agree_subpixel(disp, s0, s1, 0.5, step, minvar)
    assert torch.equal(torch.isnan(corr), torch.isnan(pc))
    m = ~torch.isnan(pc)
    torch.testing.assert_close(corr[m], pc[m], rtol=4e-6, atol=4e-6)
    assert torch.equal(torch.isnan(out), torch.isnan(po))
    assert torch.equal(out[~torch.isnan(po)], po[~torch.isnan(po)])


def test_match_cuda_launches_every_kernel_and_matches_plain(dev):
    s0, s1 = _pair(dev, 33, 16, 400)
    cfg = tb.Config(nxcorr_threshold=0.96, subpixel_step=0.1,
                    min_variance=2.0)
    _build.reset_launch_counts()
    got_d, got_c = tb.match(s0, s1, cfg, corrmap=True, backend="cuda")
    counts = _build.launch_counts()
    assert counts == {"transform": 2, "hamming": 1, "hamming_mma": 1,
                      "consistency": 0, "agree": 1, "agree_packed": 1,
                      "agree_double": 0, "band": 0, "band_consistency": 0,
                      "bases": 0}
    want_d, want_c = tb.match(s0, s1, cfg, corrmap=True, backend="torch")
    assert torch.equal(torch.isnan(got_d), torch.isnan(want_d))
    v = ~torch.isnan(want_d)
    assert torch.equal(got_d[v], want_d[v])
    m = ~torch.isnan(want_c)
    torch.testing.assert_close(got_c[m], want_c[m], rtol=4e-6, atol=4e-6)


def test_wrappers_reject_cpu_mixed_devices(dev):
    s0, _ = _pair(dev, 5, 2, 16)
    words = descriptor_words_cuda(s0, tb.TransformMode.LIMITED)
    with pytest.raises(ValueError, match="one CUDA device"):
        row_minima_words(words, words.cpu(), True)
    with pytest.raises(ValueError, match="one CUDA device"):
        row_minima_words(words.cpu(), words, True, drange=(0, 4))
    with pytest.raises(ValueError, match="one CUDA device"):
        row_minima_consistency_words(words, words.cpu(), no_dupes=True)


def _words_pair(dev, n, mode, h, w0, w1=None, seed=11):
    s0, s1 = _pair(dev, n, h, max(w0, w1 or w0), seed=seed)
    m = tb.TransformMode[mode]
    a = td.descriptor_words(s0, m)[:, :w0].contiguous()
    b = td.descriptor_words(s1, m)[:, :(w1 or w0)].contiguous()
    return a, b


def _random_words(dev, h, w, nw, seed):
    g = np.random.default_rng(seed)
    x = g.integers(-2**31, 2**31, size=(h, w, nw), dtype=np.int64)
    return torch.from_numpy(x.astype(np.int32)).to(dev)


RANGES = [(0, 511), (-5, 20), (100, 140), (5000, 6000), (-300, -200)]


@pytest.mark.parametrize("drange", RANGES)
@pytest.mark.parametrize("n, mode, w0, w1", [
    (33, "LIMITED", 1100, 1100), (16, "FULL", 513, 700),
    (65, "LIMITED", 300, 129), (2, "LIMITED", 70, 70),
])
def test_ranged_scan_kernel_equal(dev, n, mode, w0, w1, drange):
    """The ranged scan against its plain version, sentinels included
    ((5000, 6000) leaves every pixel without a candidate)."""
    a, b = _words_pair(dev, n, mode, 5, w0, w1)
    first, last = _assert_scan_equal(a, b, drange=drange)
    if drange == (5000, 6000):
        assert bool((first == -1).all()) and bool((last == -2).all())


def _assert_cons_equal(out, plain, no_dupes):
    (none0, f, l), (none1, rc, rcl) = out
    pf, pl, prc, prcl = plain
    assert none0 is None and none1 is None
    assert torch.equal(f, pf) and torch.equal(rc, prc)
    if no_dupes:
        assert torch.equal(l, pl) and torch.equal(rcl, prcl)
    else:
        assert l is None and rcl is None


@pytest.mark.parametrize("no_dupes", [True, False])
@pytest.mark.parametrize("drange", [None] + RANGES)
@pytest.mark.parametrize("n, mode, w0, w1", [
    (33, "LIMITED", 1100, 1100), (16, "FULL", 513, 700),
    (65, "LIMITED", 300, 129), (2, "LIMITED", 70, 70),
])
def test_consistency_kernel_equal(dev, n, mode, w0, w1, drange, no_dupes):
    a, b = _words_pair(dev, n, mode, 5, w0, w1)
    out = row_minima_consistency_words(a, b, no_dupes=no_dupes,
                                       drange=drange)
    _assert_cons_equal(
        out, ts.row_minima_consistency_torch_words(a, b, no_dupes, drange),
        no_dupes)


def _tie_words(dev, case, w0, w1, offs=(0,)):
    """Left and right words with ties: ``dupes``, duplicate columns on both
    sides; ``chunk_edges``, equal right columns on both sides of each
    128-column chunk boundary (127/128, 255/256, from each offset in
    ``offs``) and equal left pixels on both sides of the tile boundaries
    at 64, 128 and 192, each matched exactly by some pixel or column;
    ``cost256``, 8 all-zero words on the left against all-ones on the
    right, so every pair costs 256."""
    if case == "cost256":
        a = torch.zeros((3, w0, 8), dtype=torch.int32, device=dev)
        return a, torch.full((3, w1, 8), -1, dtype=torch.int32, device=dev)
    a = _random_words(dev, 3, w0, 2, 1)
    b = _random_words(dev, 3, w1, 2, 2)
    if case == "dupes":
        b[:, 500:520] = b[:, 10:30]
        a[:, 400:420] = a[:, 20:40]
        a[:, 40:60] = b[:, 10:30]
        a[:, 300:320] = b[:, 10:30]
        return a, b
    for off in offs:
        for j in (127, 255):
            b[:, off + j + 1] = b[:, off + j]
            a[:, off + j - 100] = b[:, off + j]
    for c in (63, 127, 191):
        a[:, c] = a[:, c + 1] = b[:, c - 20]
    return a, b


@pytest.mark.parametrize("case", ["dupes", "chunk_edges", "cost256"])
@pytest.mark.parametrize("no_dupes", [True, False])
def test_consistency_kernel_ties(dev, no_dupes, case):
    """Reverse and forward first/last tie order: duplicate columns, ties
    that straddle a chunk or tile boundary, and cost 256 in every pair
    (first 0 and last w - 1 in both directions), unranged and ranged."""
    a, b = _tie_words(dev, case, 600, 600)
    for drange in (None, (-40, 300)):
        out = row_minima_consistency_words(a, b, no_dupes=no_dupes,
                                           drange=drange)
        _assert_cons_equal(out, ts.row_minima_consistency_torch_words(
            a, b, no_dupes, drange), no_dupes)
    if case == "cost256":
        (_, f, l), (_, rc, rcl) = row_minima_consistency_words(
            a, b, no_dupes=no_dupes)
        assert bool((f == 0).all()) and bool((rc == 0).all())
        if no_dupes:
            assert bool((l == 599).all()) and bool((rcl == 599).all())


@pytest.mark.parametrize("nw", [4, 1, 3, 5, 8])
@pytest.mark.parametrize("no_dupes", [True, False])
@pytest.mark.parametrize("drange", [None, (0, 511), (-40, 300), (3, 3),
                                    (200, 300)])
@pytest.mark.parametrize("w0, w1", [(1061, 1100), (127, 129), (129, 127),
                                    (65, 63), (2048, 2048), (1, 700),
                                    (700, 1)])
def test_consistency_kernel_tile_edges(dev, w0, w1, drange, no_dupes, nw):
    """Widths around the warp tile (TILE = 64 left pixels, P = 2 a thread)
    and the block's P x TPB = 512 pixels: ragged last tiles (1061 = 2 x 512
    + 37), rows that end one pixel into a tile (65, 129), exact multiples,
    one-pixel rows; with ties from a small alphabet of descriptors of 1 to
    8 words. (200, 300) leaves 128-column chunks of a tile's window in
    which a pixel has only out-of-range pairs."""
    g = np.random.default_rng(w0 * 7 + w1)
    pool = g.integers(-2**31, 2**31, size=(24, nw)).astype(np.int32)
    a = torch.from_numpy(pool[g.integers(0, 24, (3, w0))]).to(dev)
    b = torch.from_numpy(pool[g.integers(0, 24, (3, w1))]).to(dev)
    out = row_minima_consistency_words(a, b, no_dupes=no_dupes,
                                       drange=drange)
    _assert_cons_equal(
        out, ts.row_minima_consistency_torch_words(a, b, no_dupes, drange),
        no_dupes)


@pytest.mark.parametrize("drange", [None, (0, 511), (-40000, 40000),
                                    (50000, 60000)])
def test_consistency_kernel_ultrawide(dev, drange):
    """2 rows x 40000 columns: the reverse minima live in the global
    scratch (320 KB a row with no_dupes, over the shared-memory limit)."""
    b = _random_words(dev, 2, 40000, 1, 3)
    a = torch.roll(b, 7, dims=1).contiguous()
    a[:, 30000:30010] = a[:, 100:110]
    for no_dupes in (True, False):
        out = row_minima_consistency_words(a, b, no_dupes=no_dupes,
                                           drange=drange)
        _assert_cons_equal(out, ts.row_minima_consistency_torch_words(
            a, b, no_dupes, drange), no_dupes)
    first, last = row_minima_words(a, b, True, drange=drange)
    _, pf, pl = ts.row_minima_torch_words(a, b, True, drange=drange)
    assert torch.equal(first, pf) and torch.equal(last, pl)


@pytest.mark.parametrize("variant, drange, expect", [
    (tb.Consistency(1, True), None,
     {"transform": 2, "hamming": 0, "hamming_mma": 0, "consistency": 1,
      "agree": 1, "agree_packed": 1, "agree_double": 0, "band": 0,
      "band_consistency": 0, "bases": 0}),
    (tb.NoDuplicates(), (0, 63),
     {"transform": 2, "hamming": 1, "hamming_mma": 0, "consistency": 0,
      "agree": 1, "agree_packed": 1, "agree_double": 0, "band": 0,
      "band_consistency": 0, "bases": 0}),
    (tb.Consistency(3, True), (0, 63),
     {"transform": 2, "hamming": 0, "hamming_mma": 0, "consistency": 1,
      "agree": 1, "agree_packed": 1, "agree_double": 0, "band": 0,
      "band_consistency": 0, "bases": 0}),
    (tb.Consistency(2, False), (-10, 40),
     {"transform": 2, "hamming": 0, "hamming_mma": 0, "consistency": 1,
      "agree": 1, "agree_packed": 1, "agree_double": 0, "band": 0,
      "band_consistency": 0, "bases": 0}),
])
def test_match_cuda_variants_match_plain(dev, variant, drange, expect):
    s0, s1 = _pair(dev, 33, 16, 400)
    cfg = tb.Config(nxcorr_threshold=0.96, subpixel_step=0.1,
                    min_variance=2.0, variant=variant,
                    disparity_range=drange)
    _build.reset_launch_counts()
    got_d, got_c = tb.match(s0, s1, cfg, corrmap=True, backend="cuda")
    assert _build.launch_counts() == expect
    want_d, want_c = tb.match(s0, s1, cfg, corrmap=True, backend="torch")
    assert torch.equal(torch.isnan(got_d), torch.isnan(want_d))
    v = ~torch.isnan(want_d)
    assert torch.equal(got_d[v], want_d[v])
    m = ~torch.isnan(want_c)
    torch.testing.assert_close(got_c[m], want_c[m], rtol=4e-6, atol=4e-6)


def _band_steps(a, b, nbands, need_last, drange):
    """Every (band, visit) of a ring over ``nbands`` column bands, kernel and
    plain fold from the same accumulators; returns the kernel's minima."""
    from libbicos_tpu_torch.kernels.band import row_minima_band

    w1_total = b.shape[1]
    band0 = -(-a.shape[1] // nbands)
    band = -(-w1_total // nbands)
    a = torch.nn.functional.pad(a, (0, 0, 0, band0 * nbands - a.shape[1]))
    b = torch.nn.functional.pad(b, (0, 0, 0, band * nbands - w1_total))
    out = []
    for idx in range(nbands):
        a_j = a[:, idx * band0:(idx + 1) * band0].contiguous()
        acc = [torch.full(a_j.shape[:2], ts.BIG, dtype=torch.int32,
                          device=a.device) for _ in range(2)]
        ref = [t.clone() for t in acc]
        for i in range(nbands):
            src = (idx + i) % nbands
            b_s = b[:, src * band:(src + 1) * band].contiguous()
            row_minima_band(a_j, b_s, idx * band0, src * band, acc[0],
                            acc[1] if need_last else None,
                            w1_total=w1_total, drange=drange)
            ts.row_minima_band_torch_words(
                a_j, b_s, idx * band0, src * band, ref[0],
                ref[1] if need_last else None, w1_total=w1_total,
                drange=drange)
            assert torch.equal(acc[0], ref[0]), (idx, src)
            assert torch.equal(acc[1], ref[1]), (idx, src)
        out.append(acc)
    return out


@pytest.mark.parametrize("need_last", [True, False])
@pytest.mark.parametrize("drange", [None, (0, 511), (-5, 20), (5000, 6000)])
@pytest.mark.parametrize("n, mode, w0, w1, nbands", [
    (33, "LIMITED", 1100, 1100, 4), (3, "LIMITED", 700, 700, 3),
    (16, "FULL", 513, 700, 4), (65, "LIMITED", 300, 129, 2),
])
def test_band_kernel_equal(dev, n, mode, w0, w1, nbands, drange, need_last):
    """``csrc/band.cu`` against its plain fold at every ring step, ring
    padding (widths not a multiple of the band count) included."""
    a, b = _words_pair(dev, n, mode, 5, w0, w1)
    _band_steps(a, b, nbands, need_last, drange)


def test_band_kernel_ties_and_ultrawide(dev):
    """Duplicate columns in different bands, on 2 x 20000 rows."""
    b = _random_words(dev, 2, 20000, 1, 3)
    a = torch.roll(b, 7, dims=1).contiguous()
    b[:, 19000:19010] = b[:, 100:110]
    for drange in (None, (-300, 300)):
        acc = _band_steps(a, b, 4, True, drange)
        cost, first, last = ts.decode_minima(
            torch.cat([x[0] for x in acc], 1)[:, :20000],
            torch.cat([x[1] for x in acc], 1)[:, :20000], 20000)
        _, pf, pl = ts.row_minima_torch_words(a, b, True, drange=drange)
        assert torch.equal(first, pf) and torch.equal(last, pl)


def _cons_ring(a, b, nbands, need_last, drange):
    """Every (band, visit) of a ring of the fused Consistency step over
    ``nbands`` column bands of equal-width rows, kernel and plain step from
    the same accumulators, equal after every step; returns the kernel's
    forward ``(mf, ml)`` per band and reverse ``(rf, rl)``."""
    from libbicos_tpu_torch.kernels.band import row_minima_consistency_band

    w = a.shape[1]
    band = -(-w // nbands)
    a = torch.nn.functional.pad(a, (0, 0, 0, band * nbands - w))
    b = torch.nn.functional.pad(b, (0, 0, 0, band * nbands - w))
    h = a.shape[0]

    def full(shape):
        return torch.full(shape, ts.BIG, dtype=torch.int32, device=a.device)

    got = [[full((h, band)) for _ in range(nbands)] for _ in range(2)]
    want = [[full((h, band)) for _ in range(nbands)] for _ in range(2)]
    rev, rev_want = full((2, h, nbands * band)), full((2, h, nbands * band))
    for i in range(nbands):
        for j in range(nbands):
            src = (j + i) % nbands
            a_j = a[:, j * band:(j + 1) * band].contiguous()
            b_s = b[:, src * band:(src + 1) * band].contiguous()
            for fold, (mf, ml), r in (
                    (row_minima_consistency_band,
                     (got[0][j], got[1][j]), rev),
                    (ts.row_minima_consistency_band_torch_words,
                     (want[0][j], want[1][j]), rev_want)):
                fold(a_j, b_s, j * band, src * band, mf,
                     ml if need_last else None, r[0],
                     r[1] if need_last else None, w_total=w, drange=drange)
            assert torch.equal(got[0][j], want[0][j]), (j, src)
            assert torch.equal(got[1][j], want[1][j]), (j, src)
            assert torch.equal(rev, rev_want), (j, src)
    return got, rev


@pytest.mark.parametrize("need_last", [True, False])
@pytest.mark.parametrize("drange", [None, (0, 511), (-5, 20), (5000, 6000)])
@pytest.mark.parametrize("n, mode, w, nbands", [
    (33, "LIMITED", 1100, 4), (3, "LIMITED", 700, 3), (16, "FULL", 513, 4),
    (65, "LIMITED", 300, 2), (9, "LIMITED", 1001, 1),
])
def test_consistency_band_kernel_equal(dev, n, mode, w, nbands, drange,
                                       need_last):
    """The fused Consistency ring step against its plain version at every
    ring step (ragged bands included), and the ring's decoded forward and
    reverse argmins against the Consistency scan's."""
    a, b = _words_pair(dev, n, mode, 5, w)
    (mf, ml), rev = _cons_ring(a, b, nbands, need_last, drange)
    first = torch.cat([ts.decode_minima(f, None, w)[1] for f in mf],
                      1)[:, :w]
    _, first1, last1 = ts.decode_minima(rev[0], rev[1], w)
    pf, pl, prc, prcl = ts.row_minima_consistency_torch_words(a, b, True,
                                                              drange)
    assert torch.equal(first, pf)
    rc0, rc0_last = ts._lookup_reverse(first1[:, :w], last1[:, :w], first)
    assert torch.equal(rc0, prc)
    if need_last:
        assert torch.equal(rc0_last, prcl)


@pytest.mark.parametrize("case", ["ultrawide", "chunk_edges", "cost256"])
def test_consistency_band_kernel_ties_and_ultrawide(dev, case):
    """Ties over a ring of 4 bands, ranged and not: duplicate columns in
    different bands on both sides of 2 x 20000 rows; ties that straddle a
    chunk or tile boundary in every 300-column band of 1200-column rows;
    cost 256 in every pair (first 0 and last w - 1 in both directions)."""
    if case == "ultrawide":
        b = _random_words(dev, 2, 20000, 1, 3)
        a = torch.roll(b, 7, dims=1).contiguous()
        b[:, 19000:19010] = b[:, 100:110]
        a[:, 15000:15010] = a[:, 300:310]
    else:
        a, b = _tie_words(dev, case, 1200, 1200, offs=(0, 300, 600, 900))
    for drange in (None, (-300, 300)):
        for need_last in (True, False):
            _cons_ring(a, b, 4, need_last, drange)
    if case == "cost256":
        w = a.shape[1]
        (mf, _), rev = _cons_ring(a, b, 4, True, None)
        first = torch.cat([ts.decode_minima(f, None, w)[1] for f in mf],
                          1)[:, :w]
        _, first1, last1 = ts.decode_minima(rev[0], rev[1], w)
        assert bool((first == 0).all()) and bool((first1[:, :w] == 0).all())
        assert bool((last1[:, :w] == w - 1).all())


def test_consistency_band_kernel_global_reverse(dev):
    """A one-band ring at w = 32767 (the widest the ring packs): the
    visiting band's reverse minima (262 KB) exceed a block's shared memory,
    so the step folds them into the accumulators with global atomics."""
    b = _random_words(dev, 1, 32767, 1, 5)
    a = torch.roll(b, 11, dims=1).contiguous()
    b[:, 30000:30004] = b[:, 10:14]
    for drange in (None, (0, 511)):
        _cons_ring(a, b, 1, True, drange)


@pytest.mark.parametrize("step, minvar", [(0.1, 66.0), (None, None),
                                          (0.25, 18.0)])
def test_agree_kernel_band_col_offset(dev, step, minvar):
    """A left column band against the whole right row (w1 != w), with the
    band-local disparity and a column offset."""
    s0, s1 = _pair(dev, 33, 6, 400)
    disp = ts.search_stack(s0, s1, tb.TransformMode.LIMITED,
                           tb.NoDuplicates(), backend="torch")
    off = 150
    local = disp[:, off:off + 100].to(torch.int32)
    d = torch.where(local == ta.INVALID_I16, ta.INVALID_I16,
                    local - off).to(torch.int16).contiguous()
    s0b = s0[:, :, off:off + 100].contiguous()
    out, corr = agree_cuda(d, s0b, s1, 0.5, step, minvar, col_offset=off)
    if step is None:
        po, pc = ta.agree_integer(d, s0b, s1, 0.5, minvar, col_offset=off)
        po = torch.where(po == ta.INVALID_I16,
                         torch.tensor(float("nan"), device=dev), po.float())
    else:
        po, pc = ta.agree_subpixel(d, s0b, s1, 0.5, step, minvar,
                                   col_offset=off)
    assert torch.equal(torch.isnan(corr), torch.isnan(pc))
    m = ~torch.isnan(pc)
    torch.testing.assert_close(corr[m], pc[m], rtol=4e-6, atol=4e-6)
    assert torch.equal(torch.isnan(out), torch.isnan(po))
    assert torch.equal(out[~torch.isnan(po)], po[~torch.isnan(po)])


@pytest.mark.parametrize("variant, drange, band_launches", [
    (tb.NoDuplicates(), None, {"band": 9, "band_consistency": 0}),
    (tb.Consistency(1, True), None, {"band": 0, "band_consistency": 9}),
    (tb.NoDuplicates(), (0, 63), {"band": 6, "band_consistency": 0}),
])
def test_match_sharded_w_on_one_card_equals_match(dev, variant, drange,
                                                  band_launches):
    """W-banded matching over 3 bands on one card (a virtual mesh) equals
    the single-card call exactly, corrmap included. Consistency runs one
    ring of the fused step: 3 x 3 launches."""
    from libbicos_tpu_torch import sharding

    s0, s1 = _pair(dev, 33, 16, 400)
    cfg = tb.Config(nxcorr_threshold=0.96, subpixel_step=0.1,
                    min_variance=2.0, variant=variant,
                    disparity_range=drange)
    want_d, want_c = tb.match(s0, s1, cfg, corrmap=True, backend="cuda")
    mesh = sharding.make_mesh(3, virtual=True, device=dev)
    _build.reset_launch_counts()
    got_d, got_c = sharding.match_sharded_w(s0, s1, cfg, mesh=mesh,
                                            corrmap=True, backend="cuda")
    assert _build.launch_counts() == {
        "transform": 6, "hamming": 0, "hamming_mma": 0, "consistency": 0,
        "agree": 3, "agree_packed": 3, "agree_double": 0, **band_launches,
        "bases": 0}
    for got, want in ((got_d, want_d), (got_c, want_c)):
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    hd, hc = sharding.match_sharded(s0, s1, cfg, mesh=mesh, corrmap=True)
    assert torch.equal(torch.nan_to_num(hd), torch.nan_to_num(want_d))
    assert torch.equal(torch.nan_to_num(hc), torch.nan_to_num(want_c))


def test_distmesh_nccl_four_cards_equal_localmesh(dev, tmp_path):
    """The sharded paths over NCCL, one process and one card per band
    (``tests/test_torch_dist.py``'s workers and cases), equal to a
    ``LocalMesh`` of 4 bands on card 0. Needs 4 cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    from test_torch_dist import run_group

    run_group(tmp_path, 4, "nccl")


# ---------------------------------------------------------------------------
# The dynamic window (bases.cu, the windowed agree.cu) and DOUBLE.


def _mixed_disp(dev, s0, s1, seed=3):
    """The search disparity with planted far matches and invalid pixels, so
    that some chunks take the window and some fall back."""
    disp = ts.search_stack(s0, s1, tb.TransformMode.LIMITED,
                           tb.NoDuplicates(), backend="torch").clone()
    g = np.random.default_rng(seed)
    w = disp.shape[1]
    cols = torch.arange(0, w, 97, device=dev)
    far = torch.from_numpy(g.integers(0, 2, cols.numel())).to(dev)
    # Row 0: matches on the borders (col1 = 0 or w - 1) every 97 columns;
    # row 1: matched columns 10..19 beside columns 1200..1209.
    disp[0, cols] = (cols - far * (w - 1)).to(torch.int16)
    disp[1, 1200:1210] = 1190
    disp[torch.from_numpy(g.random(tuple(disp.shape)) < 0.05).to(dev)] = (
        ta.INVALID_I16)
    return disp.contiguous()


@pytest.mark.parametrize("chunk, wcap", [(256, 640), (512, 1024)])
@pytest.mark.parametrize("w", [1408, 1412])
def test_bases_kernel_equal(dev, chunk, wcap, w):
    s0, s1 = _pair(dev, 5, 8, w)
    wp = -(-w // chunk) * chunk
    for disp in (ts.search_stack(s0, s1, tb.TransformMode.LIMITED,
                                 tb.NoDuplicates(), backend="torch"),
                 _mixed_disp(dev, s0, s1)):
        got = chunk_window_bases_cuda(disp, w, wp, wcap, chunk)
        want = ta.chunk_window_bases(disp, w, wp, wcap, chunk)
        assert torch.equal(got, want)
    assert bool((want >= 0).any()) and bool((want < 0).any())


def _edge_disp(dev, h, wd, seed):
    """Random disparities with 10% invalid pixels, a row all invalid and a
    row all out of range (every matched column negative)."""
    g = np.random.default_rng(seed)
    d = g.integers(-60, 400, (h, wd)).astype(np.int16)
    d[g.random((h, wd)) < 0.1] = ta.INVALID_I16
    if h > 2:
        d[1] = ta.INVALID_I16
        d[2] = np.arange(wd) + 7
    return torch.from_numpy(d).to(dev)


@pytest.mark.parametrize("chunk, wcap, pad", [
    (128, 256, 0), (256, 640, 0), (512, 1024, 0), (256, 640, 2),
    (130, 384, 0), (4, 256, 1), (384, 640, 1),
])
@pytest.mark.parametrize("h, wd", [(5, 1408), (5, 1409), (5, 1410),
                                   (5, 1411), (1, 3300), (3, 127)])
def test_bases_kernel_equal_edges(dev, chunk, wcap, pad, h, wd):
    """Both paths of bases.cu (the vector path: chunk % 128 == 0, W % 4 ==
    0, aligned rows; the scalar path: the rest) equal the plain version
    exactly: W % 4 of 0-3, a ragged last chunk (W < wp), ``pad`` chunks
    wholly past W, one row, rows all invalid or all out of range."""
    disp = _edge_disp(dev, h, wd, seed=wd + chunk)
    wp = (-(-wd // chunk) + pad) * chunk
    w = wd if wd > 200 else 900  # a right row wider than the left one
    _build.reset_launch_counts()
    got = chunk_window_bases_cuda(disp, w, wp, wcap, chunk)
    assert _build.launch_counts()["bases"] == 1
    assert torch.equal(got, ta.chunk_window_bases(disp, w, wp, wcap, chunk))


def test_bases_kernel_unaligned_and_noncontiguous(dev):
    """A disparity whose base is 2 bytes past an 8-byte boundary takes the
    scalar path and gives the same bases; a non-contiguous one is refused."""
    h, wd, chunk, wcap = 4, 1412, 256, 640
    disp = _edge_disp(dev, h, wd, seed=1)
    buf = torch.empty(h * wd + 1, dtype=torch.int16, device=dev)
    buf[1:] = disp.reshape(-1)
    shifted = buf[1:].view(h, wd)
    assert shifted.data_ptr() % 8 == 2 and shifted.is_contiguous()
    wp = -(-wd // chunk) * chunk
    want = ta.chunk_window_bases(disp, wd, wp, wcap, chunk)
    assert torch.equal(chunk_window_bases_cuda(shifted, wd, wp, wcap, chunk),
                       want)
    with pytest.raises(ValueError, match="contiguous"):
        chunk_window_bases_cuda(disp.t(), h, 256, 128, 128)


def _plain_agree(disp, s0, s1, thr, step, minvar, precision, col_offset=0):
    if step is None:
        po, pc = ta.agree_integer(disp, s0, s1, thr, minvar, col_offset,
                                  precision=precision)
        po = torch.where(po == ta.INVALID_I16,
                         torch.tensor(float("nan"), device=po.device),
                         po.float())
        return po, pc
    return ta.agree_subpixel(disp, s0, s1, thr, step, minvar, col_offset,
                             precision=precision)


def _assert_bitwise(a, b):
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def _assert_plain_bar(out, corr, po, pc):
    assert torch.equal(torch.isnan(corr), torch.isnan(pc))
    m = ~torch.isnan(pc)
    torch.testing.assert_close(corr[m], pc[m], rtol=4e-6, atol=4e-6)
    assert torch.equal(torch.isnan(out), torch.isnan(po))
    assert torch.equal(out[~torch.isnan(po)], po[~torch.isnan(po)])


@pytest.mark.parametrize("step, minvar", [(0.1, 2.0), (0.25, None),
                                          (None, 2.0), (None, None),
                                          (0.05, 2.0), (0.3, None)])
@pytest.mark.parametrize("n, dtype, chunk, wcap", [
    (2, np.uint8, 256, 640), (33, np.uint8, 256, 640),
    (33, np.uint16, 512, 1024), (65, np.uint16, 512, 1024),
    (65, np.uint8, 256, 640),
    # the packed sweep's other buckets and the u16 fallback
    (16, np.uint16, 256, 640), (17, np.uint8, 256, 640),
    (34, np.uint8, 256, 640), (34, np.uint16, 256, 640),
])
def test_windowed_agree_equals_global(dev, n, dtype, chunk, wcap, step,
                                      minvar):
    """The windowed agree.cu equals the global-read agree.cu bit for bit,
    corrmap included (the same arithmetic), and the plain agree to the
    usual bar. n=65 u16 at wcap 1024 stages 133,380 bytes a block (the
    opt-in shared memory)."""
    w = 1412
    s0, s1 = _pair(dev, n, 6, w, dtype)
    disp = _mixed_disp(dev, s0, s1)
    wp = -(-w // chunk) * chunk
    bases = chunk_window_bases_cuda(disp, w, wp, wcap, chunk)
    assert bool((bases >= 0).any()) and bool((bases < 0).any())
    mv = None if minvar is None else minvar * n
    _build.reset_launch_counts()
    win = agree_cuda(disp, s0, s1, 0.5, step, mv, bases=bases, chunk=chunk,
                     wcap=wcap)
    glob = agree_cuda(disp, s0, s1, 0.5, step, mv)
    assert _build.launch_counts()["agree"] == 2
    for a, b in zip(win, glob):
        _assert_bitwise(a, b)
    _assert_plain_bar(*win, *_plain_agree(disp, s0, s1, 0.5, step, mv,
                                          tb.Precision.SINGLE))


def test_windowed_agree_rejects_bad_windows(dev):
    s0, s1 = _pair(dev, 5, 2, 800)
    disp = ts.search_stack(s0, s1, tb.TransformMode.LIMITED,
                           tb.NoDuplicates(), backend="torch")
    bases = chunk_window_bases_cuda(disp, 800, 1024, 640, 256)
    with pytest.raises(ValueError, match="W1 == W"):
        agree_cuda(disp, s0, s1, 0.5, None, None, 3, bases=bases, chunk=256,
                   wcap=640)
    with pytest.raises(ValueError, match="window"):
        agree_cuda(disp, s0, s1, 0.5, None, None, bases=bases, chunk=256,
                   wcap=300)
    with pytest.raises(ValueError, match="bases"):
        agree_cuda(disp, s0, s1, 0.5, None, None,
                   bases=bases[:, :2].contiguous(), chunk=256, wcap=640)


@pytest.mark.parametrize("step, minvar", [(0.1, 66.0), (0.25, None),
                                          (None, 18.0), (None, None),
                                          (0.05, 18.0), (0.3, None)])
@pytest.mark.parametrize("n, dtype", [
    (33, np.uint8), (9, np.uint16), (65, np.uint16), (2, np.uint8),
    # the edges of the packed sweep's buckets in DOUBLE
    (3, np.uint16), (8, np.uint8), (16, np.uint8), (17, np.uint16),
    (17, np.uint8), (33, np.uint16), (34, np.uint8), (34, np.uint16),
    (65, np.uint8)])
def test_double_agree_kernel_matches_plain(dev, n, dtype, step, minvar):
    """The f64 agree kernel against the plain f64 agree; DOUBLE differs
    from SINGLE in the corrmap somewhere. DOUBLE takes the packed sweep for
    u8 at 17 to 33 shots alone (``agree_packed``)."""
    s0, s1 = _pair(dev, n, 6, 300, dtype)
    disp = ts.search_stack(s0, s1, tb.TransformMode.LIMITED,
                           tb.NoDuplicates(), backend="torch")
    _build.reset_launch_counts()
    out, corr = agree_cuda(disp, s0, s1, 0.5, step, minvar,
                           precision=tb.Precision.DOUBLE)
    packed = step is not None and dtype == np.uint8 and 17 <= n <= 33
    assert _build.launch_counts()["agree_packed"] == int(packed)
    assert _build.launch_counts()["agree_double"] == 1
    _assert_plain_bar(out, corr, *_plain_agree(
        disp, s0, s1, 0.5, step, minvar, tb.Precision.DOUBLE))
    if n == 33:
        _, c32 = agree_cuda(disp, s0, s1, 0.5, step, minvar)
        m = ~torch.isnan(corr)
        assert bool((corr[m] != c32[m]).any())


@pytest.mark.parametrize("variant, drange, scans", [
    (tb.NoDuplicates(), None, {"hamming": 1, "hamming_mma": 1}),
    (tb.Consistency(1, True), None, {"consistency": 1}),
    (tb.NoDuplicates(), (0, 63), {"hamming": 1}),
])
def test_match_cuda_dynwin_equals_window_off(dev, monkeypatch, variant,
                                             drange, scans):
    """``BICOS_AGREE_DYNWIN=640`` launches the bases kernel and the
    windowed agree, and changes no bit of the result."""
    s0, s1 = _pair(dev, 33, 16, 1400)
    cfg = tb.Config(nxcorr_threshold=0.96, subpixel_step=0.1,
                    min_variance=2.0, variant=variant,
                    disparity_range=drange)
    monkeypatch.delenv("BICOS_AGREE_DYNWIN", raising=False)
    want = tb.match(s0, s1, cfg, corrmap=True)
    monkeypatch.setenv("BICOS_AGREE_DYNWIN", "640")
    _build.reset_launch_counts()
    got = tb.match(s0, s1, cfg, corrmap=True)
    assert _build.launch_counts() == {
        "transform": 2, "hamming": 0, "hamming_mma": 0, "consistency": 0,
        "agree": 1, "agree_packed": 1, "agree_double": 0, "band": 0,
        "band_consistency": 0, "bases": 1, **scans}
    for a, b in zip(got, want):
        _assert_bitwise(a, b)


def test_match_cuda_double_launches_and_matches_plain(dev):
    s0, s1 = _pair(dev, 33, 16, 400)
    cfg = tb.Config(nxcorr_threshold=0.96, subpixel_step=0.1,
                    min_variance=2.0, precision=tb.Precision.DOUBLE)
    _build.reset_launch_counts()
    got_d, got_c = tb.match(s0, s1, cfg, corrmap=True)
    assert _build.launch_counts() == {
        "transform": 2, "hamming": 1, "hamming_mma": 1, "consistency": 0,
        "agree": 1, "agree_packed": 1, "agree_double": 1, "band": 0,
        "band_consistency": 0, "bases": 0}
    want_d, want_c = tb.match(s0, s1, cfg, corrmap=True, backend="torch")
    _assert_plain_bar(got_d, got_c, want_d, want_c)


# ---------------------------------------------------------------------------
# The edges of agree.cu's cached shot terms and exact rounding, and of
# transform.cu's vector copies and stores.

EDGE_W = 700  # a window of (256, 640) resolves at this width


def _agree_edge(dev, case):
    """``(s0, s1, disp, threshold, minvar, col_offset)`` of one agree edge
    case, made from seeds."""
    g = np.random.default_rng(23)
    n, dtype = {"n2": (2, np.uint8), "n65_u8": (65, np.uint8),
                "n65_u16": (65, np.uint16), "u16_extremes": (9, np.uint16),
                "band_offset": (9, np.uint16), "ties_n33": (33, np.uint8),
                "u8_extremes_n33": (33, np.uint8),
                "u16_extremes_n33": (33, np.uint16)}.get(case, (9, np.uint8))
    s0, s1 = _pair(dev, n, 4, EDGE_W, dtype, seed=29)
    disp = ts.search_stack(s0, s1, tb.TransformMode.LIMITED,
                           tb.NoDuplicates(), backend="torch")
    thr, minvar, off = 0.5, 2.0 * n, 0
    if case in ("ties_constant", "ties_symmetric", "ties_n33"):
        # Equal neighbours (y0 == y1 == y2: every x gives one series) or a
        # mirror (y0 == y2: x and -x give one series).
        cols = torch.arange(EDGE_W, device=dev)
        src = cols % 2 if case == "ties_symmetric" else torch.zeros_like(cols)
        s1 = s1[:, :, src].contiguous()
        thr = -1.0
    elif case in ("nan_no_minvar", "minvar"):
        s0[:, 1] = 77  # zero variance on row 1
        thr = -1.0
        minvar = None if case == "nan_no_minvar" else minvar
    elif case == "border":
        cols = torch.arange(0, EDGE_W, 5, device=dev)
        disp = disp.clone()
        disp[0, cols] = cols.to(torch.int16)  # col1 = 0
        disp[1, cols] = (cols - (EDGE_W - 1)).to(torch.int16)  # col1 = w - 1
    elif case in ("u16_extremes", "band_offset", "u8_extremes_n33",
                  "u16_extremes_n33"):
        # 0 next to the maximum: the parabola overshoots below 0 and above
        # the maximum, and the modular cast wraps.
        top = int(np.iinfo(dtype).max)
        s1 = torch.from_numpy(g.choice([0, top], size=tuple(s1.shape))
                              .astype(dtype)).to(dev)
        thr = -1.0
        if case == "band_offset":
            off = 150
            local = disp[:, off:off + 300].to(torch.int32)
            disp = torch.where(local == ta.INVALID_I16, ta.INVALID_I16,
                               local - off).to(torch.int16)
            s0 = s0[:, :, off:off + 300]
    return (s0.contiguous(), s1.contiguous(), disp.contiguous(), thr, minvar,
            off)


AGREE_EDGES = ["ties_constant", "ties_symmetric", "nan_no_minvar", "minvar",
               "border", "n2", "n65_u8", "n65_u16", "u16_extremes",
               "band_offset", "ties_n33", "u8_extremes_n33",
               "u16_extremes_n33"]
# Where agree.cu's DOUBLE corrmap differs from the plain f64 agree's in its
# last bits: the kernel's covariance and variance chains are fmas, the plain
# version's a multiply, then an add. On n=33 u8 0/255 stacks one or two
# NXCORRs within 3.5e-18 of 0 round apart (at steps 0.1, 0.05 and the
# integer check; the recomputing sweep gives the same bits). There the
# DOUBLE corrmap is held to the usual bar.
DOUBLE_NEAR = {"u8_extremes_n33"}


@pytest.mark.parametrize("step", [0.1, 0.25, None, 0.05, 0.3])
@pytest.mark.parametrize("case", AGREE_EDGES)
def test_agree_kernel_edges(dev, case, step):
    """The agree kernel against the plain agree (the usual bar), its DOUBLE
    instantiation against the plain f64 agree and the windowed variant
    against the global-read one (both bit for bit; DOUBLE_NEAR: the usual
    bar), at the edges of the sweep: ties, NaN and -1 NXCORRs, border
    columns, n = 2 and 65, u16 overshoot, a column band with an offset,
    and at n = 33 (the packed sweep's headline bucket) ties and samples
    that wrap at both widths."""
    s0, s1, disp, thr, minvar, off = _agree_edge(dev, case)
    out, corr = agree_cuda(disp, s0, s1, thr, step, minvar, off)
    _assert_plain_bar(out, corr, *_plain_agree(
        disp, s0, s1, thr, step, minvar, tb.Precision.SINGLE, off))
    dbl = agree_cuda(disp, s0, s1, thr, step, minvar, off,
                     precision=tb.Precision.DOUBLE)
    want = _plain_agree(disp, s0, s1, thr, step, minvar, tb.Precision.DOUBLE,
                        off)
    if case in DOUBLE_NEAR:
        _assert_plain_bar(*dbl, *want)
    else:
        for a, b in zip(dbl, want):
            _assert_bitwise(a, b)
    if not off:
        chunk, wcap = 256, 640
        bases = chunk_window_bases_cuda(
            disp, EDGE_W, -(-EDGE_W // chunk) * chunk, wcap, chunk)
        assert bool((bases >= 0).any())
        for prec, want in ((tb.Precision.SINGLE, (out, corr)),
                           (tb.Precision.DOUBLE, dbl)):
            got = agree_cuda(disp, s0, s1, thr, step, minvar, bases=bases,
                             chunk=chunk, wcap=wcap, precision=prec)
            for a, b in zip(got, want):
                _assert_bitwise(a, b)
    col1 = torch.arange(s0.shape[2], device=dev)[None] - disp.long()
    kept = ((disp != ta.INVALID_I16) & (col1 >= 0)
            & (col1 < s1.shape[2]))
    swept = kept & (col1 > 0) & (col1 < s1.shape[2] - 1)
    if step is None:
        swept = torch.zeros_like(kept)
    if case in ("ties_constant", "ties_n33") and step is not None:
        # Every x ties: the first, x = -1, wins.
        assert bool(swept.any())
        assert torch.equal(out[swept], disp[swept].float() + 1.0)
    if case == "ties_symmetric" and step == 0.25:
        # x and -x tie (the 0.25 grid is exact, unlike 0.1's accumulated
        # one): the negative one comes first, so d - x >= d.
        assert bool((out[swept] >= disp[swept].float()).all())
    if case == "nan_no_minvar":
        # Row 1's NXCORRs are NaN: kept, with corr -1 where no x wins and
        # NaN on the integer check.
        row = kept[1]
        assert bool(row.any()) and not bool(torch.isnan(out[1][row]).any())
        assert bool((corr[1][swept[1]] == -1.0).all())
        assert bool(torch.isnan(corr[1][row & ~swept[1]]).all())
    if case == "minvar":
        assert bool((corr[1][kept[1]] == -1.0).all())
    if case == "border":
        assert bool((kept & ~swept).any())


@pytest.mark.parametrize("n, mode, dtype, h, w, cut", [
    (33, "LIMITED", np.uint8, 7, 301, None),      # h*w odd: unaligned planes
    (33, "LIMITED", np.uint8, 4, 1600, None),     # whole tiles, aligned
    (9, "LIMITED", np.uint8, 6, 1001, "rows"),    # a row band made contiguous
    (9, "LIMITED", np.uint8, 5, 1030, "view"),    # a view at a shot offset
    (2, "LIMITED", np.uint16, 6, 333, None),
    (3, "LIMITED", np.uint16, 5, 517, "view"),
    (3, "LIMITED", np.uint8, 3, 999, None),
    (65, "LIMITED", np.uint16, 6, 1111, "rows"),
    (65, "LIMITED", np.uint8, 2, 1500, None),
    # (n - 4) % 8 >= 6: the last block spills into one more word.
    (10, "LIMITED", np.uint8, 5, 301, None),
    (10, "LIMITED", np.uint16, 4, 517, "view"),
    (11, "LIMITED", np.uint8, 6, 1001, "rows"),
    (11, "LIMITED", np.uint16, 3, 999, None),
    (18, "LIMITED", np.uint8, 4, 1600, None),
    (18, "LIMITED", np.uint16, 5, 333, None),
    (27, "LIMITED", np.uint8, 3, 517, "view"),
    (27, "LIMITED", np.uint16, 6, 1111, "rows"),
    (2, "FULL", np.uint8, 3, 301, None),
    (3, "FULL", np.uint8, 4, 517, "view"),
    (16, "FULL", np.uint16, 5, 203, None),
    # FULL at each store width (nw = 8, 4, 6: 16-byte, 8-byte; 2, 3, 7:
    # scalar), a ragged last tile, unaligned planes, a view, a row band.
    (16, "FULL", np.uint8, 7, 301, None),
    (16, "FULL", np.uint8, 3, 517, "view"),
    (16, "FULL", np.uint8, 4, 1536, None),        # whole tiles, aligned
    (16, "FULL", np.uint16, 6, 1111, "rows"),
    (16, "FULL", np.uint16, 4, 517, "view"),
    (11, "FULL", np.uint8, 4, 1600, None),
    (14, "FULL", np.uint16, 3, 999, None),
    (7, "FULL", np.uint8, 5, 1030, "view"),
    (9, "FULL", np.uint16, 6, 1001, "rows"),
    (15, "FULL", np.uint8, 5, 333, None),
])
def test_transform_kernel_edges(dev, n, mode, dtype, h, w, cut):
    """Ragged tails (h*w not a multiple of 4 or 16, odd widths), plane
    strides that are not 16-byte aligned, a row band made contiguous and a
    stack that is a view at an offset: bit-identical to the plain
    transform."""
    s, _ = _pair(dev, n + (cut == "view"), h, w, dtype, seed=31)
    if cut == "rows":
        s = s[:, 1:h - 2].contiguous()
    elif cut == "view":
        s = s[1:]
    assert s.is_contiguous()
    m = tb.TransformMode[mode]
    assert torch.equal(descriptor_words_cuda(s, m), td.descriptor_words(s, m))


@pytest.mark.parametrize("w", [16384, 20000])
def test_kernels_at_wide_rows(dev, w):
    """``transform.cu``, ``hamming.cu`` (full row and ranged) and
    ``agree.cu`` on two rows at least 16384 columns wide, against their
    plain versions."""
    s0, s1 = _pair(dev, 9, 2, w, seed=5)
    mode = tb.TransformMode.LIMITED
    w0, w1 = (descriptor_words_cuda(s, mode) for s in (s0, s1))
    assert torch.equal(w0, td.descriptor_words(s0, mode))
    assert torch.equal(w1, td.descriptor_words(s1, mode))
    for drange in (None, (0, 511), (-300, 9000)):
        first, last = row_minima_words(w0, w1, True, drange=drange)
        _, pf, pl = ts.row_minima_torch_words(w0, w1, True, drange=drange)
        assert torch.equal(first, pf) and torch.equal(last, pl)
        if drange is None:
            disp = ts._finish_nodupes(pf, pl, w)
    assert bool((disp != ta.INVALID_I16).any())
    for step, minvar in ((0.1, 18.0), (None, None)):
        out, corr = agree_cuda(disp, s0, s1, 0.5, step, minvar)
        _assert_plain_bar(out, corr, *_plain_agree(
            disp, s0, s1, 0.5, step, minvar, tb.Precision.SINGLE))


# ---------------------------------------------------------------------------
# The user surfaces on the card.


def test_pybicos_compat_on_the_card_equals_match(dev):
    from libbicos_tpu_torch import pybicos_compat as pybicos

    s0, s1, _ = synthetic_stack_pair(9, 6, 120, seed=4)
    for step in (None, 0.25):
        cfg = pybicos.Config()
        cfg.subpixel_step = step
        _build.reset_launch_counts()
        disp, corr = pybicos.match(list(s0), list(s1), cfg)
        assert _build.launch_counts()["agree"] == 1
        want_d, want_c = tb.match(s0, s1, cfg._to_native(), corrmap=True,
                                  backend="torch", device="cpu")
        assert disp.dtype == np.float32 and corr.dtype == np.float32
        _assert_plain_bar(torch.from_numpy(disp), torch.from_numpy(corr),
                          want_d.float(), want_c)


def test_cli_on_the_card_equals_cpu(dev, tmp_path):
    """``python -m libbicos_tpu_torch.cli`` on the card (the default
    device) writes the disparity of ``--device cpu``; the corrmap within
    4e-6."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    import chip_smoke as cs

    repo = Path(__file__).resolve().parent.parent
    s0, s1, _ = synthetic_stack_pair(7, 12, 96, seed=8)
    cs.write_stack_folder(tmp_path / "imgs", s0, s1)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(repo), env.get("PYTHONPATH",
                                                            "")])
    out = {}
    for tag, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        proc = subprocess.run(
            [sys.executable, "-m", "libbicos_tpu_torch.cli",
             str(tmp_path / "imgs"), "-t", "0.5", "--limited", "-s", "0.1",
             "--corrmap", "-o", str(tmp_path / f"{tag}.png"), *extra],
            cwd=repo, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        out[tag] = [torch.from_numpy(cs.read_tiff(tmp_path / name))
                    for name in (f"{tag}.tiff", f"{tag}-corrmap.tiff")]
    (cd, cc), (pd, pc) = out["card"], out["cpu"]
    _assert_plain_bar(cd, cc, pd, pc)


# ---------------------------------------------------------------------------
# The serving daemon, multi-process loading and the dry run on the card.


def test_serve_entry_points_raise_without_a_card(monkeypatch):
    """Without a card, Engine() and serve.main([]) raise and name
    --device cpu: no silent move to the CPU. (Runs on any machine: the
    card's absence is simulated.)"""
    from libbicos_tpu_torch import serve as tserve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserve.Engine()
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserve.main([])


def test_engine_on_the_card_equals_match(dev):
    """An Engine on the card (its HTTP server and client included) answers
    what ``match(backend="cuda")`` gives, through the kernels, from handler
    threads whose current device it sets."""
    import threading

    from libbicos_tpu_torch.client import BicosClient
    from libbicos_tpu_torch.serve import Engine, serve
    from test_torch_multihost import _free_port

    cfg = tb.Config(nxcorr_threshold=0.96, subpixel_step=0.1,
                    min_variance=2.0)
    engine = Engine(cfg, device=dev)
    assert engine.device == dev
    port = _free_port()
    ready = threading.Event()
    threading.Thread(target=serve, args=(engine, "127.0.0.1", port),
                     kwargs={"warmup_shapes": [((33, 16, 400), "uint8")],
                             "ready_event": ready}, daemon=True).start()
    assert ready.wait(300)
    client = BicosClient(f"http://127.0.0.1:{port}", timeout=300)
    s0, s1, _ = synthetic_stack_pair(33, 16, 400, seed=12)
    for params, variant, drange in (
            ({}, tb.NoDuplicates(), None),
            ({"lr_maxdiff": 1, "no_dupes": 1}, tb.Consistency(1, True), None),
            ({"disp_range": "0:60"}, tb.NoDuplicates(), (0, 60))):
        _build.reset_launch_counts()
        got_d, got_c = client.match(s0, s1, corrmap=True, **params)
        counts = _build.launch_counts()
        assert counts["agree"] == 1 and counts["transform"] == 2, counts
        c = tb.Config(nxcorr_threshold=0.96, subpixel_step=0.1,
                      min_variance=2.0, variant=variant,
                      disparity_range=drange)
        want_d, want_c = tb.match(s0, s1, c, corrmap=True, backend="cuda")
        _assert_bitwise(torch.from_numpy(got_d), want_d.cpu())
        _assert_bitwise(torch.from_numpy(got_c), want_c.cpu())
    b0, b1 = np.stack([s0, s0 ^ 3]), np.stack([s1, s1])
    got_b = engine.match(b0, b1)
    want_b = tb.match_batched(b0, b1, cfg, backend="cuda")
    _assert_bitwise(torch.from_numpy(got_b), want_b.cpu())


def test_engine_second_card_from_handler_threads(dev):
    """An Engine on card 1 runs there from a new thread (whose current
    device is 0)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    import threading

    from libbicos_tpu_torch.serve import Engine

    engine = Engine(tb.Config(nxcorr_threshold=0.5),
                    device=torch.device("cuda", 1))
    s0, s1, _ = synthetic_stack_pair(5, 8, 64, seed=2)
    out = {}
    t = threading.Thread(target=lambda: out.update(d=engine.match(s0, s1)))
    t.start()
    t.join(300)
    want = tb.match(s0, s1, tb.Config(nxcorr_threshold=0.5),
                    device=torch.device("cuda", 1))
    assert torch.equal(torch.from_numpy(out["d"]), want.cpu())


def test_serve_nccl_four_cards(dev, tmp_path):
    """``serve --devices 4`` over NCCL (one card a process): rank 0 serves a
    request equal to ``match`` on card 0; every rank exits 0 after SIGINT
    to rank 0. Needs 4 cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    from test_torch_multihost import run_serve

    _build.library()  # once, before the four workers load it
    run_serve(tmp_path, 4, "nccl", device="cuda:0")


def test_dryrun_multichip_on_the_card(dev):
    from libbicos_tpu_torch import dryrun

    _build.reset_launch_counts()
    dryrun.dryrun_multichip(4, device=dev)
    counts = _build.launch_counts()
    assert counts["band"] > 0 and counts["hamming"] > 0, counts
