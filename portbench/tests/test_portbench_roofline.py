"""The copied yardstick reproduces the bring-up's transform and agree
bounds from shapes and pixel counts alone, equal to ``chip_smoke.py``'s
arithmetic; the scan is priced by (pixel, column) pairs x descriptor bits,
never above the popcount price it replaced."""

import math
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from portbench import roofline

ROOT = Path(__file__).resolve().parents[2]
N, H, W = 33, 2200, 3300


def test_peaks_equal_chip_smoke():
    # chip_smoke.py's peaks are the yardstick's; the yardstick adds the
    # units that price the scan.
    assert chip_smoke.PEAK.items() <= roofline.PEAK.items()
    assert roofline.PEAK["bit_products"] == pytest.approx(
        33280 * roofline.SM_CLOCKS)
    assert roofline.words_for(N, "LIMITED") == 4
    assert roofline.words_for(16, "FULL") == 8  # 227 bits


def test_full_row_scan_bound():
    # LIMITED n=33: the compares bind, 0.358 ms a direction, above the
    # products' 0.347 ms; FULL n=16: the products, 0.625 ms.
    ms, by = roofline.scan_bound(H, W, roofline.bits_for(N, "LIMITED"),
                                 None)
    assert by == "operations"
    assert round(ms, 3) == 0.358
    assert round(roofline.scan_bound(H, W, 126, None, True)[0], 3) == 0.716
    assert round(roofline.scan_bound(H, W, roofline.bits_for(16, "FULL"),
                                     None)[0], 3) == 0.625


def test_ranged_scan_bound_equals_chip_smoke():
    # A range keeps the (pixel, column) pairs that chip_smoke.py counts.
    for drange in ((0, 511), (-3, 40)):
        pairs = 40 * roofline.scan_pairs(300, drange)
        assert (roofline.bound(40 * 300 * 16, popc=pairs * 2)
                == chip_smoke.scan_bound(40, 300, 2, drange, 8))
    ms, by = roofline.scan_bound(H, W, 126, (0, 511))
    assert (round(ms, 3), by) == (0.087, "bytes")


def _popcount_bound(h, w, nw, drange, consistency):
    """The price the scan had before: one popcount a (pair, word)."""
    nbytes = 2 * h * w * nw * 4 + h * w * (16 if consistency else 8)
    return roofline.bound(
        nbytes, popc=h * roofline.scan_pairs(w, drange) * nw)[0]


@pytest.mark.parametrize("seed", range(4))
def test_scan_bound_never_above_popcount_bound(seed):
    rng = random.Random(seed)
    for _ in range(25):
        h, w = rng.randint(1, 64), rng.randint(1, 400)
        mode = rng.choice(("LIMITED", "FULL"))
        n = rng.randint(2, 16 if mode == "FULL" else 65)
        lo = rng.randint(-w, w)
        drange = rng.choice((None, (lo, lo + rng.randint(0, w))))
        cons = rng.random() < 0.5
        new = roofline.scan_bound(h, w, roofline.bits_for(n, mode), drange,
                                  cons)[0]
        old = _popcount_bound(h, w, roofline.words_for(n, mode), drange,
                              cons)
        assert new <= old * (1 + 1e-12), (h, w, mode, n, drange, cons)


@pytest.mark.parametrize("mode", ["LIMITED", "FULL"])
def test_bits_and_words_agree(mode):
    for n in range(2, 17 if mode == "FULL" else 66):
        bits = roofline.bits_for(n, mode)
        assert roofline.words_for(n, mode) == math.ceil(bits / 32)
    assert roofline.bits_for(N, "LIMITED") == 126
    assert roofline.bits_for(2, "LIMITED") == 4
    assert roofline.bits_for(16, "FULL") == 227


def test_consistency_counts_twice_the_compares():
    # At 4 bits the compares bind both scans: twice as many in Consistency.
    nodup, by = roofline.scan_bound(H, W, 4, None)
    assert by == "operations"
    assert roofline.scan_bound(H, W, 4, None, True)[0] == pytest.approx(
        2 * nodup)
    assert roofline.scan_bound(H, W, 4, (0, 511), True)[0] == (
        pytest.approx(2 * roofline.scan_bound(H, W, 4, (0, 511))[0]))


def test_compare_term_binds_at_limited_n2():
    bits = roofline.bits_for(2, "LIMITED")
    ms = roofline.scan_bound(H, W, bits, None)[0]
    pairs = H * W * W
    assert ms == pytest.approx(pairs / roofline.PEAK["min"] * 1e3)
    assert ms > pairs * bits / roofline.PEAK["bit_products"] * 1e3
    # At FULL n=16 the products bind.
    full = roofline.scan_bound(H, W, roofline.bits_for(16, "FULL"), None)[0]
    assert full == pytest.approx(pairs * 227 / roofline.PEAK["bit_products"]
                                 * 1e3)
    assert full > ms


def test_transform_bound():
    ms, by = roofline.transform_bound(N, H, W, 1, 4)
    assert by == "bytes"
    assert round(ms, 3) == 0.106


@pytest.mark.parametrize("nx,double", [(20, False), (20, True), (0, False)])
def test_agree_bound_equals_chip_smoke(nx, double):
    g = torch.Generator().manual_seed(3)
    n, h, w = 9, 7, 50
    disp = torch.randint(-5, 30, (h, w), generator=g).to(torch.int16)
    disp[torch.rand((h, w), generator=g) < 0.2] = -32768
    s0 = torch.zeros((n, h, w), dtype=torch.uint8)
    s1 = torch.zeros((n, h, w), dtype=torch.uint8)
    swept, plain = roofline.agree_pixels(disp, w)
    assert swept > 0 and plain > 0
    ours = roofline.agree_bound(n, h, w, w, 1, swept, plain, nx,
                                double=double)
    theirs = chip_smoke.agree_bound(torch, disp, s0, s1, nx, double=double)
    assert ours == pytest.approx(theirs)


def test_agree_bound_headline_counts():
    # Every pixel kept and swept, as at the headline: the FP32 count
    # bounds it, above the bytes.
    ms, by = roofline.agree_bound(N, H, W, W, 1, H * W, 0, 20)
    assert by == "operations"
    assert ms == pytest.approx(H * W * (11 * N * 20 + 13 * N)
                               / roofline.PEAK["fp32"] * 1e3)


def test_rate_probe_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe would run")
    out = subprocess.run([sys.executable, "portbench/rate_probe.py"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr
