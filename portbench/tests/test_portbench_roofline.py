"""The copied yardstick reproduces the bring-up's bounds from shapes and
pixel counts alone, and equals ``chip_smoke.py``'s arithmetic."""

import pytest
import torch

import chip_smoke
from portbench import roofline

N, H, W = 33, 2200, 3300


def test_peaks_equal_chip_smoke():
    assert roofline.PEAK == chip_smoke.PEAK
    assert roofline.words_for(N, "LIMITED") == 4
    assert roofline.words_for(16, "FULL") == 8  # 227 bits


def test_full_row_scan_bound():
    ms, by = roofline.scan_bound(H, W, 4, None, 8)
    assert by == "operations"
    assert round(ms, 3) == 22.917
    assert roofline.scan_bound(H, W, 4, None, 16)[0] == pytest.approx(ms)
    assert (roofline.scan_bound(H, W, 4, None, 8)
            == chip_smoke.scan_bound(H, W, 4, None, 8))


def test_ranged_scan_bound_equals_chip_smoke():
    for drange in ((0, 511), (-3, 40)):
        assert (roofline.scan_bound(40, 300, 2, drange, 8)
                == chip_smoke.scan_bound(40, 300, 2, drange, 8))
    assert round(roofline.scan_bound(H, W, 4, (0, 511), 8)[0], 3) == 3.280


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
