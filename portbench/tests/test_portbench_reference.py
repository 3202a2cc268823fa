"""The plain reference against hand-worked cases and, at tiny sizes on the
CPU, against the program's plain results."""

import numpy as np
import pytest
import torch

from portbench.reference import bicos

import libbicos_tpu_torch as port
from libbicos_tpu_torch.io import synthetic_stack_pair


def test_limited_bit_count():
    for n in (3, 4, 5, 12, 33):
        stack = torch.zeros((n, 2, 3), dtype=torch.uint8)
        assert len(bicos.limited_planes(stack)) == (3 * (n - 2)
                                                    + max(0, n - 4) + 4)


def test_limited_planes_hand_worked():
    # One pixel, series 1 2 0 3: sum 6, n 4, pair sums 3 2 3.
    s = torch.tensor([1, 2, 0, 3], dtype=torch.uint8).view(4, 1, 1)
    got = [bool(p) for p in bicos.limited_planes(s)]
    want = [1 < 2, 1 < 0, 4 * 1 < 6,       # t = 0
            2 < 0, 2 < 3, 4 * 2 < 6,       # t = 1
            0 < 3, 4 * 0 < 6, 4 * 3 < 6,   # the last pair and means
            3 < 3]                         # pair sums 0 and 2
    assert got == want


def test_scan_hand_worked():
    # Rows of one pixel height; the right row is the left shifted by 2,
    # so every left column c >= 2 matches c - 2 uniquely.
    rng = np.random.default_rng(5)
    pat = rng.integers(0, 256, size=(12, 1, 14), dtype=np.uint8)
    left = torch.from_numpy(pat[:, :, :12].copy())
    right = torch.from_numpy(pat[:, :, 2:].copy())
    disp = bicos.scan(right, left, {"kind": "NoDuplicates"})
    assert disp.dtype == torch.int16
    # right[c] = pat[c + 2] = left[c + 2]: disparity -2 where c + 2 < 12.
    assert (disp[0, :10] == -2).all()


def test_scan_duplicate_invalidates():
    # Two equal right columns: the left pixel that matches them has two
    # argmins, so NoDuplicates drops it.
    rng = np.random.default_rng(6)
    right = rng.integers(0, 256, size=(9, 1, 6), dtype=np.uint8)
    right[:, :, 4] = right[:, :, 1]
    left = right.copy()
    disp = bicos.scan(torch.from_numpy(left), torch.from_numpy(right),
                      {"kind": "NoDuplicates"})
    assert disp[0, 1] == bicos.INVALID_I16 and disp[0, 4] == bicos.INVALID_I16
    assert disp[0, 0] == 0 and disp[0, 2] == 0


def test_subpixel_grid():
    xs = bicos.subpixel_grid(0.1)
    assert len(xs) == 20 and xs[0] == -1.0 and xs[-1] < 1.0


VARIANTS = [
    ({"kind": "NoDuplicates"}, port.NoDuplicates()),
    ({"kind": "Consistency", "max_lr_diff": 1, "no_dupes": True},
     port.Consistency(1, True)),
    ({"kind": "Consistency", "max_lr_diff": 2, "no_dupes": False},
     port.Consistency(2, False)),
]


@pytest.mark.parametrize("variant,pvariant", VARIANTS)
@pytest.mark.parametrize("n,h,w,seed", [(33, 6, 64, 1), (9, 5, 40, 2),
                                        (5, 4, 33, 3)])
@pytest.mark.parametrize("step", [0.1, None])
def test_reference_equals_port_plain(variant, pvariant, n, h, w, seed, step):
    s0, s1, _ = synthetic_stack_pair(n, h, w, seed=seed)
    cfg = {"variant": variant, "nxcorr_threshold": 0.5,
           "subpixel_step": step, "min_variance": 2.0}
    _, disp, corr = bicos.match(torch.from_numpy(s0), torch.from_numpy(s1),
                                cfg)
    pdisp, pcorr = port.match(
        s0, s1, port.Config(nxcorr_threshold=0.5, subpixel_step=step,
                            min_variance=2.0, variant=pvariant),
        corrmap=True, device="cpu")
    assert disp.dtype == pdisp.dtype
    assert torch.equal(torch.isnan(corr), torch.isnan(pcorr))
    assert torch.equal(torch.nan_to_num(corr), torch.nan_to_num(pcorr))
    if step is None:
        assert torch.equal(disp, pdisp)
    else:
        assert torch.equal(torch.isnan(disp), torch.isnan(pdisp))
        assert torch.equal(torch.nan_to_num(disp), torch.nan_to_num(pdisp))


def test_control_precision_differs():
    s0, s1, _ = synthetic_stack_pair(33, 6, 64, seed=4)
    cfg = {"variant": {"kind": "NoDuplicates"}, "nxcorr_threshold": 0.5,
           "subpixel_step": 0.1, "min_variance": 2.0}
    a = bicos.match(torch.from_numpy(s0), torch.from_numpy(s1), cfg)
    b = bicos.match(torch.from_numpy(s0), torch.from_numpy(s1), cfg,
                    dtype=torch.bfloat16)
    assert torch.equal(a[0], b[0])  # the search is integer
    gap = torch.nan_to_num(a[2] - b[2]).abs().max()
    assert gap > 1e-3
