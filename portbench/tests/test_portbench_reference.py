"""The plain reference against hand-worked cases and, at tiny sizes on the
CPU, against the program's plain results."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import judge
from portbench.reference import bicos

import libbicos_tpu_torch as port
from libbicos_tpu_torch.io import synthetic_stack_pair

ROOT = Path(__file__).resolve().parents[2]


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


def test_full_bit_count():
    for n in range(2, 17):
        stack = torch.zeros((n, 2, 3), dtype=torch.uint8)
        assert len(bicos.full_planes(stack)) == n * n - 2 * n + 3


def test_full_planes_hand_worked():
    # One pixel, series 1 2 0 3: sum 6, n 4, pair sums 3 2 3.
    s = torch.tensor([1, 2, 0, 3], dtype=torch.uint8).view(4, 1, 1)
    got = [bool(p) for p in bicos.full_planes(s)]
    want = [1 < 2, 1 < 0, 4 * 1 < 6,       # t = 0
            2 < 0, 2 < 3, 4 * 2 < 6,       # t = 1
            0 < 3, 4 * 0 < 6, 4 * 3 < 6,   # the last pair and means
            3 < 3,                         # pair sums 0 and 2
            3 < 3]                         # pair sums 2 and 0
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


def noisy_pair(n, h, w, dtype, seed):
    """A synthetic pair with +-8 levels of noise a camera, as the
    benchmark's traffic adds, so that thresholds and duplicates bite."""
    s0, s1, _ = synthetic_stack_pair(n, h, w, dtype=dtype, seed=seed)
    rng = np.random.default_rng(seed + 1)
    hi = np.iinfo(dtype).max

    def noisy(s):
        e = rng.integers(-8, 9, size=s.shape)
        return np.clip(s.astype(np.int64) + e, 0, hi).astype(dtype)
    return noisy(s0), noisy(s1)


# At n=3 (6 bits) nearly every pixel has a duplicate: its maps may be all
# invalid, which both sides still have to agree on.
FULL_CASES = [(n, dtype, variant, pvariant)
              for n in (3, 4, 9, 16)
              for dtype in (np.uint8, np.uint16)
              for variant, pvariant in VARIANTS[:2]]


def _full_ids(case):
    n, dtype, variant, _ = case
    return f"n{n}-{dtype.__name__}-{variant['kind']}"


@pytest.mark.parametrize("n,dtype,variant,pvariant", FULL_CASES,
                         ids=[_full_ids(c) for c in FULL_CASES])
@pytest.mark.parametrize("ties", [False, True], ids=["levels", "ties"])
def test_full_search_equals_port(n, dtype, variant, pvariant, ties):
    s0, s1 = noisy_pair(n, 5, 40, dtype, seed=n)
    if ties:
        # Four gray levels: samples, means and pair sums tie everywhere,
        # so a comparison that is not strict where upstream's is shows.
        shift = 8 * s0.itemsize - 2
        s0, s1 = s0 >> shift, s1 >> shift
    search = bicos.scan(torch.from_numpy(s0), torch.from_numpy(s1), variant,
                        mode="FULL")
    psearch = port.match(s0, s1, port.Config(
        nxcorr_threshold=None, mode=port.TransformMode.FULL,
        variant=pvariant), device="cpu")
    assert n == 3 or (search != bicos.INVALID_I16).any()
    assert torch.equal(search, psearch)


@pytest.mark.parametrize("n,dtype,variant,pvariant", FULL_CASES,
                         ids=[_full_ids(c) for c in FULL_CASES])
def test_full_match_passes_the_judge(n, dtype, variant, pvariant):
    s0, s1 = noisy_pair(n, 5, 40, dtype, seed=n)
    cfg = {"mode": "FULL", "variant": variant, "nxcorr_threshold": 0.9,
           "subpixel_step": None, "min_variance": None}
    _, disp, corr = bicos.match(torch.from_numpy(s0), torch.from_numpy(s1),
                                cfg)
    pdisp, pcorr = port.match(s0, s1, port.Config(
        nxcorr_threshold=0.9, subpixel_step=None, min_variance=None,
        mode=port.TransformMode.FULL, variant=pvariant),
        corrmap=True, device="cpu")
    assert disp.dtype == pdisp.dtype == torch.int16
    assert n == 3 or (disp != bicos.INVALID_I16).any()
    numbers = judge.compare([(pdisp, pcorr, disp, corr)])
    assert numbers["pixel_mismatch_pct"] == 0
    assert numbers["corr_gap"] <= 4e-6  # the port's own CORR_TOL


# sha256 of the LIMITED planes of both stacks and of the search, disparity
# and corrmap bytes of bicos.match under each LIMITED configuration file,
# on a pair and on its four gray levels (ties everywhere), as they were
# before FULL came in.
LIMITED_HASHES = {
    "headline33":
        "a8938cdce199b85a9c6eea99321b309729ce09eddf0751b8e98e9446d08df200",
    "consistency33":
        "6adb3b5f72faf8e8b58ab976c2012ef8af66f73b80750db31b057e018d7de8ee",
}


@pytest.mark.parametrize("name", sorted(LIMITED_HASHES))
def test_limited_outputs_unchanged(name):
    cfg = json.loads((ROOT / "portbench/configs" / f"{name}.json")
                     .read_text())
    assert cfg["mode"] == "LIMITED"
    s0, s1 = noisy_pair(33, 6, 64, np.uint8, seed=11)
    h = hashlib.sha256()
    for levels in (256, 4):
        pair = [torch.from_numpy(s // (256 // levels)) for s in (s0, s1)]
        out = bicos.match(*pair, cfg)
        assert (out[0] != bicos.INVALID_I16).any()
        planes = [torch.stack(bicos.limited_planes(s)) for s in pair]
        for x in planes + list(out):
            h.update(x.numpy().tobytes())
    assert h.hexdigest() == LIMITED_HASHES[name]
