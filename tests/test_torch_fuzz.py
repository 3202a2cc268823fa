"""The port's differential fuzz soak (``tools/fuzz_soak_torch.py``) for a
few trials, and the fault it found: the plain scan's dtype view refused a
one-column band of the ranged W-band ring."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import libbicos_tpu_torch as tb
from libbicos_tpu_torch import sharding as tsh
from libbicos_tpu_torch.io import synthetic_stack_pair

REPO = Path(__file__).resolve().parent.parent


def test_fuzz_soak_few_trials():
    """Each mode once (torch, shard, batched): exit 0, no failure."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "fuzz_soak_torch.py"),
         "--trials", "3", "--seed", "7"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "done: 3 trials, 0 failures" in proc.stdout


@pytest.mark.parametrize("size", [2, 4, 8])
def test_ranged_wband_narrow_bands_equal_match(size):
    """n=3 u16, 5x13, range (-14, 2): 4 and 8 bands visit one-column slices
    of the right bands (the soak's repro, seed 1 trial 55)."""
    cfg = tb.Config(nxcorr_threshold=0.70416097869538, subpixel_step=0.5,
                    mode=tb.TransformMode.LIMITED, disparity_range=(-14, 2))
    s0, s1, _ = synthetic_stack_pair(3, 5, 13, dtype=np.uint16, seed=1)
    mesh = tsh.make_mesh(size, virtual=True, device="cpu")
    got_d, got_c = tsh.match_sharded_w(s0, s1, cfg, mesh=mesh, corrmap=True)
    want_d, want_c = tb.match(s0, s1, cfg, corrmap=True, device="cpu")
    for got, want in ((got_d, want_d), (got_c, want_c)):
        np.testing.assert_array_equal(np.isnan(got.numpy()),
                                      np.isnan(want.numpy()))
        np.testing.assert_array_equal(np.nan_to_num(got.numpy()),
                                      np.nan_to_num(want.numpy()))
