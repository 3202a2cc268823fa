"""The port at ``full16``'s settings (upstream's ``bench_integration/16/0``:
n=16, FULL descriptors, NXCORR threshold 0.9, no subpixel step, no
min_variance, NoDuplicates, corrmap) against the benchmark's plain
reference, ``portbench.reference.bicos``, at tiny shapes: on the CPU with
the plain versions, and on the card with the hand-written kernels (marker
``cuda``, skips without one). Neither side imports JAX."""

import json

import numpy as np
import pytest
import torch

import libbicos_tpu_torch as tb
from libbicos_tpu_torch import pipeline, profiling
from libbicos_tpu_torch.io import synthetic_stack_pair
from portbench.reference import bicos

# ``portbench/configs/full16.json``'s settings, as the reference reads them.
FULL16 = {"mode": "FULL", "variant": {"kind": "NoDuplicates"},
          "nxcorr_threshold": 0.9, "subpixel_step": None,
          "min_variance": None, "disparity_range": None}
CFG = tb.Config(nxcorr_threshold=0.9, subpixel_step=None, min_variance=None,
                mode=tb.TransformMode.FULL, variant=tb.NoDuplicates())
# The port sums NXCORR's float32 terms over n=16 shots in another order
# than the reference does, so their corrmaps may differ by a few ulps of
# values up to 1 (4e-6 is the port's CORR_TOL against the JAX agree).
CORR_TOL = 4e-6


def _stacks(shape, dtype, seed, levels):
    n, h, w = shape
    s0, s1, _ = synthetic_stack_pair(n, h, w, dtype=dtype, seed=seed)
    if levels:
        # Four gray levels: samples, means and pair sums tie everywhere, so
        # descriptors and costs tie, and some series have no variance.
        shift = 8 * s0.itemsize - 2
        s0, s1 = s0 >> shift, s1 >> shift
    return torch.from_numpy(s0), torch.from_numpy(s1)


def _compare(s0, s1, backend, device):
    disp, corr = pipeline.match(s0, s1, CFG, corrmap=True, backend=backend,
                                device=device)
    _, rdisp, rcorr = bicos.match(s0.to(disp.device), s1.to(disp.device),
                                  FULL16)
    assert disp.dtype == rdisp.dtype == torch.int16
    # The scan is integer: disparity and validity equal exactly.
    assert torch.equal(disp, rdisp)
    assert (disp != bicos.INVALID_I16).any()
    nan = torch.isnan(corr)
    assert torch.equal(nan, torch.isnan(rcorr))
    gap = (corr[~nan] - rcorr[~nan]).abs().max().item() if (~nan).any() \
        else 0.0
    assert gap <= CORR_TOL


CASES = [(shape, dtype, seed)
         for shape in ((16, 12, 64), (16, 9, 97))
         for dtype in (np.uint8, np.uint16)
         for seed in (3, 1717, 2**31 + 5)]


def _ids(case):
    shape, dtype, seed = case
    return f"{'x'.join(map(str, shape))}-{dtype.__name__}-s{seed}"


@pytest.mark.parametrize("levels", [False, True], ids=["pattern", "levels"])
@pytest.mark.parametrize("shape,dtype,seed", CASES,
                         ids=[_ids(c) for c in CASES])
def test_full16_equals_reference_on_the_cpu(shape, dtype, seed, levels):
    s0, s1 = _stacks(shape, dtype, seed, levels)
    _compare(s0, s1, "torch", "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [False, True], ids=["pattern", "levels"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_full16_equals_reference_on_the_card(dtype, levels):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s0, s1 = _stacks((16, 40, 300), dtype, 29, levels)
    _compare(s0, s1, "cuda", torch.device("cuda", 0))


@pytest.mark.cuda
def test_agree_finish_span_on_the_card(tmp_path):
    """On the card, as on the CPU, the int16 glue of the integer agree
    runs in one ``bicos.agree_finish`` span inside ``bicos.agree``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    s0, s1 = (s.to(dev) for s in _stacks((16, 40, 300), np.uint8, 31,
                                          False))
    pipeline.match(s0, s1, CFG, corrmap=True, backend="cuda")  # build
    with profiling.trace(tmp_path):
        pipeline.match(s0, s1, CFG, corrmap=True, backend="cuda")
        torch.cuda.synchronize(dev)
    (path,) = tmp_path.glob("trace_*.json")
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name")).startswith("bicos.agree")]
    agree = [s for s in spans if s[2] == "bicos.agree"]
    finish = [s for s in spans if s[2] == "bicos.agree_finish"]
    assert len(agree) == 1 and len(finish) == 1
    assert agree[0][0] <= finish[0][0] <= finish[0][1] <= agree[0][1]
