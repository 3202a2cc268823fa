"""The port at ``double33``'s settings (upstream's README headline, ``-t
0.96 --limited -v 2.0 -s 0.1`` at n=33, run with ``--double``: LIMITED,
subpixel step 0.1, min_variance 2.0, NoDuplicates, corrmap, DOUBLE
precision) against the benchmark's float64 reference,
``portbench.reference.bicos_f64``, at tiny shapes: on the CPU with the
plain versions, and on the card with the hand-written kernels (marker
``cuda``, skips without one). A SINGLE port lands outside the corrmap
tolerance. Neither side imports JAX."""

import numpy as np
import pytest
import torch

import libbicos_tpu_torch as tb
from libbicos_tpu_torch import pipeline
from libbicos_tpu_torch.io import synthetic_stack_pair
from portbench.reference import bicos_f64

# ``portbench/configs/double33.json``'s settings, as the reference reads them.
DOUBLE33 = {"mode": "LIMITED", "variant": {"kind": "NoDuplicates"},
            "nxcorr_threshold": 0.96, "subpixel_step": 0.1,
            "min_variance": 2.0, "precision": "DOUBLE",
            "disparity_range": None}


def _cfg(precision):
    return tb.Config(nxcorr_threshold=0.96, subpixel_step=0.1,
                     min_variance=2.0, mode=tb.TransformMode.LIMITED,
                     variant=tb.NoDuplicates(), precision=precision)


def _stacks(shape, dtype, seed):
    n, h, w = shape
    s0, s1, _ = synthetic_stack_pair(n, h, w, dtype=dtype, seed=seed)
    return torch.from_numpy(s0), torch.from_numpy(s1)


def _ulps_apart(a, b):
    """Where ``a`` and ``b`` (float32) lie more than one float32 ulp
    apart: the larger in magnitude is past the next float32 up from the
    smaller."""
    lo = torch.minimum(a.abs(), b.abs())
    return (a - b).abs() > torch.nextafter(lo, torch.full_like(lo, 2.0)) - lo


def _answer(s0, s1, precision, backend, device):
    disp, corr = pipeline.match(s0, s1, _cfg(precision), corrmap=True,
                                backend=backend, device=device)
    _, rdisp, rcorr = bicos_f64.match(s0.to(disp.device),
                                      s1.to(disp.device), DOUBLE33)
    assert disp.dtype == rdisp.dtype == torch.float32
    assert corr.dtype == rcorr.dtype == torch.float32
    return disp, corr, rdisp, rcorr


def _compare(s0, s1, backend, device):
    """Equal disparities and validity; corrmaps NaN in the same places and
    within the backend's tolerance elsewhere: equal bit for bit on the CPU
    (the plain DOUBLE agree sums in the reference's order and rounds each
    float64 NXCORR to float32 once), within one float32 ulp on the card
    (agree.cu's fma chains may end a float64 NXCORR an ulp of float64 off,
    which can round to the neighbouring float32)."""
    disp, corr, rdisp, rcorr = _answer(s0, s1, tb.Precision.DOUBLE, backend,
                                       device)
    nan = torch.isnan(disp)
    assert torch.equal(nan, torch.isnan(rdisp))
    assert torch.equal(disp[~nan], rdisp[~nan])
    assert (~nan).any()
    cnan = torch.isnan(corr)
    assert torch.equal(cnan, torch.isnan(rcorr))
    if backend == "torch":
        assert torch.equal(corr[~cnan], rcorr[~cnan])
    else:
        assert not _ulps_apart(corr[~cnan], rcorr[~cnan]).any()


CASES = [(shape, dtype, seed)
         for shape in ((33, 12, 64), (33, 9, 97))
         for dtype in (np.uint8, np.uint16)
         for seed in (3, 2**31 + 5)]


def _ids(case):
    shape, dtype, seed = case
    return f"{'x'.join(map(str, shape))}-{dtype.__name__}-s{seed}"


@pytest.mark.parametrize("shape,dtype,seed", CASES,
                         ids=[_ids(c) for c in CASES])
def test_double33_equals_reference_on_the_cpu(shape, dtype, seed):
    s0, s1 = _stacks(shape, dtype, seed)
    _compare(s0, s1, "torch", "cpu")


def test_single_port_falls_outside_the_double_tolerance():
    """The SINGLE port in the DOUBLE cell's place: its float32 NXCORR
    leaves corrmap values off the float64 reference's, some by more than
    one float32 ulp, so neither backend's tolerance would pass it."""
    s0, s1 = _stacks((33, 9, 97), np.uint8, 3)
    _, corr, _, rcorr = _answer(s0, s1, tb.Precision.SINGLE, "torch", "cpu")
    cnan = torch.isnan(corr)
    assert torch.equal(cnan, torch.isnan(rcorr))
    assert not torch.equal(corr[~cnan], rcorr[~cnan])
    assert _ulps_apart(corr[~cnan], rcorr[~cnan]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_double33_equals_reference_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s0, s1 = _stacks((33, 40, 300), dtype, 29)
    _compare(s0, s1, "cuda", torch.device("cuda", 0))
