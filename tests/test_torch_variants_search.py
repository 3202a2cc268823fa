"""The port's search surfaces (``search_words``, ``search_stack``) with the
Consistency variant and with ``disparity_range`` against the JAX package:
int16 disparities exactly equal to the XLA search and to the Pallas search
kernels run in interpret mode."""

import numpy as np
import pytest
import torch

from conftest import make_stack_pair

import libbicos_tpu as jb
from libbicos_tpu import TransformMode as JMode
from libbicos_tpu import descriptor as jd
from libbicos_tpu import search as js
from libbicos_tpu.config import actual_bits

import libbicos_tpu_torch as tb
from libbicos_tpu_torch import TransformMode as TMode
from libbicos_tpu_torch import search as ts

CONSISTENCY = [(0, True), (1, True), (2, False), (3, True)]
SHAPES = [  # n, mode, dtype
    (3, "LIMITED", np.uint8),    # the constant LIMITED bit
    (8, "LIMITED", np.uint16),
    (33, "LIMITED", np.uint8),
    (9, "FULL", np.uint16),
]
# As in test_torch_range.py: one range wholly outside the row, one negative.
RANGES = [(0, 31), (-5, 20), (10, 40), (400, 500), (-40, -10)]
VARIANTS = [None] + CONSISTENCY  # None: NoDuplicates


def _i32(words) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words).view(np.int32).copy())


def _variants(v):
    if v is None:
        return jb.NoDuplicates(), tb.NoDuplicates()
    return jb.Consistency(*v), tb.Consistency(*v)


@pytest.mark.parametrize("variant", CONSISTENCY)
@pytest.mark.parametrize("n, mode, dtype", SHAPES)
def test_search_words_matches_xla(rng, n, mode, dtype, variant):
    s0, s1, _ = make_stack_pair(rng, n, 4, 56, dtype)
    w0 = np.asarray(jd.descriptor_words(s0, JMode[mode]))
    w1 = np.asarray(jd.descriptor_words(s1, JMode[mode]))
    nbits = actual_bits(n, JMode[mode])
    jv, tv = _variants(variant)
    want = np.asarray(js.search_words(w0, w1, nbits, jv, "xla"))
    for backend in ("auto", "torch"):
        got = ts.search_words(_i32(w0), _i32(w1), nbits, tv, backend)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", CONSISTENCY)
@pytest.mark.parametrize("n, mode, dtype", SHAPES)
def test_search_stack_matches_xla(rng, n, mode, dtype, variant):
    s0, s1, _ = make_stack_pair(rng, n, 3, 48, dtype)
    jv, tv = _variants(variant)
    want = np.asarray(js.search_stack(s0, s1, JMode[mode], jv,
                                      backend="xla"))
    got = ts.search_stack(torch.from_numpy(s0), torch.from_numpy(s1),
                          TMode[mode], tv)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", CONSISTENCY)
@pytest.mark.parametrize("n", [3, 33])  # 3: the words kernel; 33: stack
def test_search_stack_matches_pallas(rng, n, variant):
    s0, s1, _ = make_stack_pair(rng, n, 3, 48)
    jv, tv = _variants(variant)
    want = np.asarray(js.search_stack(s0, s1, JMode.LIMITED, jv,
                                      backend="pallas_interpret"))
    got = ts.search_stack(torch.from_numpy(s0), torch.from_numpy(s1),
                          TMode.LIMITED, tv)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("drange", RANGES)
@pytest.mark.parametrize("n, dtype", [(3, np.uint16), (8, np.uint8)])
def test_search_stack_range_matches_xla(rng, n, dtype, drange, variant):
    s0, s1, _ = make_stack_pair(rng, n, 3, 48, dtype)
    jv, tv = _variants(variant)
    want = np.asarray(js.search_stack(s0, s1, JMode.LIMITED, jv,
                                      backend="xla", drange=drange))
    got = ts.search_stack(torch.from_numpy(s0), torch.from_numpy(s1),
                          TMode.LIMITED, tv, drange=drange)
    np.testing.assert_array_equal(got.numpy(), want)
    if drange == (400, 500):
        assert (want == -32768).all()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("drange", [(0, 31), (-5, 20)])
def test_search_stack_range_matches_pallas(rng, drange, variant):
    """Through the ranged Pallas stack kernels (NoDuplicates and
    Consistency) in interpret mode."""
    s0, s1, _ = make_stack_pair(rng, 33, 3, 64)
    jv, tv = _variants(variant)
    want = np.asarray(js.search_stack(s0, s1, JMode.LIMITED, jv,
                                      backend="pallas_interpret",
                                      drange=drange))
    got = ts.search_stack(torch.from_numpy(s0), torch.from_numpy(s1),
                          TMode.LIMITED, tv, drange=drange)
    np.testing.assert_array_equal(got.numpy(), want)


def test_search_words_range_unequal_widths(rng):
    s0, _, _ = make_stack_pair(rng, 6, 3, 37)
    s1, _, _ = make_stack_pair(rng, 6, 3, 61)
    w0 = np.asarray(jd.descriptor_words(s0, JMode.LIMITED))
    w1 = np.asarray(jd.descriptor_words(s1, JMode.LIMITED))
    for variant in VARIANTS:
        jv, tv = _variants(variant)
        want = np.asarray(js.search_words(w0, w1, 17, jv, "xla",
                                          drange=(-30, 10)))
        got = ts.search_words(_i32(w0), _i32(w1), 17, tv, drange=(-30, 10))
        np.testing.assert_array_equal(got.numpy(), want)
