"""The port's Consistency scan (the plain version, which the consistency
kernel is held to on the card) against the JAX package: forward
first/last argmins and the reverse argmins read at the forward argmin,
exactly equal to the XLA two-pass scan and to the fused Pallas consistency
kernels run in interpret mode, with the bf16 and the int8 engine. The
search surfaces and ``match`` are in ``test_torch_variants_*.py``."""

import numpy as np
import pytest
import torch

from conftest import make_stack_pair

from libbicos_tpu import TransformMode as JMode
from libbicos_tpu import descriptor as jd
from libbicos_tpu import search as js
from libbicos_tpu.config import actual_bits
from libbicos_tpu.kernels.hamming import (
    row_minima_consistency_stack as j_cons_stack,
    row_minima_consistency_words as j_cons_words,
)

from libbicos_tpu_torch import TransformMode as TMode
from libbicos_tpu_torch import search as ts
from libbicos_tpu_torch.descriptor import descriptor_words

SHAPES = [  # n, mode, dtype
    (3, "LIMITED", np.uint8),    # the constant LIMITED bit
    (8, "LIMITED", np.uint16),
    (33, "LIMITED", np.uint8),
    (9, "FULL", np.uint16),
]


def _i32(words) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words).view(np.int32).copy())


def _words(rng, n, h, w, mode="LIMITED", dtype=np.uint8):
    s0, s1, _ = make_stack_pair(rng, n, h, w, dtype)
    return (s0, s1, np.asarray(jd.descriptor_words(s0, JMode[mode])),
            np.asarray(jd.descriptor_words(s1, JMode[mode])))


def _xla_two_pass(w0, w1, no_dupes, drange=None):
    """The XLA route: forward and reflected reverse scans, then the lookup
    at the forward argmin (numpy)."""
    _, f0, l0 = js.row_minima_xla_words(w0, w1, no_dupes, drange=drange)
    rev = None if drange is None else (-drange[1], -drange[0])
    _, f1, l1 = js.row_minima_xla_words(w1, w0, no_dupes, drange=rev)
    f0 = np.asarray(f0)
    idx = np.maximum(f0, 0)
    rc0 = np.take_along_axis(np.asarray(f1), idx, axis=1)
    rcl = (np.take_along_axis(np.asarray(l1), idx, axis=1) if no_dupes
           else None)
    return f0, (np.asarray(l0) if no_dupes else None), rc0, rcl


def _cons_words(w0, w1, no_dupes):
    """The plain Consistency scan of two int32 word tensors:
    ``(first0, last0, rc0, rc0_last)``."""
    return ts.row_minima_consistency_torch_words(w0, w1, no_dupes)


def _assert_scan(got, want, no_dupes):
    """``got``: the plain scan's ``(first0, last0, rc0, rc0_last)``;
    ``want``: the same, numpy. rc0/rc0_last are compared where
    first0 >= 0."""
    f0, l0, rc0, rcl = got
    np.testing.assert_array_equal(f0.numpy(), want[0])
    has = want[0] >= 0
    np.testing.assert_array_equal(rc0.numpy()[has], np.asarray(want[2])[has])
    if no_dupes:
        np.testing.assert_array_equal(l0.numpy(), want[1])
        np.testing.assert_array_equal(rcl.numpy()[has],
                                      np.asarray(want[3])[has])
    else:
        assert l0 is None and rcl is None

@pytest.mark.parametrize("no_dupes", [True, False])
@pytest.mark.parametrize("w0w, w1w", [(40, 40), (37, 61), (61, 37)])
@pytest.mark.parametrize("n, mode", [(3, "LIMITED"), (33, "LIMITED"),
                                     (9, "FULL")])
def test_plain_scan_matches_xla_two_pass(rng, n, mode, w0w, w1w, no_dupes):
    """W0 != W1 included: query and candidate rows of different widths."""
    _, _, a, _ = _words(rng, n, 3, w0w, mode)
    _, _, b, _ = _words(rng, n, 3, w1w, mode)
    want = _xla_two_pass(a, b, no_dupes)
    _assert_scan(_cons_words(_i32(a), _i32(b), no_dupes), want, no_dupes)


@pytest.mark.parametrize("engine", ["bf16", "i8"])
@pytest.mark.parametrize("no_dupes", [True, False])
@pytest.mark.parametrize("n, mode, dtype", SHAPES)
def test_words_wrapper_matches_pallas_words_kernel(rng, n, mode, dtype,
                                                   no_dupes, engine):
    """Against the fused Pallas consistency kernel from words and its int8
    twin (``_consistency_kernel``, ``_consistency_kernel_i8``)."""
    _, _, w0, w1 = _words(rng, n, 3, 150, mode, dtype)
    (_, f0, l0), (_, rc0, rcl) = j_cons_words(
        w0, w1, nbits=actual_bits(n, JMode[mode]), no_dupes=no_dupes,
        interpret=True, engine=engine)
    got = _cons_words(_i32(w0), _i32(w1), no_dupes)
    _assert_scan(got, tuple(None if x is None else np.asarray(x)
                            for x in (f0, l0, rc0, rcl)), no_dupes)


@pytest.mark.parametrize("engine", ["bf16", "i8"])
@pytest.mark.parametrize("no_dupes", [True, False])
@pytest.mark.parametrize("n, mode, dtype", [s for s in SHAPES if s[0] >= 4])
def test_stack_wrapper_matches_pallas_stack_kernel(rng, n, mode, dtype,
                                                   no_dupes, engine):
    """Against the fused transform + consistency Pallas kernel and its int8
    twin (``_consistency_kernel_bf16_stack``, ``_consistency_kernel_i8_
    stack``), which refuse LIMITED n < 4."""
    s0, s1, _ = make_stack_pair(rng, n, 3, 140, dtype)
    (_, f0, l0), (_, rc0, rcl) = j_cons_stack(
        s0, s1, mode=JMode[mode], no_dupes=no_dupes, interpret=True,
        engine=engine)
    got = _cons_words(descriptor_words(torch.from_numpy(s0), TMode[mode]),
                      descriptor_words(torch.from_numpy(s1), TMode[mode]),
                      no_dupes)
    _assert_scan(got, tuple(None if x is None else np.asarray(x)
                            for x in (f0, l0, rc0, rcl)), no_dupes)


@pytest.mark.parametrize("no_dupes", [True, False])
def test_reverse_ties_on_both_sides(rng, no_dupes):
    """Duplicate columns in both rows (as ``tests/test_kernels.py`` injects
    them): reverse first is the least and reverse last the greatest left
    column at the least cost."""
    w0, w1 = (np.asarray(rng.integers(0, 1 << 32, size=(3, 120, 2),
                                      dtype=np.uint64), dtype=np.uint32)
              for _ in range(2))
    w1[:, 100:106] = w1[:, 10:16]   # ties in the right row
    w0[:, 80:86] = w0[:, 20:26]     # ties in the left row
    w0[:, 40:46] = w1[:, 10:16]     # exact matches of duplicated columns,
    w0[:, 90:96] = w1[:, 10:16]     # twice in the left row too
    want = _xla_two_pass(w0, w1, no_dupes)
    got = _cons_words(_i32(w0), _i32(w1), no_dupes)
    _assert_scan(got, want, no_dupes)
    if no_dupes:
        f0, l0, rc0, rcl = got
        assert (f0[:, 40:46] != l0[:, 40:46]).all()
        assert (rc0[:, 40:46] == torch.arange(40, 46)).all()
        assert (rcl[:, 40:46] == torch.arange(90, 96)).all()
    (_, f0, l0), (_, rc0, rcl) = j_cons_words(
        w0, w1, nbits=64, no_dupes=no_dupes, interpret=True)
    _assert_scan(got, tuple(None if x is None else np.asarray(x)
                            for x in (f0, l0, rc0, rcl)), no_dupes)
