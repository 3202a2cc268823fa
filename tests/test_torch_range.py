"""``disparity_range`` in the port's plain scans (the versions the scan
and consistency kernels are held to on the card) against the JAX package:
cost, first/last argmins with the no-candidate sentinels ``-1 / -2`` and
the reverse argmins where the forward side has a candidate, exactly equal
to the masked XLA scan and to the ranged Pallas kernels run in interpret
mode. The search surfaces and ``match`` are in
``test_torch_variants_*.py``."""

import numpy as np
import pytest
import torch

from conftest import make_stack_pair

from libbicos_tpu import TransformMode as JMode
from libbicos_tpu import descriptor as jd
from libbicos_tpu import search as js
from libbicos_tpu.kernels.hamming import (
    row_minima_consistency_stack_range as j_cons_stack_range,
    row_minima_stack_range as j_stack_range,
)

from libbicos_tpu_torch import TransformMode as TMode
from libbicos_tpu_torch import search as ts
from libbicos_tpu_torch.descriptor import descriptor_words

# (0, 31), (-5, 20), (10, 40) from the JAX range tests; one range wholly
# outside a 48..150-wide row (no pixel has a candidate); one negative.
RANGES = [(0, 31), (-5, 20), (10, 40), (400, 500), (-40, -10)]


def _i32(words) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words).view(np.int32).copy())


def _words(rng, n, h, w, mode="LIMITED", dtype=np.uint8):
    s0, s1, _ = make_stack_pair(rng, n, h, w, dtype)
    return (np.asarray(jd.descriptor_words(s0, JMode[mode])),
            np.asarray(jd.descriptor_words(s1, JMode[mode])))


def _stack_words(s0, s1, mode):
    """The plain transform of two numpy stacks."""
    return (descriptor_words(torch.from_numpy(s0), TMode[mode]),
            descriptor_words(torch.from_numpy(s1), TMode[mode]))


@pytest.mark.parametrize("need_last", [True, False])
@pytest.mark.parametrize("budget", [1 << 26, 300])  # 300: row+col chunks
@pytest.mark.parametrize("drange", RANGES)
def test_plain_ranged_scan_matches_xla(rng, drange, budget, need_last):
    w0, w1 = _words(rng, 9, 4, 60)
    cost, first, last = js.row_minima_xla_words(w0, w1, need_last,
                                                drange=drange)
    gc, gf, gl = ts.row_minima_torch_words(_i32(w0), _i32(w1), need_last,
                                           pair_budget=budget, drange=drange)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(cost))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(first))
    if need_last:
        np.testing.assert_array_equal(gl.numpy(), np.asarray(last))
    else:
        assert gl is None
    if drange == (400, 500):
        assert (gf == -1).all() and (not need_last or (gl == -2).all())


@pytest.mark.parametrize("w0w, w1w", [(37, 61), (61, 37)])
def test_ranged_scan_unequal_widths(rng, w0w, w1w):
    a, _ = _words(rng, 5, 3, w0w)
    b, _ = _words(rng, 5, 3, w1w)
    for drange in ((-20, 20), (30, 80)):
        _, first, last = js.row_minima_xla_words(a, b, True, drange=drange)
        _, gf, gl = ts.row_minima_torch_words(_i32(a), _i32(b), True,
                                              drange=drange)
        np.testing.assert_array_equal(gf.numpy(), np.asarray(first))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(last))


@pytest.mark.parametrize("drange", RANGES)
@pytest.mark.parametrize("n, mode, dtype", [
    (33, "LIMITED", np.uint8), (8, "LIMITED", np.uint16),
    (9, "FULL", np.uint8),
])
def test_stack_range_matches_pallas(rng, n, mode, dtype, drange):
    """Against ``_minima_kernel_bf16_stack_range`` in interpret mode."""
    s0, s1, _ = make_stack_pair(rng, n, 3, 150, dtype)
    none, want_f, want_l = j_stack_range(s0, s1, mode=JMode[mode],
                                         drange=drange, interpret=True)
    got = ts.row_minima_torch_words(*_stack_words(s0, s1, mode), True,
                                    drange=drange)
    assert none is None
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want_l))


@pytest.mark.parametrize("no_dupes", [True, False])
@pytest.mark.parametrize("drange", RANGES)
@pytest.mark.parametrize("n, mode, dtype", [
    (33, "LIMITED", np.uint8), (9, "FULL", np.uint16),
])
def test_consistency_stack_range_matches_pallas(rng, n, mode, dtype, drange,
                                                no_dupes):
    """Against ``_consistency_kernel_bf16_stack_range`` in interpret mode.
    Its rc0/rc0_last are arbitrary where first0 < 0, so they are compared
    where first0 >= 0 (and equal the sentinels -1/-2 elsewhere here)."""
    s0, s1, _ = make_stack_pair(rng, n, 3, 150, dtype)
    (_, f0, l0), (_, rc0, rcl) = j_cons_stack_range(
        s0, s1, mode=JMode[mode], no_dupes=no_dupes, drange=drange,
        interpret=True)
    gf, gl, grc, grl = ts.row_minima_consistency_torch_words(
        *_stack_words(s0, s1, mode), no_dupes, drange)
    f0 = np.asarray(f0)
    has = f0 >= 0
    np.testing.assert_array_equal(gf.numpy(), f0)
    np.testing.assert_array_equal(grc.numpy()[has], np.asarray(rc0)[has])
    assert (grc.numpy()[~has] == -1).all()
    if no_dupes:
        np.testing.assert_array_equal(gl.numpy(), np.asarray(l0))
        np.testing.assert_array_equal(grl.numpy()[has], np.asarray(rcl)[has])
        assert (grl.numpy()[~has] == -2).all()
    else:
        assert gl is None and grl is None


@pytest.mark.parametrize("drange", RANGES)
def test_consistency_words_range_matches_xla_two_pass(rng, drange):
    """The words surface with a range against the masked XLA scans, forward
    and reflected reverse, W0 != W1."""
    a, _ = _words(rng, 8, 3, 50)
    b, _ = _words(rng, 8, 3, 70)
    _, f0, l0 = js.row_minima_xla_words(a, b, True, drange=drange)
    _, f1, l1 = js.row_minima_xla_words(b, a, True,
                                        drange=(-drange[1], -drange[0]))
    gf, gl, grc, grl = ts.row_minima_consistency_torch_words(
        _i32(a), _i32(b), True, drange)
    f0 = np.asarray(f0)
    has = f0 >= 0
    idx = np.maximum(f0, 0)
    np.testing.assert_array_equal(gf.numpy(), f0)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(l0))
    np.testing.assert_array_equal(
        grc.numpy()[has], np.take_along_axis(np.asarray(f1), idx, 1)[has])
    np.testing.assert_array_equal(
        grl.numpy()[has], np.take_along_axis(np.asarray(l1), idx, 1)[has])
