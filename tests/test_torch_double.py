"""DOUBLE precision (``Precision.DOUBLE``) of the port against the JAX
package's XLA path, which runs the agree stage's statistics, NXCORR and
tests in float64 and the parabola in float32: ``match`` end to end and the
plain agree (and the agree kernel's wrapper on CPU tensors). Both sides sum
serially in float64 and round once to float32, so disparities and corrmap
are held equal bit for bit (same NaN mask): a tolerance of 4e-6 could not
tell a float32 NXCORR from a float64 one."""

import jax
import numpy as np
import pytest
import torch

from conftest import make_stack_pair

import libbicos_tpu as jb
from libbicos_tpu import agree as ja
from libbicos_tpu import io as jio
from libbicos_tpu import search as js

import libbicos_tpu_torch as tb
from libbicos_tpu_torch import agree as ta

DOUBLE = tb.Precision.DOUBLE


def _assert_same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float32:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        m = ~np.isnan(want)
        np.testing.assert_array_equal(got[m], want[m])
    else:
        np.testing.assert_array_equal(got, want)


def _match_both(s0, s1, jcfg):
    want_d, want_c = jb.match(s0, s1, jcfg, corrmap=True, backend="xla")
    got_d, got_c = tb.match(s0, s1, tb.config_from_reference(jcfg),
                            corrmap=True, device="cpu")
    _assert_same(got_d.numpy(), want_d)
    _assert_same(got_c.numpy(), want_c)
    return got_d, got_c


@pytest.mark.parametrize("variant", [None, (1, True)])
@pytest.mark.parametrize("step", [None, 0.25])
@pytest.mark.parametrize("n, dtype", [(5, np.uint8), (9, np.uint16),
                                      (33, np.uint8)])
def test_double_match_matches_xla(rng, n, dtype, step, variant):
    s0, s1, _ = make_stack_pair(rng, n, 3, 40, dtype)
    _match_both(s0, s1, jb.Config(
        nxcorr_threshold=0.6, subpixel_step=step, min_variance=2.0,
        precision=jb.Precision.DOUBLE,
        variant=(jb.NoDuplicates() if variant is None
                 else jb.Consistency(*variant))))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_double_headline_config_matches_xla(dtype):
    s0, s1, _ = jio.synthetic_stack_pair(33, 5, 64, dtype=dtype, seed=9)
    d, _ = _match_both(s0, s1, jb.Config(
        nxcorr_threshold=0.96, subpixel_step=0.1, min_variance=2.0,
        precision=jb.Precision.DOUBLE))
    assert bool((~torch.isnan(d)).any())


def test_double_corrmap_differs_from_single():
    """The f64 path runs: the DOUBLE corrmap differs from the SINGLE one at
    some pixels, and there too it equals JAX's DOUBLE corrmap bit for bit,
    while the disparities of this input agree."""
    s0, s1, _ = jio.synthetic_stack_pair(33, 6, 64, seed=4)
    d64, c64 = _match_both(s0, s1, jb.Config(
        nxcorr_threshold=0.5, subpixel_step=0.1,
        precision=jb.Precision.DOUBLE))
    d32, c32 = tb.match(s0, s1, tb.Config(nxcorr_threshold=0.5,
                                          subpixel_step=0.1),
                        corrmap=True, device="cpu")
    assert c64.dtype == torch.float32
    m = ~torch.isnan(c32)
    assert torch.equal(m, ~torch.isnan(c64))
    assert bool((c32[m] != c64[m]).any())
    _assert_same(d64.numpy(), d32.numpy())


def _case(rng, n, h, w, dtype):
    s0, s1, _ = make_stack_pair(rng, n, h, w, dtype)
    disp = np.asarray(js.search_stack(s0, s1, jb.TransformMode.LIMITED,
                                      jb.NoDuplicates(), backend="xla")).copy()
    disp[0, 3] = 3        # col1 = 0: left border
    disp[0, w - 2] = -1   # col1 = w-1: right border
    disp[0, 5] = 9        # col1 < 0: out of bounds
    return s0, s1, disp


@pytest.mark.parametrize("step, minvar", [(None, 40.0), (None, None),
                                          (0.1, 66.0), (0.25, None)])
@pytest.mark.parametrize("n, dtype", [(9, np.uint16), (33, np.uint8)])
def test_double_plain_agree_matches_xla(rng, n, dtype, step, minvar):
    """The plain f64 agree (which the agree kernel's DOUBLE variant is held
    to on the card) against the JAX XLA agree in float64."""
    s0, s1, disp = _case(rng, n, 4, 40, dtype)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (disp, s0, s1)]
    with jax.enable_x64(True):
        if step is None:
            want_d, want_c = ja.agree_integer(disp, s0, s1, 0.5, minvar,
                                              jb.Precision.DOUBLE)
        else:
            want_d, want_c = ja.agree_subpixel(disp, s0, s1, 0.5, step,
                                               minvar, jb.Precision.DOUBLE)
        want_d, want_c = np.asarray(want_d), np.asarray(want_c)
    if step is None:
        got_d, got_c = ta.agree_integer(*t, 0.5, minvar, precision=DOUBLE)
    else:
        got_d, got_c = ta.agree_subpixel(*t, 0.5, step, minvar,
                                         precision=DOUBLE)
    _assert_same(got_d.numpy(), want_d)
    _assert_same(got_c.numpy(), want_c)
