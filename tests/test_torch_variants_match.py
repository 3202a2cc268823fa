"""End-to-end ``match`` / ``match_batched`` of the port with the
Consistency variant and ``disparity_range`` against the JAX package: int16
disparities equal, f32 disparities equal with the same NaN mask, corrmap
within 4e-6 — against ``match(backend="xla")``,
``match(backend="pallas_interpret")`` (the Pallas search and agree kernels
in interpret mode) and the reference oracle."""

import numpy as np
import pytest
import torch

from conftest import make_stack_pair

import libbicos_tpu as jb
from libbicos_tpu import _oracle
from libbicos_tpu import io as jio

import libbicos_tpu_torch as tb

CORR_TOL = dict(rtol=4e-6, atol=4e-6)
CONSISTENCY = [(0, True), (1, True), (2, False), (3, True)]


def _assert_same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float32:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        m = ~np.isnan(want)
        np.testing.assert_array_equal(got[m], want[m])
    else:
        np.testing.assert_array_equal(got, want)


def _assert_corr_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], **CORR_TOL)


def _match_both(s0, s1, jcfg, jax_backend):
    want_d, want_c = jb.match(s0, s1, jcfg, corrmap=True,
                              backend=jax_backend)
    got_d, got_c = tb.match(s0, s1, tb.config_from_reference(jcfg),
                            corrmap=True, device="cpu")
    _assert_same(got_d.numpy(), want_d)
    _assert_corr_close(got_c.numpy(), want_c)
    return got_d.numpy()


@pytest.mark.parametrize("jax_backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("step", [None, 0.25])
@pytest.mark.parametrize("mld, no_dupes", CONSISTENCY)
def test_consistency_match_matches_jax(rng, mld, no_dupes, step,
                                       jax_backend):
    s0, s1, _ = make_stack_pair(rng, 8, 4, 40)
    jcfg = jb.Config(nxcorr_threshold=0.6, min_variance=2.0,
                     subpixel_step=step,
                     variant=jb.Consistency(mld, no_dupes))
    _match_both(s0, s1, jcfg, jax_backend)


@pytest.mark.parametrize("n, dtype", [(3, np.uint16), (33, np.uint8)])
def test_consistency_headline_config_matches_xla(n, dtype):
    s0, s1, _ = jio.synthetic_stack_pair(n, 5, 64, dtype=dtype, seed=3)
    jcfg = jb.Config(nxcorr_threshold=0.96, min_variance=2.0,
                     subpixel_step=0.1, variant=jb.Consistency(1, True))
    _match_both(s0, s1, jcfg, "xla")


@pytest.mark.parametrize("cfg", [
    dict(nxcorr_threshold=0.5, variant=jb.Consistency(1, True)),
    dict(nxcorr_threshold=0.5, subpixel_step=0.25, min_variance=1.0,
         variant=jb.Consistency(2, False)),
    dict(nxcorr_threshold=None, variant=jb.Consistency(3, True)),
    dict(nxcorr_threshold=None, variant=jb.Consistency(0, False)),
])
def test_consistency_match_matches_oracle(rng, cfg):
    s0, s1, _ = make_stack_pair(rng, 8, 3, 24)
    jcfg = jb.Config(**cfg)
    want, _ = _oracle.match(s0, s1, jcfg)
    got = tb.match(s0, s1, tb.config_from_reference(jcfg), device="cpu")
    _assert_same(got.numpy(), want)


@pytest.mark.parametrize("jax_backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("step", [None, 0.25])
@pytest.mark.parametrize("variant", [None, (1, True), (2, False)])
def test_range_match_matches_jax(variant, step, jax_backend):
    s0, s1, _ = jio.synthetic_stack_pair(9, 4, 96, seed=5)
    jcfg = jb.Config(nxcorr_threshold=0.6, min_variance=2.0,
                     subpixel_step=step, disparity_range=(0, 31),
                     variant=(jb.NoDuplicates() if variant is None
                              else jb.Consistency(*variant)))
    _match_both(s0, s1, jcfg, jax_backend)


@pytest.mark.parametrize("jax_backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("step", [None, 0.25])
def test_range_widened_agree_window_case(jax_backend, step):
    """Consistency(3, True) with range (0, 63): the averaged disparity can
    sit ceil(3/2) = 2 outside the range, where the JAX package widens its
    agree windows; the port's agree reads any column."""
    s0, s1, _ = jio.synthetic_stack_pair(12, 6, 300, dtype=np.uint16,
                                         seed=13)
    jcfg = jb.Config(nxcorr_threshold=0.5, min_variance=1.0,
                     subpixel_step=step, variant=jb.Consistency(3, True),
                     disparity_range=(0, 63))
    got = _match_both(s0, s1, jcfg, jax_backend)
    v = ~np.isnan(got) if got.dtype == np.float32 else got != -32768
    assert v.any()
    assert ((got[v] >= -3) & (got[v] <= 66)).all()


@pytest.mark.parametrize("variant", [None, (1, True)])
@pytest.mark.parametrize("drange", [None, (0, 20)])
def test_match_batched_matches_xla(rng, drange, variant):
    pairs = [make_stack_pair(rng, 6, 3, 30) for _ in range(2)]
    b0 = np.stack([p[0] for p in pairs])
    b1 = np.stack([p[1] for p in pairs])
    jcfg = jb.Config(nxcorr_threshold=0.5, subpixel_step=0.5,
                     disparity_range=drange,
                     variant=(jb.NoDuplicates() if variant is None
                              else jb.Consistency(*variant)))
    want_d, want_c = jb.match_batched(b0, b1, jcfg, corrmap=True,
                                      backend="xla")
    cfg = tb.config_from_reference(jcfg)
    got_d, got_c = tb.match_batched(b0, b1, cfg, corrmap=True, device="cpu")
    _assert_same(got_d.numpy(), want_d)
    _assert_corr_close(got_c.numpy(), want_c)
    folded = tb.match_batched_folded(
        np.concatenate(list(b0), axis=1), np.concatenate(list(b1), axis=1),
        2, cfg, device="cpu")
    _assert_same(folded.numpy(), got_d.numpy())


@pytest.mark.parametrize("cfg", [
    dict(variant=tb.Consistency(1, True)),
    dict(disparity_range=(0, 20)),
    dict(variant=tb.Consistency(2, False), disparity_range=(-4, 20)),
])
def test_cuda_backend_raises_without_a_card(rng, cfg):
    """The kernel backend never carries on on the CPU with these options."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    s0, s1, _ = make_stack_pair(rng, 6, 2, 24)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.match(s0, s1, tb.Config(**cfg), backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.match(s0, s1, tb.Config(**cfg), device="cuda")
