"""End-to-end ``match`` of the port against the JAX package: int16
disparities equal, f32 disparities equal on valid pixels with the same NaN
mask, corrmap within CORR_TOL — against ``match(backend="xla")``,
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
from libbicos_tpu_torch import io as tio
from libbicos_tpu_torch.pipeline import _fold_batch

CORR_TOL = dict(rtol=4e-6, atol=4e-6)
HEADLINE = dict(nxcorr_threshold=0.96, subpixel_step=0.1, min_variance=2.0,
                mode=jb.TransformMode.LIMITED, variant=jb.NoDuplicates())


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


def _both(s0, s1, jcfg, jax_backend="xla", **kw):
    want_d, want_c = jb.match(s0, s1, jcfg, corrmap=True,
                              backend=jax_backend)
    got_d, got_c = tb.match(s0, s1, tb.config_from_reference(jcfg),
                            corrmap=True, device="cpu", **kw)
    assert got_d.device.type == "cpu"
    _assert_same(got_d.numpy(), want_d)
    _assert_corr_close(got_c.numpy(), want_c)
    return got_d


def test_headline_config_matches_xla():
    s0, s1, truth = jio.synthetic_stack_pair(33, 6, 64)
    got = _both(s0, s1, jb.Config(**HEADLINE))
    valid = ~torch.isnan(got)
    assert got.dtype == torch.float32 and bool(valid.any())
    near = (got - torch.from_numpy(truth).float()).abs() <= 1.0
    assert bool(near[valid].float().mean() > 0.9)


def test_headline_config_matches_pallas_interpret():
    s0, s1, _ = jio.synthetic_stack_pair(33, 4, 48, seed=5)
    _both(s0, s1, jb.Config(**HEADLINE), jax_backend="pallas_interpret")


def test_integer_config_matches_pallas_interpret(rng):
    s0, s1, _ = make_stack_pair(rng, 9, 4, 40, np.uint16)
    _both(s0, s1, jb.Config(nxcorr_threshold=0.5, min_variance=1.0),
          jax_backend="pallas_interpret")


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("n", [2, 3, 9, 33])
def test_match_matches_xla(rng, n, dtype, subpixel):
    s0, s1, _ = make_stack_pair(rng, n, 4, 40, dtype)
    cfg = jb.Config(nxcorr_threshold=0.6, min_variance=2.0,
                    subpixel_step=0.25 if subpixel else None)
    _both(s0, s1, cfg)


@pytest.mark.parametrize("n", [4, 16])  # 16: the widest FULL stack
def test_full_mode_matches_xla(rng, n):
    s0, s1, _ = make_stack_pair(rng, n, 3, 32)
    _both(s0, s1, jb.Config(nxcorr_threshold=0.5, subpixel_step=0.5,
                            mode=jb.TransformMode.FULL))


@pytest.mark.parametrize("cfg", [
    dict(nxcorr_threshold=0.5),
    dict(nxcorr_threshold=0.5, subpixel_step=0.25, min_variance=1.0),
    dict(nxcorr_threshold=None),
])
def test_match_matches_oracle(rng, cfg):
    s0, s1, _ = make_stack_pair(rng, 8, 3, 24)
    jcfg = jb.Config(**cfg)
    want, _ = _oracle.match(s0, s1, jcfg)
    got = tb.match(s0, s1, tb.config_from_reference(jcfg), device="cpu")
    _assert_same(got.numpy(), want)


def test_no_threshold_returns_search_disparity(rng):
    s0, s1, _ = make_stack_pair(rng, 6, 3, 30)
    jcfg = jb.Config(nxcorr_threshold=None)
    want = jb.match(s0, s1, jcfg, backend="xla")
    got = tb.match(torch.from_numpy(s0), torch.from_numpy(s1),
                   tb.config_from_reference(jcfg), backend="torch",
                   device="cpu")
    assert got.dtype == torch.int16
    _assert_same(got.numpy(), want)


def test_match_batched_matches_xla(rng):
    pairs = [make_stack_pair(rng, 5, 3, 28) for _ in range(3)]
    b0 = np.stack([p[0] for p in pairs])
    b1 = np.stack([p[1] for p in pairs])
    jcfg = jb.Config(nxcorr_threshold=0.5, subpixel_step=0.5)
    want_d, want_c = jb.match_batched(b0, b1, jcfg, corrmap=True,
                                      backend="xla")
    cfg = tb.config_from_reference(jcfg)
    got_d, got_c = tb.match_batched(b0, b1, cfg, corrmap=True, device="cpu")
    assert got_d.shape == (3, 3, 28)
    _assert_same(got_d.numpy(), want_d)
    _assert_corr_close(got_c.numpy(), want_c)
    for i in range(3):
        _assert_same(got_d[i].numpy(),
                     tb.match(b0[i], b1[i], cfg, device="cpu").numpy())
    flat0, flat1, (b, h, w) = _fold_batch(b0, b1)
    folded = tb.match_batched_folded(flat0, flat1, b, cfg, device="cpu")
    _assert_same(folded.numpy(), got_d.numpy())


def test_batched_shape_errors(rng):
    s0, s1, _ = make_stack_pair(rng, 4, 2, 8)
    with pytest.raises(ValueError, match="batch, n, H, W"):
        tb.match_batched(s0, s1)
    with pytest.raises(ValueError, match="identical shapes"):
        tb.match_batched(s0[None], np.concatenate([s1, s1], 1)[None])
    with pytest.raises(ValueError, match="multiple of batch"):
        tb.match_batched_folded(s0, s1, 3)


def test_input_checks(rng):
    s0, s1, _ = make_stack_pair(rng, 4, 2, 8)
    cpu = dict(device="cpu")
    with pytest.raises(ValueError, match="differ"):
        tb.match(s0, s1[:, :1], **cpu)
    with pytest.raises(ValueError, match="dtypes differ"):
        tb.match(s0, s1.astype(np.uint16), **cpu)
    with pytest.raises(ValueError, match="uint8 and uint16"):
        tb.match(s0.astype(np.int32), s1.astype(np.int32), **cpu)
    with pytest.raises(ValueError, match="at least two"):
        tb.match(s0[:1], s1[:1], **cpu)
    with pytest.raises(ValueError, match="corrmap requires"):
        tb.match(s0, s1, tb.Config(nxcorr_threshold=None), corrmap=True,
                 **cpu)
    with pytest.raises(ValueError, match="backend"):
        tb.match(s0, s1, backend="pallas", **cpu)


def test_cuda_backend_raises_without_a_card(rng):
    """No GPU here: the kernel backend raises instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    s0, s1, _ = make_stack_pair(rng, 4, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.match(s0, s1, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.match(s0, s1, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.match(s0, s1, backend="cuda", device="cpu")


@pytest.mark.parametrize("cfg", [
    tb.Config(precision=tb.Precision.DOUBLE),
])
def test_double_precision_runs(rng, cfg):
    """DOUBLE, the last option the port once refused, runs and returns the
    int16 disparity and the float32 corrmap (its results are held to the
    JAX package in test_torch_double.py)."""
    s0, s1, _ = make_stack_pair(rng, 4, 2, 8)
    disp, corr = tb.match(s0, s1, cfg, corrmap=True, device="cpu")
    assert disp.dtype == torch.int16 and corr.dtype == torch.float32


@pytest.mark.parametrize("entry", ["match", "match_batched",
                                   "match_batched_folded"])
def test_entry_points_default_to_the_card(rng, entry):
    """``device=None`` is the card: without one the entry points raise and
    name ``device="cpu"``; with ``device="cpu"`` they run there."""
    s0, s1, _ = make_stack_pair(rng, 4, 2, 8)
    args = {"match": (s0, s1), "match_batched": (s0[None], s1[None]),
            "match_batched_folded": (s0, s1, 1)}[entry]
    fn = getattr(tb, entry)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(*args)
    out = fn(*args, device="cpu")
    assert out.device.type == "cpu" and out.dtype == torch.int16


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_synthetic_stack_pair_matches(dtype):
    want = jio.synthetic_stack_pair(9, 5, 40, dtype=dtype, seed=3)
    got = tio.synthetic_stack_pair(9, 5, 40, dtype=dtype, seed=3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
