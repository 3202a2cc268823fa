"""The dynamic-window agree path of the port (``BICOS_AGREE_DYNWIN``)
against the JAX package: the plain ``agree.chunk_window_bases`` (which the
bases kernel is held to on the card) against ``_chunk_window_bases`` and
the Pallas ``_bases_kernel`` in interpret mode, exactly, on fields with both
windowed and fallback chunks; ``resolve_chunk_wcap`` and its environment
helper against the JAX resolution; ``search_stack_nodupes_with_bases``
(disparity and bases); and ``match`` with the window on against the JAX
``match(backend="pallas_interpret")`` with its window on (disparities
exact, same NaN mask, corrmap within 4e-6) and against the port with the
window off."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_stack_pair

import libbicos_tpu as jb
from libbicos_tpu import io as jio
from libbicos_tpu import search as jsearch
from libbicos_tpu.kernels import agree as KA

import libbicos_tpu_torch as tb
from libbicos_tpu_torch import agree as ta
from libbicos_tpu_torch import pipeline as tpipe
from libbicos_tpu_torch import search as ts
from libbicos_tpu_torch.kernels import agree as tka

CORR_TOL = dict(rtol=4e-6, atol=4e-6)


def _sine_field(w, h=16):
    """``tests/test_agree_bases_modes.py``'s field: a smooth disparity with
    scattered far matches (fallback chunks) and invalid pixels."""
    rng = np.random.default_rng(3)
    d = (20 + 30 * np.sin(np.linspace(0, 6, w))[None, :]
         * np.ones((h, 1))).astype(np.int16)
    d[:, ::97] = 1200
    d[rng.random((h, w)) < 0.05] = -32768
    return d


def _wide_field(w, h=8):
    """``tests/test_production_width.py``'s field: smooth rows, rows with a
    1200-column jump inside one chunk, border matches, invalid pixels."""
    rng = np.random.default_rng(7)
    col = np.arange(w)
    d = np.zeros((h, w), np.int16)
    ramp = (col * 120 // max(1, w - 1)).astype(np.int16)
    d[0:h // 2] = np.minimum(ramp[None, :], col[None, :]).astype(np.int16)
    d[h // 2:, 1200:] = 1200
    d[:, 5] = 5
    d[:, w - 1] = 0
    d[rng.integers(0, h, 40), rng.integers(0, w, 40)] = -32768
    return d


FIELDS = {"sine": _sine_field, "wide": _wide_field}


@pytest.mark.parametrize("w", [1408, 1412])
@pytest.mark.parametrize("chunk, wcap", [(256, 640), (512, 1024)])
@pytest.mark.parametrize("field", sorted(FIELDS))
def test_chunk_window_bases_match_jax_and_pallas(field, chunk, wcap, w):
    d = FIELDS[field](w)
    h = d.shape[0]
    d32 = KA._pad2(jnp.asarray(d).astype(jnp.int32), KA.ROW_BATCH, chunk,
                   value=KA.INVALID_I32)
    wp = d32.shape[1]
    nc = wp // chunk
    want = np.asarray(KA._chunk_window_bases(d32, w, wp, wcap, chunk))[:h]
    pallas = np.asarray(KA._chunk_window_bases_pallas(
        d32, w, wp, wcap, chunk, interpret=True))[:h, :nc]
    np.testing.assert_array_equal(pallas, want)
    assert (want >= 0).any() and (want < 0).any(), \
        "the field must give windowed and fallback chunks"
    got = ta.chunk_window_bases(torch.from_numpy(d), w, wp, wcap, chunk)
    assert got.dtype == torch.int32 and tuple(got.shape) == (h, nc)
    np.testing.assert_array_equal(got.numpy(), want)


DYNWIN = [None, 0, -1, 640, 700, 256, 1024]


@pytest.mark.parametrize("chunk", [0, 256, 512])
@pytest.mark.parametrize("dynwin", DYNWIN)
def test_resolve_chunk_wcap_matches_jax(monkeypatch, dynwin, chunk):
    """The window's resolution equals JAX's ``resolve_chunk_wcap("mxu",
    w)`` wherever JAX turns the window on, and is off (``wcap == 0``)
    wherever JAX's is: 700 is not a multiple of 128, 256 is below chunk +
    128, and narrow widths pad to ``wp <= wcap``. ``agree_window`` reads
    the same knobs from the environment."""
    monkeypatch.setattr(KA, "AGREE_DYNWIN", dynwin)
    monkeypatch.setattr(KA, "CHUNK", chunk)
    monkeypatch.setenv("BICOS_AGREE_DYNWIN",
                       "auto" if dynwin is None else str(dynwin))
    monkeypatch.setenv("BICOS_AGREE_CHUNK", str(chunk))
    seen = set()
    for w in (300, 512, 640, 700, 1000, 1024, 1408, 3300):
        want = KA.resolve_chunk_wcap("mxu", w)
        for got in (tka.resolve_chunk_wcap(w, dynwin or 0, chunk),
                    tka.agree_window(w)):
            if want[1]:
                assert got == want, (w, got, want)
            else:
                assert got[1] == 0, (w, got, want)
        seen.add(bool(want[1]))
    if dynwin in (-1, 640, 1024):
        assert seen == {False, True}


def test_agree_window_is_read_at_call_time(monkeypatch):
    monkeypatch.delenv("BICOS_AGREE_DYNWIN", raising=False)
    monkeypatch.delenv("BICOS_AGREE_CHUNK", raising=False)
    assert tka.agree_window(3300) == (256, 0)
    monkeypatch.setenv("BICOS_AGREE_DYNWIN", "640")
    assert tka.agree_window(3300) == (256, 640)
    monkeypatch.setenv("BICOS_AGREE_CHUNK", "512")
    assert tka.agree_window(3300) == (512, 640)
    monkeypatch.setenv("BICOS_AGREE_CHUNK", "640")
    assert tka.agree_window(3300) == (640, 0)  # 640 < 640 + 128
    monkeypatch.setenv("BICOS_AGREE_DYNWIN", "auto")
    assert tka.agree_window(3300) == (640, 0)


def test_search_with_bases_matches_jax(monkeypatch):
    """The port's NoDuplicates search with bases against the JAX one (the
    bases from the Pallas search kernel's epilogue, interpret mode) at
    ``tests/test_agree_bases_modes.py``'s shape."""
    monkeypatch.setattr(KA, "AGREE_DYNWIN", 640)
    n, h, w = 12, 16, 1408
    s0, s1, _ = jio.synthetic_stack_pair(n, h, w, dtype=np.uint8)
    chunk, wcap = KA.resolve_chunk_wcap("mxu", w)
    wp = w + ((-w) % chunk)
    jd, jbases = jsearch.search_stack_nodupes_with_bases(
        jnp.asarray(s0), jnp.asarray(s1), jb.TransformMode.LIMITED,
        chunk=chunk, wcap=wcap, wp=wp, backend="pallas_interpret")
    assert jbases is not None
    disp, bases = ts.search_stack_nodupes_with_bases(
        torch.from_numpy(s0), torch.from_numpy(s1), tb.TransformMode.LIMITED,
        chunk=chunk, wcap=wcap, wp=wp, backend="torch")
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(bases.numpy(), np.asarray(jbases)[:h])
    assert (bases.numpy() >= 0).any()


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


def _port_match(monkeypatch, s0, s1, cfg, dynwin):
    """The port's ``match`` with ``BICOS_AGREE_DYNWIN=dynwin`` (None: unset);
    returns its result and the windows its agree stage was given."""
    if dynwin is None:
        monkeypatch.delenv("BICOS_AGREE_DYNWIN", raising=False)
    else:
        monkeypatch.setenv("BICOS_AGREE_DYNWIN", str(dynwin))
    windows = []
    agree_stage = tpipe.agree_stage

    def spy(*args, **kw):
        windows.append(kw.get("window"))
        return agree_stage(*args, **kw)

    monkeypatch.setattr(tpipe, "agree_stage", spy)
    out = tb.match(s0, s1, cfg, corrmap=True, device="cpu")
    monkeypatch.setattr(tpipe, "agree_stage", agree_stage)
    return out, windows


# Each JAX configuration has its own width: ``_agree_call``'s jit cache
# keys on shapes, not on the patched globals.
@pytest.mark.parametrize("w, n, dtype, step, minvar", [
    (1000, 5, np.uint8, None, 2.0),
    (1001, 5, np.uint8, 0.25, None),
    (1002, 6, np.uint8, 0.1, 2.0),
    (1003, 5, np.uint16, 0.25, 1.0),
])
def test_match_dynwin_matches_jax_pallas(monkeypatch, w, n, dtype, step,
                                         minvar):
    monkeypatch.setattr(KA, "AGREE_DYNWIN", 640)
    monkeypatch.setattr(KA, "AGREE_GATHER", "mxu")
    monkeypatch.setattr(KA, "CHUNK", 256)
    s0, s1, _ = jio.synthetic_stack_pair(n, 4, w, dtype=dtype, seed=w)
    jcfg = jb.Config(nxcorr_threshold=0.5, subpixel_step=step,
                     min_variance=minvar)
    jd, jc = jb.match(s0, s1, jcfg, corrmap=True,
                      backend="pallas_interpret")
    cfg = tb.config_from_reference(jcfg)
    (gd, gc), windows = _port_match(monkeypatch, s0, s1, cfg, 640)
    assert windows == [(256, 640, 1024)]
    _assert_same(gd.numpy(), jd)
    _assert_corr_close(gc.numpy(), jc)
    (od, oc), windows = _port_match(monkeypatch, s0, s1, cfg, None)
    assert windows == [None]
    _assert_same(gd.numpy(), od.numpy())
    _assert_same(gc.numpy(), oc.numpy())


@pytest.mark.parametrize("variant, drange", [
    (tb.Consistency(1, True), None),
    (tb.NoDuplicates(), (0, 40)),
])
@pytest.mark.parametrize("step", [None, 0.1])
def test_match_dynwin_other_paths_equal_window_off(monkeypatch, variant,
                                                   drange, step):
    """Consistency and ranged searches take the window too (its bases come
    from the disparity); the results do not change."""
    s0, s1, _ = make_stack_pair(np.random.default_rng(5), 5, 3, 900)
    cfg = tb.Config(nxcorr_threshold=0.5, subpixel_step=step,
                    min_variance=1.0, variant=variant,
                    disparity_range=drange)
    (gd, gc), windows = _port_match(monkeypatch, s0, s1, cfg, -1)
    assert windows == [(256, 640, 1024)]
    (od, oc), _ = _port_match(monkeypatch, s0, s1, cfg, None)
    _assert_same(gd.numpy(), od.numpy())
    _assert_same(gc.numpy(), oc.numpy())
