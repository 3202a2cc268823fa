"""The fused Consistency ring step (``search.row_minima_consistency_band_
torch_words``, the plain version that ``csrc/band.cu``'s fused step is held
to on the card) against the JAX package on the same numpy
inputs: one step against the Pallas band kernel ``_minima_kernel_band`` in
interpret mode, run forward and with the roles swapped; and one ring of the
step on a CPU ``LocalMesh`` against the JAX ring ``row_minima_wband`` run
each way on the 8-device virtual CPU mesh. First/last argmins, sentinels
and costs are exactly equal."""

import numpy as np
import pytest
import torch

from test_torch_sharding import (
    H_BAND,
    NDEV,
    STEP_RANGES,
    W,
    _assert_step_equal,
    _decode_jax,
    _i32,
    _padded_bands,
)

import libbicos_tpu as jb
from libbicos_tpu import descriptor as jd
from libbicos_tpu import sharding as js
from libbicos_tpu.kernels.hamming import row_minima_words_band

from libbicos_tpu_torch import search as ts
from libbicos_tpu_torch import sharding as tsh


@pytest.mark.parametrize("need_last", [True, False])
@pytest.mark.parametrize("drange", STEP_RANGES)
def test_consistency_step_matches_pallas_words_band(rng, drange, need_last):
    """Every (band, visit) of a 4-band ring: the fused step's forward
    minima equal ``_minima_kernel_band``'s (interpret), and its reverse
    minima (the visiting band's columns of ``rf``/``rl``) equal the same
    kernel's with the roles swapped and the range reflected. Columns past
    ``W`` (ring padding) are left at ``BIG`` on both sides."""
    p0, p1 = _padded_bands(rng, 6)
    mode = jb.TransformMode.LIMITED
    w0, w1 = (np.asarray(jd.descriptor_words(p, mode)) for p in (p0, p1))
    bits0, bits1 = (np.asarray(jd.descriptor_bits(p, mode)) for p in (p0, p1))
    nbits = bits0.shape[-1]
    band = w0.shape[1] // NDEV
    cut = lambda a, k: a[:, k * band:(k + 1) * band]  # noqa: E731
    real = lambda k: min(band, W - k * band)  # noqa: E731
    for idx in range(NDEV):
        for src in range(NDEV):
            fwd = _decode_jax(*row_minima_words_band(
                cut(w0, idx), cut(w1, src), src * band, idx * band,
                nbits=nbits, w1_total=W, need_last=need_last, interpret=True,
                drange=drange), cut(bits0, idx).sum(-1))
            rev = _decode_jax(*row_minima_words_band(
                cut(w1, src), cut(w0, idx), idx * band, src * band,
                nbits=nbits, w1_total=W, need_last=need_last, interpret=True,
                drange=ts.reflect_range(drange)), cut(bits1, src).sum(-1))
            fold = ts.row_minima_consistency_band_torch_words
            a, b = _i32(cut(w0, idx)), _i32(cut(w1, src))
            mf = torch.full(a.shape[:2], ts.BIG, dtype=torch.int32)
            ml = torch.full_like(mf, ts.BIG) if need_last else None
            rf = torch.full((H_BAND, NDEV * band), ts.BIG,
                            dtype=torch.int32)
            rl = torch.full_like(rf, ts.BIG) if need_last else None
            fold(a, b, idx * band, src * band, mf, ml, rf, rl,
                 w_total=W, drange=drange)
            cols = slice(src * band, (src + 1) * band)
            for (cost, first, last), want, k in (
                    (ts.decode_minima(mf, ml, W), fwd, real(idx)),
                    (ts.decode_minima(rf[:, cols],
                                      None if rl is None
                                      else rl[:, cols], W), rev,
                     real(src))):
                got = (cost.numpy()[:, :k], first.numpy()[:, :k],
                       None if last is None else last.numpy()[:, :k])
                _assert_step_equal(got, tuple(
                    None if x is None else x[:, :k] for x in want))
            # Every other column of the reverse minima, and the padding
            # of both bands, stays untouched.
            untouched = torch.ones_like(rf, dtype=torch.bool)
            untouched[:, src * band:src * band + real(src)] = False
            assert bool((rf[untouched] == ts.BIG).all())
            assert bool((mf[:, real(idx):] == ts.BIG).all())


WBITS = 45  # two words


def _tied_bits(rng, h, w):
    """Random descriptor bits with duplicated columns on both sides, so
    that first and last differ in both directions, across bands."""
    b0 = rng.random((h, w, WBITS)) < 0.5
    b1 = rng.random((h, w, WBITS)) < 0.5
    b1[:, w - 3] = b1[:, 1]
    b0[:, w - 2] = b0[:, 2]
    b0[:, 5] = b1[:, 1]
    b1[:, 7] = b0[:, 2]
    return b0, b1


@pytest.mark.parametrize("drange", [None, (0, 5), (-3, 9)])
@pytest.mark.parametrize("ndev", [2, 3, 4])
def test_consistency_ring_matches_jax_both_ways(rng, ndev, drange):
    """The fused step composed over one ring of a CPU ``LocalMesh`` (W=23:
    a ragged last band at 2, 3 and 4 bands), with and without last, gives
    the forward minima of the JAX ring ``row_minima_wband(bits0, bits1)``
    and, from the same visits, the reverse minima of
    ``row_minima_wband(bits1, bits0)`` with the range reflected; the
    unpruned ring, through the plain step and through the kernel wrapper's
    CPU route, gives the same."""
    w = 23
    b0, b1 = _tied_bits(rng, 3, w)
    jm = js.make_mesh(ndev)
    _, jf, jl = (np.asarray(x) for x in js.row_minima_wband(
        b0, b1, True, mesh=jm, drange=drange))
    _, jf1, jl1 = (np.asarray(x) for x in js.row_minima_wband(
        b1, b0, True, mesh=jm, drange=ts.reflect_range(drange)))
    if drange is None:
        assert (jf != jl).any() and (jf1 != jl1).any(), "no tie to check"
    words0, words1 = _i32(jd.pack_bits(b0)), _i32(jd.pack_bits(b1))
    mesh = tsh.make_mesh(ndev, virtual=True, device="cpu")
    a, b = tsh._bands(words0, 1, mesh), tsh._bands(words1, 1, mesh)
    band = a[0].shape[1]
    for need_last in (True, False):
        fwd, (first1, last1) = tsh._ring_consistency(
            a, b, need_last, mesh, band, w, "torch", drange)
        first = torch.cat([f for f, _ in fwd], 1)[:, :w]
        np.testing.assert_array_equal(first.numpy(), jf)
        np.testing.assert_array_equal(first1.numpy(), jf1)
        if need_last:
            last = torch.cat([l for _, l in fwd], 1)[:, :w]
            np.testing.assert_array_equal(last.numpy(), jl)
            np.testing.assert_array_equal(last1.numpy(), jl1)
        else:
            assert all(l is None for _, l in fwd) and last1 is None
    fold = ts.row_minima_consistency_band_torch_words
    mf = [torch.full((3, band), ts.BIG, dtype=torch.int32)
          for _ in range(ndev)]
    ml = [torch.full_like(m, ts.BIG) for m in mf]
    rf = torch.full((3, ndev * band), ts.BIG, dtype=torch.int32)
    rl = torch.full_like(rf, ts.BIG)
    for i in range(ndev):
        for j in range(ndev):
            src = (j + i) % ndev
            fold(a[j], b[src], j * band, src * band, mf[j], ml[j], rf, rl,
                 w_total=w, drange=drange)
    fl = [ts.decode_minima(f, l, w)[1:] for f, l in zip(mf, ml)]
    for k, want in ((0, jf), (1, jl)):
        np.testing.assert_array_equal(
            torch.cat([x[k] for x in fl], 1)[:, :w].numpy(), want)
    _, f1, l1 = ts.decode_minima(rf, rl, w)
    np.testing.assert_array_equal(f1[:, :w].numpy(), jf1)
    np.testing.assert_array_equal(l1[:, :w].numpy(), jl1)
