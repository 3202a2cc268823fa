"""The port's sharded paths (``libbicos_tpu_torch.sharding`` on a
``LocalMesh``, ``backend="torch"``) against the JAX package's on the
8-device virtual CPU mesh, on the same numpy inputs: the ring visit list,
one W-band ring step (the plain fold beside ``csrc/band.cu``) against the
Pallas band kernels in interpret mode, the ring minima, ``match_sharded_w``,
``match_sharded`` and ``match_batched_sharded``, and the banded agree.
Integers, first/last argmins with their sentinels and disparities are
exactly equal (f32 disparities on valid pixels, with the same NaN mask)."""

import numpy as np
import pytest
import torch

from conftest import make_stack_pair

import libbicos_tpu as jb
from libbicos_tpu import agree as ja
from libbicos_tpu import descriptor as jd
from libbicos_tpu import search as jsearch
from libbicos_tpu import sharding as js
from libbicos_tpu.kernels.hamming import (
    pack_for_width,
    row_minima_stack_band,
    row_minima_words_band,
)

import libbicos_tpu_torch as tb
from libbicos_tpu_torch import agree as ta
from libbicos_tpu_torch import descriptor as tdesc
from libbicos_tpu_torch import search as ts
from libbicos_tpu_torch import sharding as tsh

NDEV = 4


@pytest.fixture(scope="module")
def jmesh():
    import jax

    if len(jax.devices()) < NDEV:
        pytest.skip(f"needs >= {NDEV} JAX devices")
    return js.make_mesh(NDEV)


@pytest.fixture
def tmesh():
    return tsh.make_mesh(NDEV, virtual=True, device="cpu")


def _i32(words) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words).view(np.int32).copy())


def _assert_same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float32:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        m = ~np.isnan(want)
        np.testing.assert_array_equal(got[m], want[m])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 5])
def test_wband_ring_visits_equal_jax(ndev):
    for band in (1, 4, 7, 825):
        for drange in [None, (0, 3), (2, 9), (-5, -1), (0, 0), (-2, 2),
                       (5, 100), (-100, 100), (0, 511), (3000, 4000)]:
            assert (tsh.wband_ring_visits(ndev, band, drange)
                    == js.wband_ring_visits(ndev, band, drange)), (
                ndev, band, drange)


# ---------------------------------------------------------------------------
# One ring step: the plain band fold against the Pallas band kernels.

W, H_BAND = 42, 3  # W=42: 4 bands of 11 columns, two of them ring padding
STEP_RANGES = [None, (0, 15), (-6, 6), (100, 200)]  # the last: no candidate


def _padded_bands(rng, n, dtype=np.uint8):
    s0, s1, _ = make_stack_pair(rng, n, H_BAND, W, dtype)
    pad = ((0, 0), (0, 0), (0, (-W) % NDEV))
    return np.pad(s0, pad), np.pad(s1, pad)


def _decode_jax(mf, ml, pop0):
    """The Pallas band kernels' f32 ``s * pack_s + col`` packings ->
    ``(cost, first, last, none)``, as ``libbicos_tpu.sharding`` decodes
    them."""
    pack_s, _ = pack_for_width(W)
    mf = np.asarray(mf, np.float64)
    none = mf >= float(1 << 22)
    s = np.floor(mf / pack_s)
    first = np.where(none, -1, (mf - s * pack_s).astype(np.int64))
    cost = s.astype(np.int64) + pop0
    last = None
    if ml is not None:
        ml = np.asarray(ml, np.float64)
        sl = np.floor(ml / pack_s)
        last = np.where(none, -2,
                        pack_s - 1 - (ml - sl * pack_s).astype(np.int64))
    return cost, first, last, none


def _port_step(words0, words1, idx, src, band, need_last, drange, fold):
    mf = torch.full(words0.shape[:2], ts.BIG, dtype=torch.int32)
    ml = torch.full_like(mf, ts.BIG) if need_last else None
    fold(words0, words1, idx * band, src * band, mf, ml, w1_total=W,
         drange=drange)
    cost, first, last = ts.decode_minima(mf, ml, W)
    return cost.numpy(), first.numpy(), None if ml is None else last.numpy()


def _assert_step_equal(port, jax_out):
    cost, first, last = port
    jcost, jfirst, jlast, none = jax_out
    np.testing.assert_array_equal(first < 0, none)
    np.testing.assert_array_equal(first, jfirst)
    np.testing.assert_array_equal(cost[~none], jcost[~none])
    if jlast is not None:
        np.testing.assert_array_equal(last, jlast)


@pytest.mark.parametrize("need_last", [True, False])
@pytest.mark.parametrize("drange", STEP_RANGES)
def test_band_step_matches_pallas_words_band(rng, drange, need_last):
    """Every (band, visit) of a 4-band ring, words engine
    (``_minima_kernel_band``), with the plain fold and the kernel wrapper's
    CPU route."""
    p0, p1 = _padded_bands(rng, 6)
    mode = jb.TransformMode.LIMITED
    w0, w1 = (np.asarray(jd.descriptor_words(p, mode)) for p in (p0, p1))
    bits0 = np.asarray(jd.descriptor_bits(p0, mode))
    nbits = bits0.shape[-1]
    band = w0.shape[1] // NDEV
    cut = lambda a, k: a[:, k * band:(k + 1) * band]  # noqa: E731
    for idx in range(NDEV):
        pop0 = cut(bits0, idx).sum(-1)
        for src in range(NDEV):
            mf, ml = row_minima_words_band(
                cut(w0, idx), cut(w1, src), src * band, idx * band,
                nbits=nbits, w1_total=W, need_last=need_last,
                interpret=True, drange=drange)
            _assert_step_equal(
                _port_step(_i32(cut(w0, idx)), _i32(cut(w1, src)), idx, src,
                           band, need_last, drange,
                           ts.row_minima_band_torch_words),
                _decode_jax(mf, ml, pop0))


@pytest.mark.parametrize("need_last", [True, False])
@pytest.mark.parametrize("drange", STEP_RANGES[:3])
def test_band_step_matches_pallas_stack_band(rng, drange, need_last):
    """The fused engine (``_minima_kernel_band_stack``) from raw u16
    bands: the port transforms each band once, then folds."""
    p0, p1 = _padded_bands(rng, 5, np.uint16)
    mode = jb.TransformMode.LIMITED
    band = p0.shape[2] // NDEV
    cut = lambda a, k: a[:, :, k * band:(k + 1) * band]  # noqa: E731
    for idx in range(NDEV):
        b0 = cut(p0, idx)
        pop0 = np.asarray(jd.descriptor_bits(b0, mode)).sum(-1)
        tw0 = tdesc.descriptor_words(torch.from_numpy(b0),
                                     tb.TransformMode.LIMITED)
        for src in range(NDEV):
            mf, ml = row_minima_stack_band(
                b0, cut(p1, src), src * band, idx * band, mode=mode,
                w1_total=W, need_last=need_last, interpret=True,
                drange=drange)
            tw1 = tdesc.descriptor_words(torch.from_numpy(cut(p1, src)),
                                         tb.TransformMode.LIMITED)
            _assert_step_equal(
                _port_step(tw0, tw1, idx, src, band, need_last, drange,
                           ts.row_minima_band_torch_words),
                _decode_jax(mf, ml, pop0))


# ---------------------------------------------------------------------------
# The ring.


@pytest.mark.parametrize("backend, need_last, drange", [
    ("xla", True, None), ("xla", False, None), ("xla", True, (0, 15)),
    ("pallas_interpret", False, None), ("pallas_interpret", True, (3, 20)),
])
def test_row_minima_wband_matches_jax(rng, jmesh, tmesh, backend, need_last,
                                      drange):
    s0, s1, _ = make_stack_pair(rng, 6, 3, W)  # W=42: uneven over 4 bands
    mode = jb.TransformMode.LIMITED
    b0 = jd.descriptor_bits(s0, mode)
    b1 = jd.descriptor_bits(s1, mode)
    jc, jf, jl = js.row_minima_wband(b0, b1, need_last, mesh=jmesh,
                                     backend=backend, drange=drange)
    w0, w1 = _i32(jd.pack_bits(b0)), _i32(jd.pack_bits(b1))
    cost, first, last = tsh.row_minima_wband(w0, w1, need_last, mesh=tmesh,
                                             drange=drange)
    jf = np.asarray(jf)
    m = jf >= 0
    np.testing.assert_array_equal(first.numpy(), jf)
    np.testing.assert_array_equal(cost.numpy()[m], np.asarray(jc)[m])
    sc, sf, sl = ts.row_minima_torch_words(w0, w1, need_last, drange=drange)
    assert torch.equal(first, sf) and torch.equal(cost[first >= 0],
                                                  sc[sf >= 0])
    if need_last:
        np.testing.assert_array_equal(last.numpy(), np.asarray(jl))
        assert torch.equal(last, sl)
    else:
        assert last is None
    if drange is not None and drange[0] > 0:
        assert (~m).any(), "the range should leave pixels without a candidate"


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_wband_duplicate_ties_across_bands(rng, jmesh, tmesh, backend):
    """A duplicate minimum split across two column bands is a tie (first !=
    last) after the ring."""
    b = rng.random((1, 40, 30)) < 0.5
    b1 = b.copy()
    b1[:, 35] = b1[:, 2]  # the two copies lie in bands 0 and 3
    bits0 = b[:, 2:3, :]
    jc, jf, jl = js.row_minima_wband(bits0, b1, True, mesh=jmesh,
                                     backend=backend)
    cost, first, last = tsh.row_minima_wband(
        _i32(jd.pack_bits(bits0)), _i32(jd.pack_bits(b1)), True, mesh=tmesh)
    assert (int(cost[0, 0]), int(first[0, 0]), int(last[0, 0])) == (0, 2, 35)
    assert (int(jc[0, 0]), int(jf[0, 0]), int(jl[0, 0])) == (0, 2, 35)


def test_row_minima_wband_unequal_widths(rng, tmesh):
    """Left and right rows of different widths, each padded to its own
    bands, against the single scan."""
    a = _i32(rng.integers(0, 2**32, (3, 29, 2), dtype=np.uint64)
             .astype(np.uint32))
    b = _i32(rng.integers(0, 2**32, (3, 50, 2), dtype=np.uint64)
             .astype(np.uint32))
    for drange in (None, (-20, 5)):
        got = tsh.row_minima_wband(a, b, True, mesh=tmesh, drange=drange)
        want = ts.row_minima_torch_words(a, b, True, drange=drange)
        for g, x in zip(got[1:], want[1:]):
            assert torch.equal(g, x)


# ---------------------------------------------------------------------------
# match_sharded_w, match_sharded, match_batched_sharded.

WCFGS = [
    jb.Config(nxcorr_threshold=None),
    jb.Config(nxcorr_threshold=0.5, min_variance=1.0),
    jb.Config(nxcorr_threshold=0.6, subpixel_step=0.5),
    # step 0.1: the x grid is not exact in f32, so the banded agree must
    # add the column offset before its one rounding.
    jb.Config(nxcorr_threshold=0.6, subpixel_step=0.1),
    jb.Config(nxcorr_threshold=None,
              variant=jb.Consistency(max_lr_diff=1, no_dupes=True)),
    jb.Config(nxcorr_threshold=None,
              variant=jb.Consistency(max_lr_diff=2, no_dupes=False)),
    jb.Config(nxcorr_threshold=0.5, min_variance=1.0,
              disparity_range=(0, 15)),
    jb.Config(nxcorr_threshold=0.6, subpixel_step=0.1,
              disparity_range=(-6, 6)),
    jb.Config(nxcorr_threshold=0.7, subpixel_step=0.25,
              variant=jb.Consistency(max_lr_diff=1, no_dupes=True),
              disparity_range=(0, 12)),
    jb.Config(nxcorr_threshold=0.5,
              variant=jb.Consistency(max_lr_diff=2, no_dupes=False),
              disparity_range=(-6, 9)),
]


def _port_w(s0, s1, jcfg, mesh, **kw):
    return tsh.match_sharded_w(s0, s1, tb.config_from_reference(jcfg),
                               mesh=mesh, backend="torch", **kw)


@pytest.mark.parametrize("cfg", WCFGS)
def test_match_sharded_w_matches_jax_and_single(rng, jmesh, tmesh, cfg):
    s0, s1, _ = make_stack_pair(rng, 5, 4, W)
    got = _port_w(s0, s1, cfg, tmesh).numpy()
    _assert_same(got, js.match_sharded_w(s0, s1, cfg, mesh=jmesh,
                                         backend="xla"))
    _assert_same(got, tb.match(s0, s1, tb.config_from_reference(cfg),
                               backend="torch", device="cpu").numpy())


@pytest.mark.parametrize("cfg", [WCFGS[1], WCFGS[3], WCFGS[4], WCFGS[8]])
def test_match_sharded_w_matches_jax_pallas_ring(rng, jmesh, tmesh, cfg):
    """Against the JAX ring on its Pallas band kernels (interpret)."""
    s0, s1, _ = make_stack_pair(rng, 5, 6, 41)
    _assert_same(_port_w(s0, s1, cfg, tmesh).numpy(),
                 js.match_sharded_w(s0, s1, cfg, mesh=jmesh,
                                    backend="pallas_interpret"))


def test_match_sharded_w_u16_ranged_corrmap(rng, jmesh, tmesh):
    cfg = jb.Config(nxcorr_threshold=0.5, disparity_range=(0, 15))
    s0, s1, _ = make_stack_pair(rng, 5, 3, W, dtype=np.uint16)
    gd, gc = _port_w(s0, s1, cfg, tmesh, corrmap=True)
    jd_, jc = js.match_sharded_w(s0, s1, cfg, mesh=jmesh, corrmap=True,
                                 backend="pallas_interpret")
    _assert_same(gd.numpy(), jd_)
    np.testing.assert_array_equal(np.isnan(gc.numpy()), np.isnan(jc))
    m = ~np.isnan(np.asarray(jc))
    np.testing.assert_allclose(gc.numpy()[m], np.asarray(jc)[m], rtol=4e-6,
                               atol=4e-6)
    sd, sc = tb.match(s0, s1, tb.config_from_reference(cfg), corrmap=True,
                      device="cpu")
    _assert_same(gd.numpy(), sd.numpy())
    _assert_same(gc.numpy(), sc.numpy())  # the same arithmetic per pixel


@pytest.mark.parametrize("ndev", [1, 3, 5])
def test_match_sharded_w_any_band_count(rng, ndev):
    cfg = tb.Config(nxcorr_threshold=0.6, subpixel_step=0.1,
                    variant=tb.Consistency(1, True), disparity_range=(-3, 9))
    s0, s1, _ = make_stack_pair(rng, 5, 3, 23)
    _assert_same(tsh.match_sharded_w(
        s0, s1, cfg, mesh=tsh.make_mesh(ndev, virtual=True, device="cpu")
    ).numpy(), tb.match(s0, s1, cfg, device="cpu").numpy())


@pytest.mark.parametrize("cfg", [
    jb.Config(nxcorr_threshold=None),
    jb.Config(nxcorr_threshold=0.5, min_variance=1.0),
    jb.Config(nxcorr_threshold=0.7, subpixel_step=0.25,
              variant=jb.Consistency(max_lr_diff=1, no_dupes=True),
              disparity_range=(0, 12)),
])
def test_match_sharded_matches_jax(rng, jmesh, tmesh, cfg):
    s0, s1, _ = make_stack_pair(rng, 5, 10, 24)  # H=10: uneven over 4 bands
    got = tsh.match_sharded(s0, s1, tb.config_from_reference(cfg),
                            mesh=tmesh).numpy()
    _assert_same(got, js.match_sharded(s0, s1, cfg, mesh=jmesh,
                                       backend="xla"))


def test_match_sharded_corrmap_matches_jax(rng, jmesh, tmesh):
    cfg = jb.Config(nxcorr_threshold=0.5, subpixel_step=0.1)
    s0, s1, _ = make_stack_pair(rng, 5, 7, 24)
    gd, gc = tsh.match_sharded(s0, s1, tb.config_from_reference(cfg),
                               mesh=tmesh, corrmap=True)
    jd_, jc = js.match_sharded(s0, s1, cfg, mesh=jmesh, corrmap=True,
                               backend="xla")
    _assert_same(gd.numpy(), jd_)
    np.testing.assert_array_equal(np.isnan(gc.numpy()), np.isnan(jc))
    m = ~np.isnan(np.asarray(jc))
    np.testing.assert_allclose(gc.numpy()[m], np.asarray(jc)[m], rtol=4e-6,
                               atol=4e-6)


def test_match_batched_sharded_matches_jax(rng, jmesh, tmesh):
    cfg = jb.Config(nxcorr_threshold=0.5, min_variance=1.0)
    pairs = [make_stack_pair(rng, 4, 6, 24) for _ in range(3)]
    b0 = np.stack([p[0] for p in pairs])  # 18 rows over 4 bands
    b1 = np.stack([p[1] for p in pairs])
    jd_, jc = js.match_batched_sharded(b0, b1, cfg, mesh=jmesh, corrmap=True,
                                       backend="xla")
    gd, gc = tsh.match_batched_sharded(
        b0, b1, tb.config_from_reference(cfg), mesh=tmesh, corrmap=True)
    assert tuple(gd.shape) == (3, 6, 24)
    _assert_same(gd.numpy(), jd_)
    np.testing.assert_array_equal(np.isnan(gc.numpy()), np.isnan(jc))
    m = ~np.isnan(np.asarray(jc))
    np.testing.assert_allclose(gc.numpy()[m], np.asarray(jc)[m], rtol=4e-6,
                               atol=4e-6)
    with pytest.raises(ValueError, match="identical shapes"):
        tsh.match_batched_sharded(b0, b1[:, :, :3], tb.Config(), mesh=tmesh)


# ---------------------------------------------------------------------------
# Validation and the mesh.


def test_sharded_surfaces_validate_like_match(rng, tmesh):
    s0, s1, _ = make_stack_pair(rng, 5, 8, 24)
    none = tb.Config(nxcorr_threshold=None)
    for fn in (tsh.match_sharded, tsh.match_sharded_w):
        with pytest.raises(ValueError, match="at least two"):
            fn(s0[:1], s1[:1], none, mesh=tmesh)
        with pytest.raises(ValueError, match="depths"):
            fn(s0.astype(np.float32), s1.astype(np.float32), none,
               mesh=tmesh)
        with pytest.raises(ValueError, match="corrmap"):
            fn(s0, s1, none, mesh=tmesh, corrmap=True)
        with pytest.raises(ValueError, match="backend"):
            fn(s0, s1, none, mesh=tmesh, backend="xla")
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(s0, s1, none, mesh=tmesh, backend="cuda")  # a CPU mesh
        # DOUBLE is accepted, as by match, and equals match's DOUBLE.
        double = tb.Config(precision=tb.Precision.DOUBLE, subpixel_step=0.25)
        _assert_same(fn(s0, s1, double, mesh=tmesh).numpy(),
                     tb.match(s0, s1, double, device="cpu").numpy())
    double = tb.Config(precision=tb.Precision.DOUBLE)
    _assert_same(tsh.match_batched_sharded(s0[None], s1[None], double,
                                           mesh=tmesh)[0].numpy(),
                 tb.match(s0, s1, double, device="cpu").numpy())


@pytest.mark.parametrize("width", [ts.PACK_K, ts.PACK_K + 8])
def test_sharded_w_rejects_ultrawide(tmesh, width):
    s = np.zeros((2, 1, width), np.uint8)
    with pytest.raises(ValueError, match="width"):
        tsh.match_sharded_w(s, s, tb.Config(nxcorr_threshold=None),
                            mesh=tmesh)
    if width > ts.PACK_K:
        w = torch.zeros((1, width, 1), dtype=torch.int32)
        with pytest.raises(ValueError, match="width"):
            tsh.row_minima_wband(w, w, True, mesh=tmesh)


def test_make_mesh_rules():
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert tsh.make_mesh(device="cpu").size == 1
    assert tsh.make_mesh(1, device="cpu").ranks == (0,)
    with pytest.raises(ValueError, match="virtual=True"):
        tsh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="n_devices"):
        tsh.make_mesh(virtual=True, device="cpu")
    mesh = tsh.make_mesh(3, virtual=True, device="cpu")
    assert mesh.size == 3 and mesh.ranks == (0, 1, 2)
    bands = [torch.tensor([r]) for r in range(3)]
    # Band r receives band (r + k)'s payload, as the JAX ppermute with
    # perm [((d + k) % n, d)].
    assert [int(t) for t in mesh.shift(bands, 1)] == [1, 2, 0]
    assert [int(t) for t in mesh.shift(bands, 5)] == [2, 0, 1]
    assert mesh.all_gather(bands, 0).tolist() == [0, 1, 2]


def test_sharded_entry_points_default_to_the_card(rng):
    """A mesh's ``device=None`` is the card: without one ``make_mesh`` and
    the sharded entry points (whose default mesh is ``make_mesh()``) raise
    and name ``device="cpu"``; on a CPU mesh they run on the CPU."""
    s0, s1, _ = make_stack_pair(rng, 4, 4, 24)
    cfg = tb.Config(nxcorr_threshold=0.5)
    if not torch.cuda.is_available():
        for make in (lambda: tsh.make_mesh(4, virtual=True),
                     lambda: tsh.make_mesh(), lambda: tsh.LocalMesh(2)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        for fn in (tsh.match_sharded, tsh.match_sharded_w):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn(s0, s1, cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsh.match_batched_sharded(s0[None], s1[None], cfg)
    mesh = tsh.make_mesh(2, virtual=True, device="cpu")
    assert mesh.device == torch.device("cpu")
    want = tb.match(s0, s1, cfg, device="cpu")
    for fn in (tsh.match_sharded, tsh.match_sharded_w):
        got = fn(s0, s1, cfg, mesh=mesh)
        assert got.device.type == "cpu" and torch.equal(got, want)


# ---------------------------------------------------------------------------
# The banded agree.


@pytest.mark.parametrize("step", [0.1, 0.25, None])
def test_banded_agree_col_offset_matches_jax(rng, step):
    """A left band (columns 11..21) against the whole right row, with the
    band-local disparity and ``col_offset=11``."""
    s0, s1, _ = make_stack_pair(rng, 9, 5, W)
    disp = np.asarray(jsearch.search_stack(
        s0, s1, jb.TransformMode.LIMITED, jb.NoDuplicates(), backend="xla"))
    off, band = 11, 11
    local = disp[:, off:off + band].astype(np.int32)
    d_shift = np.where(local == -32768, -32768, local - off).astype(np.int16)
    d_shift[0, 0] = -W  # col1 = W: past the row, invalid
    d_shift[1, 0] = 0  # col1 = 0: the left border
    d_shift[2, 5] = 5 - (W - 1)  # col1 = W - 1: the right border
    s0b = np.ascontiguousarray(s0[:, :, off:off + band])
    t = [torch.from_numpy(x) for x in (d_shift, s0b, s1)]
    if step is not None:
        want_d, want_c = ja.agree_subpixel(d_shift, s0b, s1, 0.5, step, 18.0,
                                           col_offset=off)
        got_d, got_c = ta.agree_subpixel(*t, 0.5, step, 18.0, col_offset=off)
    else:
        want_d, want_c = ja.agree_integer(d_shift, s0b, s1, 0.5, 18.0)
        want_d = np.asarray(want_d).astype(np.int32)
        want_d = np.where(want_d == -32768, want_d, want_d + off).astype(
            np.int16)
        got_d, got_c = ta.agree_integer(*t, 0.5, 18.0, col_offset=off)
    _assert_same(got_d.numpy(), want_d)
    np.testing.assert_array_equal(np.isnan(got_c.numpy()), np.isnan(want_c))
    m = ~np.isnan(np.asarray(want_c))
    np.testing.assert_allclose(got_c.numpy()[m], np.asarray(want_c)[m],
                               rtol=4e-6, atol=4e-6)
