"""NXCORR validation of the port (the plain agree, which the agree kernel
is held to on the card) against the JAX package: disparities exactly equal
(same NaN mask for float output), corrmap within CORR_TOL, against the XLA
agree and the Pallas agree kernel run in interpret mode."""

import re

import numpy as np
import pytest
import torch

from conftest import make_stack_pair

from libbicos_tpu import NoDuplicates as JNoDup
from libbicos_tpu import TransformMode as JMode
from libbicos_tpu import agree as ja
from libbicos_tpu import search as js
from libbicos_tpu.kernels.agree import agree_pallas

from libbicos_tpu_torch import agree as ta

# The JAX package's bar for its Pallas agree against its XLA path
# (tests/test_agree_kernel.py): sums in another order or with fmas move
# the NXCORR by a few ulps.
CORR_TOL = dict(rtol=4e-6, atol=4e-6)


def _assert_corr_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], **CORR_TOL)


def _assert_disp_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    if got.dtype == np.float32:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        m = ~np.isnan(want)
        np.testing.assert_array_equal(got[m], want[m])
    else:
        np.testing.assert_array_equal(got, want)


def _case(rng, n, h, w, dtype=np.uint8):
    """Seeded stacks and their NoDuplicates disparity, with border and
    out-of-bounds matches planted in the first row."""
    s0, s1, _ = make_stack_pair(rng, n, h, w, dtype)
    disp = np.asarray(js.search_stack(s0, s1, JMode.LIMITED, JNoDup(),
                                      backend="xla")).copy()
    disp[0, 3] = 3        # col1 = 0: left border
    disp[0, w - 2] = -1   # col1 = w-1: right border
    disp[0, 5] = 9        # col1 < 0: out of bounds
    disp[0, 6] = -w       # col1 >= w: out of bounds
    return s0, s1, disp


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("step", [0.1, 0.25, 0.5, 0.3, 0.07, 1.0, 2.5])
def test_subpixel_xgrid_matches(step):
    assert ta.subpixel_xgrid(step) == ja.subpixel_xgrid(step)


def test_xgrid_drops_one_at_step_0_1():
    xs = ta.subpixel_xgrid(0.1)
    assert len(xs) == 20 and 1.0 not in xs and xs[0] == -1.0


@pytest.mark.parametrize("threshold, minvar", [(0.5, None), (0.5, 40.0),
                                               (-1.0, None)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("n", [2, 4, 9, 33])
def test_agree_integer_matches_xla(rng, n, dtype, threshold, minvar):
    s0, s1, disp = _case(rng, n, 4, 40, dtype)
    want_d, want_c = ja.agree_integer(disp, s0, s1, threshold, minvar)
    got_d, got_c = ta.agree_integer(*_t(disp, s0, s1), threshold, minvar)
    _assert_disp_equal(got_d.numpy(), want_d)
    _assert_corr_close(got_c.numpy(), want_c)


@pytest.mark.parametrize("step, minvar", [(0.1, 66.0), (0.25, None),
                                          (0.5, 20.0)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("n", [2, 9, 33])
def test_agree_subpixel_matches_xla(rng, n, dtype, step, minvar):
    s0, s1, disp = _case(rng, n, 4, 40, dtype)
    want_d, want_c = ja.agree_subpixel(disp, s0, s1, 0.6, step, minvar)
    got_d, got_c = ta.agree_subpixel(*_t(disp, s0, s1), 0.6, step, minvar)
    _assert_disp_equal(got_d.numpy(), want_d)
    _assert_corr_close(got_c.numpy(), want_c)


def test_agree_subpixel_threshold_minus_one(rng):
    s0, s1, disp = _case(rng, 9, 4, 40)
    want_d, want_c = ja.agree_subpixel(disp, s0, s1, -1.0, 0.1, None)
    got_d, got_c = ta.agree_subpixel(*_t(disp, s0, s1), -1.0, 0.1, None)
    _assert_disp_equal(got_d.numpy(), want_d)
    _assert_corr_close(got_c.numpy(), want_c)


@pytest.mark.parametrize("minvar", [None, 5.0])
@pytest.mark.parametrize("step", [None, 0.25])
def test_flat_series(rng, step, minvar):
    """Zero-variance series: NaN NXCORR keeps the pixel (reference quirk);
    with minvar the NXCORR is -1 and the pixel is dropped."""
    n, h, w = 6, 3, 24
    s0, s1, disp = _case(rng, n, h, w)
    s0[:, 1, :] = 77
    s1[:, 2, :] = 200
    args = (disp, s0, s1, 0.5)
    if step is None:
        want_d, want_c = ja.agree_integer(*args, minvar)
        got_d, got_c = ta.agree_integer(*_t(disp, s0, s1), 0.5, minvar)
    else:
        want_d, want_c = ja.agree_subpixel(*args, step, minvar)
        got_d, got_c = ta.agree_subpixel(*_t(disp, s0, s1), 0.5, step,
                                         minvar)
    _assert_disp_equal(got_d.numpy(), want_d)
    _assert_corr_close(got_c.numpy(), want_c)
    flat = got_c.numpy()[1][disp[1] != -32768]
    if minvar is not None:
        assert (flat == -1.0).all()
    elif step is None:
        assert np.isnan(flat).all()
    else:
        # Every swept NXCORR is NaN, so the best stays at its initial -1;
        # only border pixels (the integer check) keep NaN.
        assert np.all((flat == -1.0) | np.isnan(flat))


@pytest.mark.parametrize("n, dtype, step, minvar", [
    (33, np.uint8, 0.1, 66.0),     # the headline configuration
    (33, np.uint8, None, None),
    (9, np.uint16, 0.25, 18.0),    # u16: the window-gather Pallas kernel
    (4, np.uint16, None, 8.0),
    (3, np.uint8, 0.5, None),
])
def test_kernel_wrapper_matches_pallas_agree(rng, n, dtype, step, minvar):
    """The agree kernel's plain versions against the Pallas agree kernels
    in interpret mode; the integer variant's int16 answer is read as the
    kernel gives it, float32 with NaN where invalid."""
    s0, s1, disp = _case(rng, n, 4, 40, dtype)
    thr = 0.96 if n == 33 else 0.5
    want_o, want_c = agree_pallas(disp, s0, s1, thr, step, minvar,
                                  interpret=True)
    if step is None:
        got_o, got_c = ta.agree_integer(*_t(disp, s0, s1), thr, minvar)
        got_o = torch.where(got_o == ta.INVALID_I16, float("nan"),
                            got_o.to(torch.float32))
    else:
        got_o, got_c = ta.agree_subpixel(*_t(disp, s0, s1), thr, step,
                                         minvar)
    assert got_o.dtype == torch.float32 and got_c.dtype == torch.float32
    _assert_disp_equal(got_o.numpy(), np.asarray(want_o))
    _assert_corr_close(got_c.numpy(), want_c)


def test_out_of_bounds_and_border(rng):
    s0, s1, disp = _case(rng, 5, 2, 20)
    out, corr = ta.agree_subpixel(*_t(disp, s0, s1), -1.0, 0.25, None)
    out, corr = out.numpy(), corr.numpy()
    assert np.isnan(out[0, 5]) and np.isnan(corr[0, 5])
    assert np.isnan(out[0, 6]) and np.isnan(corr[0, 6])
    # Border columns take the integer check: the output is d itself.
    assert out[0, 3] == 3.0 and out[0, 18] == -1.0


# ---------------------------------------------------------------------------
# The exact-arithmetic identities csrc/agree.cu's sweep relies on, in the
# form the kernel computes them (numpy float32/float64 round every operation
# and never contract): the interpolated sample is rounded and cast by the
# bits of v + 1.5 * 2^23 and converted back by (2^23 | u) - 2^23 (float) or
# (2^52 | u) - 2^52 (double); each must equal rint -> int32 -> & mod ->
# float, which is what the plain agree (and the JAX package) computes.

MAGIC_ROUND = np.float32(1.5 * 2**23)


def _sample_bits(pa, pb, y1, x, mod):
    """agree.cu's sample(): v = ((pa*x)*x + pb*x) + y1 in float32, and
    the bits of v + 1.5 * 2^23 masked to the input width."""
    v = ((pa * x) * x + pb * x) + y1
    return v, (v + MAGIC_ROUND).view(np.int32) & np.int32(mod)


def _from_int_f32(u):
    return (u.astype(np.int32) | np.int32(0x4B000000)).view(np.float32) \
        - np.float32(2**23)


def _from_int_f64(u):
    return (u.astype(np.int64) | np.int64(0x43300000 << 32)).view(
        np.float64) - np.float64(2**52)


def _want(v, mod):
    return np.rint(v).astype(np.int32) & np.int32(mod)


@pytest.mark.parametrize("step", [0.1, 0.25, 0.5])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_sweep_rounding_identities(dtype, step):
    """Every x of the grid on seeded (y0, y1, y2) over the full input range
    and on every corner of it (0 and the maximum side by side, where the
    parabola overshoots below 0 and above the maximum)."""
    hi = int(np.iinfo(dtype).max)
    g = np.random.default_rng(0xA6EE)
    corners = np.array(np.meshgrid([0, hi], [0, hi], [0, hi])).reshape(3, -1)
    y = np.concatenate([g.integers(0, hi + 1, (3, 20000)), corners], axis=1)
    y0, y1, y2 = y.astype(np.float32)
    pa = np.float32(0.5) * ((y0 - np.float32(2.0) * y1) + y2)
    pb = np.float32(0.5) * (y2 - y0)
    overshoot = False
    for x in ta.subpixel_xgrid(step):
        v, bits = _sample_bits(pa, pb, y1, np.float32(x), hi)
        assert np.abs(v).max() < 2**18
        overshoot |= bool((v < -0.5).any() or (v > hi + 0.5).any())
        want = _want(v, hi)
        np.testing.assert_array_equal(bits, want)
        np.testing.assert_array_equal(_from_int_f32(bits),
                                      want.astype(np.float32))
        np.testing.assert_array_equal(_from_int_f64(bits),
                                      want.astype(np.float64))
    assert overshoot


@pytest.mark.parametrize("mod", [0xFF, 0xFFFF])
def test_rounding_identities_at_boundaries(mod):
    """Half-integers (ties go to even), negatives and the ends of the
    identities' domain |v| < 2^22: rintf, (int)rintf and the masked cast."""
    k = np.arange(-2**18, 2**18 + 1, dtype=np.int64)
    v = np.concatenate([
        k + 0.5, k - 0.5, k, k + 0.25, k - 0.75,
        [-0.0, -0.3, -0.5, -1.5, 2**22 - 1.5, 2**22 - 0.5,
         -(2**22) + 0.5]]).astype(np.float32)
    r = np.rint(v)
    np.testing.assert_array_equal((v + MAGIC_ROUND) - MAGIC_ROUND, r)
    np.testing.assert_array_equal(
        (v + MAGIC_ROUND).view(np.int32) - np.int32(0x4B400000),
        r.astype(np.int32))
    bits = (v + MAGIC_ROUND).view(np.int32) & np.int32(mod)
    np.testing.assert_array_equal(bits, _want(v, mod))
    np.testing.assert_array_equal(_from_int_f32(bits),
                                  _want(v, mod).astype(np.float32))


def test_int_to_float_identities_and_integer_sums():
    """(2^23 | u) - 2^23 and (2^52 | u) - 2^52 are exact for 0 <= u < 2^23,
    and a serial float32 sum of up to 65 samples of 0..65535 is the integer
    sum (the sweep's mean pass sums in integers)."""
    g = np.random.default_rng(0x5EED)
    u = np.concatenate([g.integers(0, 2**23, 100000),
                        [0, 1, 255, 65535, 65 * 65535, 2**23 - 1]])
    np.testing.assert_array_equal(_from_int_f32(u), u.astype(np.float32))
    np.testing.assert_array_equal(_from_int_f64(u), u.astype(np.float64))
    s = g.integers(0, 65536, (2000, 65))
    s[0] = 65535
    serial = np.add.accumulate(s.astype(np.float32), axis=1)[:, -1]
    np.testing.assert_array_equal(serial, s.sum(axis=1).astype(np.float32))
    np.testing.assert_array_equal(_from_int_f32(s.sum(axis=1)), serial)


# ---------------------------------------------------------------------------
# agree.cu's packed sweep: the host-side rule that picks its shot bucket
# (kernels/agree.py::packed_bucket, mirrored by the instances agree.cu
# builds) and the byte permutations that pack a sample's bits and move
# them back under the exponent of 2^23 (or into the low word of a double).

from pathlib import Path  # noqa: E402

from libbicos_tpu_torch import Precision  # noqa: E402
from libbicos_tpu_torch.kernels.agree import (  # noqa: E402
    DOUBLE_BUCKETS,
    PACKED_BUCKETS,
    packed_bucket,
)

AGREE_CU = (Path(__file__).resolve().parent.parent / "libbicos_tpu_torch"
            / "csrc" / "agree.cu").read_text()


@pytest.mark.parametrize("precision", [Precision.SINGLE, Precision.DOUBLE])
@pytest.mark.parametrize("step", [0.1, 0.05, 0.3, None])
@pytest.mark.parametrize("dtype, n, want", [
    (torch.uint8, 2, 16), (torch.uint8, 3, 16), (torch.uint8, 8, 16),
    (torch.uint8, 9, 16), (torch.uint8, 16, 16), (torch.uint8, 17, 33),
    (torch.uint8, 33, 33), (torch.uint8, 34, 65), (torch.uint8, 65, 65),
    (torch.uint16, 2, 16), (torch.uint16, 16, 16), (torch.uint16, 17, 33),
    (torch.uint16, 33, 33), (torch.uint16, 34, 0), (torch.uint16, 65, 0),
])
def test_packed_bucket_rule(dtype, n, want, step, precision):
    """The smallest bucket that holds n; the recomputing sweep (0) with no
    step (the integer variant), for u16 past 33 shots, and in DOUBLE but
    for u8 at 17 to 33 shots."""
    if step is None or (precision == Precision.DOUBLE
                        and (dtype, want) != (torch.uint8, 33)):
        want = 0
    assert packed_bucket(n, dtype, precision, step) == want


def test_packed_buckets_match_agree_cu():
    """The buckets the host rule picks are the instances agree.cu's
    launch_bucket dispatches (u16 without 65), and each bucket's lower edge
    (bucket_below) is the bucket before it."""
    body = AGREE_CU[AGREE_CU.index("int launch_bucket("):]
    body = body[:body.index("\n}\n")]
    cases = dict(re.findall(r"case (\d+):\s*(?:if constexpr \(([^)]*)\))?",
                            body))
    assert cases.pop("0") == ""
    kinds = {"f32": lambda f32, u8: f32,
             "f32 || u8": lambda f32, u8: f32 or u8,
             "f32 && u8": lambda f32, u8: f32 and u8}
    for b, cond in cases.items():
        for (dtype, f32), buckets in (
                ((torch.uint8, True), PACKED_BUCKETS[torch.uint8]),
                ((torch.uint16, True), PACKED_BUCKETS[torch.uint16]),
                ((torch.uint8, False), DOUBLE_BUCKETS[torch.uint8]),
                ((torch.uint16, False), DOUBLE_BUCKETS[torch.uint16])):
            assert kinds[cond](f32, dtype == torch.uint8) == (
                int(b) in buckets), (b, dtype, f32)
    below = re.search(r"constexpr int bucket_below\(int nmax\) \{\s*return "
                      r"([^;]*);", AGREE_CU)[1]
    pairs = dict((int(a), int(b)) for a, b in
                 re.findall(r"nmax == (\d+) \? (\d+)", below))
    for buckets in PACKED_BUCKETS.values():
        for lo, hi in zip(buckets, buckets[1:]):
            assert pairs[hi] == lo
        assert buckets[0] not in pairs


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    (sel >> 4i) & 7 of the 8 bytes {y:x}."""
    v = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint32)
    for i in range(4):
        b = np.uint64((sel >> (4 * i)) & 7)
        out |= ((v >> (np.uint64(8) * b)) & np.uint64(0xFF)).astype(
            np.uint32) << np.uint32(8 * i)
    return out


def _selectors(struct):
    """The __byte_perm selectors of agree.cu's Pack<struct>, in source
    order (put's, then get's)."""
    body = AGREE_CU[AGREE_CU.index(f"struct Pack<{struct}> {{"):]
    body = body[:body.index("};")]
    return [int(s, 16) for s in re.findall(r"(0x[0-9A-F]{4})\b", body)]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_packed_sample_identities(dtype):
    """Seeded sample bits (those of v + 1.5 * 2^23 for |v| < 2^18), packed
    into words slot by slot with agree.cu's put() selectors and read back
    with its get() selectors: each slot reads as rint(v) & mod, zero above
    it; the dp4a / dp2a sum of a word's slots, all or the first k, is the
    int sum of theirs; and that int, read as a denormal and taken up by
    kUp, less m1 * kScale, is the recomputing sweep's d1 = u - m1 times
    kScale, bit for bit, in float32 (2^126, 2^-23) and float64 (2^1022,
    2^-52), as are the covariance and variance chains on such d1."""
    mod = int(np.iinfo(dtype).max)
    per = 4 if dtype == np.uint8 else 2
    sel = _selectors("uint8_t" if dtype == np.uint8 else "uint16_t")
    put, get = sel[:per - 1], sel[per - 1:]
    if dtype == np.uint8:
        assert get == [0x4440]
        get = [0x4440 | s for s in range(4)]
    assert len(put) == per - 1 and len(get) == per
    g = np.random.default_rng(0xB17E)
    v = np.concatenate([g.uniform(-2**18 + 1, 2**18 - 1, (per, 4000)),
                        g.integers(-300, mod + 300, (per, 4000))], axis=1)
    v = v.astype(np.float32)
    bits = (v + MAGIC_ROUND).view(np.uint32)
    want = (np.rint(v).astype(np.int64) & mod).astype(np.uint32)
    word = bits[0].copy()  # slot 0 takes the word whole
    for s in range(1, per):
        word = _byte_perm(word, bits[s], put[s - 1])
    zero = np.zeros_like(word)
    for s in range(per):
        np.testing.assert_array_equal(_byte_perm(word, zero, get[s]),
                                      want[s])
    # Pack<T>::sum: __dp4a(w, ones, 0) adds byte i of w times byte i of
    # ones; __dp2a_lo(w, ones, 0) the low half times byte 0 of ones and the
    # high half times byte 1.
    ones = int(re.search(r"kOnes = (0x[0-9a-f]+)u;", AGREE_CU[
        AGREE_CU.index(f"struct Pack<{'uint8_t' if per == 4 else 'uint16_t'}>"
                       ):])[1], 16)
    width = 32 // per
    for k in range(1, per + 1):  # a whole word, or the first k slots
        mask = ones if k == per else ones & ((1 << (8 * k)) - 1)
        dot = sum(((word >> np.uint32(width * i)) & np.uint32(mod))
                  * ((mask >> (8 * i)) & 0xFF) for i in range(per))
        np.testing.assert_array_equal(dot, want[:k].sum(axis=0))
    # Scaled<C>: m1 as the sweep makes it, the mean of n samples.
    u = want.reshape(-1)
    n = 33
    m1 = (g.integers(0, n * mod + 1, u.size).astype(np.float32)
          / np.float32(n))
    for ft, ut, up, scale in ((np.float32, np.uint32, 2.0**126, 2.0**-23),
                              (np.float64, np.uint64, 2.0**1022, 2.0**-52)):
        d1 = u.astype(ft) - m1.astype(ft)
        d1s = (u.astype(ut).view(ft) * ft(up)) - m1.astype(ft) * ft(scale)
        np.testing.assert_array_equal(d1s, d1 * ft(scale))
        d0 = g.integers(-mod, mod + 1, u.size).astype(ft) / ft(3)
        cov, var, cov_s, var_s = ft(0), ft(0), ft(0), ft(0)
        for a, b, bs in zip(d0[:n], d1[:n], d1s[:n]):
            cov, var = cov + a * b, var + b * b
            cov_s, var_s = cov_s + a * bs, var_s + bs * bs
        assert cov_s == cov * ft(scale) and var_s == var * ft(scale)**2
