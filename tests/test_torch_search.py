"""Hamming row scan and NoDuplicates search of the port (the plain scan,
the version the scan kernel is held to on the card) against the JAX
package: first/last argmin and int16 disparities exactly equal to the XLA
scan and to the Pallas scan kernels run in interpret mode, with the bf16
and the int8 engine; plus one 40000-wide Consistency search, and the kernel
wrappers' refusal of CPU tensors."""

import numpy as np
import pytest
import torch

from conftest import make_stack_pair

from libbicos_tpu import Consistency as JConsistency
from libbicos_tpu import NoDuplicates as JNoDup
from libbicos_tpu import TransformMode as JMode
from libbicos_tpu import descriptor as jd
from libbicos_tpu import search as js
from libbicos_tpu.config import actual_bits
from libbicos_tpu.kernels.hamming import (
    row_minima_pallas_words,
    row_minima_stack as j_row_minima_stack,
)

from libbicos_tpu_torch import Consistency, NoDuplicates
from libbicos_tpu_torch import TransformMode as TMode
from libbicos_tpu_torch import search as ts
from libbicos_tpu_torch.descriptor import descriptor_words


def _i32(words) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words).view(np.int32).copy())


def _words(rng, n, h, w, mode="LIMITED", dtype=np.uint8):
    s0, s1, _ = make_stack_pair(rng, n, h, w, dtype)
    w0 = np.asarray(jd.descriptor_words(s0, JMode[mode]))
    w1 = np.asarray(jd.descriptor_words(s1, JMode[mode]))
    return s0, s1, w0, w1


def _stack_minima(s0, s1, mode):
    """The plain transform and scan from numpy stacks: ``(cost, first,
    last)``."""
    return ts.row_minima_torch_words(
        descriptor_words(torch.from_numpy(s0), TMode[mode]),
        descriptor_words(torch.from_numpy(s1), TMode[mode]), True)


@pytest.mark.parametrize("need_last", [True, False])
@pytest.mark.parametrize("n, mode, budget", [
    (2, "LIMITED", 1 << 26),
    (4, "LIMITED", 100),   # forces row chunks
    (9, "FULL", 1 << 26),
    (33, "LIMITED", 37),   # forces row and column chunks
    (17, "FULL", 500),
])
def test_plain_scan_matches_xla(rng, n, mode, budget, need_last):
    _, _, w0, w1 = _words(rng, n, 5, 48, mode)
    cost, first, last = js.row_minima_xla_words(w0, w1, need_last)
    gc, gf, gl = ts.row_minima_torch_words(_i32(w0), _i32(w1), need_last,
                                           pair_budget=budget)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(cost))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(first))
    if need_last:
        np.testing.assert_array_equal(gl.numpy(), np.asarray(last))
    else:
        assert gl is None


@pytest.mark.parametrize("n, mode, dtype", [
    (33, "LIMITED", np.uint8),
    (4, "LIMITED", np.uint16),
    (9, "FULL", np.uint8),
])
def test_words_wrapper_matches_pallas_words_kernel(rng, n, mode, dtype):
    _, _, w0, w1 = _words(rng, n, 4, 150, mode, dtype)
    _, want_f, want_l = row_minima_pallas_words(
        w0, w1, nbits=actual_bits(n, JMode[mode]), need_last=True,
        interpret=True)
    _, f, last = ts.row_minima_torch_words(_i32(w0), _i32(w1), True)
    np.testing.assert_array_equal(f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(last.numpy(), np.asarray(want_l))
    _, f2, none = ts.row_minima_torch_words(_i32(w0), _i32(w1), False)
    assert none is None and torch.equal(f2, f)


@pytest.mark.parametrize("n, mode, dtype", [
    (33, "LIMITED", np.uint8),
    (9, "FULL", np.uint16),
    (4, "LIMITED", np.uint8),
])
def test_stack_wrapper_matches_pallas_stack_kernel(rng, n, mode, dtype):
    """Transform + scan from raw stacks against the fused Pallas kernel."""
    s0, s1, _ = make_stack_pair(rng, n, 3, 140, dtype)
    none, want_f, want_l = j_row_minima_stack(
        s0, s1, mode=JMode[mode], need_last=True, interpret=True)
    got = _stack_minima(s0, s1, mode)
    assert none is None
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want_l))


def test_duplicate_columns_first_ne_last(rng):
    """Repeated right columns make first != last; NoDuplicates invalidates
    exactly those pixels, as the JAX search does."""
    s0, s1, w0, w1 = _words(rng, 6, 3, 40)
    w1 = w1.copy()
    w1[:, 30:36] = w1[:, 5:11]  # every descriptor of 5..10 appears twice
    w0 = w0.copy()
    w0[:, 2:8] = w1[:, 5:11]
    _, first, last = js.row_minima_xla_words(w0, w1, True)
    _, gf, gl = ts.row_minima_torch_words(_i32(w0), _i32(w1), True)
    np.testing.assert_array_equal(gf.numpy(), np.asarray(first))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(last))
    assert (gf.numpy()[:, 2:8] != gl.numpy()[:, 2:8]).all()
    nbits = actual_bits(6, JMode.LIMITED)
    want = np.asarray(js.search_words(w0, w1, nbits, JNoDup(), "xla"))
    got = ts.search_words(_i32(w0), _i32(w1), nbits, NoDuplicates())
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[:, 2:8] == -32768).all()


@pytest.mark.parametrize("n, mode, dtype", [
    (2, "LIMITED", np.uint8),
    (3, "LIMITED", np.uint16),
    (9, "FULL", np.uint16),
    (33, "LIMITED", np.uint8),
])
def test_search_stack_matches_xla(rng, n, mode, dtype):
    s0, s1, _ = make_stack_pair(rng, n, 4, 56, dtype)
    want = np.asarray(js.search_stack(s0, s1, JMode[mode], JNoDup(),
                                      backend="xla"))
    for backend in ("auto", "torch"):
        got = ts.search_stack(torch.from_numpy(s0), torch.from_numpy(s1),
                              TMode[mode], NoDuplicates(), backend=backend)
        np.testing.assert_array_equal(got.numpy(), want)


def test_ultrawide_packing_matches_xla(rng):
    """Rows wider than PACK_K widen the packing (and the JAX scan goes
    column-chunked); both must agree."""
    w1 = np.asarray(rng.integers(0, 1 << 32, size=(1, 40000, 1),
                                 dtype=np.uint64), dtype=np.uint32)
    w1[0, 39000] = w1[0, 7]  # a duplicate across the chunk boundary
    w0 = w1[:, [7, 100, 39999, 5]].copy()
    cost, first, last = js.row_minima_xla_words(w0, w1, True)
    gc, gf, gl = ts.row_minima_torch_words(_i32(w0), _i32(w1), True)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(cost))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(first))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(last))
    assert gf[0, 0] == 7 and gl[0, 0] == 39000


def test_decode_packed_minima_matches():
    mf = np.array([[3 * 32768 + 5, 17]], np.int32)
    ml = np.array([[3 * 32768 + 40, 9]], np.int32)
    want = js.decode_packed_minima(mf, ml, 64, True)
    got = ts.decode_packed_minima(torch.from_numpy(mf), torch.from_numpy(ml),
                                  64, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_resolve_backend_rules():
    cpu = torch.zeros(1)
    assert ts.resolve_backend("auto", cpu) == "torch"
    assert ts.resolve_backend("torch", cpu) == "torch"
    assert ts.resolve_backend("auto", torch.zeros(1, device="meta")) == \
        "torch"
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        ts.resolve_backend("cuda", cpu)
    with pytest.raises(ValueError, match="backend"):
        ts.resolve_backend("xla", cpu)


@pytest.mark.parametrize("n, mode, dtype", [
    (33, "LIMITED", np.uint8),
    (9, "FULL", np.uint16),
    (3, "LIMITED", np.uint8),
])
def test_words_wrapper_matches_i8_engine_kernel(rng, n, mode, dtype):
    """Against the int8-engine twin ``_minima_kernel_i8`` (interpret)."""
    _, _, w0, w1 = _words(rng, n, 4, 150, mode, dtype)
    _, want_f, want_l = row_minima_pallas_words(
        w0, w1, nbits=actual_bits(n, JMode[mode]), need_last=True,
        interpret=True, engine="i8")
    _, f, last = ts.row_minima_torch_words(_i32(w0), _i32(w1), True)
    np.testing.assert_array_equal(f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(last.numpy(), np.asarray(want_l))


@pytest.mark.parametrize("n, mode, dtype", [
    (33, "LIMITED", np.uint8),
    (9, "FULL", np.uint16),
])
def test_stack_wrapper_matches_i8_engine_kernel(rng, n, mode, dtype):
    """Against the int8-engine twin ``_minima_kernel_i8_stack``
    (interpret)."""
    s0, s1, _ = make_stack_pair(rng, n, 3, 140, dtype)
    _, want_f, want_l = j_row_minima_stack(
        s0, s1, mode=JMode[mode], need_last=True, interpret=True,
        engine="i8")
    got = _stack_minima(s0, s1, mode)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want_l))


def test_ultrawide_consistency_matches_xla(rng):
    """1 row x 40000 columns through the Consistency search: both packings
    widen past 2^15 columns, forward and reverse."""
    w1 = np.asarray(rng.integers(0, 1 << 32, size=(1, 40000, 1),
                                 dtype=np.uint64), dtype=np.uint32)
    w0 = np.roll(w1, 3, axis=1)        # disparity 3 everywhere
    w0[0, 30000:30010] = w0[0, 100:110]  # duplicated left columns
    w0[0, 5] ^= 1                       # one bit off its match
    want = np.asarray(js.search_words(w0, w1, 32, JConsistency(1, True),
                                      "xla"))
    got = ts.search_words(_i32(w0), _i32(w1), 32, Consistency(1, True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != -32768).any() and (want == -32768).any()


def _refusal_cases():
    """Each kernel wrapper with CPU arguments of a shape it would take."""
    from libbicos_tpu_torch.kernels import agree, band, bases, consistency
    from libbicos_tpu_torch.kernels import hamming, transform

    stack = torch.zeros((5, 2, 16), dtype=torch.uint8)
    words = torch.zeros((2, 16, 1), dtype=torch.int32)
    acc = torch.zeros((2, 16), dtype=torch.int32)
    disp = torch.zeros((2, 16), dtype=torch.int16)
    return {
        "descriptor_words_cuda": lambda: transform.descriptor_words_cuda(
            stack, TMode.LIMITED),
        "row_minima_words": lambda: hamming.row_minima_words(
            words, words, True),
        "row_minima_consistency_words":
            lambda: consistency.row_minima_consistency_words(
                words, words, no_dupes=True),
        "agree_cuda": lambda: agree.agree_cuda(disp, stack, stack, 0.5, 0.1,
                                               None),
        "row_minima_band": lambda: band.row_minima_band(
            words, words, 0, 0, acc, acc.clone(), w1_total=16),
        "row_minima_consistency_band":
            lambda: band.row_minima_consistency_band(
                words, words, 0, 0, acc, acc.clone(), acc.clone(),
                acc.clone(), w_total=16),
        "chunk_window_bases_cuda": lambda: bases.chunk_window_bases_cuda(
            disp, 16, 256, 640, 256),
    }


@pytest.mark.parametrize("wrapper", sorted(_refusal_cases()))
def test_kernel_wrappers_refuse_cpu_tensors(monkeypatch, wrapper):
    """A kernel wrapper only launches: given CPU tensors it raises before
    the kernel library is built, and never runs the plain version."""
    from libbicos_tpu_torch.kernels import _build

    def no_library():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "library", no_library)
    with pytest.raises(ValueError, match="one CUDA device"):
        _refusal_cases()[wrapper]()
