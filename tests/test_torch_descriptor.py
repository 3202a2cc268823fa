"""Descriptor transform of the port (the plain version, which the transform
kernel is held to on the card) against the JAX package: descriptor words
bit-identical to ``descriptor_words`` (XLA) and to the Pallas transform
kernel run in interpret mode."""

import numpy as np
import pytest
import torch

from conftest import make_stack_pair

from libbicos_tpu import TransformMode as JMode
from libbicos_tpu import _oracle
from libbicos_tpu import descriptor as jd
from libbicos_tpu.kernels.transform import descriptor_words_pallas

from libbicos_tpu_torch import TransformMode as TMode
from libbicos_tpu_torch import descriptor as td

CASES = [(n, mode) for n in (2, 3, 4, 9, 33) for mode in ("LIMITED", "FULL")
         if not (mode == "FULL" and n > 17)] + [(17, "FULL")]


def _u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("n, mode", CASES)
def test_words_match_xla(rng, n, mode, dtype):
    s0, _, _ = make_stack_pair(rng, n, 5, 37, dtype)
    want = np.asarray(jd.descriptor_words(s0, JMode[mode]))
    got = td.descriptor_words(torch.from_numpy(s0), TMode[mode])
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("n, mode, dtype", [
    (33, "LIMITED", np.uint8),
    (3, "LIMITED", np.uint16),
    (9, "FULL", np.uint16),
    (17, "FULL", np.uint8),
])
def test_kernel_wrapper_matches_pallas_transform(rng, n, mode, dtype):
    """The transform kernel's plain version against the Pallas transform
    kernel in interpret mode."""
    s0, _, _ = make_stack_pair(rng, n, 6, 45, dtype)
    want = np.asarray(descriptor_words_pallas(s0, JMode[mode],
                                              interpret=True))
    got = td.descriptor_words(torch.from_numpy(s0), TMode[mode])
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("n, mode", [(2, "LIMITED"), (9, "LIMITED"),
                                     (5, "FULL")])
def test_bits_match_oracle(rng, n, mode):
    s0, _, _ = make_stack_pair(rng, n, 3, 11, np.uint8)
    want = _oracle.descriptor_bits(s0, JMode[mode])
    got = td.descriptor_bits(torch.from_numpy(s0), TMode[mode]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("mode", ["LIMITED", "FULL"])
def test_flat_series_mean_ties(mode, dtype):
    """A flat series sits exactly on the mean-bit tie (n*s == sum): every
    mean bit is 0, as in the reference; mixed flat/ramp pixels too."""
    n = 7
    s = np.full((n, 2, 3), 200, dtype)
    s[:, 1, :] = np.arange(n, dtype=dtype)[:, None] * 3
    want = np.asarray(jd.descriptor_words(s, JMode[mode]))
    got = td.descriptor_words(torch.from_numpy(s), TMode[mode])
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("nbits", [4, 31, 32, 33, 126, 256])
def test_pack_unpack_match(rng, nbits):
    bits = rng.integers(0, 2, size=(3, 5, nbits)).astype(bool)
    want = np.asarray(jd.pack_bits(bits))
    got = td.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(_u32(got), want)
    back = td.unpack_words(got, nbits).numpy()
    np.testing.assert_array_equal(back, bits)
    np.testing.assert_array_equal(
        back, np.asarray(jd.unpack_words(want, nbits)))


def test_words_equal_packed_bits(rng):
    s0, _, _ = make_stack_pair(rng, 12, 4, 20, np.uint16)
    t = torch.from_numpy(s0)
    for mode in (TMode.LIMITED, TMode.FULL):
        assert torch.equal(td.descriptor_words(t, mode),
                           td.pack_bits(td.descriptor_bits(t, mode)))


def test_rejects_bad_stacks():
    with pytest.raises(ValueError, match="at least two"):
        td.descriptor_words(torch.zeros((1, 2, 2), dtype=torch.uint8),
                            TMode.LIMITED)
    with pytest.raises(ValueError, match="uint8 and uint16"):
        td.descriptor_words(torch.zeros((3, 2, 2), dtype=torch.int32),
                            TMode.LIMITED)
