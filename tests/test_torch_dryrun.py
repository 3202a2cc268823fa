"""The port's dry run (libbicos_tpu_torch/dryrun.py) on the CPU: every
sharded layout on a virtual mesh equal to the single call, and ``entry()``
equal to the JAX ``__graft_entry__.entry()`` on the same inputs."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import __graft_entry__ as graft  # noqa: E402

from libbicos_tpu_torch import dryrun  # noqa: E402
from libbicos_tpu_torch import sharding  # noqa: E402

CORR_TOL = dict(rtol=4e-6, atol=4e-6)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_dryrun_multichip_cpu(n_devices):
    dryrun.dryrun_multichip(n_devices, device="cpu")


def test_dryrun_multichip_catches_a_wrong_layout(monkeypatch):
    """The dry run's asserts fire: an H-banded result off by one pixel
    fails it."""
    real = sharding.match_sharded

    def off_by_one(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[0, 0] += 1
        return out

    monkeypatch.setattr(sharding, "match_sharded", off_by_one)
    with pytest.raises(AssertionError, match="match_sharded"):
        dryrun.dryrun_multichip(2, device="cpu")


def test_entry_equals_jax_entry():
    jfn, jargs = graft.entry()
    jd, jc = jax.jit(jfn)(*jargs)
    fn, args = dryrun.entry(device="cpu")
    for a, ja in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    disp, corr = fn(*args)
    assert disp.dtype == torch.int16 and disp.shape == (32, 64)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jd))
    np.testing.assert_allclose(corr.numpy(), np.asarray(jc), equal_nan=True,
                               **CORR_TOL)
    valid = disp != -32768
    assert valid.any() and bool(torch.isfinite(corr[valid]).all())


def test_entry_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(2)
