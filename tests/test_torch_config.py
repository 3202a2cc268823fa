"""The port's configuration surface (libbicos_tpu_torch.config) against the
JAX package's: same fields, defaults, bit counts and validation."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import libbicos_tpu as jb
from libbicos_tpu import config as jc

import libbicos_tpu_torch as tb
from libbicos_tpu_torch import config as tc

REPO = Path(__file__).resolve().parent.parent


def _default(field):
    if field.default is not dataclasses.MISSING:
        return field.default
    return field.default_factory()


@pytest.mark.parametrize("name", ["Config", "Consistency", "NoDuplicates"])
def test_dataclass_fields_and_defaults_match(name):
    want = dataclasses.fields(getattr(jc, name))
    got = dataclasses.fields(getattr(tc, name))
    assert [f.name for f in got] == [f.name for f in want]
    for fg, fw in zip(got, want):
        dg, dw = _default(fg), _default(fw)
        if isinstance(dw, jc.TransformMode | jc.Precision):
            assert dg.name == dw.name
        elif dataclasses.is_dataclass(dw):
            assert type(dg).__name__ == type(dw).__name__
            assert dataclasses.asdict(dg) == dataclasses.asdict(dw)
        else:
            assert dg == dw


@pytest.mark.parametrize("enum_name", ["TransformMode", "Precision"])
def test_enums_match(enum_name):
    want = {m.name: m.value for m in getattr(jc, enum_name)}
    got = {m.name: m.value for m in getattr(tc, enum_name)}
    assert got == want


@pytest.mark.parametrize("mode", ["LIMITED", "FULL"])
def test_bit_counts_match(mode):
    jm, tm = jc.TransformMode[mode], tc.TransformMode[mode]
    for n in range(2, 70):
        assert tc.required_bits(n, tm) == jc.required_bits(n, jm)
        assert tc.actual_bits(n, tm) == jc.actual_bits(n, jm)
        try:
            want = jc.validate_stack(n, jm)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                tc.validate_stack(n, tm)
        else:
            assert tc.validate_stack(n, tm) == want
    for bits in (32, 64, 128, 256):
        assert tc.max_stacksize(tm, bits) == jc.max_stacksize(jm, bits)


def test_headline_descriptor_is_126_bits_in_4_words():
    lim = tc.TransformMode.LIMITED
    assert tc.required_bits(33, lim) == 125
    assert tc.actual_bits(33, lim) == 126
    from libbicos_tpu_torch.descriptor import n_words_for

    assert n_words_for(tc.actual_bits(33, lim)) == 4


def test_validate_stack_rejects_one_image():
    with pytest.raises(ValueError, match="at least two"):
        tc.validate_stack(1, tc.TransformMode.LIMITED)


@pytest.mark.parametrize("cfg", [
    jb.Config(),
    jb.Config(nxcorr_threshold=0.96, subpixel_step=0.1, min_variance=2.0),
    jb.Config(nxcorr_threshold=None, mode=jb.TransformMode.FULL),
    jb.Config(precision=jb.Precision.DOUBLE,
              variant=jb.Consistency(max_lr_diff=3, no_dupes=True)),
    jb.Config(disparity_range=(np.int64(-4), 9)),
])
def test_config_from_reference_round_trip(cfg):
    got = tb.config_from_reference(cfg)
    assert isinstance(got, tc.Config)
    for f in dataclasses.fields(jc.Config):
        gv, wv = getattr(got, f.name), getattr(cfg, f.name)
        if isinstance(wv, jc.TransformMode | jc.Precision):
            assert gv.name == wv.name
        elif dataclasses.is_dataclass(wv):
            assert type(gv).__name__ == type(wv).__name__
            assert dataclasses.asdict(gv) == dataclasses.asdict(wv)
        else:
            assert gv == wv


@pytest.mark.parametrize("kwargs, match", [
    (dict(subpixel_step=0.0), "positive"),
    (dict(disparity_range=(1.5, 3)), "integer"),
    (dict(disparity_range=(True, 3)), "integer"),
    (dict(disparity_range=(5, 3)), "dmin <= dmax"),
])
def test_config_validation_matches(kwargs, match):
    with pytest.raises(ValueError, match=match):
        jc.Config(**kwargs)
    with pytest.raises(ValueError, match=match):
        tc.Config(**kwargs)


def test_invalid_sentinels_and_mask():
    assert tc.INVALID_DISP_INT16 == jc.INVALID_DISP_INT16
    assert np.isnan(tc.INVALID_DISP_FLOAT)
    d16 = torch.tensor([[-32768, 0, 5]], dtype=torch.int16)
    df = torch.tensor([[float("nan"), 0.0, 1.5]])
    want16 = np.asarray(jc.is_invalid(d16.numpy()))
    wantf = np.asarray(jc.is_invalid(df.numpy()))
    np.testing.assert_array_equal(tc.is_invalid(d16).numpy(), want16)
    np.testing.assert_array_equal(tc.is_invalid(df).numpy(), wantf)


@pytest.mark.parametrize("np_dtype, torch_dtype", [
    (np.float32, torch.float32), (np.float64, torch.float64),
    (np.float16, torch.float16), (np.int16, torch.int16),
])
def test_invalid_disparity_matches(np_dtype, torch_dtype):
    want = jc.invalid_disparity(np_dtype)
    for dt in (np_dtype, np.dtype(np_dtype), np.dtype(np_dtype).name,
               torch_dtype):
        got = tc.invalid_disparity(dt)
        assert type(got) is type(want)
        assert (np.isnan(got) and np.isnan(want)) or got == want


@pytest.mark.parametrize("dtype", [np.int32, np.uint8, torch.int32,
                                   torch.bool])
def test_invalid_disparity_rejects_other_dtypes(dtype):
    if not isinstance(dtype, torch.dtype):
        with pytest.raises(ValueError, match="unsupported"):
            jc.invalid_disparity(dtype)
    with pytest.raises(ValueError, match="unsupported"):
        tc.invalid_disparity(dtype)


@pytest.mark.parametrize("values, dtype", [
    ([[-32768, 0, 5], [7, -32768, -1]], np.int16),
    ([[float("nan"), 0.0, 1.5], [-2.5, float("nan"), 3.0]], np.float32),
    ([[-32768, 0, 32767]], np.int32),
])
def test_is_invalid_numpy_and_tensors_match(values, dtype):
    arr = np.asarray(values, dtype)
    want = np.asarray(jc.is_invalid(arr))
    got = tc.is_invalid(arr)
    assert isinstance(got, np.ndarray) and got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    got_t = tc.is_invalid(torch.from_numpy(arr))
    assert isinstance(got_t, torch.Tensor) and got_t.dtype == torch.bool
    np.testing.assert_array_equal(got_t.numpy(), want)
    # A nested list is taken as an array, as by the JAX package.
    np.testing.assert_array_equal(tc.is_invalid(arr.tolist()),
                                  np.asarray(jc.is_invalid(arr.tolist())))


def test_both_packages_export_invalid_disparity():
    assert "invalid_disparity" in jb.__all__
    assert "invalid_disparity" in tb.__all__
    assert tb.invalid_disparity is tc.invalid_disparity
    assert set(tb.__all__) <= set(jb.__all__) | {"config_from_reference"}


def test_import_leaves_jax_out():
    """The port (every module, kernels included) must import without jax:
    the machine with the card has none."""
    code = (
        "import sys\n"
        "import libbicos_tpu_torch, libbicos_tpu_torch.io\n"
        "import libbicos_tpu_torch.kernels.agree\n"
        "import libbicos_tpu_torch.kernels.band\n"
        "import libbicos_tpu_torch.kernels.bases\n"
        "import libbicos_tpu_torch.kernels.consistency\n"
        "import libbicos_tpu_torch.kernels.hamming\n"
        "import libbicos_tpu_torch.kernels.transform\n"
        "import libbicos_tpu_torch.sharding\n"
        "import libbicos_tpu_torch.debug, libbicos_tpu_torch.profiling\n"
        "import libbicos_tpu_torch.pybicos_compat, libbicos_tpu_torch.cli\n"
        "import libbicos_tpu_torch._colormaps\n"
        "import libbicos_tpu_torch.serve, libbicos_tpu_torch.client\n"
        "import libbicos_tpu_torch.dryrun\n"
        "import libbicos_tpu_torch.native\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'libbicos_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_client_file_needs_only_numpy():
    """``libbicos_tpu_torch/client.py`` loaded by path (as a scanner host
    without torch would load a copy of it) imports neither torch nor jax."""
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    'bicos_client', 'libbicos_tpu_torch/client.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert mod.BicosClient and mod.ServerError\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'libbicos_tpu', 'libbicos_tpu_torch')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
