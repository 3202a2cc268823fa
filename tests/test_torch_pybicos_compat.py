"""The port's pybicos surface (``libbicos_tpu_torch/pybicos_compat.py``)
against the JAX package's: the same ``Config`` semantics (defaults, the
None <-> -1 sentinels, the engine config it maps to) and the same
``match`` results, disparity bit for bit (NaN mask included) and corrmap
within CORR_TOL, on the CPU."""

import numpy as np
import pytest

import libbicos_tpu.pybicos_compat as jp

import libbicos_tpu_torch as tb
import libbicos_tpu_torch.pybicos_compat as tp
from libbicos_tpu_torch.io import synthetic_stack_pair

CORR_TOL = dict(rtol=4e-6, atol=4e-6)


def _configure(mod, setup):
    cfg = mod.Config()
    for name, value in setup.items():
        if name == "consistency":
            cfg.set_consistency(*value)
        elif name == "no_duplicates":
            cfg.set_no_duplicates()
        elif name in ("mode", "precision"):
            setattr(cfg, name, getattr(mod, type(value).__name__)[value.name]
                    if hasattr(value, "name") else value)
        else:
            setattr(cfg, name, value)
    return cfg


SETUPS = {
    "defaults": {},
    "subpixel": {"subpixel_step": 0.25, "min_variance": 1.0},
    "none threshold": {"nxcorr_threshold": None},
    "negative threshold": {"nxcorr_threshold": -1.0, "subpixel_step": 0.5},
    "cleared sentinels": {"subpixel_step": 0.1, "min_variance": 2.0},
    "full": {"mode": jp.TransformMode.FULL, "nxcorr_threshold": 0.6},
    "mode as int": {"mode": 1},
    "double": {"precision": jp.Precision.DOUBLE, "subpixel_step": 0.2},
    "consistency": {"consistency": (2, True)},
    "consistency then nodup": {"consistency": (1, False),
                               "no_duplicates": True},
}


@pytest.mark.parametrize("name", sorted(SETUPS))
def test_config_semantics_match(name):
    jcfg, tcfg = _configure(jp, SETUPS[name]), _configure(tp, SETUPS[name])
    if name == "cleared sentinels":
        for cfg in (jcfg, tcfg):
            cfg.subpixel_step = None
            cfg.min_variance = None
    for attr in ("nxcorr_threshold", "subpixel_step", "min_variance",
                 "variant"):
        assert getattr(tcfg, attr) == getattr(jcfg, attr), attr
    assert tcfg.mode.name == jcfg.mode.name
    assert tcfg.precision.name == jcfg.precision.name
    assert repr(tcfg) == repr(jcfg)
    assert tcfg._to_native() == tb.config_from_reference(jcfg._to_native())


def test_enums_match():
    for enum in ("TransformMode", "Precision", "VariantType"):
        assert ({e.name: e.value for e in getattr(tp, enum)}
                == {e.name: e.value for e in getattr(jp, enum)})


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("name", sorted(SETUPS))
def test_match_equal(name, dtype):
    n = 12 if name in ("full", "mode as int") else 7
    s0, s1, _ = synthetic_stack_pair(n, 5, 36, dtype=dtype, seed=len(name))
    jd, jc = jp.match(list(s0), list(s1), _configure(jp, SETUPS[name]))
    td, tc = tp.match(list(s0), list(s1), _configure(tp, SETUPS[name]),
                      device="cpu")
    assert isinstance(td, np.ndarray) and isinstance(tc, np.ndarray)
    assert td.dtype == jd.dtype == np.float32 and tc.dtype == np.float32
    assert td.shape == jd.shape == tc.shape == (5, 36)
    np.testing.assert_array_equal(np.isnan(td), np.isnan(jd))
    np.testing.assert_array_equal(td[~np.isnan(jd)], jd[~np.isnan(jd)])
    np.testing.assert_array_equal(np.isnan(tc), np.isnan(jc))
    m = ~np.isnan(jc)
    np.testing.assert_allclose(tc[m], jc[m], **CORR_TOL)
    if SETUPS[name].get("subpixel_step") is None:
        # The integer path's invalid pixels stay -32768.0, not NaN.
        assert not np.isnan(td).any() and (td == -32768.0).any()


def test_match_rejects_empty_stacks():
    for mod, kw in ((jp, {}), (tp, {"device": "cpu"})):
        with pytest.raises(ValueError, match="Empty image stacks"):
            mod.match([], [np.zeros((2, 2), np.uint8)], **kw)


def test_invalid_and_float_disparity_match():
    assert np.isnan(tp.invalid_disparity(np.float32))
    assert tp.invalid_disparity(np.int16) == jp.invalid_disparity(np.int16)
    assert type(tp.invalid_disparity(np.int16)) is np.int16
    for mod in (jp, tp):
        with pytest.raises(ValueError, match="Unsupported dtype"):
            mod.invalid_disparity(np.int32)
    g = np.random.default_rng(1)
    i16 = g.integers(-40, 40, (3, 8)).astype(np.int16)
    i16[0, 0] = -32768
    f = g.normal(size=(3, 8)).astype(np.float32)
    for d in (i16, f):
        got, want = tp.float_disparity(d), jp.float_disparity(d)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    import torch

    np.testing.assert_array_equal(
        tp.float_disparity(torch.from_numpy(i16)), jp.float_disparity(i16))
