"""The port's profiling module (``libbicos_tpu_torch/profiling.py``)
against the JAX package's: equal ``metrics``, the same ``stage_timings``
keys, ``device_memory`` empty on the CPU, ``emit`` and ``trace``."""

import json

import numpy as np
import pytest
import torch

from libbicos_tpu import profiling as jp
from libbicos_tpu.config import Config as JConfig

import libbicos_tpu_torch as tb
from libbicos_tpu_torch import profiling as tp
from libbicos_tpu_torch.io import synthetic_stack_pair


def _disparities():
    g = np.random.default_rng(7)
    i16 = g.integers(-30, 60, (9, 23)).astype(np.int16)
    i16[g.random(i16.shape) < 0.3] = -32768
    f = g.normal(10, 5, (4, 9, 23)).astype(np.float32)
    f[g.random(f.shape) < 0.2] = np.nan
    f[0, 0, 0] = np.inf
    return {"int16": i16, "float": f, "all invalid": np.full((3, 5), np.nan,
                                                             np.float32)}


@pytest.mark.parametrize("elapsed", [None, 12.5, 0.0371])
@pytest.mark.parametrize("kind", sorted(_disparities()))
def test_metrics_equal(kind, elapsed):
    disp = _disparities()[kind]
    want = jp.metrics(disp, elapsed)
    assert tp.metrics(disp, elapsed) == want
    assert tp.metrics(torch.from_numpy(disp), elapsed) == want


@pytest.mark.parametrize("cfg", [
    JConfig(nxcorr_threshold=0.5, subpixel_step=0.25),
    JConfig(nxcorr_threshold=None),
])
def test_stage_timings_keys(cfg):
    s0, s1, _ = synthetic_stack_pair(6, 8, 48, seed=3)
    want = jp.stage_timings(s0, s1, cfg, backend="xla")
    got = tp.stage_timings(s0, s1, tb.config_from_reference(cfg),
                           device="cpu")
    assert sorted(got) == sorted(want)
    assert all(isinstance(v, float) and v >= 0 for v in got.values())
    assert (got["agree_ms"] == 0.0) == (cfg.nxcorr_threshold is None)


def test_device_memory_is_empty_on_the_cpu():
    assert tp.device_memory("cpu") == {}
    assert tp.device_memory(torch.device("cpu")) == {}
    if not torch.cuda.is_available():
        assert tp.device_memory() == {}


def test_emit(capsys):
    d = {"a": 1, "b": [0.5, None]}
    assert tp.emit(d) == jp.emit(d)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and json.loads(out[0]) == d


def test_trace_writes_a_chrome_trace(tmp_path):
    s0, s1, _ = synthetic_stack_pair(4, 4, 24, seed=1)
    with tp.trace(tmp_path / "prof"):
        tb.match(s0, s1, device="cpu")
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
