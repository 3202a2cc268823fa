"""The check fails what it must: the control (the plain reference in the
program's place, its statistics and NXCORR in bfloat16, the precision next
below the configuration's float32) and each fault that a cell can have,
planted under the timed path, make ``correct`` come out false. The run is
the command's own, with the look for a card skipped, on the CPU at a tiny
shape."""

import io
import json
import time
from pathlib import Path

import pytest
import torch

from portbench import harness, spec

from libbicos_tpu_torch import pipeline

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SHAPE = (33, 32, 128)


def run(cell, seed=3000000321):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(ROOT, cell, seed, 1.5, False,
                          t_start=time.perf_counter(), device="cpu",
                          backend="torch", shape=SHAPE, out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def control(cell):
    cfg = spec.Benchmark(ROOT).config(spec.Benchmark(ROOT).cell(cell)[
        "config"])
    ref = spec.load_module("reference", cfg["reference"])

    def match(s0, s1, _cfg, *, corrmap=False, **_):
        _, disp, corr = ref.match(s0, s1, cfg, dtype=torch.bfloat16)
        return (disp, corr) if corrmap else disp
    return match


def altered(real):
    """Answers altered where they are made: the disparity of a band of 2%
    of the rows (one row at least) moved by one pixel."""
    def match(*a, **kw):
        disp, corr = real(*a, **kw)
        disp = disp.clone()
        disp[:max(1, disp.shape[0] // 50)] += 1.0
        return disp, corr
    return match


def stale(real):
    """The previous call's answer returned again: state left unchanged."""
    last = []

    def match(*a, **kw):
        out = real(*a, **kw)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return match


def half_rows(real):
    """Half of the rows left out: their maps stay invalid."""
    def match(*a, **kw):
        disp, corr = (x.clone() for x in real(*a, **kw))
        h = disp.shape[0]
        disp[h // 2:] = float("nan")
        corr[h // 2:] = float("nan")
        return disp, corr
    return match


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert run(cell)["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, monkeypatch):
    monkeypatch.setattr(pipeline, "match", control(cell))
    line = run(cell)
    assert line["correct"] is False
    failed = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert failed


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [altered, stale, half_rows])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(pipeline, "match", fault(pipeline.match))
    assert run(cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_raising_call_is_counted_and_not_correct(cell, monkeypatch):
    real = pipeline.match
    calls = []

    def match(*a, **kw):
        calls.append(1)
        if len(calls) == 3:  # the window's first, after a warm call a pair
            raise RuntimeError("planted")
        return real(*a, **kw)
    monkeypatch.setattr(pipeline, "match", match)
    line = run(cell)
    assert line["failed"] == 1 and line["correct"] is False
