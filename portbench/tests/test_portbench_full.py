"""The harness takes a FULL-descriptor configuration with an int16
disparity (no subpixel step), as upstream's own integration benchmark at
n=16 (``bench_integration/16/0``, ``bench/cuda.cu:297-323``) runs it,
without a cell of its own in ``BENCHMARK.json``: a temporary root names
that one configuration under the ``device`` traffic, and the command's
run, on the CPU at a tiny shape, is correct for a sound run and not
correct for the control and for each planted fault."""

import json
from pathlib import Path

import pytest
import torch

from portbench import spec

from libbicos_tpu_torch import pipeline

from test_portbench_control import (altered, control, half_rows, run,
                                    stale)
from test_portbench_harness import run as rehearse

ROOT = Path(__file__).resolve().parents[2]
CELL = "full16.device"
# The limits every cell of the benchmark holds to (workloads/*.json).
LIMITS = {"pixel_mismatch_pct": 0.3, "corr_gap": 1e-3}
FULL16 = {
    "name": "full16",
    "source": "https://github.com/nexus1203/libBICOS bench/cuda.cu:297-323"
              ",397-401 (bench_integration/16/0: n=16, FULL, nxcorr 0.9, "
              "no subpixel step, NoDuplicates) at bench/cuda.cu:44",
    "reference": "bicos",
    "n": 16,
    "height": 2200,
    "width": 3300,
    "dtype": "uint8",
    "mode": "FULL",
    "nxcorr_threshold": 0.9,
    "min_variance": None,
    "subpixel_step": None,
    "precision": "SINGLE",
    "variant": {"kind": "NoDuplicates"},
    "disparity_range": None,
    "corrmap": True,
    "reduced": [],
}


@pytest.fixture
def root(tmp_path, monkeypatch):
    """A checkout root whose ``BENCHMARK.json`` names ``full16.device``
    alone, reporting every metric of the real one."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "portbench/configs").mkdir(parents=True)
    (tmp_path / "portbench/configs/full16.json").write_text(
        json.dumps(FULL16))
    bench["configs"] = [{"name": "full16", "source": FULL16["source"],
                         "file": "portbench/configs/full16.json",
                         "reduced": [], "why": "FULL n=16, int16"}]
    bench["workloads"] = [{"name": CELL, "config": "full16",
                           "traffic": "device", "chips": 1,
                           "why": "FULL n=16, int16"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec.Benchmark, "limits",
                        staticmethod(lambda cell: dict(LIMITS)))
    return tmp_path


@pytest.mark.parametrize("trace", [False, True])
def test_full_cell_rehearsal(root, trace):
    line, err = rehearse(CELL, trace, shape=(16, 8, 96), root=root)
    assert line["correct"] is True, err
    assert line["failed"] == 0
    want = {m["name"] for m in spec.Benchmark(root).metrics(
        "per_layer" if trace else "end_to_end", CELL)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert line["metrics"]["pair_ms"]["value"] > 0


def test_full_sound_run_is_correct_and_int16(root, monkeypatch):
    real = pipeline.match
    dtypes = set()

    def match(*a, **kw):
        disp, corr = real(*a, **kw)
        dtypes.add(disp.dtype)
        return disp, corr
    monkeypatch.setattr(pipeline, "match", match)
    line = run(CELL, root=root)
    assert line["correct"] is True and line["failed"] == 0
    assert dtypes == {torch.int16}
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


def test_full_control_is_not_correct(root, monkeypatch):
    monkeypatch.setattr(pipeline, "match", control(CELL, root))
    line = run(CELL, root=root)
    assert line["correct"] is False and line["failed"] == 0
    assert [k for k, c in line["checks"].items()
            if c["value"] > c["limit"]]


@pytest.mark.parametrize("fault", [altered, stale, half_rows])
def test_full_fault_is_not_correct(root, fault, monkeypatch):
    monkeypatch.setattr(pipeline, "match", fault(pipeline.match))
    line = run(CELL, root=root)
    # Planted, not raised: every call returned an answer.
    assert line["correct"] is False and line["failed"] == 0


def test_full_raising_call_is_counted_and_not_correct(root, monkeypatch):
    real = pipeline.match
    calls = []

    def match(*a, **kw):
        calls.append(1)
        if len(calls) == 3:  # the window's first, after a warm call a pair
            raise RuntimeError("planted")
        return real(*a, **kw)
    monkeypatch.setattr(pipeline, "match", match)
    line = run(CELL, root=root)
    assert line["failed"] == 1 and line["correct"] is False
