"""The DOUBLE cell, ``double33.device`` (upstream's headline with
``--double``): its reference, ``reference/bicos_f64.py``, is the plain
reference with the compute type float64 and refuses a SINGLE
configuration; the command's run, on the CPU at a tiny shape, is correct
with the plain port and not correct with a SINGLE program in its place."""

import dataclasses

import pytest
import torch

from portbench import spec, traffic
from portbench.reference import bicos, bicos_f64

from libbicos_tpu_torch import pipeline
from libbicos_tpu_torch.config import Precision

from test_portbench_control import ROOT, cell_config, run

CELL = "double33.device"


@pytest.fixture(scope="module")
def pair():
    cfg = cell_config(CELL)
    bench = spec.Benchmark(ROOT)
    mix = bench.traffic(bench.cell(CELL)["traffic"])
    (s0, s1), = traffic.make_pool(cfg, {**mix, "pool_pairs": 1},
                                  2147483651, torch.device("cpu"),
                                  (cfg["n"], 16, 96))
    return cfg, s0, s1


def test_f64_reference_is_the_plain_reference_in_float64(pair):
    cfg, s0, s1 = pair
    got = bicos_f64.match(s0, s1, cfg)
    want = bicos.match(s0, s1, cfg, dtype=torch.float64)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(torch.nan_to_num(a, nan=-7.0),
                           torch.nan_to_num(b, nan=-7.0))
    # The control's lower compute type still passes through.
    _, disp, corr = bicos_f64.match(s0, s1, cfg, dtype=torch.bfloat16)
    assert corr.dtype == torch.float32
    assert not torch.equal(torch.nan_to_num(corr), torch.nan_to_num(got[2]))


def test_f64_reference_refuses_a_single_configuration(pair):
    cfg, s0, s1 = pair
    with pytest.raises(ValueError, match="DOUBLE"):
        bicos_f64.match(s0, s1, {**cfg, "precision": "SINGLE"})


def test_double_cell_is_correct_with_the_plain_port(monkeypatch):
    real = pipeline.match
    precisions = set()

    def match(s0, s1, cfg, **kw):
        precisions.add(cfg.precision)
        return real(s0, s1, cfg, **kw)
    monkeypatch.setattr(pipeline, "match", match)
    line = run(CELL)
    assert line["correct"] is True and line["failed"] == 0
    assert precisions == {Precision.DOUBLE}
    # The plain DOUBLE agree rounds each float64 NXCORR as the reference
    # does.
    assert line["checks"]["corr_gap"]["value"] == 0.0


def test_double_cell_is_not_correct_with_a_single_program(monkeypatch):
    real = pipeline.match

    def match(s0, s1, cfg, **kw):
        return real(s0, s1, dataclasses.replace(
            cfg, precision=Precision.SINGLE), **kw)
    monkeypatch.setattr(pipeline, "match", match)
    line = run(CELL)
    assert line["correct"] is False and line["failed"] == 0
    gap = line["checks"]["corr_gap"]
    assert gap["value"] > gap["limit"]
