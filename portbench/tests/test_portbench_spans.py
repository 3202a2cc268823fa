"""The readers of the program's spans, ``dispatch_idle_pct`` and
``match_host_ms`` (``portbench/spans.py``), on synthetic traces with
``bicos.*`` spans, and on a CPU rehearsal of a cell."""

import io
import json
import time
from pathlib import Path

import pytest

from portbench import harness, spans, spec
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
READERS = ("dispatch_idle_pct", "match_host_ms")


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _host(name, ts, dur):
    return _event(name, "user_annotation", ts, dur)


def _kernel(ts, dur):
    return _event("void row_minima_kernel<4, true>(...)", "kernel", ts, dur)


def _pairs(extra=()):
    """Two pairs in a 100 us window. Each: ``portbench.call`` holds an
    outer ``bicos.match`` of 8 us (``match_batched``) and a nested one,
    with the stages inside; the card runs a transform for 0.5 us and the
    scan from 3 us into the match on, past its end. So 2.5 us of each
    match has the card idle."""
    ev = [_host("portbench.trace_window", 1000, 100)]
    for b in (1000, 1050):
        ev += [_host("portbench.call", b, 10),
               _host("bicos.match", b + 1, 8),
               _host("bicos.match", b + 1.5, 7),
               _host("bicos.prepare", b + 1.5, 0.5),
               _host("bicos.transform", b + 2, 0.5),
               _host("bicos.scan", b + 3, 1),
               _host("bicos.agree", b + 5, 3.5),
               _event("void transform_kernel<unsigned char>(...)", "kernel",
                      b + 2.5, 0.5),
               _kernel(b + 4, 36)]
    return Trace(ev + list(extra))


def _readings(trace, traced=(0, 1)):
    return harness.Readings(trace=trace, traced=list(traced))


def _read(name, r):
    return spec.load_module("metrics", name).read(r)


def test_readers_on_two_pairs():
    tr = _pairs()
    r = _readings(tr)
    assert _read("dispatch_idle_pct", r) == pytest.approx(5.0)
    assert _read("match_host_ms", r) == pytest.approx(0.008)
    device_idle = _read("device_idle_pct", r)
    assert device_idle == pytest.approx(100 - 2 * 36.5)
    assert _read("dispatch_idle_pct", r) <= device_idle
    # The breakdown names the program's stages where a gap falls in one.
    labels = {g[0] for g in tr.idle_gaps()}
    assert {"bicos.match", "bicos.scan"} <= labels


def test_nested_match_counted_once():
    tr = _pairs()
    assert spans.outermost(tr) == [(1001, 1009), (1051, 1059)]
    # The same start: the longer span holds the shorter.
    same = Trace([_host("portbench.trace_window", 0, 10),
                  _host("bicos.match", 1, 2), _host("bicos.match", 1, 5),
                  _host("bicos.match", 2, 1)])
    assert spans.outermost(same) == [(1, 6)]


def test_window_clipping():
    # A match that began before the stretch and one that runs past it:
    # the card is idle in both, from 1000 to 1000.5 and from 1095 to 1100.
    tr = _pairs([_host("bicos.match", 985, 15.5),
                 _host("bicos.match", 1095, 15)])
    r = _readings(tr)
    assert _read("dispatch_idle_pct", r) == pytest.approx(5.0 + 0.5 + 5)
    # Only spans that start inside count, up to the stretch's end.
    assert _read("match_host_ms", r) == pytest.approx((8 + 8 + 5) / 2e3)


@pytest.mark.parametrize("name", READERS)
def test_none_without_spans_or_trace(name):
    assert _read(name, _readings(None)) is None
    no_spans = Trace([_host("portbench.trace_window", 1000, 100),
                      _host("portbench.call", 1000, 10), _kernel(1004, 36)])
    assert _read(name, _readings(no_spans)) is None
    outside = Trace([_host("portbench.trace_window", 1000, 100),
                     _host("bicos.match", 900, 50), _kernel(1004, 36)])
    assert _read(name, _readings(outside)) is None


def test_dispatch_idle_needs_a_device():
    # A CPU trace has the program's spans but no device intervals.
    cpu = Trace([_host("portbench.trace_window", 1000, 100),
                 _host("bicos.match", 1001, 8)])
    assert _read("dispatch_idle_pct", _readings(cpu)) is None
    assert _read("match_host_ms", _readings(cpu, [0])) == pytest.approx(
        0.008)


def test_interval_helpers():
    assert spans.clip([(0, 5), (8, 12), (20, 30)], 3, 10) == [(3, 5),
                                                              (8, 10)]
    assert spans.union([(4, 6), (0, 2), (1, 3), (6, 7)]) == [(0, 3), (4, 7)]
    assert spans.overlap([(0, 3), (4, 7)], [(2, 5), (6, 10)]) == 3
    assert spans.overlap([], [(0, 1)]) == 0


def test_rehearsal_reads_the_programs_spans():
    """A traced CPU rehearsal: the program's spans are in the trace, so
    ``match_host_ms`` is read; the CPU has no device intervals, so
    ``dispatch_idle_pct`` is not."""
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())[
        "workloads"][0]["name"]
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(ROOT, cell, 2000000011, 1.0, True,
                          t_start=time.perf_counter(), device="cpu",
                          backend="torch", shape=(33, 8, 96), out=out,
                          err=err)
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["match_host_ms"]["value"] > 0
    assert "dispatch_idle_pct" not in line["metrics"]
