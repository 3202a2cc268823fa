"""Rehearsals of the harness on the CPU at a tiny shape, through the same
files the command uses: every cell with the plain backend, every entry
kind and every metric reader, the trace reduction, and the command's exit
without a card."""

import io
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import harness, roofline, spec
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SHAPE = (33, 8, 96)  # headline33's stack size, for the tests of one cell
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def cell_shape(cell, root=ROOT):
    """The rehearsal's tiny shape at the cell's own stack size ``n``."""
    bench = spec.Benchmark(root)
    return (bench.config(bench.cell(cell)["config"])["n"], 8, 96)


def run(cell, trace, seed=3000000123, seconds=1.5, shape=None, root=ROOT):
    shape = shape or cell_shape(cell, root)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(root, cell, seed, seconds, trace,
                          t_start=time.perf_counter(), device="cpu",
                          backend="torch", shape=shape, out=out, err=err)
    assert rc == 0, err.getvalue()
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1]), err.getvalue()


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_rehearsal(cell, trace):
    line, err = run(cell, trace)
    assert line["correct"] is True, err
    assert line["failed"] == 0 and line["attempted"] >= 2
    assert list(line)[-1] == "checks"
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)
    want = {m["name"] for m in spec.Benchmark(ROOT).metrics(
        "per_layer" if trace else "end_to_end", cell)}
    # On the CPU the device metrics (memory, kernels, idle) find nothing.
    assert set(line["metrics"]) <= want
    if not trace:
        assert "setup_s" in line["metrics"]
        assert line["metrics"]["pair_ms"]["value"] > 0
    else:
        assert "breakdown" in line and "window_s" in line["device"]


def test_same_seed_same_inputs():
    bench = spec.Benchmark(ROOT)
    cfg = bench.config("headline33")
    mix = bench.traffic("device")
    from portbench import traffic

    a = traffic.make_pool(cfg, mix, 2**31 + 77, "cpu", SHAPE)
    b = traffic.make_pool(cfg, mix, 2**31 + 77, "cpu", SHAPE)
    c = traffic.make_pool(cfg, mix, 2**31 + 78, "cpu", SHAPE)
    assert all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    assert not torch.equal(a[0][0], c[0][0])
    assert not torch.equal(a[0][0], a[1][0])  # two distinct pairs


def test_inputs_follow_the_disparity_field():
    bench = spec.Benchmark(ROOT)
    from portbench import traffic

    mix = bench.traffic("device")
    n, h, w = SHAPE
    (left, right), _ = traffic.make_pool(bench.config("headline33"), mix, 9,
                                         "cpu", SHAPE)
    d = traffic.disparity_field(h, w, mix["inputs"], "cpu")
    assert int(d.min()) >= 1 and int(d.max()) <= w // 16
    noise = mix["inputs"]["noise"]
    assert noise > 0
    gaps = []
    for y in range(h):
        for x in range(w):
            if x - d[y, x] >= 0:
                gaps.append((left[:, y, x].int()
                             - right[:, y, x - d[y, x]].int()).abs().max())
    # Two cameras' noise apart at most, and not all exact.
    assert max(gaps) <= 2 * noise and max(gaps) > 0


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def synthetic_trace():
    """Two pairs in a 100 us window: transform x2, scan, agree each, a
    memcpy, and the harness's spans."""
    ev = [_event("portbench.trace_window", "user_annotation", 1000, 100)]
    for base in (1000, 1050):
        ev += [_event("portbench.call", "user_annotation", base, 5),
               _event("portbench.sync", "user_annotation", base + 5, 40),
               _event("portbench.next", "user_annotation", base + 45, 5),
               _event("void transform_kernel<unsigned char>(...)", "kernel",
                      base + 6, 1),
               _event("void transform_kernel<unsigned char>(...)", "kernel",
                      base + 7, 1),
               _event("void row_minima_kernel<4, true>(...)", "kernel",
                      base + 8, 30),
               _event("void agree_kernel<unsigned char, float>(...)",
                      "kernel", base + 38, 6),
               _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy",
                      base + 44, 1)]
    ev.append(_event("void band_consistency_kernel<4>(...)", "kernel",
                     900, 50))  # outside the window
    return Trace(ev)


def test_trace_reduction():
    tr = synthetic_trace()
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(2 * 39e-6)
    assert tr.kernel_s(r"\brow_minima_kernel\b") == pytest.approx(60e-6)
    assert tr.kernel_s(r"\bconsistency_kernel\b") == 0
    assert tr.top_ops()[0] == ["void row_minima_kernel<4, true>(...)",
                               pytest.approx(60e-6)]
    gaps = tr.idle_gaps()
    assert gaps[0][1] == pytest.approx(11e-6)
    assert {g[0] for g in gaps} <= {"portbench.call", "portbench.next",
                                    "portbench.sync"}


def _readings(trace, cons=False):
    n, h, w = SHAPE
    cfg = {"variant": {"kind": "Consistency" if cons else "NoDuplicates"},
           "precision": "SINGLE", "disparity_range": None}
    return harness.Readings(
        cfg=cfg, shape=SHAPE, itemsize=1, nw=4, bits=126, window_s=2.0,
        pairs=10, pair_ms=[float(i) for i in range(1, 21)], setup_s=9.5,
        program_peak_bytes=3 * 2**29, entry=None, t_open=0.0,
        trace=trace, traced=[0, 1] if trace else [], nx=20,
        agree_pixels={0: (600, 20), 1: (500, 10)})


def test_metric_readers():
    n, h, w = SHAPE
    r = _readings(synthetic_trace())
    read = {m["name"]: spec.load_module("metrics", m["name"]).read(r)
            for m in BENCH["per_layer"]}
    scan = roofline.scan_bound(h, w, roofline.bits_for(n, "LIMITED"),
                               None)[0]
    assert read["scan_roofline_pct"] == pytest.approx(100 * scan / 0.030)
    agree = sum(roofline.agree_bound(n, h, w, w, 1, *px, 20)[0]
                for px in ((600, 20), (500, 10))) / 2
    assert read["agree_roofline_pct"] == pytest.approx(100 * agree / 0.006)
    tf = 2 * roofline.transform_bound(n, h, w, 1, 4)[0]
    assert read["transform_roofline_pct"] == pytest.approx(100 * tf / 0.002)
    assert read["pair_mfu_pct"] == pytest.approx(
        100 * (scan + agree + tf) / 0.050)
    assert read["device_idle_pct"] == pytest.approx(22.0)
    e2e = {m["name"]: spec.load_module("end_to_end", m["name"]).read(r)
           for m in BENCH["end_to_end"]}
    assert e2e["pair_ms"] == 200.0
    assert e2e["pair_p95_ms"] == pytest.approx(19.05)
    assert e2e["peak_mem_gib"] == 1.5 and e2e["setup_s"] == 9.5


def test_readers_find_nothing_without_a_trace():
    r = _readings(None)
    for m in BENCH["per_layer"]:
        if m["source"] == "device_trace":
            assert spec.load_module("metrics", m["name"]).read(r) is None


def test_command_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_benchmark_json_is_well_formed():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        spec.load_module("reference", cfg["reference"])
    cells = {}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        cells[w["name"]] = w
        spec.Benchmark.traffic(w["traffic"])
        assert set(spec.Benchmark.limits(w["name"])) == {
            "pixel_mismatch_pct", "corr_gap"}
    e2e = {}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = set(m.get("workloads", cells))
        assert (ROOT / "portbench/end_to_end" / f"{m['name']}.py").is_file()
    assert e2e["setup_s"] == set(cells)
    for cell in cells:
        assert len([k for k, v in e2e.items() if cell in v]) >= 2
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m["workloads"]) <= e2e[m["moves"]]
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
