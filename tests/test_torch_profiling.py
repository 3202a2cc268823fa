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


# The program's spans (``profiling.span``): the tree a ``match`` call leaves
# in a trace, as (depth, name) in order of start.
_SEARCH = [(1, "bicos.prepare"), (1, "bicos.transform"),
           (1, "bicos.transform"), (1, "bicos.scan"),
           (1, "bicos.search_finish")]
_CFGS = {
    "nodupes": tb.Config(nxcorr_threshold=0.5, subpixel_step=0.25),
    "consistency": tb.Config(nxcorr_threshold=0.5, subpixel_step=0.25,
                             variant=tb.Consistency(1, True)),
    "consistency integer": tb.Config(nxcorr_threshold=0.5,
                                     variant=tb.Consistency(2, False)),
    "no threshold": tb.Config(nxcorr_threshold=None),
    # ``portbench/configs/full16.json``'s settings, at n=16.
    "full16": tb.Config(nxcorr_threshold=0.9, subpixel_step=None,
                        min_variance=None, mode=tb.TransformMode.FULL),
}
_SHOTS = {"full16": 16}  # 9 shots for the others


def _span_tree(logdir):
    """``[(depth, name), ...]`` of the ``bicos.*`` spans of the one Chrome
    trace in ``logdir``, in order of start; depth counts the enclosing
    ``bicos.*`` spans on the same thread."""
    files = list(logdir.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = sorted(
        ((float(e["ts"]), -float(e["dur"]), e["tid"], e["name"])
         for e in events if e.get("ph") == "X"
         and e.get("cat") == "user_annotation"
         and str(e.get("name")).startswith("bicos.")))
    open_ends, tree = {}, []
    for ts, neg_dur, tid, name in spans:
        stack = open_ends.setdefault(tid, [])
        while stack and stack[-1] <= ts:
            stack.pop()
        tree.append((len(stack), name))
        stack.append(ts - neg_dur)
    return tree


@pytest.mark.parametrize("debug", [False, True])
@pytest.mark.parametrize("kind", sorted(_CFGS))
def test_match_spans_nest_in_order(tmp_path, monkeypatch, kind, debug):
    monkeypatch.setenv("BICOS_DEBUG", "1" if debug else "0")
    cfg = _CFGS[kind]
    s0, s1, _ = synthetic_stack_pair(_SHOTS.get(kind, 9), 6, 40, seed=2)
    with tp.trace(tmp_path):
        tb.match(s0, s1, cfg, device="cpu")
    want = [(0, "bicos.match")] + _SEARCH
    if cfg.nxcorr_threshold is not None:
        want.append((1, "bicos.agree"))
        if cfg.subpixel_step is None:
            want.append((2, "bicos.agree_finish"))
    if debug:
        want.append((1, "bicos.debug"))
    assert _span_tree(tmp_path) == want


@pytest.mark.parametrize("folded", [False, True])
def test_match_batched_has_one_outermost_match_span(tmp_path, folded):
    s0, s1, _ = synthetic_stack_pair(9, 6, 40, seed=4)
    b0 = torch.from_numpy(np.stack([s0, s0[:, ::-1].copy()]))
    b1 = torch.from_numpy(np.stack([s1, s1[:, ::-1].copy()]))
    cfg = _CFGS["nodupes"]
    with tp.trace(tmp_path):
        if folded:
            flat0, flat1, (b, _, _) = tb.pipeline._fold_batch(b0, b1)
            tb.pipeline.match_batched_folded(flat0, flat1, b, cfg,
                                             device="cpu")
        else:
            tb.match_batched(b0, b1, cfg, device="cpu")
    tree = _span_tree(tmp_path)
    assert [t for t in tree if t[0] == 0] == [(0, "bicos.match")]
    inner = 2 if folded else 3  # each batched surface nests one more
    assert tree[:inner] == [(d, "bicos.match") for d in range(inner)]
    assert [(d - inner + 1, n) for d, n in tree[inner:]] == _SEARCH + [
        (1, "bicos.agree")]


@pytest.mark.parametrize("variant", ["nodupes", "consistency"])
def test_kernel_wrappers_span_on_the_cpu(tmp_path, variant):
    """The stage dispatch (``search.transform_words``, ``search._scan``)
    owns the spans, which both backends share: ``search_stack`` on the
    plain versions gives two transforms, the scan and its finish."""
    s0, s1, _ = synthetic_stack_pair(9, 6, 40, seed=5)
    s0, s1 = torch.from_numpy(s0), torch.from_numpy(s1)
    variants = {"nodupes": tb.NoDuplicates(),
                "consistency": tb.Consistency(1, True)}
    with tp.trace(tmp_path):
        tb.search.search_stack(s0, s1, tb.TransformMode.LIMITED,
                               variants[variant], backend="torch")
    assert _span_tree(tmp_path) == [(0, "bicos.transform"),
                                    (0, "bicos.transform"),
                                    (0, "bicos.scan"),
                                    (0, "bicos.search_finish")]


def test_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler recording a span is one check: ``match`` builds no
    ``record_function`` nor enters the profiler's ``RecordFunction``, and
    ``span`` hands out one shared object."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(tp, "_RecordSpan", refuse)
    monkeypatch.setattr(torch._C._autograd,
                        "_record_function_with_args_enter", refuse)
    monkeypatch.setenv("BICOS_DEBUG", "1")
    s0, s1, _ = synthetic_stack_pair(9, 6, 40, seed=6)
    for cfg in _CFGS.values():
        tb.match(s0, s1, cfg, device="cpu")
    tb.match_batched(s0[None], s1[None], _CFGS["nodupes"], device="cpu")
    assert tp.span("bicos.match") is tp.span("bicos.scan")


def test_span_records_while_a_profiler_runs(tmp_path):
    """A span is a user annotation in the trace, as ``record_function``'s
    are, with the spans it encloses inside it; none outlives the
    profiler."""
    with tp.trace(tmp_path):
        with tp.span("bicos.test"):
            with tp.span("bicos.inner"):
                torch.ones(3).add_(1)
        with torch.profiler.record_function("bicos.record_function"):
            pass
    assert _span_tree(tmp_path) == [(0, "bicos.test"), (1, "bicos.inner"),
                                    (0, "bicos.record_function")]
    assert tp.span("bicos.after") is tp.span("bicos.test")


@pytest.mark.parametrize("kind", sorted(_CFGS))
def test_profiler_leaves_results_bit_identical(tmp_path, kind):
    cfg = _CFGS[kind]
    s0, s1, _ = synthetic_stack_pair(9, 6, 40, seed=8)
    corrmap = cfg.nxcorr_threshold is not None
    plain = tb.match(s0, s1, cfg, corrmap=corrmap, device="cpu")
    with tp.trace(tmp_path):
        traced = tb.match(s0, s1, cfg, corrmap=corrmap, device="cpu")
    if not corrmap:
        plain, traced = (plain,), (traced,)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
