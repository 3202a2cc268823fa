"""One run of one cell: set-up, the measured window, the check, the line.

:func:`run_cell` loads the cell's files by name (see :mod:`portbench.spec`),
makes the pool of input pairs from the seed, builds the entry and warms it
on every pair of the pool (set-up), then drives the entry in a closed loop,
one pair in flight, for ``seconds``. Set-up ends when the window opens.

* Every pair's time is kept: on the card from a CUDA event pair around
  the call (the device's clock), on the CPU by the host clock until the
  entry's synchronize returns. The window is timed by the host clock.
* One answer of each pool pair is kept, drawn from the seed (a reservoir
  of one over the calls of that pair), and compared with the plain
  reference after the window has closed, the peak memory has been read and
  the program's state is freed (:mod:`portbench.judge`).
* With ``trace`` a stretch of the window (``trace_skip`` pairs in, then
  ``trace_pairs`` pairs) is traced by ``torch.profiler``, started a pair
  earlier, and the window lasts until that stretch is whole; the
  per-layer metrics read it (:mod:`portbench.trace`).

The harness's own ``record_function`` spans, ``portbench.call`` (the
entry's call), ``portbench.sync`` (its synchronize) and ``portbench.next``
(the harness's bookkeeping before the next pair), label the device's idle
gaps in the breakdown.
"""

from __future__ import annotations

import gc
import json
import os
import random
import sys
import tempfile
import time
import traceback

import torch

from . import judge, roofline, spec, traffic
from .trace import WINDOW_SPAN, Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "libbicos_tpu")
MAX_FAILED = 3  # calls that may raise before the window is cut


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``libbicos_tpu_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Sample:
    """One kept answer per pool pair: a reservoir of one over its calls,
    drawn from the seed."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.seen = {}
        self.kept = {}

    def offer(self, p: int, answer) -> None:
        self.seen[p] = self.seen.get(p, 0) + 1
        if self.rng.randrange(self.seen[p]) == 0:
            self.kept[p] = answer

    def device_bytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for ans in self.kept.values() for x in ans
                   if isinstance(x, torch.Tensor) and x.device.type == "cuda")


class Readings:
    """What the metric readers read: the window, the set-up, the memory,
    the trace, the reference's search output and the entry itself (with
    whatever it recorded; ``t_open`` is the window's opening on
    ``time.perf_counter``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def kernel_ms_per_pair(self, pattern: str):
        """Device ms per traced pair of the kernels matching ``pattern``,
        or None where the trace holds none."""
        if self.trace is None or not self.traced:
            return None
        s = self.trace.kernel_s(pattern)
        return s * 1e3 / len(self.traced) if s else None

    def agree_bound_ms(self):
        """The agree stage's least time, mean over the traced pairs, on the
        kept and swept pixels of the reference's search of each."""
        if not self.traced:
            return None
        n, h, w = self.shape
        ms = [roofline.agree_bound(
            n, h, w, w, self.itemsize, *self.agree_pixels[p], self.nx,
            double=self.cfg["precision"] == "DOUBLE")[0]
            for p in self.traced]
        return sum(ms) / len(ms)


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _read_trace(prof) -> Trace:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return Trace.from_file(path)
    finally:
        os.unlink(path)


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device=None, backend: str = "auto",
             shape=None, out=None, err=None) -> int:
    """Run one cell once and print its result line. Returns the exit code:
    0 with a result (correct or not), 3 without one (JAX was loaded).
    ``device``, ``backend`` and ``shape`` are for CPU rehearsals."""
    out = out or sys.stdout
    err = err or sys.stderr
    bench = spec.Benchmark(root)
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)
    e2e = bench.metrics("end_to_end", workload)
    layers = bench.metrics("per_layer", workload)
    readers = {m["name"]: spec.load_module(
        "metrics" if trace else "end_to_end", m["name"])
        for m in (layers if trace else e2e)}
    reference = spec.load_module("reference", cfg["reference"])
    entry_mod = spec.load_module("entries", mix["entry"])
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    cuda = dev.type == "cuda"
    corrmap = bool(cfg.get("corrmap", True))

    # Set-up: the pool from the seed, the entry, one warm call a pair.
    pool = traffic.make_pool(cfg, mix, seed, dev, shape)
    n, h, w = pool[0][0].shape
    itemsize = pool[0][0].element_size()
    entry = entry_mod.Entry(spec.port_config(cfg), pool, dev, backend,
                            corrmap)
    del pool
    for p in range(int(mix["pool_pairs"])):
        entry.call(p)
        entry.finish()
    if trace:
        with _profiler(dev):  # the profiler's own start-up, out of the window
            entry.call(0)
            entry.finish()
    gc.collect()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)

    # The window.
    sample = Sample(seed)
    npool = int(mix["pool_pairs"])
    skip = int(mix.get("trace_skip", 0))
    ntrace = int(mix.get("trace_pairs", 0))
    pair_ms, traced = [], []
    attempted = failed = 0
    prof = span = None
    prof_on = False
    rf = torch.profiler.record_function
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    t_done = t_open

    def more() -> bool:
        # Every pool pair is called once, and a traced run goes on past
        # ``seconds`` until its stretch is whole.
        if failed >= MAX_FAILED:
            return False
        return (t_done - t_open < seconds or attempted < npool
                or (trace and (attempted <= skip or span is not None)))

    def stop() -> None:
        nonlocal span, prof_on
        if span is not None:
            span.__exit__(None, None, None)
            span = None
        if prof_on:
            prof.__exit__(None, None, None)
            prof_on = False

    while more():
        p = attempted % npool
        # The profiler starts a pair before the stretch: its own start-up
        # leaves a gap on the device that is not the program's.
        if trace and prof is None and attempted >= skip - 1:
            prof = _profiler(dev)
            prof.__enter__()
            prof_on = True
        if trace and attempted == skip:
            span = rf(WINDOW_SPAN)
            span.__enter__()
        attempted += 1
        t0 = time.perf_counter()
        try:
            with rf("portbench.call"):
                if cuda:
                    ev0.record()
                answer = entry.call(p)
                if cuda:
                    ev1.record()
            with rf("portbench.sync"):
                entry.finish()
        except Exception:  # counted against the attempts; the run goes on
            failed += 1
            traceback.print_exc(file=err)
            t_done = time.perf_counter()
            continue
        t_done = time.perf_counter()
        with rf("portbench.next"):
            pair_ms.append(ev0.elapsed_time(ev1) if cuda
                           else (t_done - t0) * 1e3)
            sample.offer(p, answer)
            del answer
            if span is not None:
                traced.append(p)
        if span is not None and len(traced) >= ntrace:
            stop()
    window_s = t_done - t_open
    stop()
    completed = attempted - failed

    # The window's peak (the program's and the harness's pool), not the
    # generator's transient in set-up.
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    held = entry.harness_bytes() + sample.device_bytes()
    trace_data = _read_trace(prof) if prof is not None else None

    # The check, after the program's state is freed.
    entry.close()
    inputs = {p: tuple(torch.as_tensor(s).to(dev) for s in entry.inputs(p))
              for p in range(npool)}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_search, answers = {}, []
    t_ref = time.perf_counter()
    for p in range(npool):
        s0, s1 = inputs[p]
        search, rdisp, rcorr = reference.match(s0, s1, cfg)
        ref_search[p] = search
        if p in sample.kept:
            answers.append(tuple(torch.as_tensor(x).to(dev)
                                 for x in sample.kept[p]) + (rdisp, rcorr))
        del rdisp, rcorr
    numbers = judge.compare(answers)
    t_ref = time.perf_counter() - t_ref
    passed, checks = judge.verdict(numbers, limits)
    correct = passed and failed == 0 and len(answers) == npool

    step = cfg.get("subpixel_step")
    readings = Readings(
        cfg=cfg, shape=(n, h, w), itemsize=itemsize,
        nw=roofline.words_for(n, cfg["mode"]), window_s=window_s,
        pairs=completed, pair_ms=pair_ms, setup_s=setup_s,
        program_peak_bytes=(window_peak - held) if cuda else None,
        entry=entry, t_open=t_open, trace=trace_data, traced=traced,
        nx=len(reference.subpixel_grid(step)) if step else 0,
        agree_pixels={p: roofline.agree_pixels(s, w)
                      for p, s in ref_search.items()})
    metrics = {}
    for m in (layers if trace else e2e):
        v = readers[m["name"]].read(readings) if completed else None
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": (torch.cuda.get_device_name(dev) if cuda
                                  else dev.type),
                         "count": 1,
                         "memory_peak_bytes": window_peak}}
    if trace_data is not None:
        result["device"]["busy_s"] = trace_data.busy_s
        result["device"]["window_s"] = trace_data.window_s
        result["breakdown"] = {"device_ops": trace_data.top_ops(),
                               "idle_gaps": trace_data.idle_gaps()}
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=err)
        return 3
    print(f"portbench: {workload} seed {seed}: {completed} pairs in "
          f"{window_s:.3f} s, {failed} failed, compared "
          f"{len(answers)} answers with the reference in {t_ref:.3f} s",
          file=err)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
