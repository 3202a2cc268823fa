"""Tracing, stage timings and metrics.

The counterpart of ``libbicos_tpu.profiling``:

* :func:`trace`: ``torch.profiler`` over the enclosed block (CPU and, on a
  card, CUDA activities), written as a Chrome trace into a directory;
* :func:`span`: a named stage of the program in the profiler's trace,
  which costs one check while no profiler records;
* :func:`stage_timings`: the time of each stage of the pipeline
  (transform, search, agree) and of the whole call, each after a warm
  run: CUDA events on the card, ``perf_counter`` on the CPU;
* :func:`metrics`: JSON-able throughput and quality figures of a result;
* :func:`device_memory`: the CUDA allocator's figures of a card, ``{}`` on
  the CPU;
* :func:`emit`: one JSON line.

The spans of a ``match`` call, as a trace (``--profile``) shows them on the
host's timeline, each inside the one above it:

* ``bicos.match``: :func:`pipeline.match`, the whole call (and
  ``match_batched`` / ``match_batched_folded`` around it);
* ``bicos.prepare``: the checks, the move to the run's device, the
  backend;
* ``bicos.transform``: one descriptor transform (two a call);
* ``bicos.scan``: the scan (kernel launch or plain version);
* ``bicos.search_finish``: the int16 disparity from the scan's minima;
* ``bicos.agree``: the agree stage, with a threshold;
* ``bicos.agree_finish``: inside ``bicos.agree``, the int16 disparity
  from the agree's answer, with a threshold and no subpixel step;
* ``bicos.debug``: the ``BICOS_DEBUG`` checks, when the variable is set.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed block with ``torch.profiler`` (CPU activities,
    and CUDA ones where a card is present) and write a Chrome trace,
    ``trace_<pid>.json``, into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}.json"))


class _NoSpan:
    """What :func:`span` returns while no profiler records: a context that
    does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_NO_SPAN = _NoSpan()


class _RecordSpan:
    """What :func:`span` returns while a profiler records: the C++
    ``RecordFunction`` (user scope) that ``torch.profiler.record_function``
    wraps, entered without the wrapper's operator calls, which cost about
    three times as much a span."""

    __slots__ = ("name", "handle")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.handle = torch._C._autograd._record_function_with_args_enter(
            self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        torch._C._autograd._record_function_with_args_exit(self.handle)
        return None


def span(name: str):
    """``with span("bicos.scan"): ...`` marks a stage of the program.

    While a profiler records, the span lands in the profiler's trace as a
    user annotation, as one of ``torch.profiler.record_function`` does: on
    the clock of the device's kernels and copies, inside the span that
    encloses it on the same thread. Otherwise it is one shared context
    that does nothing: the call costs one check and records nothing. The
    profiler holds the spans; :func:`trace` writes them out.

    The check reads the flag that ``torch.profiler.profile`` (and
    ``emit_nvtx`` / ``emit_itt``) set while they record, the one
    TorchDynamo reads: a Python attribute, cheaper than asking the C++
    profiler's state."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordSpan(name)
    return _NO_SPAN


def _timed_ms(fn: Callable, device: torch.device) -> float:
    """Milliseconds of one run of ``fn()`` after a warm one: CUDA events on
    a card, ``perf_counter`` on the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def stage_timings(stack0, stack1, cfg=None, *, backend: str = "auto",
                  device=None) -> Dict:
    """Time each stage of the pipeline separately, on ``device`` (None: the
    card, as :func:`pipeline.match`), each after a warm run.

    Returns ``{"transform_ms", "search_ms", "agree_ms", "total_ms"}``: the
    transform of both stacks, the scan on their words, the agree stage on
    the search disparity (0 without a threshold) and the whole ``match``.
    """
    from . import pipeline as _pipeline
    from . import search as _search
    from .config import Config, validate_stack

    cfg = cfg or Config()
    s0, s1, backend = _pipeline._prepare(stack0, stack1, cfg, False, backend,
                                         device)
    dev = s0.device
    words = [None, None]

    def run_transform():
        words[0] = _search.transform_words(s0, cfg.mode, backend)
        words[1] = _search.transform_words(s1, cfg.mode, backend)

    t_transform = _timed_ms(run_transform, dev)
    nbits = validate_stack(s0.shape[0], cfg.mode)
    disp = [None]

    def run_search():
        disp[0] = _search.search_words(words[0], words[1], nbits,
                                       cfg.variant, backend,
                                       drange=cfg.disparity_range)

    t_search = _timed_ms(run_search, dev)
    t_agree = 0.0
    if cfg.nxcorr_threshold is not None:
        window = _pipeline._agree_window_params(s0, cfg)
        t_agree = _timed_ms(lambda: _pipeline.agree_stage(
            disp[0], s0, s1, cfg, backend, window=window), dev)
    t_total = _timed_ms(lambda: _pipeline.match(s0, s1, cfg, backend=backend,
                                                device=dev), dev)
    return {
        "transform_ms": round(t_transform, 3),
        "search_ms": round(t_search, 3),
        "agree_ms": round(t_agree, 3),
        "total_ms": round(t_total, 3),
    }


def metrics(disparity, elapsed_ms: Optional[float] = None) -> Dict:
    """Quality and throughput figures of a disparity (tensor or array)."""
    if isinstance(disparity, torch.Tensor):
        disparity = disparity.detach().cpu().numpy()
    disp = np.asarray(disparity)
    h, w = disp.shape[-2:]
    if np.issubdtype(disp.dtype, np.floating):
        valid = np.isfinite(disp)
    else:
        valid = disp != np.int16(-32768)
    out = {
        "height": int(h),
        "width": int(w),
        "megapixels": round(h * w / 1e6, 3),
        "valid_fraction": round(float(valid.mean()), 4),
    }
    if elapsed_ms is not None:
        out["latency_ms"] = round(elapsed_ms, 3)
        out["mp_per_s"] = round(h * w / 1e6 / (elapsed_ms / 1e3), 2)
    return out


def device_memory(device=None) -> Dict:
    """The CUDA allocator's figures of ``device`` (None: the current card),
    in bytes: ``bytes_in_use``, ``peak_bytes_in_use`` (since the last
    ``torch.cuda.reset_peak_memory_stats``) and ``bytes_limit`` (the
    card's total memory). ``{}`` for the CPU or without a card."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
    }


def emit(d: Dict) -> str:
    """One-line JSON for log scraping."""
    s = json.dumps(d)
    print(s)
    return s
