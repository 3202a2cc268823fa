"""Reduction of a ``torch.profiler`` trace to device time, idle time and
the breakdown.

The profiler's Chrome trace holds the device's kernels, copies and memsets
(``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``) and the host's
annotations (``user_annotation``: the harness's ``record_function`` spans)
on one clock, in microseconds. The traced stretch is the harness's
``portbench.trace_window`` span; every reading is clipped to it.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "portbench.trace_window"


class Trace:
    """Device intervals and host spans of one traced stretch."""

    def __init__(self, events: list):
        spans = [e for e in events if e.get("ph") == "X"]
        win = [e for e in spans if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW_SPAN]
        if not win:
            raise ValueError(f"the trace holds no {WINDOW_SPAN} span")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.device = []  # (start, end, name), clipped to the window
        for e in spans:
            if e.get("cat") not in DEVICE_CATS:
                continue
            a = max(self.t0, float(e["ts"]))
            b = min(self.t1, float(e["ts"]) + float(e.get("dur", 0)))
            if b > a:
                self.device.append((a, b, e["name"]))
        self.device.sort()
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
             e["name"]) for e in spans
            if e.get("cat") == "user_annotation"
            and e.get("name") != WINDOW_SPAN)

    @classmethod
    def from_file(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device's intervals, as sorted ``(start,
        end)``."""
        merged = []
        for a, b, _ in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_s(self, pattern: str) -> float:
        """Seconds of the kernels whose name matches ``pattern`` (a regular
        expression searched in the demangled name)."""
        rx = re.compile(pattern)
        return sum(b - a for a, b, name in self.device
                   if rx.search(name)) * 1e-6

    def top_ops(self, k: int = 10) -> list:
        """``[[name, seconds], ...]``: the device operations that took most
        time, summed by name."""
        total = defaultdict(float)
        for a, b, name in self.device:
            total[name] += (b - a) * 1e-6
        return [[n, s] for n, s in
                sorted(total.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """``[[label, seconds], ...]``: the longest stretches with nothing
        on the device, each labelled by the innermost host span that holds
        its middle (``host`` where none does)."""
        edges = [self.t0]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.t1)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = (a + b) / 2
            inner = [s for s in self.host if s[0] <= mid <= s[1]]
            label = (min(inner, key=lambda s: s[1] - s[0])[2] if inner
                     else "host")
            out.append([label, (b - a) * 1e-6])
        return out
