"""The program's own spans in a trace.

``libbicos_tpu_torch.profiling.span`` puts a ``record_function`` span
around each stage of a ``match`` call while a profiler records
(``bicos.match``, ``bicos.prepare``, ``bicos.transform``, ``bicos.scan``,
``bicos.search_finish``, ``bicos.agree``). They reach
:class:`portbench.trace.Trace` as host spans (``user_annotation``), on the
clock of the device's intervals. A program without them leaves the readers
here nothing to read.

Intervals are ``(start, end)`` in the trace's microseconds.
"""

from __future__ import annotations

MATCH = "bicos.match"


def outermost(trace, name: str = MATCH) -> list:
    """The spans named ``name`` that no other span of that name holds,
    sorted by start: one for each call, however the program's entry points
    nest (``match_batched`` around ``match``)."""
    out, reach = [], float("-inf")
    for a, b in sorted(((a, b) for a, b, n in trace.host if n == name),
                       key=lambda s: (s[0], -s[1])):
        if b <= reach:  # inside an earlier span that ends later
            continue
        out.append((a, b))
        reach = b
    return out


def clip(intervals, t0: float, t1: float) -> list:
    """The parts of ``intervals`` inside ``[t0, t1]``."""
    return [(max(a, t0), min(b, t1)) for a, b in intervals
            if min(b, t1) > max(a, t0)]


def union(intervals) -> list:
    """Sorted, disjoint intervals covering ``intervals``."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def overlap(xs, ys) -> float:
    """Length of the intersection of two sorted, disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total
