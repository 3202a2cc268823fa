"""``dispatch_idle_pct``: the share of the traced stretch, in %, in which
the card ran nothing while the host was inside an outermost ``bicos.match``
span, the program's ``match`` call. It is the part of ``device_idle_pct``
that a change of the program can remove; the rest falls between calls, in
the harness. None without a device in the trace or without the program's
spans in the stretch."""

from portbench import spans


def read(r):
    tr = r.trace
    if tr is None or not tr.device:
        return None
    inside = spans.union(spans.clip(spans.outermost(tr), tr.t0, tr.t1))
    if not inside:
        return None
    idle = (sum(b - a for a, b in inside)
            - spans.overlap(inside, tr.busy_intervals()))
    return 100 * idle * 1e-6 / tr.window_s
