"""``match_host_ms``: the host's ms inside the program's ``match`` per
traced pair: the outermost ``bicos.match`` spans that start in the traced
stretch, clipped to it, summed, over the traced pairs. It is the time a
caller is held inside ``match``: the enqueue of the pair's work plus any
wait on the card. None without a traced pair or without the program's
spans in the stretch."""

from portbench import spans


def read(r):
    tr = r.trace
    if tr is None or not r.traced:
        return None
    held = [(a, min(b, tr.t1)) for a, b in spans.outermost(tr)
            if tr.t0 <= a < tr.t1]
    if not held:
        return None
    return sum(b - a for a, b in held) * 1e-3 / len(r.traced)
