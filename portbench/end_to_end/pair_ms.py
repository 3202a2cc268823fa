"""``pair_ms``: the window's seconds over the stack pairs completed in it,
in ms, for an entry on device-resident stacks (host clock; the window
spans many pairs)."""


def read(r):
    return 1e3 * r.window_s / r.pairs
