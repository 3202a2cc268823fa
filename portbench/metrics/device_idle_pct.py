"""``device_idle_pct``: the share of the traced stretch in which the card
ran no kernel, copy or memset, in %, in the cells on device-resident
stacks."""


def read(r):
    if r.trace is None or not r.trace.device:
        return None
    return 100 * (1 - r.trace.busy_s / r.trace.window_s)
