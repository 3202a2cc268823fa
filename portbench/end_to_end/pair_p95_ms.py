"""``pair_p95_ms``: the 95th percentile over every pair completed in the
window of its time on the device's clock, from a CUDA event recorded as
the entry is called to one recorded after its last kernel was queued, in
ms. The device's clock, because a host-clock reading of one 30 ms pair
carries the host's jitter of some tenths of a ms."""

import statistics


def read(r):
    if len(r.pair_ms) < 2:
        return None
    return statistics.quantiles(r.pair_ms, n=100, method="inclusive")[94]
