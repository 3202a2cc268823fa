"""``pair_mfu_pct``: the whole pair's share of the chip's peak, in %: the
least times of its work (two transforms, the scan and the agree stage, by
``roofline``) over the traced stretch's length per traced pair. It bounds
the kernels' rooflines from above: a kernel taken off the path leaves its
own roofline silent, not this."""

from portbench import roofline


def read(r):
    if r.trace is None or not r.traced or not r.trace.device:
        return None
    n, h, w = r.shape
    cons = r.cfg["variant"]["kind"] == "Consistency"
    drange = r.cfg.get("disparity_range")
    least = (2 * roofline.transform_bound(n, h, w, r.itemsize, r.nw)[0]
             + roofline.scan_bound(h, w, r.bits, drange, cons)[0]
             + r.agree_bound_ms())
    return 100 * least / (r.trace.window_s * 1e3 / len(r.traced))
