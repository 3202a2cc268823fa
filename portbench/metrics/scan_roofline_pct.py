"""``scan_roofline_pct``: the scan's least time over its device time per
pair, in %. The scan kernels are ``hamming.cu``'s ``row_minima_kernel``
(NoDuplicates) and ``consistency.cu``'s ``consistency_kernel`` (the fused
forward and reverse scan); the least time is the largest of the (left
pixel, right column) pairs times the descriptor's bits at the rate of
every unit that forms exact bit products, one 16-bit min a pair and
direction, and both descriptor arrays read once and the minima written
once (``roofline.scan_bound``)."""

from portbench import roofline

KERNELS = r"\brow_minima_kernel\b|\bconsistency_kernel\b"


def read(r):
    ms = r.kernel_ms_per_pair(KERNELS)
    if not ms:
        return None
    n, h, w = r.shape
    cons = r.cfg["variant"]["kind"] == "Consistency"
    drange = r.cfg.get("disparity_range")
    least = roofline.scan_bound(h, w, r.bits, drange, cons)[0]
    return 100 * least / ms
