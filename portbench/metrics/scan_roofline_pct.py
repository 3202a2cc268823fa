"""``scan_roofline_pct``: the scan's least time over its device time per
pair, in %. The scan kernels are ``hamming.cu``'s ``row_minima_kernel``
(NoDuplicates) and ``consistency.cu``'s ``consistency_kernel`` (the fused
forward and reverse scan); the least time is one popcount per (left pixel,
right column, word), each once for both directions of a Consistency scan,
with both descriptor arrays read once and the minima written once
(``roofline.scan_bound``)."""

from portbench import roofline

KERNELS = r"\brow_minima_kernel\b|\bconsistency_kernel\b"


def read(r):
    ms = r.kernel_ms_per_pair(KERNELS)
    if not ms:
        return None
    n, h, w = r.shape
    cons = r.cfg["variant"]["kind"] == "Consistency"
    drange = r.cfg.get("disparity_range")
    least = roofline.scan_bound(h, w, r.nw, drange, 16 if cons else 8)[0]
    return 100 * least / ms
