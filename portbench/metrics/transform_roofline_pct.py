"""``transform_roofline_pct``: the two descriptor transforms' least time
over the device time per pair of ``transform.cu``'s ``transform_kernel``,
in %. Each transform reads its stack once and writes its words once
(``roofline.transform_bound``)."""

from portbench import roofline

KERNELS = r"\btransform_kernel\b"


def read(r):
    ms = r.kernel_ms_per_pair(KERNELS)
    if not ms:
        return None
    n, h, w = r.shape
    least = 2 * roofline.transform_bound(n, h, w, r.itemsize, r.nw)[0]
    return 100 * least / ms
