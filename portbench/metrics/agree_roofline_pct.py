"""``agree_roofline_pct``: the agree stage's least time over the device
time per pair of ``agree.cu``'s kernels, in %. The least time counts the
kept and swept pixels of the reference's own search of each traced pair
(``roofline.agree_bound``)."""

KERNELS = r"\bagree(_window)?_kernel\b"


def read(r):
    ms = r.kernel_ms_per_pair(KERNELS)
    least = r.agree_bound_ms()
    if not ms or least is None:
        return None
    return 100 * least / ms
