"""``glue_ms``: the device ms per traced pair of the kernels that are not
the program's own but PyTorch's, ``at::native``'s elementwise and copy
kernels: the glue between the program's kernels, which
``bicos.search_finish`` and ``bicos.agree_finish`` launch (the int16 and
NaN conversions of the disparity). The trace keeps no launch
correlation, so the kernels are matched by name, as the roofline readers
match theirs. None where the trace holds no such kernel."""

KERNELS = r"\bat::native::"


def read(r):
    return r.kernel_ms_per_pair(KERNELS)
