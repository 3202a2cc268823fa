"""The reader of ``glue_ms`` (``portbench/metrics/glue_ms.py``) on
hand-made traces: PyTorch's ``at::native`` kernels inside the traced
stretch, over the traced pairs, and nothing of the program's own."""

import pytest

from portbench import harness, spec
from portbench.trace import Trace


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


# Kernel names as the profiler writes them on the H100.
PROGRAM = [
    "void (anonymous namespace)::transform_kernel<unsigned char, 8>(...)",
    "void (anonymous namespace)::row_minima_kernel<8, false>(...)",
    "void (anonymous namespace)::consistency_kernel<4, true, false>(...)",
    "void (anonymous namespace)::agree_kernel<float, unsigned char>(...)",
]
GLUE = [
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "BinaryFunctor<short, short, bool, at::native::(anonymous namespace)"
    "::CompareEqFunctor<short> >, at::detail::Array<char*, 3> >(...)",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_"
    "impl_nocast<at::native::direct_copy_kernel_cuda(...)>(...)",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_"
    "kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>(...)",
]


def _trace(glue=True):
    """Two pairs in a 100 us window: each runs the program's kernels for
    40 us and three glue kernels of 0.5, 1 and 1.5 us; a glue kernel of
    2 us begins 1 us before the window and one of 4 us ends after it."""
    ev = [_event("portbench.trace_window", "user_annotation", 1000, 100)]
    for b in (1000, 1050):
        ev += [_event(name, "kernel", b + 2 + 10 * i, 10)
               for i, name in enumerate(PROGRAM)]
        if glue:
            ev += [_event(name, "kernel", b + 43 + 2 * i, 0.5 * (i + 1))
                   for i, name in enumerate(GLUE)]
    if glue:
        ev += [_event(GLUE[0], "kernel", 999, 2),
               _event(GLUE[1], "kernel", 1098, 4)]
    ev.append(_event("Memcpy DtoD (Device -> Device)", "gpu_memcpy",
                     1046, 1))
    return Trace(ev)


def _read(trace, traced=(0, 1)):
    r = harness.Readings(trace=trace, traced=list(traced))
    return spec.load_module("metrics", "glue_ms").read(r)


def test_sums_glue_in_the_window_over_the_traced_pairs():
    # Each pair's 3 us, the 1 us of the first kernel inside the window
    # and the 2 us of the last: 9 us over two pairs.
    assert _read(_trace()) == pytest.approx(9e-3 / 2)
    assert _read(_trace(), traced=(0, 1, 0)) == pytest.approx(9e-3 / 3)


def test_ignores_the_programs_kernels_and_copies():
    tr = _trace(glue=False)
    assert tr.kernel_s("") > 0  # the program's kernels are in the window
    assert _read(tr) is None


def test_none_without_a_trace_or_traced_pairs():
    assert _read(None) is None
    assert _read(_trace(), traced=()) is None
