"""Build and load the CUDA kernel library, and count kernel launches.

The sources in ``csrc/*.cu`` are compiled with ``nvcc``, one process per
source, all started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``. The build runs at first use into
``libbicos_tpu_torch/_build/`` and is redone whenever the hash of the
sources and flags changes; ``nvcc``'s output (``-Xptxas -v``: registers,
shared memory, spills) is kept beside the library as a ``.log``.

Every wrapper adds one to its kernel's count in :data:`LAUNCHES` where it
launches the kernel, and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"

# -fmad=false: no implicit contraction of a*b+c (agree.cu writes its
# intended fmas as __fmaf_rn). Never --use_fast_math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# "hamming_mma" counts the scan launches that took hamming.cu's full-row
# scan on the 1-bit tensor cores (every unranged one), beside their count
# in "hamming"; "agree_packed" counts the agree launches that took the
# packed sweep (kernels/agree.py::packed_bucket) and "agree_double" those in
# float64 (Precision.DOUBLE), each beside their count in "agree".
LAUNCHES = {"transform": 0, "hamming": 0, "hamming_mma": 0, "consistency": 0,
            "agree": 0, "agree_packed": 0, "agree_double": 0, "band": 0,
            "band_consistency": 0, "bases": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    # every entry point takes the device index first, then:
    # stack, words, n, h, w, u16, full, nw, stream
    "bicos_transform": (_I, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # words0, words1, first, last, h, wid0, wid1, nw, need_last, has_range,
    # dmin, dmax, stream
    "bicos_row_minima": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P),
    # wid1, nw, no_dupes
    "bicos_consistency_needs_scratch": (_I, _I, _I, _I),
    # words0, words1, first, last, rc0, rc0_last, scratch, h, wid0, wid1,
    # nw, no_dupes, has_range, dmin, dmax, stream
    "bicos_consistency": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _P),
    # disp, s0, s1, xs, nx, out, corr, n, h, w, w1, col_offset, u16,
    # threshold, minvar, has_minvar, f64, packed, bases, nc, chunk, wcap,
    # stream
    "bicos_agree": (_I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                    _D, _D, _I, _I, _I, _P, _I, _I, _I, _P),
    # (the device only): the opt-in shared memory per block, or -error
    "bicos_smem_optin": (_I,),
    # disp, out, h, wd, w, wp, wcap, chunk, stream
    "bicos_chunk_window_bases": (_I, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # words0, words1, mf, ml, h, wid0, band, wid1, nw, off1, w1_total,
    # has_range, dmin, dmax, stream
    "bicos_row_minima_band": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _P),
    # words0, words1, mf, ml, rf, rl, h, band0, band, nw, off0, off1, w,
    # rstride, has_range, dmin, dmax, stream
    "bicos_consistency_band": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _P),
}


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _sources():
    return sorted(CSRC.glob("*.cu*"))


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Path of the built library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbicos_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one ``nvcc -c`` per source in parallel, then one link."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        log.append(f"== {src.name}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    tmp = so.with_name(f"{tag}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    text = "\n".join(log)
    so.with_suffix(".log").write_text(text)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed: {', '.join(failed)}:\n{text[-4000:]}")
    os.replace(tmp, so)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.bicos_error_string.argtypes = (ctypes.c_int,)
    lib.bicos_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        msg = library().bicos_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device and is contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: all tensors must lie on one CUDA device, got "
                f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
