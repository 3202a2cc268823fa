"""Native (C++) host I/O: a threaded PNG stack decoder and the ``.xyz``
writer.

The counterpart of ``libbicos_tpu.native``, with its names and contract:
:func:`build`, :func:`get`, :func:`decode_stack` and :func:`write_xyz`.
``fastio.cpp`` reads PNGs itself and inflates them with zlib, so it needs
no libpng: ``g++ -O3 -shared -fPIC -std=c++17 -pthread fastio.cpp -lz``,
built at first use into ``libbicos_tpu_torch/_build/`` (never beside the
source) and rebuilt when the source's hash changes.

The layer is a host accelerator whose absence changes no result:
:mod:`libbicos_tpu_torch.io` uses it first and takes its per-file path
wherever a function here returns ``None``, which it does when the library
cannot be built or loaded, when ``BICOS_NO_NATIVE`` is set (read at each
call), or when the inputs are ones the native path does not take.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parent / "fastio.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
LIBS = ("-lz",)

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Path of the library for the current source and flags."""
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libbicos_fastio_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Optional[Path]:
    """Compile ``fastio.cpp`` unless its library exists (or ``force``).
    Returns the library's path, or None without ``g++`` or on a compile
    error."""
    so = library_path()
    if so.exists() and not force:
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run([gxx, *FLAGS, str(_SRC), *LIBS, "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so


def _load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.bicos_png_probe.restype = i
    lib.bicos_png_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(i),
                                    ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.bicos_decode_stack.restype = i
    lib.bicos_decode_stack.argtypes = [ctypes.POINTER(ctypes.c_char_p), i, i,
                                       i, i, p, i]
    lib.bicos_write_xyz.restype = ctypes.c_long
    lib.bicos_write_xyz.argtypes = [ctypes.c_char_p, p, p, ctypes.c_long, i,
                                    i, i]
    return lib


def get() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first use), or None when it cannot be
    built or loaded, or when ``BICOS_NO_NATIVE`` is set."""
    global _lib, _tried
    if os.environ.get("BICOS_NO_NATIVE"):
        return None
    with _lock:
        if not _tried:
            _tried = True
            so = build()
            if so is not None:
                try:
                    _lib = _load(so)
                except OSError:
                    _lib = None
        return _lib


def threads_for(n: int, n_threads: int = 0) -> int:
    """Threads that :func:`decode_stack` uses for ``n`` images: ``n_threads``,
    or one per core when it is 0, at most ``n``."""
    return max(1, min(n, n_threads if n_threads > 0 else os.cpu_count() or 1))


def decode_stack(paths: Sequence, n_threads: int = 0) -> Optional[np.ndarray]:
    """Decode PNGs into one contiguous ``(n, H, W)`` array on
    :func:`threads_for` threads, uint16 if the first image is 16-bit, else
    uint8; or None if the native path cannot take them (the caller decodes
    the files one by one)."""
    lib = get()
    if lib is None or not paths:
        return None
    w, h, depth = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.bicos_png_probe(os.fsencode(paths[0]), ctypes.byref(w),
                           ctypes.byref(h), ctypes.byref(depth)) != 0:
        return None
    out_depth = 16 if depth.value == 16 else 8
    n = len(paths)
    out = np.empty((n, h.value, w.value),
                   dtype=np.uint16 if out_depth == 16 else np.uint8)
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = lib.bicos_decode_stack(names, n, w.value, h.value, out_depth,
                                out.ctypes.data, threads_for(n, n_threads))
    return out if rc == 0 else None


def write_xyz(path, points: np.ndarray, disp: np.ndarray,
              allow_negative_z: bool) -> Optional[int]:
    """Write the ``.xyz`` text of ``points`` (``(N, 3)``; float32 as it is,
    any other dtype as float64) whose ``disp`` (``(N,)``) is not NaN: one
    ``"%g %g %g"`` line a finite point, negative z skipped unless
    ``allow_negative_z``, formatted on one thread per core. Returns the
    number written, or None (the caller writes the file itself)."""
    lib = get()
    if lib is None:
        return None
    pts = np.asarray(points).reshape(-1, 3)
    f64 = pts.dtype != np.float32
    pts = np.ascontiguousarray(pts, dtype=np.float64 if f64 else np.float32)
    d = np.ascontiguousarray(np.asarray(disp).reshape(-1), dtype=np.float32)
    if d.shape[0] != pts.shape[0]:
        raise ValueError(f"{pts.shape[0]} points but {d.shape[0]} "
                         "disparities")
    n = lib.bicos_write_xyz(os.fsencode(path), pts.ctypes.data,
                            d.ctypes.data, pts.shape[0],
                            int(allow_negative_z), int(f64), 0)
    return None if n < 0 else int(n)
