#!/usr/bin/env python3
"""Host facts and host-CPU costs behind the port's native layer.

    python3 tools/native_probe_torch.py

Prints whether the host has the C headers the native build uses
(``zlib.h``) and the JAX package's native module needs (``png.h``), its
cores, the zlib and g++ versions; then, on one headline-size 8-bit image
(2200 x 3300, uniform random, seed 0): ``cv2.imencode`` and
``cv2.imread`` of its PNG, the native decoder on one thread, and 1 M
points written as ``.xyz`` by the Python writer and by the native writer
on one thread and on one per core. Every time is the host CPU's (best of
3); none is a device number.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from libbicos_tpu_torch import io as tio  # noqa: E402
from libbicos_tpu_torch import native  # noqa: E402


def best(fn, n=3):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main() -> None:
    import cv2

    for h in ("/usr/include/zlib.h", "/usr/include/png.h"):
        print(f"{h}: {'present' if os.path.exists(h) else 'absent'}")
    gxx = shutil.which("g++")
    version = (subprocess.run([gxx, "--version"], capture_output=True,
                              text=True).stdout.splitlines()[0]
               if gxx else "absent")
    print(f"cores: os.cpu_count() {os.cpu_count()}, affinity "
          f"{len(os.sched_getaffinity(0))}; zlib {zlib.ZLIB_RUNTIME_VERSION};"
          f" g++: {version}; cv2 {cv2.__version__}")
    if native.get() is None:
        sys.exit("the native library does not build here")

    img = np.random.default_rng(0).integers(0, 256, (2200, 3300),
                                            dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "0.png"
        enc = best(lambda: cv2.imencode(".png", img))
        path.write_bytes(cv2.imencode(".png", img)[1].tobytes())
        read = best(lambda: cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
        dec = best(lambda: native.decode_stack([path], n_threads=1))
        if not np.array_equal(native.decode_stack([path])[0], img):
            sys.exit("the native decoder differs from the image")
        print(f"one 2200x3300 u8 PNG ({path.stat().st_size} bytes): "
              f"cv2.imencode {enc:.4f} s, cv2.imread {read:.4f} s, "
              f"native.decode_stack on 1 thread {dec:.4f} s")

        g = np.random.default_rng(0)
        n = 1_000_000
        pts = g.normal(0, 300, (n, 3)).astype(np.float32)
        disp = np.ones(n, np.float32)
        ok = np.ones(n, bool)
        out = os.fsencode(Path(tmp) / "n.xyz")
        lib = native.get()
        py = best(lambda: tio._write_xyz(Path(tmp) / "p.xyz", pts, ok,
                                         False))
        one = best(lambda: lib.bicos_write_xyz(
            out, pts.ctypes.data, disp.ctypes.data, n, 0, 0, 1))
        every = best(lambda: native.write_xyz(Path(tmp) / "n.xyz", pts,
                                              disp, False))
        same = ((Path(tmp) / "p.xyz").read_bytes()
                == (Path(tmp) / "n.xyz").read_bytes())
        print(f"1 M .xyz points: Python writer {py:.4f} s, native writer on "
              f"1 thread {one:.4f} s, on {os.cpu_count()} threads "
              f"{every:.4f} s; byte-equal {same}")


if __name__ == "__main__":
    main()
