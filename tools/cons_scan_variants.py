"""Build variants of the fused Consistency scan side by side and time them
on one card, at the shapes of ``chip_smoke.py``'s calls B (the full-row
``consistency.cu`` scan), D (the same scan ranged to (0, 511)) and F (the 16
fused ring steps of ``band.cu`` over 4 column bands)::

    python3 tools/cons_scan_variants.py '{"name": [["old", "new"], ...]}'

A variant is the kernel sources (``cons_scan.cuh``, ``row_scan.cuh``,
``consistency.cu``, ``band.cu``) with each ``old`` string replaced by
``new``; a string found in none of them fails the run. Every variant is
built with the package's nvcc flags, all at once, and its ``-Xptxas -v``
registers, stack and spill bytes are printed per kernel instance
(``<nw,last,global>``). The tree's own kernels (``tree``) and then every
variant are checked against the tree's plain-version-checked results bit
for bit and timed (CUDA events, median of 5), in the order given and back
again; the last line is one JSON object of the times in ms.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import libbicos_tpu_torch as tb  # noqa: E402
from libbicos_tpu_torch import descriptor as td  # noqa: E402
from libbicos_tpu_torch import search as ts  # noqa: E402
from libbicos_tpu_torch import sharding  # noqa: E402
from libbicos_tpu_torch.io import synthetic_stack_pair  # noqa: E402
from libbicos_tpu_torch.kernels import _build  # noqa: E402
from libbicos_tpu_torch.kernels.hamming import range_args  # noqa: E402

FILES = ("cons_scan.cuh", "row_scan.cuh", "consistency.cu", "band.cu")
ENTRY_POINTS = ("bicos_consistency", "bicos_consistency_band")


def build_variants(variants: dict) -> dict:
    """``{name: ctypes library}`` with ``tree`` first; prints each build's
    registers/stack/spills of the Consistency kernels."""
    out_dir = _build.BUILD_DIR / "variants"
    nvcc = _build._nvcc()
    jobs = {}
    for name, subs in variants.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        texts = {f: (_build.CSRC / f).read_text() for f in FILES}
        for old, new in subs:
            if not any(old in t for t in texts.values()):
                cs.fail(f"variant {name}: {old!r} is in no source")
            texts = {f: t.replace(old, new) for f, t in texts.items()}
        for f, t in texts.items():
            (d / f).write_text(t)
        jobs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "consistency.cu"), str(d / "band.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {"tree": _build.library()}
    logs = {"tree": _build.library_path().with_suffix(".log").read_text()}
    for name, job in jobs.items():
        logs[name] = job.communicate()[0]
        if job.returncode:
            cs.fail(f"variant {name} does not build:\n{logs[name][-3000:]}")
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        for fn in ENTRY_POINTS:
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    for name, log in logs.items():
        rep = {k: v for k, v in cs.ptxas_report(log).items()
               if "consistency_kernel<" in k}
        print(f"{name} registers/stack/spill bytes: " + " ".join(
            f"{k} {v.get('registers')}/{v.get('stack')}/"
            f"{v.get('spill_stores', 0)}" for k, v in sorted(rep.items())),
            flush=True)
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    variants = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {}
    print(cs.card_line(), flush=True)
    libs = build_variants(variants)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    s0, s1, _ = synthetic_stack_pair(*cs.HEADLINE)
    mode = tb.TransformMode.LIMITED
    w0, w1 = (td.descriptor_words(torch.from_numpy(s).to(dev), mode)
              for s in (s0, s1))
    h, w, nw = w0.shape

    def scan(lib, drange):
        has, dmin, dmax = range_args(drange, w, w)
        out = [torch.empty((h, w), dtype=torch.int32, device=dev)
               for _ in range(4)]
        rc = lib.bicos_consistency(
            0, w0.data_ptr(), w1.data_ptr(), *(o.data_ptr() for o in out),
            None, h, w, w, nw, 1, has, dmin, dmax, stream)
        if rc:
            cs.fail(f"bicos_consistency returned {rc}")
        return out

    mesh = sharding.make_mesh(cs.NBANDS, virtual=True, device=dev)
    a, b = sharding._bands(w0, 1, mesh), sharding._bands(w1, 1, mesh)
    band, n = a[0].shape[1], cs.NBANDS

    def fresh():
        mf = [torch.full((h, band), ts.BIG, dtype=torch.int32, device=dev)
              for _ in range(n)]
        rev = torch.full((2, h, n * band), ts.BIG, dtype=torch.int32,
                         device=dev)
        return mf, [m.clone() for m in mf], rev

    def ring(lib, acc):
        mf, ml, rev = acc
        for i in range(n):
            for j in range(n):
                src = (j + i) % n
                rc = lib.bicos_consistency_band(
                    0, a[j].data_ptr(), b[src].data_ptr(), mf[j].data_ptr(),
                    ml[j].data_ptr(), rev[0].data_ptr(), rev[1].data_ptr(),
                    h, band, band, nw, j * band, src * band, w, n * band, 0,
                    0, 0, stream)
                if rc:
                    cs.fail(f"bicos_consistency_band returned {rc}")

    def ring_result(lib):
        acc = fresh()
        ring(lib, acc)
        first = torch.cat([ts.decode_minima(f, l, w)[1]
                           for f, l in zip(acc[0], acc[1])], 1)[:, :w]
        _, f1, l1 = ts.decode_minima(acc[2][0], acc[2][1], w)
        return [first, *ts._lookup_reverse(f1[:, :w], l1[:, :w], first)]

    # The tree's kernels are held against their plain versions by
    # chip_smoke.py; each variant is held against the tree's.
    want = {dr: scan(libs["tree"], dr) for dr in (None, cs.DRANGE)}
    want_f = [want[None][0], want[None][2], want[None][3]]
    out = {"card": cs.card_line()}
    for name in list(libs) + list(libs)[::-1]:
        lib, res = libs[name], out.setdefault(name, {})
        for drange, tag in ((None, "B"), (cs.DRANGE, "D")):
            if not all(torch.equal(x, y)
                       for x, y in zip(scan(lib, drange), want[drange])):
                cs.fail(f"variant {name}: {tag}'s scan differs from tree's")
            res.setdefault(tag, []).append(
                round(cs.time_ms(torch, lambda: scan(lib, drange)), 3))
        if not all(torch.equal(x, y)
                   for x, y in zip(ring_result(lib), want_f)):
            cs.fail(f"variant {name}: F's ring differs from B's scan")
        acc = fresh()
        res.setdefault("F", []).append(
            round(cs.time_ms(torch, lambda: ring(lib, acc)), 3))
        print(name, res, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
