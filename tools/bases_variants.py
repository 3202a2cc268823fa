"""Build variants of the bases kernel side by side and time them on one
card at the shapes of ``chip_smoke.py``'s call I (the int16 search
disparity of the headline input, 2200 x 3300, chunk 256, wcap 640, padded
width 3328)::

    python3 tools/bases_variants.py '{"name": [["old", "new"], ...]}' \
        [NAME=PATH.cu ...]

A variant is ``csrc/bases.cu`` with each ``old`` string replaced by
``new`` (a string it does not hold fails the run), or, as ``NAME=PATH``,
another source of the same entry point (a parent commit's ``bases.cu``).
Each is built alone with the package's nvcc flags, all at once; its
``-Xptxas -v`` registers and spills (a spill is noted) and its vector
kernel's SASS opcode counts are printed. Every variant is held bit for bit
to the plain version at I's shapes and at edge shapes (W % 4 of 0-3,
chunks 100, 128, 256, 384 and 512, ragged last chunks), then timed with
:func:`chip_smoke.device_times` (``LAUNCHES`` launches in a CUDA graph
behind one event pair, warm and with the L2 flushed, and
``torch.profiler``'s device time), in the order given and back again;
then, as yardsticks, PyTorch calls that read the same disparity and the
smallest kernel. The last line is one JSON object of the times in
microseconds.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import libbicos_tpu_torch as tb  # noqa: E402
from libbicos_tpu_torch import agree as ta  # noqa: E402
from libbicos_tpu_torch import search as ts  # noqa: E402
from libbicos_tpu_torch.io import synthetic_stack_pair  # noqa: E402
from libbicos_tpu_torch.kernels import _build  # noqa: E402

ENTRY = "bicos_chunk_window_bases"
CHUNK, WCAP = 256, 640


def build_variants(variants: dict, files: dict) -> dict:
    """``{name: ctypes library}``, ``tree`` first."""
    out_dir = _build.BUILD_DIR / "bases_variants"
    nvcc = _build._nvcc()
    tree_src = (_build.CSRC / "bases.cu").read_text()
    sources = {"tree": tree_src}
    for name, subs in variants.items():
        text = tree_src
        for old, new in subs:
            if old not in text:
                cs.fail(f"variant {name}: {old!r} is not in bases.cu")
            text = text.replace(old, new)
        sources[name] = text
    for name, path in files.items():
        sources[name] = Path(path).read_text()
    jobs = {}
    for name, text in sources.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "bases.cu").write_text(text)
        jobs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "bases.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, job in jobs.items():
        log = job.communicate()[0]
        if job.returncode:
            cs.fail(f"variant {name} does not build:\n{log[-3000:]}")
        rep = cs.ptxas_report(log)
        print(f"{name} registers/stack/spill bytes: " + " ".join(
            f"{k.split('bases')[-1][:12]} {v.get('registers')}/"
            f"{v.get('stack')}/{v.get('spill_stores', 0)}"
            for k, v in sorted(rep.items())), flush=True)
        if any(v.get("spill_stores") for v in rep.values()):
            print(f"{name} SPILLS registers", flush=True)
        sass = sass_counts(out_dir / name / "lib.so")
        print(f"{name} vector kernel SASS: {sass}", flush=True)
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        fn = getattr(lib, ENTRY)
        fn.argtypes = _build._SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def sass_counts(lib: Path) -> dict:
    """Instruction count and the most frequent opcodes of the vector
    kernel, from ``cuobjdump -sass`` (``{}`` without it)."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    ops, on = collections.Counter(), False
    for line in text.splitlines():
        if "Function :" in line:
            on = "vec_kernel" in line
            continue
        m = re.search(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if on and m:
            ops[m[1]] += 1
    return {"instructions": sum(ops.values()), **dict(ops.most_common(14))}


def run(fn, disp, w, wp, wcap, chunk):
    out = torch.empty((disp.shape[0], wp // chunk), dtype=torch.int32,
                      device=disp.device)
    rc = fn(disp.device.index, disp.data_ptr(), out.data_ptr(),
            disp.shape[0], disp.shape[1], w, wp, wcap, chunk,
            torch.cuda.current_stream(disp.device).cuda_stream)
    if rc:
        cs.fail(f"{ENTRY} returned {rc}")
    return out


def edge_cases(dev):
    """``(disp, w, wp, wcap, chunk)`` at the edges of both paths."""
    g = np.random.default_rng(3)
    cases = []
    for wd, chunk, wcap, pad, w in ((1408, 256, 640, 0, 1408),
                                    (1409, 256, 640, 1, 1409),
                                    (1410, 128, 256, 0, 1410),
                                    (1412, 384, 640, 1, 30000),
                                    (1411, 256, 640, 0, 1411),
                                    (1412, 100, 256, 2, 1412),
                                    (3300, 512, 1024, 0, 3300)):
        d = g.integers(-60, 400, (5, wd)).astype(np.int16)
        d[g.random(d.shape) < 0.1] = -32768
        d[1] = -32768
        d[2] = np.arange(wd) + 7
        cases.append((torch.from_numpy(d).to(dev), w,
                      (-(-wd // chunk) + pad) * chunk, wcap, chunk))
    return cases


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    args = sys.argv[1:]
    variants = json.loads(args.pop(0)) if args and args[0][:1] == "{" else {}
    files = dict(a.split("=", 1) for a in args)
    print(cs.card_line(), flush=True)
    libs = build_variants(variants, files)
    dev = torch.device("cuda", 0)
    n, h, w = cs.HEADLINE
    s0, s1 = (torch.from_numpy(x).to(dev)
              for x in synthetic_stack_pair(n, h, w)[:2])
    disp = ts.search_stack(s0, s1, tb.TransformMode.LIMITED,
                           tb.NoDuplicates(), "cuda")
    del s0, s1
    wp = -(-w // CHUNK) * CHUNK
    cases = [(disp, w, wp, WCAP, CHUNK)] + edge_cases(dev)
    wants = [ta.chunk_window_bases(*c) for c in cases]
    out = {"card": cs.card_line(), "bound_ms": cs.bound(
        disp.numel() * 2 + wants[0].numel() * 4)[0]}
    for name in list(libs) + list(libs)[::-1]:
        fn = libs[name]
        for case, want in zip(cases, wants):
            if not torch.equal(run(fn, *case), want):
                cs.fail(f"variant {name}: bases differ from plain at "
                        f"{tuple(case[0].shape)}, chunk {case[4]}")
        t = cs.device_times(torch, lambda: run(fn, *cases[0]), "bases",
                            graph=True)
        res = out.setdefault(name, {})
        for k in ("ms", "cold_ms", "profiler_ms", "profiler_cold_ms"):
            res.setdefault(k, []).append(  # us; None: no profiler record
                None if t[k] is None else round(t[k] * 1e3, 3))
        print(name, "us:", res, flush=True)
    # Yardsticks (not ports): PyTorch calls that read the same 14.5 MB, and
    # the smallest kernel, timed the same way.
    yard = {"torch_amax_rows": lambda: disp.amax(dim=1),
            "torch_clone": lambda: disp.clone(),
            "torch_sleep_0": lambda: torch.cuda._sleep(0)}
    for name, fn in yard.items():
        t = cs.device_times(torch, fn, "\0", graph=True)
        out[name] = {k: round(t[k] * 1e3, 3) for k in ("ms", "cold_ms")}
        print(name, "us:", out[name], flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
