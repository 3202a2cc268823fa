#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``libbicos_tpu_torch``) on one card.

    python3 chip_smoke.py

1. Prints the card (name, power limit), the torch and CUDA versions, and
   builds the CUDA kernels from ``libbicos_tpu_torch/csrc``; prints the
   registers, stack and spills (``-Xptxas -v``) of the agree, transform,
   scan (tensor-core and ranged), Consistency scan, fused ring step and
   bases kernels (one of them that spills fails the run, and so does a
   FULL transform instance with a stack frame) and the agree, transform
   and tensor-core scan kernels' SASS opcode counts, whole and per sweep
   loop (``cuobjdump -sass``; a scan's tile loop also as SASS instructions
   a (pixel, column) pair); of the FULL transform's
   instances (``transform_kernel<u8,16>``: u8 and u16, n = 2..16) the
   counts of the two n = 16 ones and each one's instructions a pixel.
2. Compares each kernel with its plain PyTorch version on the card, at a
   full-width row band of the headline input (n=33, 64 x 3300, u8, LIMITED)
   and at a ragged small shape (n=9, 7 x 1001, u16, FULL): the scan
   unranged and ranged (0, 511) and with a range that leaves no candidate,
   the consistency scan with and without no_dupes and range (0, 511), and
   the agree sweep, the W-band ring step and the fused Consistency ring
   step (every band and visit of a 4-band ring, unranged, ranged (0, 511),
   with no candidate, and without last) and the agree of a left column
   band against the whole right row (column offset). The dynamic window at both shapes and at n=65 u16 (16
   x 1412, LIMITED), for each (chunk, wcap) of (256, 640) and (512, 1024)
   that the width admits: the bases kernel on the search disparity and on
   a mixed field (planted matches make some chunks fall back), and the
   windowed agree on the mixed field against the global-read agree (equal
   bit for bit, corrmap included) and the plain agree; the DOUBLE agree
   against the plain f64 agree, bit for bit. Then one 2 x 40000 consistency case
   (reverse minima in global memory), both ring steps on n=3 LIMITED words
   (16 x 3300) and on a 2 x 20000 n=9 row pair over 4 bands, and the fused
   step on a 1-band ring at 32767 columns (reverse minima in global
   memory).
3. Runs five full-size calls ``match(s0, s1, cfg, backend="cuda")`` on
   synthetic input: four at n=33, 2200 x 3300, u8, LIMITED, threshold
   0.96, min_variance 2.0, subpixel step 0.1 (A the NoDuplicates
   headline, B Consistency(1, True), C NoDuplicates with disparity_range
   (0, 511), D Consistency(1, True) with (0, 511)), and N at ``full16``'s
   settings on the headline's first 16 shots (n=16, u8, FULL, 8 words a
   pixel, threshold 0.9, no step, no min_variance, NoDuplicates, int16
   disparity). Before them the FULL transform of N's stacks is compared
   with its plain version, and at the end timed beside the LIMITED one.
   Each call's launch counts are set to 0 just before it and read just
   after, and must equal the kernels of its path (``hamming_mma``, the
   scan launches that took the tensor-core scan: every unranged one, not
   C's; ``agree_packed``, the agree launches that took the packed sweep:
   every subpixel call, not N's integer agree; ``agree_double``, those in
   float64: J's alone); two
   runs must agree; the valid share must be above 0. The call's scan
   kernel and the agree kernel (N: the integer agree) are compared with
   their plain versions at the shapes the call gives them, and the call
   and its kernels are timed (CUDA events, median of 5 after a warm run)
   beside their plain versions (one run each). Then two more calls of
   A's configuration: I with the dynamic window
   (``BICOS_AGREE_DYNWIN=640``, chunk 256), which launches the bases
   kernel and the windowed agree and must equal A bit for bit, with a
   share of windowed chunks above 0; J in DOUBLE, whose agree kernel must
   equal the plain f64 agree bit for bit at the call's shapes.
4. Runs four sharded calls on the same input over a virtual mesh of 4
   bands on the one card (``sharding.make_mesh(4, virtual=True)``): E
   ``match_sharded_w`` NoDuplicates, F ``match_sharded_w`` Consistency(1,
   True), G ``match_sharded_w`` NoDuplicates with (0, 511), H
   ``match_sharded`` (4 row bands) NoDuplicates. Each must launch exactly
   its path's kernels (F: one ring, 16 fused Consistency steps), run
   deterministically, and equal the single-card call of its configuration
   (A, B, C, A) exactly: the same NaN mask, equal disparities, equal
   corrmaps. The ring's band kernel is compared with its plain fold at E's
   and G's shapes, the fused step with its plain version at F's, and each
   call's kernels are timed at its shapes beside the call.

5. Runs the user surfaces on the card. The native host layer
   (``libbicos_tpu_torch/native``) must build and load. The headline input
   is written as a scanner's folder (66 PNGs, ``cv2.imwrite`` at its
   default settings) and decoded through ``native.decode_stack`` and
   through the per-file path, both equal to the stacks, best of 3 each;
   call A's disparity reprojected to ``.xyz`` through the native and the
   Python writer, byte-equal, each timed. The CLI (``python -m
   libbicos_tpu_torch.cli``, a process of its own) runs on that folder
   with A's configuration (``-t 0.96 --limited -v 2.0 -s 0.1
   --corrmap``); its disparity TIFF must equal call A's bit for bit and
   its corrmap TIFF lie within 4e-6 of it, and its process seconds (cell
   K) are set beside the CLI's steps timed in its order in two fresh
   processes (imports, ``load_stack_pair``, the kernel library, upload,
   first match, download, the two ``save_image`` calls, and each process's
   start and exit); two small
   CLI cases (``-q`` with a Q matrix, ``-m 1 --no-dupes``), each equal to
   its in-process ``match``; ``profiling.stage_timings`` at A;
   ``pybicos_compat.match`` equal to ``match``; call A under
   ``BICOS_DEBUG=1``, whose checks must pass.
6. Runs the port's daemon (``libbicos_tpu_torch.serve``) in a thread on
   the card with A's configuration, warmed at the headline shape, and
   drives it through ``libbicos_tpu_torch.client.BicosClient``: ``/healthz``
   reports 1 specialization after the warmup; four headline
   ``/match?corrmap=1`` requests (cell L) each equal call A bit for bit; a
   batched request of two full-size pairs (cell M) equals
   ``match_batched_folded`` in process and its first pair call A;
   ``lr_maxdiff=1&no_dupes=1`` equals call B and ``disp_range=0:511`` call
   C; a second daemon on a 4-band virtual mesh answers call H. Each
   request's launches are counted from 0 and must be its path's kernels.
   It prints the warmup's time and each request split into the client's
   npz encode, the server's body read, ``np.load``, upload, match and
   download (each fenced by ``torch.cuda.synchronize()``), the reply's
   encode and the client's decode (the ``Server-Timing`` header).

It then prints how to hold the answers to a parent commit's bit for bit
(``tools/output_hashes.py`` on both trees in one call).

The bases and transform kernels' times are device times: ``LAUNCHES``
launches behind one event pair (the bases replayed from a CUDA graph, so
that the wrapper's host work does not sit between them), warm and with the
L2 flushed, confirmed by ``torch.profiler``; ``call_ms`` is one launch
between an event pair, host work included.

The bars: descriptor words bit-identical; first/last argmins and reverse
argmins equal, sentinels included; agree corrmaps with the same NaN mask
and within 4e-6; disparities equal except at pixels whose plain corr lies
within 4e-6 of the threshold, or whose best and runner-up sweep NXCORR lie
within 4e-6 of each other (counted).

Any failure exits non-zero. The last line is the device JSON object; the
line before it lists the kernels with their launches (summed over the eleven
calls and the served requests), errors, times and bounds. A kernel's bound
is the least time the card could take for its work on this run's inputs:
the larger of its bytes (each input read once, each output written once)
over the memory rate and its operations over the rate of their type
(``portbench/roofline.py``, ``PEAK``; a scan by its pairs x descriptor
bits and its 16-bit minima, ``roofline.scan_bound``; beside it the
ranged and Consistency scans' price on the popcount pipe alone,
:func:`scan_bound`).
"""

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# The yardstick (one H100 SXM at 700 W: peaks and the work of each kernel)
# is the benchmark's own, so that both price a kernel alike (``PEAK`` is
# re-exported as this script's peaks).
from portbench import roofline
from portbench.roofline import PEAK, bits_for, bound  # noqa: F401

REPO = Path(__file__).resolve().parent
TOL = 4e-6  # corrmap bar of the JAX package's own agree kernel
THRESHOLD, MIN_VARIANCE, STEP = 0.96, 2.0, 0.1
HEADLINE = (33, 2200, 3300)
DRANGE = (0, 511)
REPS = 5
_H = "libbicos_tpu/kernels/hamming.py:"
# Each CUDA kernel with every TPU kernel (file:line) it serves; transform.cu
# is the descriptor half of every fused stack kernel.
SOURCES = {
    "transform": ("libbicos_tpu_torch/csrc/transform.cu", [
        "libbicos_tpu/kernels/transform.py:32", _H + "779", _H + "715",
        _H + "2007", _H + "890", _H + "1305", _H + "1037", _H + "2216"]),
    "hamming": ("libbicos_tpu_torch/csrc/hamming.cu", [
        _H + "345", _H + "574", _H + "779", _H + "715", _H + "2007"]),
    "consistency": ("libbicos_tpu_torch/csrc/consistency.cu", [
        _H + "1413", _H + "1553", _H + "890", _H + "629", _H + "1305",
        _H + "1037"]),
    "agree": ("libbicos_tpu_torch/csrc/agree.cu", [
        "libbicos_tpu/kernels/agree.py:483",
        "libbicos_tpu/kernels/agree.py:826"]),
    "band": ("libbicos_tpu_torch/csrc/band.cu", [_H + "2216", _H + "1813"]),
    # The fused Consistency ring step: the band kernels' role in F, where
    # the TPU runs them in two rings.
    "band_consistency": ("libbicos_tpu_torch/csrc/band.cu",
                         [_H + "2216", _H + "1813"]),
    "bases": ("libbicos_tpu_torch/csrc/bases.cu",
              ["libbicos_tpu/kernels/agree.py:298"]),
}
NBANDS = 4
KERNELS = tuple(SOURCES)
WINDOWS = ((256, 640), (512, 1024))  # (chunk, wcap) of the dynamic window


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def plain_timed(torch, fn):
    """One CUDA-event-timed run of ``fn()``: (result, ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def time_ms(torch, fn, reps: int = REPS, warm: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed
    runs, after ``warm`` untimed ones."""
    for _ in range(warm):
        fn()
    return statistics.median(plain_timed(torch, fn)[1] for _ in range(reps))


FLUSH_BYTES = 128 << 20  # written between launches: > the card's 50 MB L2
LAUNCHES = 100  # launches behind one event pair for a device time


def profiled_ms(torch, fn, kernel: str) -> tuple:
    """``(mean ms, count)`` of the device time that ``torch.profiler``
    records for the kernels whose name holds ``kernel`` while ``fn()``
    runs; ``(None, 0)`` where it records none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = count = 0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if kernel in e.key and t > 0:
            total += t
            count += e.count
    return (total / 1e3 / count, count) if count else (None, 0)


def device_times(torch, fn, kernel: str, graph: bool) -> dict:
    """One launch's device time of ``fn()`` (which launches the kernels
    named ``kernel``), in ms:

    * ``ms``: ``LAUNCHES`` launches back to back between one event pair,
      over the count; with ``graph`` they are replayed from a CUDA graph, so
      that no host work sits between them (for a kernel of microseconds the
      wrapper's host work is longer than the kernel);
    * ``cold_ms``: the same with the L2 flushed (a ``FLUSH_BYTES`` write)
      before each launch, less the flushes alone;
    * ``profiler_ms``, ``profiler_cold_ms``: ``torch.profiler``'s device
      time of the kernel, mean of ``LAUNCHES`` plain launches, warm and
      flushed;
    * ``call_ms``: one launch between an event pair, median of ``REPS``.
    """
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")

    def run(with_flush, with_fn):
        for _ in range(LAUNCHES):
            if with_flush:
                flush.fill_(7)
            if with_fn:
                fn()

    keys = ((False, True), (True, True), (True, False))
    if graph:
        graphs = {}
        for key in keys:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, capture_error_mode="relaxed"):
                run(*key)
            graphs[key] = g.replay
    else:
        graphs = {key: (lambda key=key: run(*key)) for key in keys}
    span = {key: time_ms(torch, graphs[key]) for key in keys}
    out = {
        "ms": span[keys[0]] / LAUNCHES,
        "cold_ms": (span[keys[1]] - span[keys[2]]) / LAUNCHES,
        "call_ms": time_ms(torch, fn),
    }
    out["profiler_ms"] = profiled_ms(torch, lambda: run(False, True),
                                     kernel)[0]
    out["profiler_cold_ms"] = profiled_ms(torch, lambda: run(True, True),
                                          kernel)[0]
    return out


def scan_bound(h, w, nw, drange, out_bytes):
    """A scan's bound on the popcount pipe alone: one popcount per (left
    pixel, right column in ``drange``, word) at ``PEAK["popc"]``, both word
    arrays read once, ``out_bytes`` written per pixel. The ranged and
    Consistency scans pay that price; each call line prints it beside the
    yardstick's bound (``roofline.scan_bound``), which prices the tensor
    cores too."""
    return bound(2 * h * w * nw * 4 + h * w * out_bytes,
                 popc=h * roofline.scan_pairs(w, drange) * nw)


def agree_bound(torch, disp, s0, s1, nx, double=False, conv_pipe=False):
    """The agree function's bound on this input. A kept pixel that sweeps
    needs, per shot and x, 5 FP32 operations for the interpolated sample,
    4 in the compute type for its NXCORR terms (mean add, difference, two
    fmas) and 2 roundings or casts (the round-to-int and back); once per
    shot, 6 FP32 operations (the parabola), 3 in the compute type (left
    statistics) and 4 casts. A kept pixel on the integer check needs 7n
    operations in the compute type and 2n casts. The compute type is FP32,
    or FP64 with ``double``. The roundings and casts are exact FP32 adds
    (as ``agree.cu`` computes them); ``conv_pipe`` counts them at the
    conversion pipe's rate instead, the yardstick of the kernel's first
    design."""
    n = s0.shape[0]
    w1 = s1.shape[2]
    col1 = torch.arange(disp.shape[1], device=disp.device)[None] - disp.long()
    keep = (disp != -32768) & (col1 >= 0) & (col1 < w1)
    sweep = int((keep & (col1 != 0) & (col1 != w1 - 1)).sum()) if nx else 0
    plain = int(keep.sum()) - sweep
    fp32 = sweep * (5 * n * nx + 6 * n)
    comp = sweep * (4 * n * nx + 3 * n) + plain * 7 * n
    conv = sweep * (2 * n * nx + 4 * n) + plain * 2 * n
    nbytes = ((s0.numel() + s1.numel()) * s0.element_size()
              + disp.numel() * (2 + 4 + 4))
    if not conv_pipe:
        fp32, conv = fp32 + conv, 0
    if double:
        return bound(nbytes, fp32=fp32, fp64=comp, conv=conv)
    return bound(nbytes, fp32=fp32 + comp, conv=conv)


_KERNEL_NAME = re.compile(
    r"(agree_window_kernel|agree_kernel|transform_kernel)I((?:[a-z]|Li\d+E)+)E")
_SCAN_NAME = re.compile(r"\d(band_consistency_kernel|consistency_kernel|"
                        r"row_minima_kernel)I((?:L[ib]\d+E)+)E")
_TYPE_LETTERS = {"f": "float", "d": "double", "h": "u8", "t": "u16"}
# The kernels whose registers, stack and spills build_report prints.
REPORTED = ("agree", "transform", "consistency", "band_consistency",
            "bases", "row_minima_kernel")
# hamming.cu's tensor-core scan, one instance a word count.
_MMA_SCAN = re.compile(r"row_minima_kernel<\d>")
_BASES_NAME = re.compile(r"\d(bases_vec_kernel|bases_kernel)E")


def short_name(mangled: str) -> str:
    """``agree_kernel<float,u8>`` for an agree or transform kernel's
    mangled name (``transform_kernel<u8,16>`` for the FULL transform of 16
    shots), ``consistency_kernel<4,1,0>`` (nw, last, global reverse minima)
    for a Consistency scan or fused ring step, ``row_minima_kernel<4>``
    (nw) for the tensor-core scan and ``row_minima_kernel<4,1>`` for the
    ranged one, else the mangled name."""
    m = _KERNEL_NAME.search(mangled)
    if m:
        args = (num or _TYPE_LETTERS.get(c, c)
                for num, c in re.findall(r"Li(\d+)E|([a-z])", m[2]))
        return f"{m[1]}<{','.join(args)}>"
    m = _SCAN_NAME.search(mangled)
    if m:
        args = re.findall(r"L[ib](\d+)E", m[2])
        return f"{m[1]}<{','.join(args)}>"
    m = _BASES_NAME.search(mangled)
    return m[1] if m else mangled


def ptxas_report(log: str) -> dict:
    """Per entry function of the nvcc ``-Xptxas -v`` log: registers,
    stack frame, spill stores and loads (bytes)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = short_name(m[1])
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m[1]), spill_stores=int(m[2]),
                            spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m[1])
    return out


SASS_OPS = ("I2F", "I2FP", "F2I", "F2IP", "FRND", "F2F", "FMUL", "FADD",
            "FFMA", "DMUL", "DADD", "DFMA", "LOP3", "IADD3", "LDS", "MUFU")


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@(!?)(U?P\w+)\s+)?"
                        r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*([^;]*);")
# The packed agree instance of the LIMITED cells (u8, n=33, SINGLE) and
# the bucket below its own.
HEADLINE_AGREE, HEADLINE_BELOW = "agree_kernel<float,u8,33>", 16


def sass_instruction(line: str):
    """One ``cuobjdump -sass`` instruction line as ``{"addr", "neg",
    "pred", "op", "mods", "args", "tgt"}`` (``tgt``: a branch's target
    address), or None."""
    m = _SASS_LINE.search(line)
    if not m:
        return None
    tgt = re.search(r"0x([0-9a-f]+)", m[6]) if m[4] == "BRA" else None
    return {"addr": int(m[1], 16), "neg": m[2] == "!", "pred": m[3],
            "op": m[4], "mods": m[5], "args": m[6],
            "tgt": int(tgt[1], 16) if tgt else None}


def packed_issue(ins: list, n: int, below: int) -> dict:
    """Instructions issued once through the x-tile loop of a packed agree
    instance (the smallest loop that holds its DP4As) for ``n`` shots of its
    bucket (``below`` < n): each guard ``ISETP`` of a register against an
    immediate in (below, n + 4] is taken as a comparison with n, every
    other predicate as false (the fast paths of the divisions and square
    roots). ``samples`` (a tile's n x K) is the mean pass's FMULs over 3;
    the mean pass runs to the tile's first MUFU (its divisions), the
    covariance pass from the next LDS to the MUFU after it."""
    idp = [k for k, x in enumerate(ins) if x["op"] == "IDP"]
    index = {x["addr"]: k for k, x in enumerate(ins)}
    j, k_end = min(((index[x["tgt"]], k) for k, x in enumerate(ins)
                    if x["tgt"] in index and index[x["tgt"]] <= idp[0]
                    and k >= idp[-1]), key=lambda span: span[1] - span[0])
    cmp = {"GE": int.__ge__, "GT": int.__gt__, "LT": int.__lt__,
           "LE": int.__le__, "EQ": int.__eq__, "NE": int.__ne__}
    preds, seq = {}, []
    while j != k_end and len(seq) < 100000:
        x = ins[j]
        seq.append(x)
        args = [a.strip() for a in x["args"].split(",")]
        m = re.fullmatch(r"\.(GE|GT|LT|LE|EQ|NE)\.AND", x["mods"])
        if x["op"] == "ISETP" and m and len(args) == 5 and \
                args[3].startswith("0x") and \
                below < int(args[3], 16) <= n + 4:
            preds[args[0]] = cmp[m[1]](n, int(args[3], 16))
        elif re.fullmatch(r"P\d", args[0]):
            preds[args[0]] = False
        taken = x["op"] == "BRA" and (
            not x["pred"] or preds.get(x["pred"], False) != x["neg"])
        j = index[x["tgt"]] if taken else j + 1
    mufu = [k for k, x in enumerate(seq) if x["op"] == "MUFU"]
    cov0 = next(k for k, x in enumerate(seq)
                if k > mufu[0] and x["op"] == "LDS")
    cov1 = next(k for k in mufu if k > cov0)
    samples = sum(x["op"] == "FMUL" for x in seq[:mufu[0]]) // 3
    return {"n": n, "samples": samples, "tile": len(seq),
            "mean_pass": mufu[0], "covariance_pass": cov1 - cov0}


def mma_loop(ins: list) -> dict:
    """The tensor-core scan's tile loop in ``(addr, op, target)``
    instructions: the smallest loop (the span of a backward branch) that
    holds a BMMA, with its instructions, its BMMAs, IMADs, 3-input minima
    (VIMNMX3) and shared loads, and its SASS instructions a (pixel, column)
    pair: a BMMA takes 16 x 8 pairs of a warp, so the loop's instructions x
    32 lanes over its BMMAs x 128. ``{}`` where no loop holds a BMMA."""
    best = None
    for addr, _, tgt in ins:
        if tgt is None or tgt >= addr:
            continue
        body = [op for a, op, _ in ins if tgt <= a <= addr]
        if "BMMA" in body and (best is None or len(body) < len(best[1])):
            best = (f"{tgt:#06x}-{addr:#06x}", body)
    if best is None:
        return {}
    span, body = best
    out = {"span": span, "instructions": len(body),
           **{op: body.count(op) for op in ("BMMA", "IMAD", "VIMNMX3",
                                            "LDS")}}
    out["per_pair"] = len(body) * 32 / (out["BMMA"] * 128)
    return out


def sass_report(lib: Path) -> dict:
    """Opcode counts (``SASS_OPS``) of the agree and transform kernels in
    the built library, from ``cuobjdump -sass``: over the whole kernel, and
    over each loop (the span of a backward branch) that holds at least 20
    FMULs (the sweep's two shot loops of an x tile, and the x loop around
    them) or, in the transform, at least 16 instructions; ``last_loop``,
    the instructions of the loop that the kernel's last backward branch
    closes (in a FULL transform, the loop over a thread's pixels); and for
    the LIMITED cells' packed agree instance (``HEADLINE_AGREE``), the
    instructions issued a tile at n = 33 (:func:`packed_issue`); for each
    tensor-core scan instance its tile loop (:func:`mma_loop`). ``{}``
    where the toolkit has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.access(tool, os.X_OK):
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    funcs, full, cur = {}, {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = short_name(m[1])
            cur = (funcs.setdefault(name, [])
                   if name.startswith(("agree", "transform"))
                   or _MMA_SCAN.fullmatch(name) else None)
            continue
        x = sass_instruction(line)
        if cur is not None and x:
            cur.append((x["addr"], x["op"], x["tgt"]))
            full.setdefault(name, []).append(x)

    def counts(ins):
        return {op: sum(1 for _, o, _ in ins if o == op) for op in SASS_OPS}

    report = {}
    for name, ins in funcs.items():
        loops, last_loop = [], None
        for addr, _, tgt in ins:
            if tgt is None or tgt >= addr:
                continue
            body = [x for x in ins if tgt <= x[0] <= addr]
            last_loop = len(body)
            c = counts(body)
            if c["FMUL"] >= 20 or (name.startswith("transform")
                                   and len(body) >= 16):
                loops.append({"span": f"{tgt:#06x}-{addr:#06x}",
                              "instructions": len(body), **c})
        report[name] = {"instructions": len(ins), **counts(ins),
                        "loops": loops, "last_loop": last_loop}
        if name == HEADLINE_AGREE:
            report[name]["issued"] = packed_issue(full[name], 33,
                                                  HEADLINE_BELOW)
        if _MMA_SCAN.fullmatch(name):
            report[name]["tile_loop"] = mma_loop(ins)
    return report


_FULL_TRANSFORM = re.compile(r"transform_kernel<(u8|u16),(\d+)>")


def build_report(lib: Path) -> dict:
    """Prints the registers and spills (the ``-Xptxas -v`` log beside
    ``lib``) of the agree, transform, scan, Consistency scan, fused ring
    step and bases kernels, and the agree, transform and tensor-core scan
    kernels' SASS opcode counts;
    fails if one of those kernels spills, or if a FULL transform instance
    has a stack frame (its words left the registers). Returns the SASS
    instructions a pixel of each FULL transform instance (its last loop,
    the loop over a thread's pixels), by short name."""
    log = lib.with_suffix(".log")
    ptxas = ptxas_report(log.read_text()) if log.exists() else {}
    mine = {k: v for k, v in ptxas.items() if k.startswith(REPORTED)}
    if not any(k.startswith("band_consistency") for k in mine):
        fail("the build log names no fused Consistency ring step kernel")
    full = {k: v for k, v in mine.items() if _FULL_TRANSFORM.fullmatch(k)}
    if len(full) != 2 * 15:
        fail(f"the build log names {len(full)} FULL transform instances, "
             f"not 30 (u8 and u16, n = 2..16)")
    for k, v in mine.items():
        if k.startswith(("agree", "transform", "bases")) and k not in full:
            print(f"  ptxas: {k}: {v}", flush=True)
    print("  ptxas: transform_kernel<T,n> registers/stack/spills: "
          + " ".join(f"{k[len('transform_kernel'):]} {v.get('registers')}/"
                     f"{v.get('stack')}/{v.get('spill_stores', 0)}"
                     for k, v in full.items()), flush=True)
    stacked = [k for k, v in full.items() if v.get("stack")]
    if stacked:
        fail(f"these FULL transform instances have a stack frame: {stacked}")
    for fam, args in (("consistency_kernel", "<nw,last,global>"),
                      ("band_consistency_kernel", "<nw,last,global>"),
                      ("row_minima_kernel", "<nw> and <nw,ranged>")):
        # registers/stack/spill bytes of each instance
        print(f"  ptxas: {fam}{args} registers/stack/spills: "
              + " ".join(f"{k[len(fam):]} {v.get('registers')}/"
                         f"{v.get('stack')}/{v.get('spill_stores', 0)}"
                         for k, v in mine.items() if k.startswith(fam + "<")),
              flush=True)
    others = {v.get("registers") for k, v in ptxas.items() if k not in mine}
    print(f"  ptxas: {len(ptxas) - len(mine)} other kernels, registers "
          f"{sorted(others)}", flush=True)
    spills = [k for k, v in mine.items()
              if v.get("spill_stores") or v.get("spill_loads")]
    if spills:
        fail(f"these kernels spill registers: {spills}")
    sass = sass_report(lib)
    per_pixel = {k: v["last_loop"] for k, v in sass.items()
                 if _FULL_TRANSFORM.fullmatch(k)}
    for k, v in sass.items():
        if k in per_pixel and not k.endswith(",16>"):
            continue  # the other FULL instances: a pixel's count below
        print(f"  sass: {k}: " + " ".join(
            f"{op} {v[op]}" for op in ("instructions",) + SASS_OPS),
              flush=True)
        for loop in v["loops"]:
            print(f"    loop {loop['span']}: " + " ".join(
                f"{op} {loop[op]}" for op in ("instructions",) + SASS_OPS),
                  flush=True)
        if v.get("tile_loop"):
            t = v["tile_loop"]
            print(f"    tile loop {t['span']}: {t['instructions']} "
                  f"instructions, BMMA {t['BMMA']}, IMAD {t['IMAD']}, "
                  f"VIMNMX3 {t['VIMNMX3']}, LDS {t['LDS']}: "
                  f"{t['per_pair']:.3f} a (pixel, column) pair", flush=True)
        if "issued" in v:
            t = v["issued"]
            both = t["mean_pass"] + t["covariance_pass"]
            print(f"    issued a tile at n={t['n']}: {t['tile']} for "
                  f"{t['samples']} samples, {t['tile'] / t['samples']:.2f} "
                  f"a sample; both passes {both / t['samples']:.2f} (mean "
                  f"{t['mean_pass'] / t['samples']:.2f}, covariance "
                  f"{t['covariance_pass'] / t['samples']:.2f})", flush=True)
    if per_pixel:
        print("  sass: transform_kernel<T,n> instructions a pixel: "
              + " ".join(f"{k[len('transform_kernel'):]} {v}"
                         for k, v in per_pixel.items()), flush=True)
    if not sass:
        print("  sass: cuobjdump not found, no opcode counts", flush=True)
    return per_pixel


def same_bits(torch, a, b) -> bool:
    """Equal NaN masks and equal values elsewhere."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def sweep_margins(torch, disp, s0, s1, step, minvar, dtype=None):
    """Plain-path (best, runner-up) sweep NXCORR per pixel, in ``dtype``
    (float32 by default); the runner-up is the best over the x whose
    interpolated series differs from the best x's."""
    from libbicos_tpu_torch import agree as ta

    dtype = dtype or torch.float32
    _, h, w = s0.shape
    w1 = s1.shape[2]
    _, _, col1c = ta._matched(disp, w, w1)
    s1i = s1.to(torch.int32)
    y0, y1, y2 = (ta._gather_cols(s1i, (col1c + k).clamp(0, w1 - 1)).float()
                  for k in (-1, 0, 1))
    pa = 0.5 * (y0 - 2.0 * y1 + y2)
    pb = 0.5 * (y2 - y0)
    diff0, var0 = ta._stats(s0.to(torch.int32).to(dtype))
    mod = 0xFFFF if s0.dtype == torch.uint16 else 0xFF

    def series(x):
        xf = torch.tensor(x, dtype=torch.float32, device=s0.device)
        v = torch.round(((pa * xf) * xf + pb * xf) + y1)
        it = (v.to(torch.int32) & mod).float()
        return it, ta._nxcorr_from(diff0, var0, it, minvar)

    xs = ta.subpixel_xgrid(step)
    best = torch.full((h, w), -1.0, dtype=dtype, device=s0.device)
    best_series = torch.zeros_like(y1)
    for x in xs:
        it, c = series(x)
        upd = best < c
        best = torch.where(upd, c, best)
        best_series = torch.where(upd[None], it, best_series)
    runner = torch.full((h, w), -float("inf"), dtype=dtype, device=s0.device)
    for x in xs:
        it, c = series(x)
        differs = (it != best_series).any(dim=0)
        runner = torch.where(differs & (c > runner), c, runner)
    return best, runner


# Largest |kernel - plain| seen per kernel over every comparison of the run.
ERRS = {k: 0.0 for k in KERNELS}


def note_err(name, got, want) -> None:
    diff = (got.long() - want.long()).abs()
    if diff.numel():
        ERRS[name] = max(ERRS[name], float(diff.max()))


def check_transform(torch, label, stacks, mode):
    from libbicos_tpu_torch import descriptor as td
    from libbicos_tpu_torch.kernels.transform import descriptor_words_cuda

    for s in stacks:
        got = descriptor_words_cuda(s, mode)
        want = td.descriptor_words(s, mode)
        note_err("transform", got, want)
        if not torch.equal(got, want):
            fail(f"{label}: transform words differ from plain in "
                 f"{int((got != want).sum())} words")


def check_scan(torch, label, w0, w1, drange=None):
    """Scan kernel vs plain; returns (first, last) and the plain ms."""
    from libbicos_tpu_torch import search as ts
    from libbicos_tpu_torch.kernels.hamming import row_minima_words

    fk, lk = row_minima_words(w0, w1, True, drange=drange)
    (_, fp, lp), ms = plain_timed(
        torch, lambda: ts.row_minima_torch_words(w0, w1, True,
                                                 drange=drange))
    note_err("hamming", fk, fp)
    note_err("hamming", lk, lp)
    if not (torch.equal(fk, fp) and torch.equal(lk, lp)):
        fail(f"{label}: scan first/last (range {drange}) differ from plain "
             f"in {int((fk != fp).sum() + (lk != lp).sum())} pixels")
    if drange is not None:
        print(f"  {label} scan range {drange}: "
              f"{int((fp < 0).sum())} pixels without a candidate",
              flush=True)
    return (fp, lp), ms


def check_consistency(torch, label, w0, w1, no_dupes, drange=None):
    """Consistency kernel vs plain, all four outputs (sentinels included);
    returns the plain (first0, last0, rc0, rc0_last) and the plain ms."""
    from libbicos_tpu_torch import search as ts
    from libbicos_tpu_torch.kernels.consistency import (
        row_minima_consistency_words,
    )

    (_, fk, lk), (_, rk, rlk) = row_minima_consistency_words(
        w0, w1, no_dupes=no_dupes, drange=drange)
    (fp, lp, rp, rlp), ms = plain_timed(
        torch, lambda: ts.row_minima_consistency_torch_words(
            w0, w1, no_dupes, drange))
    pairs = [(fk, fp), (rk, rp)]
    if no_dupes:
        pairs += [(lk, lp), (rlk, rlp)]
    elif lk is not None or rlk is not None:
        fail(f"{label}: consistency without no_dupes returned last values")
    bad = 0
    for got, want in pairs:
        note_err("consistency", got, want)
        bad += int((got != want).sum())
    if bad:
        fail(f"{label}: consistency (no_dupes={no_dupes}, range {drange}) "
             f"differs from plain in {bad} values")
    print(f"  {label} consistency no_dupes={no_dupes} range {drange}: "
          f"equal; {int((fp < 0).sum())} pixels without a forward "
          f"candidate", flush=True)
    return (fp, lp, rp, rlp), ms


def check_agree(torch, label, disp, s0, s1, thr, step, minvar,
                col_offset=0, double=False, window=None):
    """Agree kernel vs plain (corrmap error noted in ERRS); ``s1`` may be
    wider than ``s0`` (a left column band at ``col_offset``). ``double``:
    both in DOUBLE. ``window = (chunk, wcap, bases)``: the windowed kernel,
    also held to the global-read kernel bit for bit. Returns the kernel's
    (disparity, corrmap)."""
    from libbicos_tpu_torch import agree as ta
    from libbicos_tpu_torch.config import Precision
    from libbicos_tpu_torch.kernels.agree import agree_cuda

    prec = Precision.DOUBLE if double else Precision.SINGLE
    ok, ck = agree_cuda(disp, s0, s1, thr, step, minvar, col_offset,
                        precision=prec)
    if window is not None:
        chunk, wcap, bases = window
        wk = agree_cuda(disp, s0, s1, thr, step, minvar, precision=prec,
                        bases=bases, chunk=chunk, wcap=wcap)
        for got, want, what in zip(wk, (ok, ck), ("disparity", "corrmap")):
            if not same_bits(torch, got, want):
                fail(f"{label}: the windowed agree's {what} differs from "
                     f"the global-read agree's (chunk {chunk}, wcap {wcap})")
        ok, ck = wk
    if step is None:
        op, cp = ta.agree_integer(disp, s0, s1, thr, minvar, col_offset,
                                  prec)
        op = torch.where(op == ta.INVALID_I16,
                         torch.tensor(float("nan"), device=op.device),
                         op.float())
    else:
        op, cp = ta.agree_subpixel(disp, s0, s1, thr, step, minvar,
                                   col_offset, prec)
    if not torch.equal(torch.isnan(ck), torch.isnan(cp)):
        fail(f"{label}: corrmap NaN masks differ")
    m = ~torch.isnan(cp)
    err = (ck[m] - cp[m]).abs()
    # DOUBLE sums serially in f64 and rounds once to f32 on both sides, as
    # the JAX package's XLA agree does: it is held equal bit for bit.
    tol = 0.0 if double else TOL
    if bool((err > tol + tol * cp[m].abs()).any()):
        fail(f"{label}: corrmap off by up to {float(err.max())}")
    max_err = float(err.max()) if err.numel() else 0.0
    ERRS["agree"] = max(ERRS["agree"], max_err)
    differ = ~((torch.isnan(ok) & torch.isnan(op)) | (ok == op))
    ties = 0
    if double and bool(differ.any()):
        fail(f"{label}: {int(differ.sum())} DOUBLE disparities differ")
    if bool(differ.any()):
        # Only the rows with a difference need the sweep margins.
        rows = differ.any(dim=1).nonzero()[:, 0]
        excused = (cp[rows] - thr).abs() <= TOL
        if step is not None:
            best, runner = sweep_margins(
                torch, disp[rows], s0[:, rows], s1[:, rows], step, minvar,
                torch.float64 if double else torch.float32)
            excused |= (best - runner) <= TOL
        bad = differ[rows] & ~excused
        if bool(bad.any()):
            fail(f"{label}: {int(bad.sum())} disparities differ outside the "
                 f"tie rules (step={step}, thr={thr})")
        ties = int(excused.sum())
    kind = ("" if window is None else
            f" windowed (chunk {window[0]}, wcap {window[1]}; equal to the "
            f"global-read kernel bit for bit)") + (" DOUBLE" if double else "")
    print(f"  {label} agree{kind} step={step} thr={thr} minvar={minvar} "
          f"col_offset={col_offset} (w {s0.shape[2]} of {s1.shape[2]}): "
          f"{int(differ.sum())} disparities differ (each at a threshold or "
          f"sweep tie; {ties} tie pixels in their rows); corrmap max err "
          f"{max_err:.3g}", flush=True)
    return ok, ck


def check_bases(torch, label, disp, chunk, wcap):
    """Bases kernel vs plain, exactly; returns (bases, windowed share)."""
    from libbicos_tpu_torch import agree as ta
    from libbicos_tpu_torch.kernels.bases import chunk_window_bases_cuda

    w = disp.shape[1]
    wp = -(-w // chunk) * chunk
    got = chunk_window_bases_cuda(disp, w, wp, wcap, chunk)
    want = ta.chunk_window_bases(disp, w, wp, wcap, chunk)
    note_err("bases", got, want)
    if not torch.equal(got, want):
        fail(f"{label}: bases (chunk {chunk}, wcap {wcap}) differ from "
             f"plain in {int((got != want).sum())} chunks")
    share = float((got >= 0).float().mean())
    print(f"  {label} bases chunk={chunk} wcap={wcap}: equal; windowed "
          f"share {share:.6f} of {got.numel()} chunks", flush=True)
    return got, share


def mixed_disp(torch, disp):
    """``disp`` with, in every 4th row, every 97th column matched to column
    0: chunks that hold such a pixel and lie far to the right fall back."""
    d = disp.clone()
    cols = torch.arange(0, d.shape[1], 97, device=d.device)
    d[::4, cols] = cols.to(torch.int16)
    return d


def compare_window(torch, label, disp, s0, s1, steps):
    """The dynamic window and DOUBLE on one input: bases on ``disp`` and on
    a mixed field, the windowed agree on the mixed field, the DOUBLE agree
    on ``disp``."""
    from libbicos_tpu_torch.kernels.agree import resolve_chunk_wcap

    minvar = MIN_VARIANCE * s0.shape[0]
    mixed = mixed_disp(torch, disp)
    for chunk, wcap in WINDOWS:
        if not resolve_chunk_wcap(s0.shape[2], wcap, chunk)[1]:
            continue
        check_bases(torch, label, disp, chunk, wcap)
        bases, share = check_bases(torch, f"{label} mixed", mixed, chunk,
                                   wcap)
        if not 0 < share < 1:
            fail(f"{label}: the mixed field gives windowed share {share}")
        for step in steps:
            check_agree(torch, f"{label} mixed", mixed, s0, s1, THRESHOLD,
                        step, minvar, window=(chunk, wcap, bases))
    for step in steps:
        check_agree(torch, label, disp, s0, s1, THRESHOLD, step, minvar,
                    double=True)


def ring_steps(a, b, nbands, drange, every_visit=False):
    """Every kept (band, visit) step of a W-band ring over ``nbands``
    column bands of left words ``a`` and right words ``b``, in ring order:
    ``(j, left band, visiting band, off0, off1)``. ``every_visit`` keeps
    the visits that the range prunes as well."""
    from libbicos_tpu_torch import sharding

    mesh = sharding.make_mesh(nbands, virtual=True)
    a_b = sharding._bands(a, 1, mesh)
    b_b = sharding._bands(b, 1, mesh)
    band0, band = a_b[0].shape[1], b_b[0].shape[1]
    visits = (range(nbands) if every_visit
              else sharding.wband_ring_visits(nbands, band, drange))
    return [(j, a_b[j], b_b[(j + i) % nbands], j * band0,
             (j + i) % nbands * band)
            for i in visits for j in range(nbands)]


def ring_acc(torch, a, nbands, need_last):
    """Fresh ``(mf, ml)`` accumulators for the ``nbands`` left column bands
    of words ``a``."""
    from libbicos_tpu_torch import search as ts

    band0 = -(-a.shape[1] // nbands)
    acc = []
    for _ in range(nbands):
        mf = torch.full((a.shape[0], band0), ts.BIG, dtype=torch.int32,
                        device=a.device)
        acc.append((mf, mf.clone() if need_last else None))
    return acc


def run_steps(steps, acc, w1_total, drange, fold):
    for j, a_j, b_s, off0, off1 in steps:
        fold(a_j, b_s, off0, off1, *acc[j], w1_total=w1_total, drange=drange)


def check_band(torch, label, a, b, drange, need_last=True,
               every_visit=False):
    """The band kernel against its plain fold after every step of a
    ``NBANDS``-band ring; returns (steps, kernel acc, plain ms)."""
    from libbicos_tpu_torch import search as ts
    from libbicos_tpu_torch.kernels.band import row_minima_band

    steps = ring_steps(a, b, NBANDS, drange, every_visit)
    w1 = b.shape[1]
    got = ring_acc(torch, a, NBANDS, need_last)
    want = ring_acc(torch, a, NBANDS, need_last)
    plain_ms = 0.0
    for step in steps:
        run_steps([step], got, w1, drange, row_minima_band)
        _, ms = plain_timed(torch, lambda: run_steps(
            [step], want, w1, drange, ts.row_minima_band_torch_words))
        plain_ms += ms
        j = step[0]
        for g, x in zip(got[j], want[j]):
            if g is None:
                continue
            note_err("band", g, x)
            if not torch.equal(g, x):
                fail(f"{label}: band step (band {j}, offsets {step[3:]}, "
                     f"range {drange}) differs from plain in "
                     f"{int((g != x).sum())} pixels")
    first = torch.cat([ts.decode_minima(*acc, w1)[1] for acc in got],
                      1)[:, :a.shape[1]]
    print(f"  {label} band ring ({NBANDS} bands, {len(steps)} steps, range "
          f"{drange}, need_last={need_last}): equal after every step; "
          f"{int((first < 0).sum())} pixels without a candidate", flush=True)
    return steps, got, plain_ms


def cons_ring_acc(torch, a, nbands, need_last):
    """Fresh accumulators for a fused Consistency ring over ``nbands``
    column bands of words ``a``: ``(forward (mf, ml) per band, reverse
    (rf, rl))``, the reverse ones ``(H, nbands * band)``."""
    from libbicos_tpu_torch import search as ts

    band = -(-a.shape[1] // nbands)
    rf = torch.full((a.shape[0], nbands * band), ts.BIG, dtype=torch.int32,
                    device=a.device)
    return (ring_acc(torch, a, nbands, need_last),
            (rf, rf.clone() if need_last else None))


def run_cons_steps(steps, acc, w, drange, fold):
    fwd, (rf, rl) = acc
    for j, a_j, b_s, off0, off1 in steps:
        fold(a_j, b_s, off0, off1, *fwd[j], rf, rl, w_total=w, drange=drange)


def check_cons_band(torch, label, a, b, drange, need_last=True,
                    every_visit=False, nbands=NBANDS):
    """The fused Consistency ring step against its plain version after
    every step of an ``nbands``-band ring (``a``, ``b``: equal widths),
    forward and reverse accumulators; returns (steps, kernel acc, plain
    ms)."""
    from libbicos_tpu_torch import search as ts
    from libbicos_tpu_torch.kernels.band import row_minima_consistency_band

    steps = ring_steps(a, b, nbands, drange, every_visit)
    w = b.shape[1]
    got = cons_ring_acc(torch, a, nbands, need_last)
    want = cons_ring_acc(torch, a, nbands, need_last)
    plain_ms = 0.0
    for step in steps:
        run_cons_steps([step], got, w, drange, row_minima_consistency_band)
        _, ms = plain_timed(torch, lambda: run_cons_steps(
            [step], want, w, drange,
            ts.row_minima_consistency_band_torch_words))
        plain_ms += ms
        j = step[0]
        for g, x in zip(got[0][j] + got[1], want[0][j] + want[1]):
            if g is None:
                continue
            note_err("band_consistency", g, x)
            if not torch.equal(g, x):
                fail(f"{label}: fused Consistency step (band {j}, offsets "
                     f"{step[3:]}, range {drange}) differs from plain in "
                     f"{int((g != x).sum())} values")
    first = torch.cat([ts.decode_minima(*acc, w)[1] for acc in got[0]],
                      1)[:, :w]
    first1 = ts.decode_minima(got[1][0], None, w)[1][:, :w]
    print(f"  {label} fused Consistency ring ({nbands} bands, {len(steps)} "
          f"steps, range {drange}, need_last={need_last}): equal after every "
          f"step; {int((first < 0).sum())} left and {int((first1 < 0).sum())}"
          f" right pixels without a candidate", flush=True)
    return steps, got, plain_ms


def compare_case(torch, label, s0, s1, mode, steps):
    """Each kernel against its plain version on one input."""
    from libbicos_tpu_torch import descriptor as td
    from libbicos_tpu_torch import search as ts

    check_transform(torch, label, (s0, s1), mode)
    w0 = td.descriptor_words(s0, mode)
    w1 = td.descriptor_words(s1, mode)
    (first, last), _ = check_scan(torch, label, w0, w1)
    disp = ts._finish_nodupes(first, last, s0.shape[2])
    minvar = MIN_VARIANCE * s0.shape[0]
    for step in steps:
        for thr, mv in ((THRESHOLD, minvar), (-1.0, None)):
            check_agree(torch, label, disp, s0, s1, thr, step, mv)
    width = s0.shape[2]
    for drange in (DRANGE, (width + 100, width + 600)):  # the 2nd: none
        check_scan(torch, label, w0, w1, drange)
    for drange in (None, DRANGE):
        check_band(torch, label, w0, w1, drange)
    # No candidate: the ring would prune every visit, so run them all.
    check_band(torch, label, w0, w1, (width + 100, width + 600),
               every_visit=True)
    check_band(torch, label, w0, w1, None, need_last=False)
    for drange in (None, DRANGE):
        check_cons_band(torch, label, w0, w1, drange)
    check_cons_band(torch, label, w0, w1, (width + 100, width + 600),
                    every_visit=True)
    check_cons_band(torch, label, w0, w1, None, need_last=False)
    # A left column band against the whole right row, as the W-banded
    # agree runs it: band-local disparities and the band's column offset.
    off, band = width // NBANDS, -(-width // NBANDS)
    local = disp[:, off:off + band].to(torch.int32)
    d_shift = torch.where(local == ts.INVALID_I16, ts.INVALID_I16,
                          local - off).to(torch.int16).contiguous()
    for step in (steps[0], None):
        check_agree(torch, label, d_shift,
                    s0[:, :, off:off + band].contiguous(), s1, THRESHOLD,
                    step, minvar, col_offset=off)
    for no_dupes in (True, False):
        for drange in (None, DRANGE):
            check_consistency(torch, label, w0, w1, no_dupes, drange)
    compare_window(torch, label, disp, s0, s1, steps)


def call_case(torch, label, call, expect, truth, dtype=None):
    """One full-size call ``call(backend)`` -> (disparity, corrmap) through
    the kernels: launches (set to 0 just before, read just after), two-run
    determinism, valid share, time. The disparity must be ``dtype``
    (float32 by default; int16, with -32768 invalid, where the call has no
    subpixel step). Returns (results, disparity as float32 with NaN
    invalid, corrmap)."""
    from libbicos_tpu_torch import search as ts
    from libbicos_tpu_torch.kernels import _build

    dtype = dtype or torch.float32

    def as_float(d):
        if d.dtype != torch.int16:
            return d
        return torch.where(d == ts.INVALID_I16, float("nan"), d.float())

    _build.reset_launch_counts()
    d1, c1 = call("cuda")
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    if launches != expect:
        fail(f"call {label} launched {launches}, expected {expect}")
    d2, c2 = call("cuda")
    if d1.dtype != dtype:
        fail(f"call {label} disparity is {d1.dtype}, expected {dtype}")
    d1, d2 = as_float(d1), as_float(d2)
    for a, b, what in ((d1, d2, "disparity"), (c1, c2, "corrmap")):
        if not (torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))):
            fail(f"two runs of call {label} gave different {what}")
    h, w = truth.shape
    if d1.shape != (h, w):
        fail(f"call {label} disparity is {tuple(d1.shape)}")
    valid = ~torch.isnan(d1)
    if not bool(torch.isfinite(d1[valid]).all()):
        fail(f"call {label}: valid disparities are not finite")
    share = float(valid.float().mean())
    if share <= 0:
        fail(f"call {label}: no valid pixel")
    near = float(((d1 - truth.float()).abs() <= 1.0)[valid].float().mean())
    print(f"call {label}: valid share {share:.6f}, valid pixels within 1 px "
          f"of the synthetic truth {near:.6f}, launches {launches}, two "
          f"runs identical", flush=True)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(torch, lambda: call("cuda"))
    peak = torch.cuda.max_memory_allocated()
    plain_ms = time_ms(torch, lambda: call("torch"), reps=1, warm=0)
    return ({"launches": launches, "valid_share": share,
             "within_1px_of_truth": near, "ms": ms, "plain_ms": plain_ms,
             "stacks_per_s": 1000.0 / ms, "peak_bytes": peak,
             "call_peak_bytes": peak - held}, d1, c1)


def write_png_gray8(path: Path, img) -> None:
    """An 8-bit grayscale PNG of a ``(H, W)`` uint8 array: filter Up on
    every row, stored (level-0) deflate blocks."""
    import struct
    import zlib

    import numpy as np

    h, w = img.shape
    up = np.diff(img, axis=0, prepend=np.zeros((1, w), np.uint8))
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up.astype(np.uint8)],
                         axis=1)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0,
                                                  0, 0))
                     + chunk(b"IDAT", zlib.compress(raw.tobytes(), 0))
                     + chunk(b"IEND", b""))


def read_tiff(path: Path):
    """A single-channel TIFF: cv2 where it imports, else the uncompressed
    little-endian layout that ``libbicos_tpu_torch.io`` writes without
    it (int16 or float32, strips in order)."""
    import struct

    import numpy as np

    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if img is None:
            fail(f"cv2 cannot read {path}")
        return img
    data = path.read_bytes()
    if data[:4] != b"II*\x00":
        fail(f"{path}: not a little-endian TIFF")
    (ifd,) = struct.unpack("<I", data[4:8])
    (count,) = struct.unpack("<H", data[ifd:ifd + 2])
    tags = {}
    for i in range(count):
        tag, typ, n, value = struct.unpack(
            "<HHII", data[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        tags[tag] = value & 0xFFFF if typ == 3 else value
    if tags.get(259, 1) != 1 or tags.get(277, 1) != 1 or tags[273] == 0:
        fail(f"{path}: not an uncompressed one-strip single-channel TIFF")
    dtype = {(16, 2): "<i2", (32, 3): "<f4"}[(tags[258], tags.get(339, 1))]
    w, h = tags[256], tags[257]
    return np.frombuffer(data, dtype=dtype, count=w * h,
                         offset=tags[273]).reshape(h, w).astype(dtype[1:])


def write_q_yaml(path: Path, q) -> None:
    """A 4x4 ``Q`` in the ``!!opencv-matrix`` YAML of ``cv::FileStorage``."""
    vals = ", ".join(repr(float(v)) for v in q.reshape(-1))
    path.write_text("%YAML:1.0\n---\nQ: !!opencv-matrix\n   rows: 4\n"
                    f"   cols: 4\n   dt: d\n   data: [ {vals} ]\n")


def repo_env() -> dict:
    """This process's environment with the checkout first on PYTHONPATH."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def run_cli(folder: Path, args, label: str) -> tuple:
    """``python -m libbicos_tpu_torch.cli folder args`` in a process of its
    own; returns its stdout and its seconds, fails the run unless it exits
    0."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "libbicos_tpu_torch.cli", str(folder), *args],
        cwd=REPO, env=repo_env(), capture_output=True, text=True,
        timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"CLI {label} exited {proc.returncode}:\n{proc.stdout[-2000:]}"
             f"\n{proc.stderr[-3000:]}")
    print(f"  CLI {label}: exit 0 in {secs:.3f} s "
          "(process start, loading and saving included)", flush=True)
    return proc.stdout, secs


def write_stack_folder(folder: Path, s0, s1) -> None:
    folder.mkdir(parents=True)
    for i in range(s0.shape[0]):
        write_png_gray8(folder / f"{i}_left.png", s0[i])
        write_png_gray8(folder / f"{i}_right.png", s1[i])


# The reprojection matrix of phase 5's .xyz cases: z = 500 / (0.1 d) > 0
# for every positive disparity.
SMOKE_Q = ((1, 0, 0, -128.0), (0, 1, 0, -24.0), (0, 0, 0, 500.0),
           (0, 0, 1 / 0.1, 0))
HEADLINE_ARGS = ("-t", str(THRESHOLD), "--limited", "-v", str(MIN_VARIANCE),
                 "-s", str(STEP), "--corrmap")

# Cell K's steps in a fresh process, in the CLI's order (``cli._run``):
# argv: folder, output stem. Prints one JSON object of seconds per step.
K_STEPS = """
import time
started = time.time()
import json, sys
t = {}
tick = time.perf_counter()
import torch
t["import torch"] = time.perf_counter() - tick
tick = time.perf_counter()
import libbicos_tpu_torch
from libbicos_tpu_torch import cli, io, pipeline
t["import libbicos_tpu_torch (after torch)"] = time.perf_counter() - tick
folder, stem = sys.argv[1], sys.argv[2]
cfg = cli.config_from_args(cli.build_parser().parse_args(
    [folder, *sys.argv[3:]]))
tick = time.perf_counter()
l, r = io.load_stack_pair(folder)
t["load_stack_pair"] = time.perf_counter() - tick
tick = time.perf_counter()
from libbicos_tpu_torch.kernels import _build
_build.library()
t["kernel library (load, build cached)"] = time.perf_counter() - tick
dev = pipeline.resolve_device(None)
tick = time.perf_counter()
ld = torch.from_numpy(l).to(dev)
rd = torch.from_numpy(r).to(dev)
torch.cuda.synchronize(dev)
t["upload (CUDA context included)"] = time.perf_counter() - tick
tick = time.perf_counter()
disp, corr = pipeline.match(ld, rd, cfg, corrmap=True, device=dev)
torch.cuda.synchronize(dev)
t["first match"] = time.perf_counter() - tick
tick = time.perf_counter()
disp, corr = disp.cpu().numpy(), corr.cpu().numpy()
t["download"] = time.perf_counter() - tick
tick = time.perf_counter()
io.save_image(disp, stem + ".png")
t["save_image disparity"] = time.perf_counter() - tick
tick = time.perf_counter()
io.save_image(corr, stem + "-corrmap.png", colormap="viridis")
t["save_image corrmap"] = time.perf_counter() - tick
print(json.dumps({"steps": t, "started": started, "ended": time.time()}))
"""


def png_filter_counts(path: Path) -> list:
    """Rows of each PNG filter type (None, Sub, Up, Average, Paeth) in an
    8-bit grayscale PNG."""
    import struct
    import zlib

    import numpy as np

    data, pos, idat, w = path.read_bytes(), 8, [], None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            (w,) = struct.unpack(">I", data[pos + 8:pos + 12])
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return np.bincount(raw.reshape(-1, w + 1)[:, 0], minlength=5).tolist()


def best_of(n: int, fn) -> tuple:
    """``(result of the last run, least seconds)`` of ``n`` runs of
    ``fn()``."""
    best = None
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        secs = time.perf_counter() - t0
        best = secs if best is None else min(best, secs)
    return out, best


def native_phase(torch, s0n, s1n, want_a, work: Path, card) -> dict:
    """Phase 5 (a)-(c): the native library loads; the headline stacks,
    written by ``cv2.imwrite`` at its default PNG settings into
    ``work/headline`` (cell K's input), decode equal to the stacks through
    ``native.decode_stack`` and through the per-file path; call A's
    disparity, reprojected with ``SMOKE_Q``, gives the same ``.xyz`` bytes
    through the native and the Python writer. Each timed."""
    import contextlib
    import filecmp
    import io as _stdio
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    try:
        import cv2
    except ImportError:
        fail("phase 5: cv2 does not import; the scanner folder is cv2's")
    from libbicos_tpu_torch import io as tio
    from libbicos_tpu_torch import native

    # Built here from the checkout's source, whatever _build/ holds.
    t0 = time.perf_counter()
    built = native.build(force=True)
    build_s = time.perf_counter() - t0
    if built is None or native.get() is None:
        fail("phase 5: the native library (libbicos_tpu_torch/native/"
             "fastio.cpp) did not build or load")
    print(f"  native: {built.relative_to(REPO)} built by g++ from "
          f"libbicos_tpu_torch/native/fastio.cpp (zlib, no libpng) in "
          f"{build_s:.3f} s and loaded ({card})", flush=True)

    folder = work / "headline"
    folder.mkdir(parents=True)
    n = s0n.shape[0]
    jobs = [(folder / f"{i}_{side}.png", s[i]) for i in range(n)
            for side, s in (("left", s0n), ("right", s1n))]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        if not all(pool.map(lambda job: cv2.imwrite(str(job[0]), job[1]),
                            jobs)):
            fail("phase 5: cv2.imwrite failed")
    filters = png_filter_counts(folder / "0_left.png")
    disk = sum(p.stat().st_size for p, _ in jobs)
    print(f"  scanner folder: {len(jobs)} PNGs written by cv2 "
          f"{cv2.__version__} at its default settings in "
          f"{time.perf_counter() - t0:.3f} s ({disk / 1e6:.1f} MB on disk); "
          f"rows of filter None/Sub/Up/Average/Paeth in 0_left.png: "
          f"{filters}", flush=True)

    left = [folder / f"{i}_left.png" for i in range(n)]
    right = [folder / f"{i}_right.png" for i in range(n)]
    threads = native.threads_for(n)
    (nl, nr), native_s = best_of(3, lambda: (native.decode_stack(left),
                                             native.decode_stack(right)))
    (pl, pr), plain_s = best_of(3, lambda: tuple(
        np.stack([tio._imread_gray_anydepth(p) for p in ps])
        for ps in (left, right)))
    if nl is None or nr is None:
        fail("phase 5: native.decode_stack refused the cv2-written folder")
    for got, want, what in ((nl, s0n, "left"), (nr, s1n, "right"),
                            (pl, s0n, "left"), (pr, s1n, "right")):
        if got.dtype != want.dtype or not np.array_equal(got, want):
            fail(f"phase 5: a decoded {what} stack differs from the input")
    pixels = s0n.nbytes + s1n.nbytes
    print(f"  decode of the {len(jobs)} PNGs ({pixels / 1e6:.1f} MB of "
          f"pixels), best of 3: native.decode_stack {native_s:.3f} s on "
          f"{threads} threads ({pixels / 1e6 / native_s:.0f} MB/s), per-file "
          f"cv2.imread {plain_s:.3f} s ({pixels / 1e6 / plain_s:.0f} MB/s); "
          f"both equal to the stacks ({card})", flush=True)

    disp = want_a[0].cpu().numpy()
    points = tio.reproject_image_to_3d(disp, np.array(SMOKE_Q))
    times, counts = {}, {}
    for path in ("native", "python"):
        if path == "python":
            os.environ["BICOS_NO_NATIVE"] = "1"
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(_stdio.StringIO()):
                counts[path] = tio.save_pointcloud(points, disp,
                                                   work / f"{path}.xyz")
            times[path] = time.perf_counter() - t0
        finally:
            os.environ.pop("BICOS_NO_NATIVE", None)
    expect = int((~np.isnan(disp) & (disp > 0)).sum())
    if not (counts["native"] == counts["python"] == expect and filecmp.cmp(
            work / "native.xyz", work / "python.xyz", shallow=False)):
        fail(f"phase 5: the .xyz writers differ: {counts}, expected {expect}"
             " points, byte-equal files")
    size = (work / "native.xyz").stat().st_size
    for path in ("native", "python"):
        (work / f"{path}.xyz").unlink()
    print(f"  .xyz of call A's disparity ({expect} points, {size / 1e6:.1f} "
          f"MB): save_pointcloud with the native writer {times['native']:.3f}"
          f" s, with the Python writer (BICOS_NO_NATIVE=1) "
          f"{times['python']:.3f} s; byte-equal ({card})", flush=True)
    return {"build_s": build_s, "threads": threads, "pixel_bytes": pixels,
            "decode_native_s": native_s, "decode_per_file_s": plain_s,
            "png_filters_0_left": filters, "xyz_points": expect,
            "xyz_native_s": times["native"], "xyz_python_s": times["python"]}


def k_steps(folder: Path, stem: Path, k_secs: float, card) -> dict:
    """Phase 5 (d): cell K's steps, timed in the CLI's order in a fresh
    process (twice, to show their spread), against the CLI's own process
    seconds ``k_secs``; each process's start-up (spawn to its first line)
    and exit (its last line to its end) from the wall clock."""
    runs = []
    for _ in range(2):
        spawned = time.time()
        proc = subprocess.run(
            [sys.executable, "-c", K_STEPS, str(folder), str(stem),
             *HEADLINE_ARGS], cwd=REPO, env=repo_env(), capture_output=True,
            text=True, timeout=600)
        done = time.time()
        if proc.returncode != 0:
            fail(f"phase 5: the K step timing exited {proc.returncode}:\n"
                 f"{proc.stderr[-3000:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"steps_s": out["steps"], "wall_s": done - spawned,
                     "start_s": out["started"] - spawned,
                     "exit_s": done - out["ended"]})
    print(f"  K, attributed: the CLI's process took {k_secs:.3f} s; its "
          "steps in its order, in two fresh processes:", flush=True)
    for name in runs[0]["steps_s"]:
        print(f"    {name}: " + ", ".join(f"{r['steps_s'][name]:.3f}"
                                          for r in runs) + " s", flush=True)
    for what in ("start", "exit"):
        print(f"    process {what}: " + ", ".join(
            f"{r[what + '_s']:.3f}" for r in runs) + " s", flush=True)
    for r in runs:
        r["sum_s"] = sum(r["steps_s"].values())
        r["rest_s"] = r["wall_s"] - r["sum_s"] - r["start_s"] - r["exit_s"]
    print("    sum of the steps " + ", ".join(f"{r['sum_s']:.3f}"
                                              for r in runs)
          + " s; each process's wall " + ", ".join(
              f"{r['wall_s']:.3f}" for r in runs)
          + " s, outside its steps, start and exit " + ", ".join(
              f"{r['rest_s']:.3f}" for r in runs) + " s", flush=True)
    first = runs[0]
    unexplained = k_secs - first["sum_s"] - first["start_s"] - first["exit_s"]
    print(f"    left unexplained in K (less the first run's steps, start "
          f"and exit): {unexplained:.3f} s ({card})", flush=True)
    return {"k_process_s": k_secs, "runs": runs,
            "unexplained_s": unexplained}


def cli_phase(torch, s0n, s1n, want_a, card) -> dict:
    """The native layer and the CLI at the headline size on a scanner's
    folder (cv2-written PNGs), the CLI equal to call A and its process time
    attributed step by step; two small cases (``-q`` and ``-m 1
    --no-dupes``) equal to their in-process calls."""
    import shutil

    import numpy as np

    import libbicos_tpu_torch as bicos
    from libbicos_tpu_torch.io import synthetic_stack_pair

    work = REPO / "_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        native_info = native_phase(torch, s0n, s1n, want_a, work, card)
        out, k_secs = run_cli(work / "headline", [
            *HEADLINE_ARGS, "-o", str(work / "disp.png")], "headline")
        latency = next((line for line in out.splitlines()
                        if line.startswith("Latency")), None)
        if latency is None:
            fail("the CLI printed no latency line")
        print(f"  CLI headline: {latency.strip()} ({card})", flush=True)
        disp = torch.from_numpy(read_tiff(work / "disp.tiff"))
        corr = torch.from_numpy(read_tiff(work / "disp-corrmap.tiff"))
        want_d, want_c = (x.cpu() for x in want_a)
        if disp.dtype != torch.float32 or not same_bits(torch, disp, want_d):
            fail("the CLI's disparity TIFF differs from call A's disparity")
        m = ~torch.isnan(want_c)
        if not torch.equal(torch.isnan(corr), ~m) or bool(
                ((corr[m] - want_c[m]).abs() > TOL + TOL * want_c[m].abs())
                .any()):
            fail("the CLI's corrmap TIFF is not within 4e-6 of call A's")
        print("  CLI headline: disparity TIFF equal to call A bit for bit "
              "(NaN mask included), corrmap within 4e-6", flush=True)
        k = k_steps(work / "headline", work / "steps", k_secs, card)

        x0, x1, _ = synthetic_stack_pair(9, 48, 256, seed=17)
        write_stack_folder(work / "small", x0, x1)
        write_q_yaml(work / "Q.yaml", np.array(SMOKE_Q))
        run_cli(work / "small", ["-t", "0.5", "--limited", "-s", "0.25",
                                 "-q", str(work / "Q.yaml"), "-o",
                                 str(work / "q.png")], "-q")
        dq = read_tiff(work / "q.tiff")
        want = bicos.match(x0, x1, bicos.Config(
            nxcorr_threshold=0.5, subpixel_step=0.25), backend="cuda").cpu()
        if not same_bits(torch, torch.from_numpy(dq), want):
            fail("the CLI's -q disparity differs from match's")
        # cv::reprojectImageTo3D with SMOKE_Q: z > 0 for the valid pixels of
        # positive disparity.
        lines = (work / "q.xyz").read_text().splitlines()
        valid = ~np.isnan(dq)
        expect = int((valid & (dq > 0)).sum())
        if len(lines) != expect or any(len(ln.split()) != 3
                                       for ln in lines[:100]):
            fail(f"the CLI's .xyz has {len(lines)} lines, expected {expect}")
        run_cli(work / "small", ["-m", "1", "--no-dupes", "-o",
                                 str(work / "m.png")], "-m 1 --no-dupes")
        dm = read_tiff(work / "m.tiff")
        want = bicos.match(x0, x1, bicos.Config(
            nxcorr_threshold=0.75, mode=bicos.TransformMode.FULL,
            variant=bicos.Consistency(1, True)), backend="cuda").cpu()
        if dm.dtype != np.int16 or not torch.equal(torch.from_numpy(dm),
                                                   want):
            fail("the CLI's -m 1 --no-dupes disparity differs from match's")
        print(f"  CLI small cases (n=9 48x256): -q wrote {len(lines)} points "
              "and its disparity equals match's; -m 1 --no-dupes (FULL, "
              "threshold 0.75) equals match's", flush=True)
        return {"latency_line": latency.strip(), "xyz_points": len(lines),
                "native": native_info, "k": k}
    finally:
        shutil.rmtree(work, ignore_errors=True)


SERVE_PHASES = ("encode", "server_read", "server_load", "server_upload",
                "server_match", "server_download", "server_reply", "decode")


def serve_phase(torch, s0n, s1n, cfgs, want, card) -> dict:
    """Phase 6: the port's daemon on the card, through its client. ``want``:
    label -> (disparity, corrmap) of calls A, B, C and H. Returns the
    launch counts and times of the served requests, by cell."""
    import threading

    import numpy as np

    from libbicos_tpu_torch import sharding
    from libbicos_tpu_torch.client import BicosClient
    from libbicos_tpu_torch.io import synthetic_stack_pair
    from libbicos_tpu_torch.kernels import _build
    from libbicos_tpu_torch.pipeline import match_batched_folded
    from libbicos_tpu_torch.serve import Engine, serve

    dev = torch.device("cuda", 0)

    def start(engine, warmup=()):
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        ready = threading.Event()
        threading.Thread(target=serve, args=(engine, "127.0.0.1", port),
                         kwargs={"warmup_shapes": warmup,
                                 "ready_event": ready},
                         daemon=True).start()
        if not ready.wait(600):
            fail("phase 6: the daemon did not start")
        return BicosClient(f"http://127.0.0.1:{port}", timeout=600)

    def held(label, got, ref):
        for g, r, what in zip(got, ref, ("disparity", "corrmap")):
            if not same_bits(torch, torch.from_numpy(g), r.cpu()):
                fail(f"phase 6: {label}: the served {what} differs")

    def split(timing) -> str:
        return ", ".join(f"{k} {timing[k]:.3f}" for k in SERVE_PHASES)

    out = {}
    path = dict.fromkeys(_build.LAUNCHES, 0)
    nodup = {**path, "transform": 2, "hamming": 1, "hamming_mma": 1,
             "agree": 1, "agree_packed": 1}
    engine = Engine(cfgs["A"], device=dev)
    t0 = time.perf_counter()
    client = start(engine, [(s0n.shape, "uint8")])
    warm_s = time.perf_counter() - t0
    health = client.healthz()
    if health != {"status": "ok", "compiled": 1}:
        fail(f"phase 6: /healthz after the warmup says {health}")
    print(f"phase 6: daemon on {dev}, warmup {s0n.shape} u8 in {warm_s:.3f} "
          f"s (kernel library, CUDA context, random pair, one match) "
          f"({card})", flush=True)

    # Cell L: headline requests, the first after the warmup and 3 more.
    _build.reset_launch_counts()
    timings = []
    for k in range(4):
        t0 = time.perf_counter()
        got = client.match(s0n, s1n, corrmap=True)
        wall = (time.perf_counter() - t0) * 1e3
        timings.append({**client.last_timing, "wall": wall})
        held(f"headline request {k}", got, want["A"])
    launches = _build.launch_counts()
    if launches != {k: 4 * v for k, v in nodup.items()}:
        fail(f"phase 6: 4 headline requests launched {launches}")
    med = {k: statistics.median(t[k] for t in timings[1:])
           for k in timings[0]}
    for tag, t in (("first", timings[0]), ("median of 3 more", med)):
        print(f"  L headline /match?corrmap=1, {tag}: {t['wall']:.3f} ms "
              f"wall, request {t['request']:.3f}: {split(t)} ({card})",
              flush=True)
    out["L"] = {"launches": launches, "warmup_s": warm_s,
                "first_ms": timings[0], "median_ms": med,
                "equals": "A"}

    # Cell M: a batched request of two full-size pairs.
    t1n, t2n, _ = synthetic_stack_pair(*s0n.shape, seed=0x5EED)
    b0, b1 = np.stack([s0n, t1n]), np.stack([s1n, t2n])
    del t1n, t2n
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    got = client.match(b0, b1, corrmap=True)
    wall = (time.perf_counter() - t0) * 1e3
    timing = {**client.last_timing, "wall": wall}
    launches = _build.launch_counts()
    if launches != nodup:
        fail(f"phase 6: the batched request launched {launches}")
    want_b = match_batched_folded(*(sharding.fold_host(b) for b in (b0, b1)),
                                  2, cfgs["A"], corrmap=True, device=dev)
    held("batched request", got, want_b)
    held("batched request, first pair", (got[0][0], got[1][0]), want["A"])
    del b0, b1, want_b
    print(f"  M batched {(2, *s0n.shape)} /match?corrmap=1: {wall:.3f} ms "
          f"wall, request {timing['request']:.3f}: {split(timing)}; equal "
          f"to match_batched_folded in process, its first pair to call A "
          f"({card})", flush=True)
    out["M"] = {"launches": launches, "ms": timing,
                "equals": "match_batched_folded"}

    # Consistency and the range, from the same daemon.
    cons = {**path, "transform": 2, "consistency": 1, "agree": 1,
            "agree_packed": 1}
    for label, params, ref, expect in (
            ("B", {"lr_maxdiff": 1, "no_dupes": 1}, "B", cons),
            ("C", {"disp_range": f"{DRANGE[0]}:{DRANGE[1]}"}, "C",
             {**nodup, "hamming_mma": 0})):
        _build.reset_launch_counts()
        got = client.match(s0n, s1n, corrmap=True, **params)
        launches = _build.launch_counts()
        if launches != expect:
            fail(f"phase 6: the request {params} launched {launches}")
        held(f"request {params}", got, want[ref])
        out[f"served {label}"] = {"launches": launches, "equals": ref,
                                  "ms": client.last_timing}
        query = "&".join(f"{k}={v}" for k, v in params.items())
        print(f"  /match?corrmap=1&{query} equals call {ref}: "
              f"{split(client.last_timing)} ({card})", flush=True)

    # An Engine on 4 row bands of the one card.
    mesh = sharding.make_mesh(NBANDS, virtual=True, device=dev)
    mclient = start(Engine(cfgs["A"], mesh=mesh))
    _build.reset_launch_counts()
    got = mclient.match(s0n, s1n, corrmap=True)
    launches = _build.launch_counts()
    want_l = {**path, "transform": 2 * NBANDS, "hamming": NBANDS,
              "hamming_mma": NBANDS, "agree": NBANDS, "agree_packed": NBANDS}
    if launches != want_l:
        fail(f"phase 6: the 4-band engine launched {launches}")
    held("4-band engine", got, want["H"])
    out["served H"] = {"launches": launches, "equals": "H",
                       "ms": mclient.last_timing}
    print(f"  4-band engine (make_mesh(4, virtual=True)) equals call H: "
          f"{split(mclient.last_timing)} ({card})", flush=True)
    return out


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on the GPU")
    if not (REPO / "libbicos_tpu_torch" / "csrc").is_dir():
        fail(f"libbicos_tpu_torch/csrc not found beside {__file__}")
    sys.path.insert(0, str(REPO))
    import numpy as np

    import libbicos_tpu_torch as bicos
    from libbicos_tpu_torch import agree as ta
    from libbicos_tpu_torch import descriptor as td
    from libbicos_tpu_torch import search as ts
    from libbicos_tpu_torch.io import synthetic_stack_pair
    from libbicos_tpu_torch.kernels import _build
    from libbicos_tpu_torch.kernels.agree import agree_cuda
    from libbicos_tpu_torch.kernels.consistency import (
        row_minima_consistency_words,
    )
    from libbicos_tpu_torch.kernels.hamming import row_minima_words
    from libbicos_tpu_torch.kernels.transform import descriptor_words_cuda

    if "jax" in sys.modules or "libbicos_tpu" in sys.modules:
        fail("the port pulled in jax or the JAX package")

    # Phase 1: card, versions, build.
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    fresh = not _build.library_path().exists()
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel library: {_build.library_path().name}, "
          f"{'built' if fresh else 'found'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    full_per_pixel = build_report(_build.library_path())
    dev = torch.device("cuda", 0)

    # Phase 2: each kernel against its plain version.
    n, h, w = HEADLINE
    mode = bicos.TransformMode.LIMITED
    t0 = time.perf_counter()
    s0n, s1n, truth = synthetic_stack_pair(n, h, w)
    print(f"headline input made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    s0 = torch.from_numpy(s0n).to(dev)
    s1 = torch.from_numpy(s1n).to(dev)
    truth = torch.from_numpy(truth).to(dev)
    band = slice(1000, 1064)
    compare_case(
        torch, "band n=33 64x3300 u8 LIMITED", s0[:, band].contiguous(),
        s1[:, band].contiguous(), mode, (STEP, None))
    r0, r1, _ = synthetic_stack_pair(9, 7, 1001, dtype=np.uint16, seed=7)
    compare_case(
        torch, "ragged n=9 7x1001 u16 FULL", torch.from_numpy(r0).to(dev),
        torch.from_numpy(r1).to(dev), bicos.TransformMode.FULL,
        (STEP, 0.25, None))
    u0, u1, _ = synthetic_stack_pair(9, 2, 40000, seed=5)
    wu0 = td.descriptor_words(torch.from_numpy(u0).to(dev), mode)
    wu1 = td.descriptor_words(torch.from_numpy(u1).to(dev), mode)
    for no_dupes in (True, False):
        check_consistency(torch, "wide n=9 2x40000 u8 LIMITED", wu0, wu1,
                          no_dupes)
    for label, (nn, hh, ww) in (("n=3 16x3300 u8 LIMITED", (3, 16, 3300)),
                                ("wide n=9 2x20000 u8 LIMITED",
                                 (9, 2, 20000))):
        x0, x1, _ = synthetic_stack_pair(nn, hh, ww, seed=5)
        xw0, xw1 = (td.descriptor_words(torch.from_numpy(x).to(dev), mode)
                    for x in (x0, x1))
        for drange in (None, DRANGE):
            check_band(torch, label, xw0, xw1, drange)
            check_cons_band(torch, label, xw0, xw1, drange)
    # A 1-band ring at the widest packable row: the fused step's reverse
    # minima (262 KB) go to the accumulators with global atomics.
    x0, x1, _ = synthetic_stack_pair(9, 1, 32767, seed=5)
    xw0, xw1 = (td.descriptor_words(torch.from_numpy(x).to(dev), mode)
                for x in (x0, x1))
    for drange in (None, DRANGE):
        check_cons_band(torch, "wide n=9 1x32767 u8 LIMITED", xw0, xw1,
                        drange, nbands=1)
    # The window's largest block: n=65 u16 at wcap 1024 stages 133,380
    # bytes of shared memory (the opt-in limit).
    x0, x1 = (torch.from_numpy(x).to(dev) for x in synthetic_stack_pair(
        65, 16, 1412, dtype=np.uint16, seed=3)[:2])
    compare_window(torch, "n=65 16x1412 u16 LIMITED",
                   ts.search_stack(x0, x1, mode, bicos.NoDuplicates(),
                                   "torch"), x0, x1, (STEP, None))
    torch.cuda.synchronize()
    print("phase 2: every kernel agrees with its plain version", flush=True)

    # Phase 3: five calls at full size, each with the kernels of its path.
    check_transform(torch, "headline", (s0, s1), mode)
    # full16's stacks: the first 16 shots, n=16 u8 FULL (8 words a pixel).
    full_mode = bicos.TransformMode.FULL
    k0, k1 = s0[:16].contiguous(), s1[:16].contiguous()
    check_transform(torch, "n=16 2200x3300 u8 FULL", (k0, k1), full_mode)
    w0 = descriptor_words_cuda(s0, mode)
    w1 = descriptor_words_cuda(s1, mode)
    stacks = {mode: (s0, s1, w0, w1),
              full_mode: (k0, k1, descriptor_words_cuda(k0, full_mode),
                          descriptor_words_cuda(k1, full_mode))}
    mv = MIN_VARIANCE * n
    nx = len(ta.subpixel_xgrid(STEP))
    # Launches per call; "hamming_mma": the scan launches that took the
    # tensor-core scan (every unranged one); "agree_packed": the agree
    # launches that took the packed sweep (every subpixel call here, not N's
    # integer agree); "agree_double": those in float64 (J's alone, below).
    path = dict.fromkeys(_build.LAUNCHES, 0)
    nodup_path = {**path, "transform": 2, "hamming": 1, "hamming_mma": 1,
                  "agree": 1, "agree_packed": 1}
    cons_path = {**path, "transform": 2, "consistency": 1, "agree": 1,
                 "agree_packed": 1}

    def headline(variant, drange):
        return bicos.Config(nxcorr_threshold=THRESHOLD, subpixel_step=STEP,
                            min_variance=MIN_VARIANCE, mode=mode,
                            variant=variant, disparity_range=drange)

    calls = {
        "A": (headline(bicos.NoDuplicates(), None), nodup_path),
        "B": (headline(bicos.Consistency(1, True), None), cons_path),
        "C": (headline(bicos.NoDuplicates(), DRANGE),
              {**nodup_path, "hamming_mma": 0}),
        "D": (headline(bicos.Consistency(1, True), DRANGE), cons_path),
        # full16's configuration (portbench/configs/full16.json): the
        # 8-word scan and the integer agree.
        "N": (bicos.Config(nxcorr_threshold=0.9, mode=full_mode),
              {**nodup_path, "agree_packed": 0}),
    }
    results, scans, single, search_disp, cfgs = {}, {}, {}, {}, {}
    for label, (cfg, expect) in calls.items():
        variant, drange = cfg.variant, cfg.disparity_range
        thr, step = cfg.nxcorr_threshold, cfg.subpixel_step
        a, b, wa, wb = stacks[cfg.mode]
        amv = None if cfg.min_variance is None else cfg.min_variance * len(a)
        cfgs[label] = cfg
        res, d1, c1 = call_case(
            torch, label,
            lambda backend, a=a, b=b, cfg=cfg: bicos.match(
                a, b, cfg, corrmap=True, backend=backend),
            expect, truth, None if step else torch.int16)
        single[label] = (d1, c1)
        # The call's scan kernel against its plain version at its shapes.
        if isinstance(variant, bicos.NoDuplicates):
            kname = "hamming"
            (first, last), plain_ms = check_scan(torch, f"call {label}", wa,
                                                 wb, drange)
            disp = ts._finish_nodupes(first, last, w)
            kms = time_ms(torch, lambda: row_minima_words(
                wa, wb, True, drange=drange))
        else:
            kname = "consistency"
            out, plain_ms = check_consistency(torch, f"call {label}", wa, wb,
                                              True, drange)
            disp = ts._finish_gathered(variant, *out)
            kms = time_ms(torch, lambda: row_minima_consistency_words(
                wa, wb, no_dupes=True, drange=drange))
        if not torch.equal(ts.search_stack(a, b, cfg.mode, variant, "cuda",
                                           drange=drange), disp):
            fail(f"call {label}: the kernels' search disparity differs "
                 "from the plain scan's")
        check_agree(torch, f"call {label}", disp, a, b, thr, step, amv)
        ams = time_ms(torch, lambda: agree_cuda(disp, a, b, thr, step, amv))
        if step is None:
            aplain = time_ms(torch, lambda: ta.agree_integer(
                disp, a, b, thr, amv), reps=1, warm=0)
        else:
            aplain = time_ms(torch, lambda: ta.agree_subpixel(
                disp, a, b, thr, step, amv), reps=1, warm=0)
        anx = len(ta.subpixel_xgrid(step)) if step else 0
        scans[label] = (kname, kms, plain_ms)
        res.update(variant=repr(variant), mode=cfg.mode.name, n=len(a),
                   words=wa.shape[2], threshold=thr, step=step,
                   drange=drange, scan=kname, scan_ms=kms,
                   scan_plain_ms=plain_ms, agree_ms=ams,
                   agree_plain_ms=aplain,
                   scan_bound_ms=roofline.scan_bound(
                       h, w, bits_for(len(a), cfg.mode.name), drange,
                       consistency=kname == "consistency")[0],
                   scan_popc_bound_ms=scan_bound(
                       h, w, wa.shape[2], drange,
                       16 if kname == "consistency" else 8)[0],
                   agree_bound_ms=agree_bound(torch, disp, a, b, anx)[0],
                   agree_bound_conv_pipe_ms=agree_bound(
                       torch, disp, a, b, anx, conv_pipe=True)[0])
        results[label] = res
        search_disp[label] = disp
        print(f"call {label} (n={len(a)} {cfg.mode.name}, {wa.shape[2]} "
              f"words, {variant!r}, range {drange}, step {step}): "
              f"{res['ms']:.3f} ms with the kernels, {res['plain_ms']:.1f} "
              f"ms plain; {kname} kernel {kms:.3f} ms (bound "
              f"{res['scan_bound_ms']:.3f} ms; on the popcount pipe "
              f"{res['scan_popc_bound_ms']:.3f} ms), plain {plain_ms:.1f} ms; "
              f"agree kernel {ams:.3f} ms (bound "
              f"{res['agree_bound_ms']:.3f} ms, "
              f"{res['agree_bound_conv_pipe_ms']:.3f} ms with the roundings "
              f"and casts on the conversion pipe), plain {aplain:.1f} ms; "
              f"peak device memory {res['peak_bytes']} bytes, "
              f"{res['call_peak_bytes']} above what was held before the "
              f"call ({card})", flush=True)

    # Call I: A with the dynamic window. The same search disparity as A.
    chunk, wcap = WINDOWS[0]
    wp = -(-w // chunk) * chunk
    knobs = {"BICOS_AGREE_DYNWIN": str(wcap), "BICOS_AGREE_CHUNK": str(chunk)}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        res, d1, c1 = call_case(
            torch, "I", lambda backend: bicos.match(
                s0, s1, cfgs["A"], corrmap=True, backend=backend),
            {**nodup_path, "bases": 1}, truth)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for got, want, what in zip((d1, c1), single["A"],
                               ("disparity", "corrmap")):
        if not same_bits(torch, got, want):
            fail(f"call I: {what} differs from call A's")
    disp = search_disp["A"]
    bases, share = check_bases(torch, "call I", disp, chunk, wcap)
    if share <= 0:
        fail("call I: no chunk took the window")
    check_agree(torch, "call I", disp, s0, s1, THRESHOLD, STEP, mv,
                window=(chunk, wcap, bases))
    from libbicos_tpu_torch.kernels.bases import chunk_window_bases_cuda

    bases_dt = device_times(torch, lambda: chunk_window_bases_cuda(
        disp, w, wp, wcap, chunk), "bases", graph=True)
    bases_ms = bases_dt["ms"]
    bases_plain_ms = time_ms(torch, lambda: ta.chunk_window_bases(
        disp, w, wp, wcap, chunk), reps=3)
    bases_bound = bound(disp.numel() * 2 + bases.numel() * 4)
    wms = time_ms(torch, lambda: agree_cuda(
        disp, s0, s1, THRESHOLD, STEP, mv, bases=bases, chunk=chunk,
        wcap=wcap))
    res.update(variant=repr(cfgs["A"].variant), window=[chunk, wcap],
               window_share=share, equals="A", bases_ms=bases_ms,
               bases_plain_ms=bases_plain_ms, agree_ms=wms,
               agree_global_ms=results["A"]["agree_ms"],
               bases_bound_ms=bases_bound[0],
               agree_bound_ms=results["A"]["agree_bound_ms"])
    results["I"] = res
    print(f"call I (A with BICOS_AGREE_DYNWIN={wcap}, chunk {chunk}): "
          f"{res['ms']:.3f} ms with the kernels (A {results['A']['ms']:.3f}),"
          f" {res['plain_ms']:.1f} ms plain; equal to call A bit for bit; "
          f"windowed share {share:.6f} of {bases.numel()} chunks; bases "
          f"kernel {bases_ms:.4f} ms ({LAUNCHES} launches in a CUDA graph; "
          f"L2 flushed {bases_dt['cold_ms']:.4f}; profiler "
          f"{bases_dt['profiler_ms']:.4f}, flushed "
          f"{bases_dt['profiler_cold_ms']:.4f}; one launch "
          f"{bases_dt['call_ms']:.4f}), plain {bases_plain_ms:.3f} ms; "
          f"windowed agree {wms:.3f} ms, global-read agree "
          f"{results['A']['agree_ms']:.3f} ms ({card})", flush=True)

    # Call J: A in DOUBLE.
    cfg = dataclasses.replace(cfgs["A"], precision=bicos.Precision.DOUBLE)
    res, d1, c1 = call_case(
        torch, "J", lambda backend: bicos.match(s0, s1, cfg, corrmap=True,
                                                backend=backend),
        {**nodup_path, "agree_double": 1}, truth)
    check_agree(torch, "call J", disp, s0, s1, THRESHOLD, STEP, mv,
                double=True)
    jms = time_ms(torch, lambda: agree_cuda(
        disp, s0, s1, THRESHOLD, STEP, mv,
        precision=bicos.Precision.DOUBLE))
    jplain = time_ms(torch, lambda: ta.agree_subpixel(
        disp, s0, s1, THRESHOLD, STEP, mv,
        precision=bicos.Precision.DOUBLE), reps=1, warm=0)
    da, ca = single["A"]
    d_diff = int(((torch.isnan(d1) != torch.isnan(da))
                  | (torch.nan_to_num(d1) != torch.nan_to_num(da))).sum())
    c_diff = int(((torch.isnan(c1) != torch.isnan(ca))
                  | (torch.nan_to_num(c1) != torch.nan_to_num(ca))).sum())
    res.update(variant=repr(cfg.variant), precision="DOUBLE", agree_ms=jms,
               agree_plain_ms=jplain, disparities_differing_from_A=d_diff,
               corrmap_differing_from_A=c_diff,
               agree_bound_ms=agree_bound(torch, disp, s0, s1, nx,
                                          double=True)[0])
    results["J"] = res
    print(f"call J (A in DOUBLE): {res['ms']:.3f} ms with the kernels, "
          f"{res['plain_ms']:.1f} ms plain; f64 agree kernel {jms:.3f} ms, "
          f"plain f64 agree {jplain:.1f} ms; {d_diff} disparities and "
          f"{c_diff} corrmap values differ from call A ({card})", flush=True)
    print("phase 3: every call launched its path's kernels, ran "
          "deterministically, and each kernel agrees with its plain "
          "version at the call's shapes", flush=True)

    # Phase 4: the sharded paths on NBANDS bands of the one card, each equal
    # to the single-card call of its configuration.
    from libbicos_tpu_torch import sharding
    from libbicos_tpu_torch.kernels.band import (
        row_minima_band,
        row_minima_consistency_band,
    )

    mesh = sharding.make_mesh(NBANDS, virtual=True, device=dev)
    wpath = {**path, "transform": 2 * NBANDS, "agree": NBANDS,
             "agree_packed": NBANDS}
    sharded = {  # label: (single-card call, entry point, launches)
        "E": ("A", sharding.match_sharded_w, {**wpath, "band": 16}),
        "F": ("B", sharding.match_sharded_w,
              {**wpath, "band_consistency": 16}),
        "G": ("C", sharding.match_sharded_w, {**wpath, "band": 8}),
        "H": ("A", sharding.match_sharded,
              {**wpath, "hamming": NBANDS, "hamming_mma": NBANDS}),
    }
    sharded_out = {}
    col_b0, col_b1 = (sharding._bands(x, 2, mesh) for x in (s0, s1))
    row_b0, row_b1 = (sharding._bands(x, 1, mesh) for x in (s0, s1))
    row_w0, row_w1 = ([descriptor_words_cuda(x, mode) for x in b]
                      for b in (row_b0, row_b1))
    band_w = col_b0[0].shape[2]
    offs = [j * band_w for j in range(NBANDS)]
    for label, (ref, fn, expect) in sharded.items():
        cfg = cfgs[ref]
        drange = cfg.disparity_range
        res, d1, c1 = call_case(
            torch, label,
            lambda backend, fn=fn, cfg=cfg: fn(s0, s1, cfg, mesh=mesh,
                                               corrmap=True,
                                               backend=backend),
            expect, truth)
        sharded_out[label] = (d1, c1)
        for got, want, what in zip((d1, c1), single[ref],
                                   ("disparity", "corrmap")):
            bad = (torch.isnan(got) != torch.isnan(want)) | (
                torch.nan_to_num(got) != torch.nan_to_num(want))
            if bool(bad.any()):
                fail(f"call {label}: {what} differs from the single-card "
                     f"call {ref} in {int(bad.sum())} pixels")
        # The call's kernels, timed at its shapes.
        if label == "H":
            disp_bands = sharding._bands(search_disp[ref], 0, mesh)
            parts = {
                "transform": time_ms(torch, lambda: [
                    descriptor_words_cuda(x, mode) for x in row_b0 + row_b1]),
                "hamming": time_ms(torch, lambda: [
                    row_minima_words(a, b, True)
                    for a, b in zip(row_w0, row_w1)]),
                "agree": time_ms(torch, lambda: [
                    agree_cuda(d, a, b, THRESHOLD, STEP, mv)
                    for d, a, b in zip(disp_bands, row_b0, row_b1)]),
            }
        else:
            # The ring kernel vs its plain version at the call's shapes.
            if label == "F":
                steps, acc, plain_ms = check_cons_band(
                    torch, f"call {label}", w0, w1, drange)
                kname, fold, run = ("band_consistency",
                                    row_minima_consistency_band,
                                    run_cons_steps)
                cons_timing = (time_ms(torch, lambda: run(
                    steps, acc, w, drange, fold)), plain_ms)
            else:
                steps, acc, plain_ms = check_band(torch, f"call {label}", w0,
                                                  w1, drange)
                kname, fold, run = "band", row_minima_band, run_steps
                if label == "E":
                    band_timing = (time_ms(torch, lambda: run(
                        steps, acc, w, drange, fold)), plain_ms)
            col_disp = sharding._bands(search_disp[ref], 1, mesh)
            parts = {
                "transform": time_ms(torch, lambda: [
                    descriptor_words_cuda(x, mode) for x in col_b0 + col_b1]),
                kname: time_ms(torch, lambda: run(steps, acc, w, drange,
                                                  fold)),
                "agree": time_ms(torch, lambda: [
                    sharding._agree_banded(d, x, s1, off, cfg, "cuda")
                    for d, x, off in zip(col_disp, col_b0, offs)]),
            }
        res.update(variant=repr(cfg.variant), drange=drange,
                   entry=fn.__name__, equals=ref, parts_ms=parts,
                   # F's fused steps, like B's scan, take the forward and
                   # the reverse minima of each pair.
                   scan_bound_ms=roofline.scan_bound(
                       h, w, bits_for(n, mode.name), drange,
                       consistency=label == "F")[0])
        results[label] = res
        print(f"call {label} ({fn.__name__}, {cfg.variant!r}, range "
              f"{drange}, {NBANDS} bands on one card): {res['ms']:.3f} ms "
              f"with the kernels, {res['plain_ms']:.1f} ms plain; its "
              f"kernels {sum(parts.values()):.3f} ms "
              + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
              + f"; equal to call {ref}; peak device memory "
              f"{res['peak_bytes']} bytes, {res['call_peak_bytes']} above "
              f"what was held before the call ({card})", flush=True)
    print("phase 4: every sharded call launched its path's kernels, ran "
          "deterministically and equals its single-card call", flush=True)

    # Phase 5: the user surfaces on the card: the CLI, stage timings, the
    # pybicos surface and BICOS_DEBUG's checks.
    from libbicos_tpu_torch import profiling
    from libbicos_tpu_torch import pybicos_compat as pybicos

    cli = cli_phase(torch, s0n, s1n, single["A"], card)
    stages = profiling.stage_timings(s0, s1, cfgs["A"], backend="cuda")
    print(f"  stage_timings at A: {stages} ({card})", flush=True)
    p0, p1, _ = synthetic_stack_pair(9, 24, 160, seed=9)
    pcfg = pybicos.Config()
    pcfg.subpixel_step = 0.25
    pd, pc = pybicos.match(list(p0), list(p1), pcfg)
    md, mc = bicos.match(p0, p1, pcfg._to_native(), corrmap=True,
                         backend="cuda")
    if not (isinstance(pd, np.ndarray) and same_bits(
            torch, torch.from_numpy(pd), md.cpu())
            and same_bits(torch, torch.from_numpy(pc), mc.cpu())):
        fail("pybicos_compat.match differs from match")
    print("  pybicos_compat.match (n=9 24x160) equals match", flush=True)
    os.environ["BICOS_DEBUG"] = "1"
    try:
        dd, dc = bicos.match(s0, s1, cfgs["A"], corrmap=True, backend="cuda")
    finally:
        os.environ.pop("BICOS_DEBUG")
    if not (same_bits(torch, dd, single["A"][0])
            and same_bits(torch, dc, single["A"][1])):
        fail("call A under BICOS_DEBUG differs from call A")
    print("  call A under BICOS_DEBUG=1: the checks passed, equal to call A",
          flush=True)
    results_extra = {"cli": cli, "stage_timings_A": stages}
    print("phase 5: the CLI, stage timings, pybicos_compat and BICOS_DEBUG "
          "ran on the card and agree with match", flush=True)

    # Phase 6: the daemon on the card, through the client.
    served = serve_phase(torch, s0n, s1n, cfgs, {
        **{k: single[k] for k in "ABC"}, "H": sharded_out["H"]}, card)
    results.update(served)
    print("phase 6: the daemon served the headline, batched, Consistency, "
          "ranged and 4-band requests through the kernels, each equal to "
          "its in-process call", flush=True)
    print("verify against a parent commit: unpack it into the git-ignored "
          "_chipcheck/parent (git archive <commit> | tar -x -C "
          "_chipcheck/parent), then run python3 tools/output_hashes.py "
          "_chipcheck/parent --seed N and python3 tools/output_hashes.py . "
          "--seed N in one call on the card: their lines (calls A-D, I, J, "
          "N and each benchmark cell's pool pairs) must be equal", flush=True)

    transform_dt = device_times(torch, lambda: descriptor_words_cuda(
        s0, mode), "transform_kernel", graph=False)
    full_dt = device_times(torch, lambda: descriptor_words_cuda(
        k0, full_mode), "transform_kernel", graph=False)
    full_dt["plain_ms"] = time_ms(
        torch, lambda: td.descriptor_words(k0, full_mode), reps=3)
    full_dt["bound_ms"], full_dt["bound_by"] = bound(
        k0.numel() + stacks[full_mode][2].numel() * 4)
    full_dt["sass_per_pixel"] = full_per_pixel.get("transform_kernel<u8,16>")
    timings = {
        "transform": (
            transform_dt["ms"],
            time_ms(torch, lambda: td.descriptor_words(s0, mode), reps=3)),
        "hamming": scans["A"][1:],
        "consistency": scans["B"][1:],
        "agree": (
            time_ms(torch, lambda: agree_cuda(search_disp["A"], s0, s1,
                                              THRESHOLD, STEP, mv)),
            time_ms(torch, lambda: ta.agree_subpixel(
                search_disp["A"], s0, s1, THRESHOLD, STEP, mv), reps=3)),
        "band": band_timing,  # the 16 ring steps of call E
        "band_consistency": cons_timing,  # the 16 fused steps of call F
        "bases": (bases_ms, bases_plain_ms),  # call I's bases
    }
    # Each kernel's bound at the shapes it was timed at: one stack's
    # transform; A's scan, B's fused scan, E's ring and F's fused ring (126
    # bits a descriptor); A's agree; I's bases.
    bits = bits_for(n, mode.name)
    bounds = {
        "transform": bound(s0.numel() * s0.element_size()
                           + w0.numel() * 4),
        "hamming": roofline.scan_bound(h, w, bits, None),
        "consistency": roofline.scan_bound(h, w, bits, None, consistency=True),
        "band": roofline.scan_bound(h, w, bits, None),
        "band_consistency": roofline.scan_bound(h, w, bits, None,
                                                consistency=True),
        "agree": agree_bound(torch, search_disp["A"], s0, s1, nx),
        "bases": bases_bound,
    }
    # Agree's bound with its roundings and casts on the conversion pipe: the
    # yardstick of the kernel's first design, kept to compare with it.
    conv_pipe_ms = agree_bound(torch, search_disp["A"], s0, s1, nx,
                               conv_pipe=True)[0]
    for k, (kms, pms) in timings.items():
        print(f"  {k}: kernel {kms:.3f} ms, plain {pms:.3f} ms, bound "
              f"{bounds[k][0]:.4f} ms by {bounds[k][1]} ({card})",
              flush=True)
    print(f"  transform FULL n=16 {h}x{w} u8: kernel {full_dt['ms']:.4f} ms "
          f"(flushed {full_dt['cold_ms']:.4f}, profiler "
          f"{full_dt['profiler_ms']}), plain {full_dt['plain_ms']:.3f} ms, "
          f"bound {full_dt['bound_ms']:.4f} ms by {full_dt['bound_by']}, "
          f"{full_dt['sass_per_pixel']} SASS instructions a pixel ({card})",
          flush=True)
    print(json.dumps({"calls": results, **results_extra,
                      "shape": list(HEADLINE),
                      "dtype": "uint8", "mode": "LIMITED",
                      "threshold": THRESHOLD, "min_variance": MIN_VARIANCE,
                      "step": STEP, "card": card}), flush=True)
    many = {"bases": bases_dt, "transform": transform_dt}
    kernels = [
        {"name": k, "route": "cuda", "source": SOURCES[k][0],
         "replaces": SOURCES[k][1],
         "launches": sum(r["launches"][k] for r in results.values()),
         "max_abs_err": ERRS[k], "ms": timings[k][0],
         "plain_ms": timings[k][1], "bound_ms": bounds[k][0],
         "bound_by": bounds[k][1],
         # No single PyTorch call computes any of these functions.
         "library_ms": None,
         **({"bound_conv_pipe_ms": conv_pipe_ms} if k == "agree" else {}),
         # Device time of many launches (ms); call_ms: one launch between
         # an event pair, the wrapper's host work included.
         **({x: many[k][x] for x in ("call_ms", "cold_ms", "profiler_ms",
                                     "profiler_cold_ms")}
            if k in many else {}),
         # The FULL transform of call N's left stack (n=16 u8 FULL).
         **({"full16": full_dt} if k == "transform" else {})}
        for k in KERNELS
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
