#!/usr/bin/env python3
"""Time, on the card, the units that ``roofline.PEAK`` prices a scan by:
the bit products (``bit_products``) and the 16-bit minima (``min``), so
that no unit is found faster than the yardstick allows.

    python3 portbench/rate_probe.py

It prints one line a reading and, last, one JSON object:

* ``int_mm``: ``torch._int_mm`` (int8 in, int32 out) on +-1 planes, one
  row block of the scan (3304 left pixels, or 8 rows of them, against one
  right row of 3304 columns; 3300 padded to a multiple of 8) at K = 128
  and 256 bits, and a square 8192 product, whose K leaves the tensor cores
  and not the int32 output as the limit. Its products are checked against
  a float product.
* Loops on registers or shared memory, one kernel each, built by ``nvcc``
  into ``.portbench_cache/rate_probe/``: the 1-bit ``.and.popc``
  ``mma.sync`` (m16n8k256), ``wgmma`` INT8 (m64n64k32) and 1-bit
  (m64n64k256), ``__popc`` of an XOR, and packed 16-bit minima two at a
  time, which ptxas fuses into 3-input mins (``min.u16x2``, ``min.f16x2``
  and the two interleaved). Where ``nvcc`` refuses one for sm_90a, the
  line says so, with the compiler's last words. Each loop's most frequent
  SASS opcodes are printed beside it (``cuobjdump``). A product loop is
  run again on all-ones inputs, where every output's sum is known, and
  the line says whether each thread's sum came out as counted: the check
  that every instruction counted ran.

Each loop runs back to back for about 1.5 s while ``nvidia-smi`` samples
the SM clock. A rate is bit products (multiply-adds for INT8) or minima a
second, the same a clock an SM at the yardstick's clock
(``roofline.SM_CLOCKS``) and at the sampled clock, and its share of the
priced rate. It needs a card; without one it exits 2.
"""

from __future__ import annotations

import collections
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / ".portbench_cache" / "rate_probe"
NVCC = "/usr/local/cuda/bin/nvcc"
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
         "-Xcompiler", "-fPIC"]
SASS_OP = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9.]+)")
THREADS = 256
SUSTAIN_S = 1.5

HEAD = r"""
#include <cuda_runtime.h>
#include <cstdint>
__global__ void loop(int iters, unsigned seed, int ones, int *out);
extern "C" int launch(int blocks, int threads, int iters, unsigned seed,
                      int ones, void *out, void *stream) {
  loop<<<blocks, threads, 0, (cudaStream_t)stream>>>(iters, seed, ones,
                                                      (int *)out);
  return (int)cudaGetLastError();
}
#define TID (blockIdx.x * blockDim.x + threadIdx.x)
"""

# mma.sync m16n8k256: a warp's A fragment is 4 words, B 2, C/D 4.
# CHAINS independent accumulators a thread hide the unit's latency.
MMA_SYNC = r"""
#define CHAINS 4
__global__ void loop(int iters, unsigned seed, int ones, int *out) {
  unsigned m = ones ? ~0u : 0u, t = seed ^ TID * 2654435761u;
  unsigned a0 = t | m, a1 = t * 3u | m, a2 = t * 5u | m, a3 = t * 7u | m;
  unsigned b0 = ~t | m, b1 = (t + 1u) | m;
  int c[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k)
      asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc"
                   " {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+r"(c[k][0]), "+r"(c[k][1]), "+r"(c[k][2]), "+r"(c[k][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[TID] = s;
}
"""

# wgmma: a warpgroup's 64x64 tile, A and B (64 rows of 32 bytes each, K
# major, no swizzle) from shared memory; 32 accumulators a thread.
WGMMA = r"""
#define UNROLL 4
__device__ uint64_t desc(const void *p) {
  uint64_t a = (uint32_t)__cvta_generic_to_shared(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t)(128 >> 4) << 16
         | (uint64_t)(256 >> 4) << 32;
}
__global__ void __launch_bounds__(256) loop(int iters, unsigned seed,
                                            int ones, int *out) {
  __shared__ __align__(1024) unsigned smem[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x)
    smem[i] = ones ? ~0u : seed ^ (unsigned)i * 2654435761u;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  uint64_t da = desc(smem), db = desc(smem + 1024);
  int d[32] = {};
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                   "OP REGS, %32, %33, p;\n}\n"
                   : OUTS : "l"(da), "l"(db), "r"(1));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  int s = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) s += d[k];
  out[TID] = s;
}
""".replace("REGS", "{" + ",".join(f"%{i}" for i in range(32)) + "}").replace(
    "OUTS", ", ".join(f'"+r"(d[{i}])' for i in range(32)))

POPC = r"""
#define CHAINS 8
__global__ void loop(int iters, unsigned seed, int ones, int *out) {
  unsigned t = seed ^ TID * 2654435761u, w[CHAINS], acc[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) { w[k] = t * (2u * k + 3u); acc[k] = 0; }
  for (int i = 0; i < iters; ++i) {
    unsigned x = (unsigned)i * 0x9E3779B9u;
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) acc[k] += __popc(w[k] ^ x);
  }
  unsigned s = 0;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) s += acc[k];
  out[TID] = (int)s;
}
"""

# Packed 16-bit minima; the values are finite positive halves, so the
# f16x2 min orders them as the u16x2 min does.
MINS = r"""
__global__ void loop(int iters, unsigned seed, int ones, int *out) {
  unsigned t = seed ^ TID * 2654435761u, acc[8], w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    acc[k] = t * (2u * k + 3u) & 0x3BFF3BFFu;
    w[k] = (t ^ (unsigned)k * 0x9E3779B9u) & 0x3BFF3BFFu;
  }
  for (int i = 0; i < iters; ++i) {
BODY
  }
  unsigned s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s ^= acc[k];
  out[TID] = (int)s;
}
"""


def _mins(ops) -> str:
    """Eight chains of ``ops`` in turn, two minima a statement, which
    ptxas fuses into one 3-input min."""
    body = [f'    asm volatile("{op} %0, %0, %1;\\n\\t{op} %0, %0, %2;" '
            f': "+r"(acc[{k}]) : "r"(w[{k}]), "r"(w[{(k + 1) % 8}]));'
            for k, op in ((k, ops[k % len(ops)]) for k in range(8))]
    return MINS.replace("BODY", "\n".join(body))


# name: (source, unit priced in roofline.PEAK, work a thread an iteration).
LOOPS = {
    "mma_sync_b1": (MMA_SYNC, "bit_products", 4 * 16 * 8 * 256 // 32),
    "wgmma_s8": (WGMMA.replace(
        "OP", "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8"),
        "bit_products", 4 * 64 * 64 * 32 // 128),
    "wgmma_b1": (WGMMA.replace(
        "OP", "wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc"),
        "bit_products", 4 * 64 * 64 * 256 // 128),
    "popc": (POPC, "bit_products", 8 * 32),
    "min_u16x2": (_mins(["min.u16x2"]), "min", 32),
    "min_f16x2": (_mins(["min.f16x2"]), "min", 32),
    "min_u16x2_f16x2": (_mins(["min.u16x2", "min.f16x2"]), "min", 32),
}
# All-ones inputs: each product loop's thread sums its work (every bit
# product is 1; an INT8 product is (-1) x (-1) = 1).
CHECKED = {"mma_sync_b1", "wgmma_s8", "wgmma_b1"}


def build(name: str, src: str):
    """``(library, SASS opcode counts)``, or ``(None, nvcc's last words)``
    where nvcc refuses the source."""
    BUILD.mkdir(parents=True, exist_ok=True)
    cu, so = BUILD / f"{name}.cu", BUILD / f"{name}.so"
    cu.write_text(HEAD + src)
    p = subprocess.run([NVCC, *FLAGS, "-o", str(so), str(cu)],
                       capture_output=True, text=True, timeout=300)
    if p.returncode:
        return None, (p.stderr or p.stdout).strip()[-600:]
    sass = subprocess.run([CUOBJDUMP, "-sass", str(so)], capture_output=True,
                          text=True, timeout=120).stdout
    ops = collections.Counter(m.group(1).split(".")[0]
                              for m in SASS_OP.finditer(sass))
    lib = ctypes.CDLL(str(so))
    lib.launch.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_uint, ctypes.c_int]
                           + [ctypes.c_void_p] * 2)
    lib.launch.restype = ctypes.c_int
    return lib, dict(ops.most_common(8))


def events(torch):
    return [torch.cuda.Event(enable_timing=True) for _ in range(2)]


def sustained(torch, call, n: int) -> tuple:
    """``(device ms of n back-to-back calls, median SM MHz, median W)``,
    with ``nvidia-smi`` sampling the card every 100 ms meanwhile."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        start, end = events(torch)
        start.record()
        for _ in range(n):
            call()
        end.record()
        end.synchronize()
    finally:
        smi.terminate()
        lines = smi.communicate(timeout=30)[0]
    samples = [[float(x) for x in ln.split(",")]
               for ln in lines.splitlines() if ln.count(",") == 1]
    if not samples:
        return start.elapsed_time(end), None, None
    return (start.elapsed_time(end),
            statistics.median(s[0] for s in samples),
            statistics.median(s[1] for s in samples))


def run_loop(torch, lib, work: int, checked: bool) -> dict:
    """One loop on 8 blocks an SM: iterations doubled until a launch
    takes 20 ms, then :func:`sustained`, then the all-ones check."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 8 * sms
    out = torch.empty(blocks * THREADS, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(iters, ones=0):
        rc = lib.launch(blocks, THREADS, iters, 12345, ones, out.data_ptr(),
                        stream)
        if rc:
            raise RuntimeError(f"launch failed: cudaError {rc}")

    iters = 64
    while True:
        call(iters)
        start, end = events(torch)
        start.record()
        call(iters)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        if ms >= 20 or iters >= 1 << 24:
            break
        iters *= 2
    n = max(2, int(SUSTAIN_S * 1e3 / ms))
    ms, mhz, watts = sustained(torch, lambda: call(iters), n)
    res = {"rate": n * blocks * THREADS * iters * work / (ms * 1e-3),
           "ms_a_launch": ms / n, "sm_mhz": mhz, "power_w": watts}
    if checked:
        call(iters, ones=1)
        want = (work * iters + 2**31) % 2**32 - 2**31
        res["check"] = bool((out == want).all())
    return res


def int_mm_rates(torch) -> dict:
    g = torch.Generator(device="cuda").manual_seed(7)

    def planes(rows, k):
        bits = torch.randint(0, 2, (rows, k), generator=g, device="cuda",
                             dtype=torch.int8)
        return bits * 2 - 1

    out = {}
    for m, n, k, what in ([(3304, 3304, k, "one row") for k in (128, 256)]
                          + [(8 * 3304, 3304, k, "8 rows")
                             for k in (128, 256)]
                          + [(8192, 8192, 8192, "square")]):
        a, b = planes(m, k), planes(n, k).t()
        dot = torch._int_mm(a, b)
        want = a[:64].float() @ b[:, :64].float()
        start, end = events(torch)
        start.record()
        for _ in range(20):
            torch._int_mm(a, b)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 20
        out[f"int_mm {what} M={m} N={n} K={k}"] = {
            "rate": m * n * k / (ms * 1e-3), "ms_a_launch": ms,
            "check": bool(torch.equal(dot[:64, :64].float(), want))}
        del a, b, dot
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import roofline

    if not torch.cuda.is_available():
        print("rate_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    readings = {k: dict(v, unit="bit_products")
                for k, v in int_mm_rates(torch).items()}
    refused = []
    for name, (src, unit, work) in LOOPS.items():
        lib, ops = build(name, src)
        if lib is None:
            print(f"{name}: nvcc refused it for sm_90a: {ops}", flush=True)
            refused.append(name)
            continue
        print(f"{name}: SASS {ops}", flush=True)
        readings[name] = dict(run_loop(torch, lib, work, name in CHECKED),
                              unit=unit)
    faster = []
    for what, r in readings.items():
        priced = roofline.PEAK[r["unit"]]
        at_clock = (f", {r['rate'] / (132 * r['sm_mhz'] * 1e6):.1f} at the "
                    f"sampled {r['sm_mhz']:.0f} MHz ({r['power_w']:.0f} W)"
                    if r.get("sm_mhz") else "")
        check = ("" if "check" not in r else
                 ", check " + ("ok" if r["check"] else "FAILED"))
        print(f"{what}: {r['rate']:.6e} {r['unit']}/s ({r['ms_a_launch']:.4f}"
              f" ms a launch), {r['rate'] / roofline.SM_CLOCKS:.1f} a clock "
              f"an SM at 1.98 GHz{at_clock}, {100 * r['rate'] / priced:.2f}%"
              f" of the priced {priced:.6e}{check}", flush=True)
        if r["rate"] > priced:
            faster.append(what)
    print(json.dumps({"priced": {u: roofline.PEAK[u]
                                 for u in ("bit_products", "min")},
                      "readings": readings, "refused": refused,
                      "faster_than_priced": faster}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
