// Fused forward + reverse Hamming scan for the Consistency search: for every
// left pixel, the first (and, with no_dupes, last) right column of least
// Hamming distance; for every right column, the first (and last) left
// column of least distance; and those reverse values read at each left
// pixel's forward first argmin. Optionally restricted to the pairs whose
// disparity col0 - col1 lies in [dmin, dmax], in both directions.
//
// Replaces the Pallas kernels in libbicos_tpu/kernels/hamming.py:
// _consistency_kernel (from packed words) and its int8-engine twin
// _consistency_kernel_i8; the scan half of _consistency_kernel_bf16_stack
// and of its twin _consistency_kernel_i8_stack (their descriptor half is
// transform.cu), with the reverse lookup of _consistency_lookup; and,
// ranged, the scan half of _consistency_kernel_bf16_stack_range.
//
// Each popcount serves both directions: the TPU kernel takes the forward
// minima along one axis of its cost tile and the reverse minima along the
// other, and so does this one, in one sweep of the cost matrix.
//
// Bound on the card: popcount issue rate, as hamming.cu (H*W0*W1*nw
// popcounts at the full scan), which the fold meets only if the integer
// work of a pair stays well below the ALU's four instructions a popcount
// (cons_scan.cuh); a ranged scan visits only the columns each warp's tile
// can reach, about (TILE + dmax - dmin) per tile of TILE left pixels.
//
// Design: one block per image row; its warps take the row's tiles of TILE
// left pixels in turn and scan each against the right row with the shared
// fused fold of cons_scan.cuh (P pixels a thread; both directions in
// 16-bit (first, last) key pairs; reverse minima reduced over the thread's
// pixels, then over the warp by one transposed butterfly per group of
// columns, then one shared-memory atomicMin per column and chunk of
// columns). The block keeps the row's reverse minima as packed int32,
// cost << S | col0 for first and cost << S | (2^S - 1 - col0) for last
// (cost <= 256, col0 < 2^S); each pixel's forward minima are packed the
// same way with the right column. After a __syncthreads() the same block
// reads the reverse minima at each pixel's forward first argmin.
//
// The reverse minima take 4*W1 bytes (8*W1 with no_dupes) of shared
// memory beside the warps' staging buffers, 26.4 KB + 20 KB at W=3300 and
// nw=4 with no_dupes; rows too wide for the block's shared memory keep them
// in a global scratch row instead (GLOBAL_REV, global atomicMin; each block
// owns its row's scratch). A pixel with no in-range column gets
// first0 = -1, last0 = -2 and rc0 = -1, rc0_last = -2.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "cons_scan.cuh"

namespace {

namespace cons = bicos::cons;
using cons::TPB;

constexpr int S = 22;  // bits of a column in the packing
constexpr int MASK = (1 << S) - 1;

// Dynamic shared memory of one block: the warps' staging buffers, plus the
// row's reverse minima unless they live in the global scratch.
size_t smem_bytes(int nw, int wid1, bool no_dupes, bool global_rev) {
  const size_t stage = cons::stage_bytes(nw);
  return global_rev ? stage
                    : stage + sizeof(int32_t) * (no_dupes ? 2 : 1) * wid1;
}

struct Args {
  const uint32_t* words0;
  const uint32_t* words1;
  int32_t* first;
  int32_t* last;
  int32_t* rc0;
  int32_t* rc0_last;
  int32_t* scratch;  // GLOBAL_REV: (h, 2, wid1) int32
  int wid0, wid1, has_range, dmin, dmax;
};

template <int NW, bool NO_DUPES, bool GLOBAL_REV>
__global__ void __launch_bounds__(TPB, cons::min_blocks(NW, NO_DUPES))
    consistency_kernel(Args p) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int64_t row = blockIdx.x;
  const int wid0 = p.wid0, wid1 = p.wid1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* stage = smem + warp * cons::stage_words(NW);
  int32_t* rf;
  if (GLOBAL_REV)
    rf = p.scratch + row * 2 * wid1;
  else
    rf = reinterpret_cast<int32_t*>(smem +
                                    cons::WARPS * cons::stage_words(NW));
  int32_t* rl = rf + wid1;
  for (int i = threadIdx.x; i < wid1; i += TPB) {
    rf[i] = INT_MAX;
    if (NO_DUPES) rl[i] = INT_MAX;
  }
  __syncthreads();

  cons::Row r{p.words0 + row * wid0 * NW, p.words1 + row * wid1 * NW,
              rf, rl, wid0, wid1,
              p.has_range ? p.dmin : -wid1, p.has_range ? p.dmax : wid0,
              0, MASK, 0, MASK};
  constexpr int TILE = cons::TILE, P = cons::P;
  const int tiles = (wid0 + TILE - 1) / TILE;
  for (int t = warp; t < tiles; t += cons::WARPS) {
    int32_t f[P], l[P];
    cons::scan_tile<NW, S, NO_DUPES>(r, stage, t * TILE, f, l);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int c0 = t * TILE + 32 * q + lane;
      if (c0 >= wid0) continue;
      const bool none = f[q] >= cons::none_lim<S>();
      p.first[row * wid0 + c0] = none ? -1 : f[q] & MASK;
      if (NO_DUPES) p.last[row * wid0 + c0] = none ? -2 : MASK - (l[q] & MASK);
    }
  }
  __syncthreads();

  // The lookup: every thread reads back forward argmins written by the
  // block.
  for (int c0 = threadIdx.x; c0 < wid0; c0 += TPB) {
    const int64_t o = row * wid0 + c0;
    const int f = p.first[o];
    int rv = -1, rvl = -2;
    if (f >= 0) {
      const int vf = GLOBAL_REV ? __ldcg(rf + f) : rf[f];
      if (vf != INT_MAX) rv = vf & MASK;
      if (NO_DUPES) {
        const int vl = GLOBAL_REV ? __ldcg(rl + f) : rl[f];
        if (vl != INT_MAX) rvl = MASK - (vl & MASK);
      }
    }
    p.rc0[o] = rv;
    if (NO_DUPES) p.rc0_last[o] = rvl;
  }
}

template <int NW, bool NO_DUPES, bool GLOBAL_REV>
int launch(const Args& p, int h, cudaStream_t st) {
  const size_t bytes = smem_bytes(NW, p.wid1, NO_DUPES, GLOBAL_REV);
  auto* kern = consistency_kernel<NW, NO_DUPES, GLOBAL_REV>;
  if (bytes > 48 * 1024) {
    if (cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes)))
      return static_cast<int>(e);
  }
  kern<<<h, TPB, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int NW>
int launch_nw(const Args& p, int h, int no_dupes, cudaStream_t st) {
  const bool global = p.scratch != nullptr;
  if (no_dupes)
    return global ? launch<NW, true, true>(p, h, st)
                  : launch<NW, true, false>(p, h, st);
  return global ? launch<NW, false, true>(p, h, st)
                : launch<NW, false, false>(p, h, st);
}

}  // namespace

// 1 when one block's reverse minima and right-row chunk exceed the device's
// per-block shared memory (opt-in limit, 227 KB on the H100), so the caller
// must pass a (h, 2, wid1) int32 global scratch; 0 when they fit; a
// negative CUDA error code when the device cannot be queried.
extern "C" int bicos_consistency_needs_scratch(int device, int wid1, int nw,
                                               int no_dupes) {
  int limit = 0;
  if (cudaError_t e = cudaDeviceGetAttribute(
          &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device))
    return -static_cast<int>(e);
  const size_t bytes = smem_bytes(nw, wid1, no_dupes != 0, false);
  return bytes > static_cast<size_t>(limit) ? 1 : 0;
}

// last/rc0_last are written only with no_dupes; scratch is null unless the
// reverse minima do not fit in shared memory. dmin/dmax are read only with
// has_range; the caller clamps them into [-wid1, wid0].
extern "C" int bicos_consistency(int device, const void* words0,
                                 const void* words1, void* first, void* last,
                                 void* rc0, void* rc0_last, void* scratch,
                                 int h, int wid0, int wid1, int nw,
                                 int no_dupes, int has_range, int dmin,
                                 int dmax, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args p{static_cast<const uint32_t*>(words0),
         static_cast<const uint32_t*>(words1),
         static_cast<int32_t*>(first),
         static_cast<int32_t*>(last),
         static_cast<int32_t*>(rc0),
         static_cast<int32_t*>(rc0_last),
         static_cast<int32_t*>(scratch),
         wid0, wid1, has_range, dmin, dmax};
  switch (nw) {
    case 1: return launch_nw<1>(p, h, no_dupes, st);
    case 2: return launch_nw<2>(p, h, no_dupes, st);
    case 3: return launch_nw<3>(p, h, no_dupes, st);
    case 4: return launch_nw<4>(p, h, no_dupes, st);
    case 5: return launch_nw<5>(p, h, no_dupes, st);
    case 6: return launch_nw<6>(p, h, no_dupes, st);
    case 7: return launch_nw<7>(p, h, no_dupes, st);
    case 8: return launch_nw<8>(p, h, no_dupes, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
