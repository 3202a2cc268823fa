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
// popcounts at the full scan), plus per (warp, column) one or two warp
// reductions (__reduce_min_sync) and one or two shared-memory atomicMin.
// A ranged scan visits only the columns each warp's pixels can reach.
//
// Design: one block per image row. The block keeps the row's reverse
// minima as packed int32, cost << S | col0 for first and
// cost << S | (2^S - 1 - col0) for last (cost <= 256, col0 < 2^S), so a
// plain minimum keeps the least (or the greatest) left column among the
// least costs in any order, which makes the result deterministic. Threads
// loop over tiles of TPB left pixels; the right row's window streams
// through shared memory as in hamming.cu. For every column, each thread
// updates its forward (best, first, last) in column order, and each warp
// folds its 32 candidates for the column with __reduce_min_sync and one
// atomicMin into the reverse minima. After a __syncthreads() the same
// block reads the reverse minima at each pixel's forward first argmin.
//
// The reverse minima take 4*W1 bytes (8*W1 with no_dupes) of shared
// memory, 26.4 KB at W=3300 with no_dupes; rows too wide for the block's
// shared memory keep them in a global scratch row instead (GLOBAL_REV,
// global atomicMin; each block owns its row's scratch). A pixel with no
// in-range column gets first0 = -1, last0 = -2 and rc0 = -1,
// rc0_last = -2.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TPB = 256;
constexpr int CHUNK = 256;
constexpr int S = 22;  // bits of the left column in the reverse packing
constexpr int MASK = (1 << S) - 1;
constexpr unsigned FULL = 0xffffffffu;

// Dynamic shared memory of one block: a chunk of the right row, plus the
// row's reverse minima unless they live in the global scratch.
size_t smem_bytes(int nw, int wid1, bool no_dupes, bool global_rev) {
  const size_t tile = sizeof(uint32_t) * CHUNK * nw;
  return global_rev ? tile
                    : tile + sizeof(int32_t) * (no_dupes ? 2 : 1) * wid1;
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
__global__ void __launch_bounds__(TPB) consistency_kernel(Args p) {
  extern __shared__ int32_t smem[];
  const int64_t row = blockIdx.x;
  const int wid0 = p.wid0, wid1 = p.wid1;
  int32_t* rf;
  int32_t* rl;
  uint32_t* tile;
  if (GLOBAL_REV) {
    rf = p.scratch + row * 2 * wid1;
    rl = rf + wid1;
    tile = reinterpret_cast<uint32_t*>(smem);
  } else {
    rf = smem;
    rl = smem + wid1;
    tile = reinterpret_cast<uint32_t*>(smem + (NO_DUPES ? 2 : 1) * wid1);
  }
  for (int i = threadIdx.x; i < wid1; i += TPB) {
    rf[i] = INT_MAX;
    if (NO_DUPES) rl[i] = INT_MAX;
  }

  const int lane = threadIdx.x & 31;
  const uint32_t* right = p.words1 + row * wid1 * NW;
  for (int t0 = 0; t0 < wid0; t0 += TPB) {
    const int c0 = t0 + threadIdx.x;
    const bool live = c0 < wid0;
    uint32_t a[NW];
    const uint32_t* left = p.words0 + (row * wid0 + c0) * NW;
#pragma unroll
    for (int k = 0; k < NW; ++k) a[k] = live ? left[k] : 0u;

    // Column windows [lo, hi): the block's tile, the warp's 32 pixels
    // (warp-uniform, so every lane takes part in the reductions) and the
    // thread's own pixel.
    const int tend = min(t0 + TPB, wid0);
    const int w0c = t0 + (threadIdx.x & ~31);
    const int wend = min(w0c + 32, wid0);
    int blo = 0, bhi = wid1, wlo = 0, whi = wid1;
    int mylo = 0, myhi = live ? wid1 : 0;
    if (p.has_range) {
      blo = max(0, t0 - p.dmax);
      bhi = min(wid1, tend - p.dmin);
      wlo = max(0, w0c - p.dmax);
      whi = min(wid1, wend - p.dmin);
      mylo = max(0, c0 - p.dmax);
      myhi = live ? min(wid1, c0 - p.dmin + 1) : 0;
    }
    if (wend <= w0c) whi = 0;  // a warp past the row's end
    const unsigned span =
        myhi > mylo ? static_cast<unsigned>(myhi - mylo) : 0u;

    int best = INT_MAX, bf = -1, bl = -2;
    for (int base = blo; base < bhi; base += CHUNK) {
      const int cols = min(CHUNK, bhi - base);
      __syncthreads();
      for (int i = threadIdx.x; i < cols * NW; i += TPB)
        tile[i] = right[static_cast<int64_t>(base) * NW + i];
      __syncthreads();
      const int jlo = max(0, wlo - base);
      const int jhi = min(cols, whi - base);
      for (int j = jlo; j < jhi; ++j) {
        int cost = 0;
#pragma unroll
        for (int k = 0; k < NW; ++k) cost += __popc(a[k] ^ tile[j * NW + k]);
        const int col = base + j;
        const bool ok = static_cast<unsigned>(col - mylo) < span;
        if (ok && cost < best) {
          best = cost;
          bf = col;
        }
        if (NO_DUPES && ok && cost <= best) bl = col;
        const int packed = cost << S;
        const int mf = __reduce_min_sync(FULL, ok ? packed | c0 : INT_MAX);
        if (lane == 0 && mf != INT_MAX) atomicMin(rf + col, mf);
        if (NO_DUPES) {
          const int ml =
              __reduce_min_sync(FULL, ok ? packed | (MASK - c0) : INT_MAX);
          if (lane == 0 && ml != INT_MAX) atomicMin(rl + col, ml);
        }
      }
    }
    if (live) {
      p.first[row * wid0 + c0] = bf;
      if (NO_DUPES) p.last[row * wid0 + c0] = bl;
    }
  }
  __syncthreads();

  // The lookup: every thread reads back the forward argmins it wrote.
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
