// Hamming row scan for the NoDuplicates search: for every left pixel, the
// first and the last column of the same right row whose packed descriptor
// has the least Hamming distance to the pixel's own, optionally restricted
// to the columns whose disparity col0 - col1 lies in [dmin, dmax].
//
// Replaces the Pallas kernels in libbicos_tpu/kernels/hamming.py:
// _minima_kernel (search from packed words) and its int8-engine twin
// _minima_kernel_i8; the scan half of _minima_kernel_bf16_stack (the fused
// stack search, whose descriptor half is transform.cu) and of its twin
// _minima_kernel_i8_stack; and, ranged, the scan half of
// _minima_kernel_bf16_stack_range. The TPU computes Hamming distances as
// MXU matmuls over bit planes and packs (cost, column) into f32 values; on
// Hopper a distance is nw __popc of XOR-ed words and the argmin is kept as
// plain integers, so neither trick carries over.
//
// Bound on the card: popcount issue rate. The full scan does H*W0*W1*nw
// popcounts (2200*3300*3300*4 = 9.6e10 at the headline call) and reads
// each right row once per tile of left pixels from L2. A ranged scan visits
// only the columns its tile can reach, about (TPB + dmax - dmin) per tile,
// and each warp only the (32 + dmax - dmin) columns its own pixels can
// reach, so its cost is O(W * range), not O(W^2).
//
// Design: one block per (row, tile of TPB left pixels). Each thread holds
// its left descriptor in registers and its (best, first, last) state; the
// right row's window streams through shared memory in chunks of CHUNK
// columns, which every thread reads as broadcasts. Each thread walks the
// columns in increasing order: cost < best moves `first`, cost <= best
// moves `last`. A row of any width is covered, since only one chunk is
// resident at a time (a whole row at W=3300 and nw=4 is 52.8 KB, over the
// 48 KB static limit). A pixel with no in-range column keeps the sentinels
// first = -1, last = -2, as the JAX scan decodes them.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TPB = 128;
constexpr int CHUNK = 512;

template <int NW, bool RANGED>
__global__ void __launch_bounds__(TPB)
row_minima_kernel(const uint32_t* __restrict__ words0,
                  const uint32_t* __restrict__ words1,
                  int32_t* __restrict__ first, int32_t* __restrict__ last,
                  int wid0, int wid1, int need_last, int dmin, int dmax) {
  __shared__ uint32_t tile[CHUNK * NW];
  const int64_t row = blockIdx.x;
  const int t0 = blockIdx.y * TPB;
  const int c0 = t0 + threadIdx.x;
  const bool live = c0 < wid0;

  uint32_t a[NW];
  const uint32_t* left = words0 + (row * wid0 + c0) * NW;
#pragma unroll
  for (int k = 0; k < NW; ++k) a[k] = live ? left[k] : 0u;

  // Column windows [lo, hi): the block's (what its tile can reach), the
  // warp's (what its 32 pixels can reach; warp-uniform) and the thread's.
  int blo = 0, bhi = wid1, wlo = 0, whi = wid1, mylo = 0, myhi = wid1;
  if (RANGED) {
    const int tend = min(t0 + TPB, wid0);
    blo = max(0, t0 - dmax);
    bhi = min(wid1, tend - dmin);
    const int w0c = t0 + (threadIdx.x & ~31);
    const int wend = min(w0c + 32, wid0);
    wlo = max(0, w0c - dmax);
    whi = min(wid1, wend - dmin);
    mylo = max(0, c0 - dmax);
    myhi = live ? min(wid1, c0 - dmin + 1) : 0;
  }
  const unsigned span = myhi > mylo ? static_cast<unsigned>(myhi - mylo) : 0u;

  const uint32_t* right = words1 + row * wid1 * NW;
  int best = INT_MAX, bf = -1, bl = -2;
  for (int base = blo; base < bhi; base += CHUNK) {
    const int cols = min(CHUNK, bhi - base);
    __syncthreads();
    for (int i = threadIdx.x; i < cols * NW; i += TPB)
      tile[i] = right[static_cast<int64_t>(base) * NW + i];
    __syncthreads();
    const int jlo = RANGED ? max(0, wlo - base) : 0;
    const int jhi = RANGED ? min(cols, whi - base) : cols;
    for (int j = jlo; j < jhi; ++j) {
      int cost = 0;
#pragma unroll
      for (int k = 0; k < NW; ++k) cost += __popc(a[k] ^ tile[j * NW + k]);
      const int col = base + j;
      const bool ok =
          !RANGED || static_cast<unsigned>(col - mylo) < span;
      if (ok && cost < best) {
        best = cost;
        bf = col;
      }
      if (ok && cost <= best) bl = col;
    }
  }
  if (live) {
    first[row * wid0 + c0] = bf;
    if (need_last) last[row * wid0 + c0] = bl;
  }
}

template <int NW>
void launch(const void* w0, const void* w1, void* first, void* last, int h,
            int wid0, int wid1, int need_last, int has_range, int dmin,
            int dmax, cudaStream_t st) {
  const dim3 grid(h, (wid0 + TPB - 1) / TPB);
  const auto* a = static_cast<const uint32_t*>(w0);
  const auto* b = static_cast<const uint32_t*>(w1);
  auto* f = static_cast<int32_t*>(first);
  auto* l = static_cast<int32_t*>(last);
  if (has_range)
    row_minima_kernel<NW, true><<<grid, TPB, 0, st>>>(
        a, b, f, l, wid0, wid1, need_last, dmin, dmax);
  else
    row_minima_kernel<NW, false><<<grid, TPB, 0, st>>>(
        a, b, f, l, wid0, wid1, need_last, 0, 0);
}

}  // namespace

// dmin/dmax are read only with has_range; the caller clamps them into
// [-wid1, wid0], which leaves the set of in-range pairs unchanged.
extern "C" int bicos_row_minima(int device, const void* words0,
                                const void* words1, void* first, void* last,
                                int h, int wid0, int wid1, int nw,
                                int need_last, int has_range, int dmin,
                                int dmax, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BICOS_CASE(K)                                                       \
  case K:                                                                   \
    launch<K>(words0, words1, first, last, h, wid0, wid1, need_last,        \
              has_range, dmin, dmax, st);                                   \
    break;
  switch (nw) {
    BICOS_CASE(1)
    BICOS_CASE(2)
    BICOS_CASE(3)
    BICOS_CASE(4)
    BICOS_CASE(5)
    BICOS_CASE(6)
    BICOS_CASE(7)
    BICOS_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BICOS_CASE
  return static_cast<int>(cudaGetLastError());
}
