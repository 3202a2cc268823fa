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
// Design: one block per (row, tile of TPB left pixels), each thread one
// left pixel, the right row streamed through shared memory in chunks
// (row_scan.cuh, shared with the W-band ring step band.cu). A pixel with no
// in-range column keeps the sentinels first = -1, last = -2, as the JAX
// scan decodes them.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_scan.cuh"

namespace {

using bicos::CHUNK;
using bicos::TPB;

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
  const bicos::ScanResult r = bicos::scan_row<NW, RANGED>(
      words0 + row * wid0 * NW, words1 + row * wid1 * NW, tile, t0, wid0,
      wid1, dmin, dmax);
  if (c0 < wid0) {
    first[row * wid0 + c0] = r.first;
    if (need_last) last[row * wid0 + c0] = r.last;
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
