// One step of the W-band ring: a left column band of packed descriptors,
// at global column off0, scanned against one visiting right band at global
// column off1, folded into the running packed minima of the left band:
//
//   mf = min(mf, cost * PACK_K + gcol)
//   ml = min(ml, cost * PACK_K + (w1_total - 1 - gcol))
//
// over the visiting columns gcol = off1 + j. After every band has visited,
// mf and ml decode to the global (cost, first, last) argmin of the row.
//
// Replaces the Pallas kernels in libbicos_tpu/kernels/hamming.py:
// _minima_kernel_band (the ring step from packed words) and the scan half
// of _minima_kernel_band_stack (the fused ring step from raw bands, whose
// descriptor half is transform.cu, run once per band). The TPU rotates raw
// bands and re-transforms them on every visit to avoid a VPU unpack of
// the words; on Hopper the words are read as they are, so the ring rotates
// packed words (16 B a pixel at n=33, against 33 B of samples) and each
// band is transformed once. The TPU's f32 s*pack_s + col packing exists
// only because the MXU emits floats; here the packing is cost * 32768 +
// col in int32, decoded by search.decode_packed_minima.
//
// Bound on the card: popcount issue rate, as hamming.cu. A full ring does
// the same H*W0*W1*nw popcounts as the single-card scan, in n*n launches;
// a ranged step visits only the pairs whose global disparity can lie in
// [dmin, dmax] (the range shifted by off0 - off1 into band coordinates),
// so a ring step outside the range costs a launch and no scan.
//
// Design: hamming.cu's scan (row_scan.cuh): one block per (row, tile of TPB
// left pixels), one thread per left pixel, the right band streamed through
// shared memory. Right columns at or past w1_total (the ring's padding) are
// cut off before the scan. Each thread folds its own pixel (one
// read-min-write of its own mf/ml words, no atomics), so ties across bands
// keep first-occurrence order exactly and the result does not depend on the
// order of the visits.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_scan.cuh"

namespace {

using bicos::CHUNK;
using bicos::TPB;

constexpr int PACK_K = 32768;

template <int NW, bool RANGED>
__global__ void __launch_bounds__(TPB)
band_kernel(const uint32_t* __restrict__ words0,
            const uint32_t* __restrict__ words1, int32_t* __restrict__ mf,
            int32_t* __restrict__ ml, int wid0, int band, int wid1, int off1,
            int w1_total, int dmin, int dmax) {
  __shared__ uint32_t tile[CHUNK * NW];
  const int64_t row = blockIdx.x;
  const int t0 = blockIdx.y * TPB;
  const int c0 = t0 + threadIdx.x;
  const bicos::ScanResult r = bicos::scan_row<NW, RANGED>(
      words0 + row * wid0 * NW, words1 + row * band * NW, tile, t0, wid0,
      wid1, dmin, dmax);
  if (c0 < wid0 && r.first >= 0) {
    const int64_t i = row * wid0 + c0;
    const int32_t base = r.best * PACK_K;
    mf[i] = min(mf[i], base + off1 + r.first);
    if (ml != nullptr)
      ml[i] = min(ml[i], base + (w1_total - 1 - off1 - r.last));
  }
}

template <int NW>
void launch(const void* w0, const void* w1, void* mf, void* ml, int h,
            int wid0, int band, int wid1, int off1, int w1_total,
            int has_range, int dmin, int dmax, cudaStream_t st) {
  const dim3 grid(h, (wid0 + TPB - 1) / TPB);
  const auto* a = static_cast<const uint32_t*>(w0);
  const auto* b = static_cast<const uint32_t*>(w1);
  auto* f = static_cast<int32_t*>(mf);
  auto* l = static_cast<int32_t*>(ml);
  if (has_range)
    band_kernel<NW, true><<<grid, TPB, 0, st>>>(
        a, b, f, l, wid0, band, wid1, off1, w1_total, dmin, dmax);
  else
    band_kernel<NW, false><<<grid, TPB, 0, st>>>(
        a, b, f, l, wid0, band, wid1, off1, w1_total, 0, 0);
}

}  // namespace

// words0: (h, wid0, nw) left band; words1: (h, band, nw) visiting band, of
// which the first wid1 columns (those below w1_total) are scanned; mf, ml:
// (h, wid0) int32 accumulators (ml may be null). dmin/dmax are read only
// with has_range, already shifted into band coordinates (c0 - j) and
// clamped into [-wid1, wid0] by the caller.
extern "C" int bicos_row_minima_band(int device, const void* words0,
                                     const void* words1, void* mf, void* ml,
                                     int h, int wid0, int band, int wid1,
                                     int nw, int off1, int w1_total,
                                     int has_range, int dmin, int dmax,
                                     void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BICOS_CASE(K)                                                       \
  case K:                                                                   \
    launch<K>(words0, words1, mf, ml, h, wid0, band, wid1, off1, w1_total,  \
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
