// The W-band ring steps: a left column band of packed descriptors, at
// global column off0, scanned against one visiting right band at global
// column off1 (w the row's real width, gcol = off1 + j the global right
// column, gcol0 = off0 + c0 the global left column).
//
// The NoDuplicates step folds into the running packed minima of the left
// band:
//
//   mf = min(mf, cost * PACK_K + gcol)
//   ml = min(ml, cost * PACK_K + (w - 1 - gcol))
//
// The fused Consistency step folds the same pairs into those minima and,
// with the roles swapped, into the reverse minima of the right columns,
// (H, n * band) int32 accumulators indexed by the global right column:
//
//   rf[gcol] = min(rf[gcol], cost * PACK_K + gcol0)
//   rl[gcol] = min(rl[gcol], cost * PACK_K + (w - 1 - gcol0))
//
// so one ring of visits gives both directions and pays each popcount once.
// After every band has visited, mf and ml decode to the global (cost,
// first, last) argmin of each left pixel, and rf and rl (minimum-reduced
// over the processes of a mesh) to those of each right column.
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
// col in int32, decoded by search.decode_packed_minima. The TPU runs a
// second ring for Consistency because its band kernels keep only minima
// along one axis; here the fused step keeps both.
//
// Bound on the card: popcount issue rate, as hamming.cu. A full ring does
// the same H*W0*W1*nw popcounts as the single-card scan, in n*n launches;
// a ranged step visits only the pairs whose global disparity can lie in
// [dmin, dmax] (the range shifted by off0 - off1 into band coordinates),
// so a ring step outside the range costs a launch and no scan.
//
// Design, NoDuplicates step: hamming.cu's scan (row_scan.cuh): one block
// per (row, tile of TPB left pixels), one thread per left pixel, the right
// band streamed through shared memory. Right columns at or past w (the
// ring's padding) are cut off before the scan. Each thread folds its own
// pixel (one read-min-write of its own mf/ml words, no atomics), so ties
// across bands keep first-occurrence order exactly and the result does not
// depend on the order of the visits.
//
// Design, Consistency step: consistency.cu's fold (cons_scan.cuh), one
// block per row of the held band, its warps on tiles of TILE left pixels.
// Left and right columns at or past w are cut off on both sides. Each
// thread folds its pixels' forward minima into mf/ml (one read-min-write,
// no atomics). The visiting band's reverse minima stay in the block's
// shared memory for the launch (8 * band bytes, 6.6 KB at a band of 825)
// and go to rf/rl with one read-min-write per column at the end: no global
// atomics. A band too wide for the block's shared memory (a 1-band mesh at
// w = 32767: 262 KB) folds them straight into rf/rl with global atomicMin
// instead (GLOBAL_REV; the block owns its row of the accumulators).

#include <algorithm>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "cons_scan.cuh"
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


constexpr int PACK_S = 15;  // PACK_K = 2^PACK_S
namespace cons = bicos::cons;

struct ConsArgs {
  const uint32_t* words0;  // (h, band0, NW)
  const uint32_t* words1;  // (h, band, NW)
  int32_t* mf;             // (h, band0)
  int32_t* ml;
  int32_t* rf;             // (h, rstride), indexed by the global column
  int32_t* rl;
  int band0, band, wid0, wid1, off0, off1, w, rstride, dmin, dmax;
};

size_t cons_smem_bytes(int nw, int wid1, bool last, bool global_rev) {
  const size_t stage = cons::stage_bytes(nw);
  return global_rev ? stage
                    : stage + sizeof(int32_t) * (last ? 2 : 1) * wid1;
}

template <int NW, bool LAST, bool GLOBAL_REV>
__global__ void __launch_bounds__(cons::TPB, cons::min_blocks(NW, LAST))
band_consistency_kernel(ConsArgs p) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int64_t row = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* stage = smem + warp * cons::stage_words(NW);
  int32_t* const grf = p.rf + row * p.rstride + p.off1;
  int32_t* const grl = LAST ? p.rl + row * p.rstride + p.off1 : nullptr;
  int32_t* rf = grf;
  int32_t* rl = grl;
  if (!GLOBAL_REV) {
    rf = reinterpret_cast<int32_t*>(smem +
                                    cons::WARPS * cons::stage_words(NW));
    rl = rf + p.wid1;
    for (int i = threadIdx.x; i < p.wid1; i += cons::TPB) {
      rf[i] = INT_MAX;
      if (LAST) rl[i] = INT_MAX;
    }
    __syncthreads();
  }

  cons::Row r{p.words0 + row * p.band0 * NW, p.words1 + row * p.band * NW,
              rf, rl, p.wid0, p.wid1, p.dmin, p.dmax,
              p.off1, p.w - 1 - p.off1, p.off0, p.w - 1 - p.off0};
  constexpr int TILE = cons::TILE, P = cons::P;
  const int tiles = (p.wid0 + TILE - 1) / TILE;
  for (int t = warp; t < tiles; t += cons::WARPS) {
    int32_t f[P], l[P];
    cons::scan_tile<NW, PACK_S, LAST>(r, stage, t * TILE, f, l);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int c0 = t * TILE + 32 * q + lane;
      if (c0 >= p.wid0 || f[q] >= cons::none_lim<PACK_S>()) continue;
      const int64_t i = row * p.band0 + c0;
      p.mf[i] = min(p.mf[i], f[q]);
      if (LAST) p.ml[i] = min(p.ml[i], l[q]);
    }
  }
  if (!GLOBAL_REV) {
    __syncthreads();
    for (int j = threadIdx.x; j < p.wid1; j += cons::TPB) {
      if (rf[j] != INT_MAX) grf[j] = min(grf[j], rf[j]);
      if (LAST && rl[j] != INT_MAX) grl[j] = min(grl[j], rl[j]);
    }
  }
}

template <int NW, bool LAST, bool GLOBAL_REV>
int launch_cons(const ConsArgs& p, int h, cudaStream_t st) {
  const size_t bytes = cons_smem_bytes(NW, p.wid1, LAST, GLOBAL_REV);
  auto* kern = band_consistency_kernel<NW, LAST, GLOBAL_REV>;
  if (bytes > 48 * 1024) {
    if (cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes)))
      return static_cast<int>(e);
  }
  kern<<<h, cons::TPB, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int NW>
int launch_cons_nw(const ConsArgs& p, int h, bool last, bool global,
                   cudaStream_t st) {
  if (last)
    return global ? launch_cons<NW, true, true>(p, h, st)
                  : launch_cons<NW, true, false>(p, h, st);
  return global ? launch_cons<NW, false, true>(p, h, st)
                : launch_cons<NW, false, false>(p, h, st);
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

// words0: (h, band0, nw) held left band at global column off0; words1:
// (h, band, nw) visiting right band at global column off1; mf, ml: (h,
// band0) int32 forward accumulators; rf, rl: (h, rstride) int32 reverse
// accumulators (ml and rl both null without last). Left and right columns
// at or past w are skipped. dmin/dmax are read only with has_range, already
// shifted into band coordinates (c0 - j) and clamped into [-wid1, wid0] by
// the caller (wid0 = min(band0, w - off0), wid1 = min(band, w - off1)).
extern "C" int bicos_consistency_band(int device, const void* words0,
                                      const void* words1, void* mf, void* ml,
                                      void* rf, void* rl, int h, int band0,
                                      int band, int nw, int off0, int off1,
                                      int w, int rstride, int has_range,
                                      int dmin, int dmax, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int limit = 0;
  if (cudaError_t e = cudaDeviceGetAttribute(
          &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device))
    return static_cast<int>(e);
  const int wid0 = std::max(0, std::min(band0, w - off0));
  const int wid1 = std::max(0, std::min(band, w - off1));
  const bool last = ml != nullptr;
  const bool global =
      cons_smem_bytes(nw, wid1, last, false) > static_cast<size_t>(limit);
  ConsArgs p{static_cast<const uint32_t*>(words0),
             static_cast<const uint32_t*>(words1),
             static_cast<int32_t*>(mf), static_cast<int32_t*>(ml),
             static_cast<int32_t*>(rf), static_cast<int32_t*>(rl),
             band0, band, wid0, wid1, off0, off1, w, rstride,
             has_range ? dmin : -wid1, has_range ? dmax : wid0};
  switch (nw) {
    case 1: return launch_cons_nw<1>(p, h, last, global, st);
    case 2: return launch_cons_nw<2>(p, h, last, global, st);
    case 3: return launch_cons_nw<3>(p, h, last, global, st);
    case 4: return launch_cons_nw<4>(p, h, last, global, st);
    case 5: return launch_cons_nw<5>(p, h, last, global, st);
    case 6: return launch_cons_nw<6>(p, h, last, global, st);
    case 7: return launch_cons_nw<7>(p, h, last, global, st);
    case 8: return launch_cons_nw<8>(p, h, last, global, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
