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
// MXU matmuls over bit planes and packs (cost, column) into f32 values.
//
// Two kernels share the name row_minima_kernel:
//
// * row_minima_kernel<NW> scans the full row (no range) on the 1-bit tensor
//   cores. A distance is popc(a) + popc(b) - 2 popc(a & b); the AND
//   popcounts of a tile of 16 left pixels x 8 right columns are one
//   mma.sync m16n8k128 .b1 .and.popc for nw <= 4 and one m16n8k256 for nw
//   5-8, the words zero-padded to K in registers and shared memory only.
// * row_minima_kernel<NW, true> scans a range with one __popc of an XOR a
//   (pair, word) (row_scan.cuh, shared with the W-band ring step band.cu).
//   A warp visits only the (32 + dmax - dmin) columns its pixels can reach,
//   O(W * range) and not O(W^2). It is the slower design even so: at the
//   headline with range [0, 511] it takes 3.8 ms, the full-row tensor-core
//   scan of the same row 3.0-3.1 ms; a tensor-core scan limited to each
//   tile's column window is not written yet.
//   A pixel with no in-range column keeps the sentinels first = -1,
//   last = -2, as the JAX scan decodes them.
//
// Bound on the card (portbench/roofline.scan_bound): the larger of the
// (pixel, column) pairs x descriptor bits at the rate of every unit that
// forms exact bit products, and one 16-bit minimum a pair at 256 a clock
// an SM; 0.358 ms at the headline (2200 x 3300, 126 bits, the minima bind)
// and 0.625 ms at FULL n = 16 (227 bits, the products bind). What bounds
// this kernel is its epilogue, one IMAD and half a 3-input min a pair (64
// IMADs a clock an SM: 1.43 ms at the headline), and the wait of each warp
// on its own MMAs before it folds them. The design keeps the epilogue to
// that:
//
// * Keys. A block of WARPS warps takes PIXELS left pixels of one row, a
//   warp MT tiles of 16, its A fragments in registers. The accumulators
//   start at 0 (RZ: a per-pixel start would cost four register copies an
//   MMA), so they end as popc(a & b), and one IMAD turns each into a
//   16-bit key pair, key = acc * -(2 << S) * (1 + 2^16) + addend, whose
//   halves read (cost - popc(a) + 32 nw) << S | k: the first's key low
//   with k, the last's high with 2^S - 1 - k. The right column's addend,
//   (popc(b) + 32 nw) << S with its k in each half, is computed once a
//   column when the row is staged; 32 nw covers any popc(a), so no half
//   goes below 0, and popc(a) is the pixel's own and moves no argmin. Any
//   of the nw words may have all 32 bits set, so the cost term is at most
//   64 nw: 9 bits for nw <= 4 (S = 7), 10 for nw 5-8 (S = 6).
// * Fold. A thread holds 2 rows x 2 columns of each tile; one
//   __vimin3_u16x2 folds a row's two new key pairs into its running one.
//   k counts the thread's own columns of a chunk of 4 << S columns (512
//   for nw <= 4, 256 for nw 5-8), 2 a tile, so that a smaller k is a
//   smaller column. After each chunk the running keys widen into 32-bit
//   minima cost << 22 | col and cost << 22 | (2^22 - 1 - col); after the
//   row the four lanes of a row take the least of each. Ties go to the
//   first and the last column of least cost, as in the popcount scan.
// * Right row. The block stages STAGE columns at a time in shared memory
//   (the whole row at W = 3300 for nw <= 4; two stages for nw 5-8), each
//   column's words laid out as its B fragment reads them, beside its
//   addend; a warp's B fragment is one conflict-free 32- or 64-bit load a
//   lane, its addends one broadcast 64-bit load. Rows of any width stream
//   through in stages; a key pair persists across a stage boundary.
//
// mma.sync and not wgmma: a wgmma pipeline (m64n64k256, two tiles a
// warpgroup in turn, one folded while the other computes) took 3.3-3.4 ms
// at the headline and 4.0-4.2 at FULL n = 16 against this kernel's
// 2.9-3.0 and 3.4, as ptxas serialises the wgmmas once the accumulators
// of one are read while another is in flight (C7514).

#include <atomic>
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

namespace mma {

constexpr int MT = 4;                    // 16-pixel tiles a warp
constexpr int WARPS = 8;                 // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr int PIXELS = 16 * MT * WARPS;  // left pixels a block
constexpr int MIN_BLOCKS = 2;            // up to 128 registers a thread
constexpr int COL_BITS = 22;             // check_words: widths <= 2^22
constexpr uint32_t COL_MASK = (1u << COL_BITS) - 1;
constexpr uint32_t NONE = 0xffffffffu;   // a key pair or minimum of no column
constexpr unsigned FULL = 0xffffffffu;

// Words of a column in a K tile: K = 128 bits for nw <= 4, else 256.
__host__ __device__ constexpr int kw(int nw) { return nw <= 4 ? 4 : 8; }
// Index bits S of a 16-bit key; the cost term takes the other 16 - S.
__host__ __device__ constexpr int key_bits(int nw) { return nw <= 4 ? 7 : 6; }
// Right columns a block stages at once: 4 * (kw + 1) bytes each.
__host__ __device__ constexpr int stage(int nw) {
  return nw <= 4 ? 3328 : 1664;
}

// Columns of the block's stage, and the dynamic shared memory it takes:
// the stage's words, then one addend a column.
__host__ __device__ inline int stage_cols(int nw, int wid1) {
  const int padded = (wid1 + 7) & ~7;
  return padded < stage(nw) ? padded : stage(nw);
}
inline size_t smem_bytes(int nw, int wid1) {
  return sizeof(uint32_t) * (kw(nw) + 1) * stage_cols(nw, wid1);
}

// d = popc(a & b) over a 16 x 8 tile, K = 32 * KW bits; the accumulator
// starts at 0 (RZ: no register copies).
template <int KW>
__device__ __forceinline__ void bmma(int (&d)[4], const uint32_t (&a)[KW / 2],
                                     const uint32_t (&b)[KW / 4]) {
  if constexpr (KW == 4)
    asm("mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%8,%9,%10};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b[0]), "r"(0), "r"(0), "r"(0), "r"(0));
  else
    asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "r"(0), "r"(0), "r"(0), "r"(0));
}

struct Lane {
  int g, t;  // the lane's row (g, g + 8) and column pair (2t, 2t + 1)
};

// The warp's MT tiles against 8 staged columns, folded into key: bw is the
// lane's B fragment (word t, or words t and t + 4, of column g), ad the
// addends of its columns 2t and 2t + 1. MASKED: some column of the tile is
// at or past wid1; j is the tile's first column.
template <int NW, bool MASKED>
__device__ __forceinline__ void scan_tile(
    const uint32_t* bw, const uint32_t* ad, int j, int wid1, Lane ln,
    const uint32_t (&a)[MT][kw(NW) / 2], uint32_t (&key)[MT][2]) {
  constexpr int KW = kw(NW), S = key_bits(NW);
  // acc * M subtracts 2 * acc << S from both halves of a key pair.
  constexpr uint32_t M = 0u - ((2u << S) | (2u << (16 + S)));
  uint32_t b[KW / 4];
  if constexpr (KW == 4) {
    b[0] = *bw;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(bw);
    b[0] = v.x;
    b[1] = v.y;
  }
  const uint2 add = *reinterpret_cast<const uint2*>(ad);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    int d[4];
    bmma<KW>(d, a[m], b);
    uint32_t k0 = static_cast<uint32_t>(d[0]) * M + add.x;
    uint32_t k1 = static_cast<uint32_t>(d[1]) * M + add.y;
    uint32_t k2 = static_cast<uint32_t>(d[2]) * M + add.x;
    uint32_t k3 = static_cast<uint32_t>(d[3]) * M + add.y;
    if (MASKED && j + 2 * ln.t >= wid1) k0 = k2 = NONE;
    if (MASKED && j + 2 * ln.t + 1 >= wid1) k1 = k3 = NONE;
    key[m][0] = __vimin3_u16x2(key[m][0], k0, k1);
    key[m][1] = __vimin3_u16x2(key[m][1], k2, k3);
  }
}

// A chunk's key pairs (chunk at column base) into the running minima
// bf (cost << 22 | col) and bl (cost << 22 | (2^22 - 1 - col)). A key pair
// of no column (NONE) widens to more than any real minimum, and below 2^32.
template <int NW>
__device__ __forceinline__ void widen(uint32_t base, Lane ln,
                                      uint32_t (&key)[MT][2],
                                      uint32_t (&bf)[MT][2],
                                      uint32_t (&bl)[MT][2]) {
  constexpr int S = key_bits(NW);
  constexpr uint32_t KMAX = (1u << S) - 1;
  const uint32_t lane_col = base + 2 * ln.t;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t kf = key[m][r] & 0xffffu, kl = key[m][r] >> 16;
      const uint32_t i = kf & KMAX, il = KMAX - (kl & KMAX);
      const uint32_t cf = lane_col + ((i >> 1) << 3) + (i & 1);
      const uint32_t cl = lane_col + ((il >> 1) << 3) + (il & 1);
      bf[m][r] = min(bf[m][r], ((kf >> S) << COL_BITS) + cf);
      bl[m][r] = min(bl[m][r], ((kl >> S) << COL_BITS) + (COL_MASK - cl));
      key[m][r] = NONE;
    }
  }
}

}  // namespace mma

// The full-row scan on the 1-bit tensor cores (the header above). Grid:
// one block per (row, PIXELS left pixels), rows outermost.
template <int NW>
__global__ void __launch_bounds__(mma::THREADS, mma::MIN_BLOCKS)
row_minima_kernel(const uint32_t* __restrict__ words0,
                  const uint32_t* __restrict__ words1,
                  int32_t* __restrict__ first, int32_t* __restrict__ last,
                  int wid0, int wid1, int need_last) {
  using namespace mma;
  constexpr int KW = kw(NW), S = key_bits(NW);
  constexpr uint32_t KMAX = (1u << S) - 1;
  constexpr int CHUNK_COLS = 4 << S;
  constexpr int UNROLL = KW == 4 ? 4 : 2;  // tiles a loop trip
  extern __shared__ __align__(16) uint32_t smem[];
  const int cap = stage_cols(NW, wid1);
  uint32_t* const sw = smem;             // cap x KW words, B-fragment order
  uint32_t* const sa = smem + cap * KW;  // cap addends

  const int per_row = (wid0 + PIXELS - 1) / PIXELS;
  const int64_t row = blockIdx.x / per_row;
  const int warp = threadIdx.x >> 5;
  const Lane ln{static_cast<int>(threadIdx.x & 31) >> 2,
               static_cast<int>(threadIdx.x & 3)};
  const int p0 = static_cast<int>(blockIdx.x % per_row) * PIXELS +
                 warp * 16 * MT;
  const uint32_t* left = words0 + row * wid0 * NW;
  const uint32_t* right = words1 + row * wid1 * NW;

  // A fragments: a[m][r] word t of pixel p0 + 16 m + 8 r + g, a[m][2 + r]
  // its word t + 4.
  uint32_t a[MT][KW / 2];
  uint32_t key[MT][2], bf[MT][2], bl[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = p0 + 16 * m + 8 * r + ln.g;
      const uint32_t* px = left + static_cast<int64_t>(q) * NW;
      const bool live = q < wid0;
      a[m][r] = live && ln.t < NW ? px[ln.t] : 0u;
      if constexpr (KW == 8)
        a[m][2 + r] = live && ln.t + 4 < NW ? px[ln.t + 4] : 0u;
      key[m][r] = bf[m][r] = bl[m][r] = NONE;
    }
  }

  const bool busy = p0 < wid0;
  for (int sbase = 0; sbase < wid1; sbase += cap) {
    const int cols = min(cap, wid1 - sbase);
    __syncthreads();
    for (int i = threadIdx.x; i < cols; i += THREADS) {
      const uint32_t* src = right + static_cast<int64_t>(sbase + i) * NW;
      uint32_t w[KW];
      uint32_t pb = 0;
#pragma unroll
      for (int k = 0; k < KW; ++k) {
        w[k] = k < NW ? src[k] : 0u;
        pb += __popc(w[k]);
      }
      if constexpr (KW == 4) {
        *reinterpret_cast<uint4*>(sw + i * 4) =
            make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        *reinterpret_cast<uint4*>(sw + i * 8) =
            make_uint4(w[0], w[4], w[1], w[5]);
        *reinterpret_cast<uint4*>(sw + i * 8 + 4) =
            make_uint4(w[2], w[6], w[3], w[7]);
      }
      // k: the column's index among its lane's columns of the chunk. The
      // bias 32 nw covers any popc(a), so no half goes below 0.
      const uint32_t j = sbase + i;
      const uint32_t k = (((j & (CHUNK_COLS - 1)) >> 3) << 1) | (j & 1u);
      const uint32_t add = (pb + 32 * NW) << S;
      sa[i] = (add | k) | (add | (KMAX - k)) << 16;
    }
    __syncthreads();
    if (!busy) continue;
    const int send = sbase + ((cols + 7) & ~7);
    for (int cb = sbase; cb < send;) {
      const int cend = min(send, (cb | (CHUNK_COLS - 1)) + 1);
      const int fend = min(cend, wid1 & ~7);
      const uint32_t* bw =
          sw + (cb - sbase + ln.g) * KW + (KW == 4 ? ln.t : 2 * ln.t);
      const uint32_t* ad = sa + (cb - sbase) + 2 * ln.t;
      int j = cb;
#pragma unroll(UNROLL)
      for (; j < fend; j += 8, bw += 8 * KW, ad += 8)
        scan_tile<NW, false>(bw, ad, j, wid1, ln, a, key);
      if (j < cend) scan_tile<NW, true>(bw, ad, j, wid1, ln, a, key);
      if ((cend & (CHUNK_COLS - 1)) == 0 || cend >= wid1)
        widen<NW>(cb & ~(CHUNK_COLS - 1), ln, key, bf, bl);
      cb = cend;
    }
  }

  // The least of each row's four lanes; lane t = 0 stores.
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t f = bf[m][r], l = bl[m][r];
      f = min(f, __shfl_xor_sync(FULL, f, 1));
      f = min(f, __shfl_xor_sync(FULL, f, 2));
      l = min(l, __shfl_xor_sync(FULL, l, 1));
      l = min(l, __shfl_xor_sync(FULL, l, 2));
      const int q = p0 + 16 * m + 8 * r + ln.g;
      if (ln.t == 0 && q < wid0) {
        first[row * wid0 + q] = static_cast<int32_t>(f & COL_MASK);
        if (need_last)
          last[row * wid0 + q] =
              static_cast<int32_t>(COL_MASK - (l & COL_MASK));
      }
    }
  }
}

// row_minima_kernel<NW>, told apart from the ranged one by its type.
using Scan = void (*)(const uint32_t*, const uint32_t*, int32_t*, int32_t*,
                      int, int, int);

// Lets row_minima_kernel<NW> take its largest stage (above the 48 KB of
// dynamic shared memory a kernel gets by default) on `device`; the
// attribute is set once an instance and device, not at every scan.
template <int NW>
cudaError_t allow_stage(Scan kern, int device) {
  static std::atomic<uint64_t> done{0};
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(uint32_t) * (mma::kw(NW) + 1) *
                       mma::stage(NW)));
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

template <int NW>
int launch(int device, const void* w0, const void* w1, void* first,
           void* last, int h, int wid0, int wid1, int need_last,
           int has_range, int dmin, int dmax, cudaStream_t st) {
  const auto* a = static_cast<const uint32_t*>(w0);
  const auto* b = static_cast<const uint32_t*>(w1);
  auto* f = static_cast<int32_t*>(first);
  auto* l = static_cast<int32_t*>(last);
  if (has_range) {
    const dim3 grid(h, (wid0 + TPB - 1) / TPB);
    row_minima_kernel<NW, true><<<grid, TPB, 0, st>>>(
        a, b, f, l, wid0, wid1, need_last, dmin, dmax);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t blocks =
      static_cast<int64_t>(h) * ((wid0 + mma::PIXELS - 1) / mma::PIXELS);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = mma::smem_bytes(NW, wid1);
  const Scan kern = row_minima_kernel<NW>;
  if (bytes > 48 * 1024) {
    if (cudaError_t e = allow_stage<NW>(kern, device))
      return static_cast<int>(e);
  }
  kern<<<static_cast<unsigned>(blocks), mma::THREADS, bytes, st>>>(
      a, b, f, l, wid0, wid1, need_last);
  return static_cast<int>(cudaGetLastError());
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
    return launch<K>(device, words0, words1, first, last, h, wid0, wid1,    \
                     need_last, has_range, dmin, dmax, st);
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
}
