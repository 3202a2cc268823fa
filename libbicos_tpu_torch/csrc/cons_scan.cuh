// One warp's fused forward + reverse Hamming scan of a tile of left pixels
// against a right row, shared by the Consistency scan (consistency.cu) and
// the fused Consistency ring step (band.cu).
//
// A warp holds a tile of TILE = 32 * P left pixels, P in each thread's
// registers (pixel t0 + 32 * p + lane), and walks the right columns of the
// tile's window in increasing order, STAGE at a time (a chunk). Every
// (pixel, column) pair costs nw popcounts, and its cost serves both
// directions. The callers want 32-bit packed minima,
//
//   forward, per pixel:   f = min(f, cost << S | (fbase + j))
//                         l = min(l, cost << S | (lbase1 - j))
//   reverse, per column:  rf[j] = min(rf[j], cost << S | (rbase + c0))
//                         rl[j] = min(rl[j], cost << S | (lbase0 - c0))
//
// with every term below 2^S, so that a plain minimum keeps the least cost
// and, among equal costs, the least (first) or the greatest (last) column
// in any order: ties do not depend on the walk, the warp or the block.
//
// The bound is the popcount pipe: nw __popc a pair at 16 a clock an SM,
// beside an integer ALU of 64 a clock, so the fold has room for about 4
// ALU instructions a popcount, and every instruction a pair spends on
// packing, minima and reductions beyond the XORs eats into it. The fold
// keeps both directions in 16-bit keys, cost << KEY | k (cost <= 256, or
// NONE = 511 out of range; k < 2^KEY), the first's key in the low half of
// a register and the last's in the high half, where k counts the other way
// (STAGE - 1 - k, or TILE - 1 - k):
//
//   forward: k = the column's index in the chunk. Each pixel keeps one
//            register fk a chunk; one add-then-min of two 16-bit lanes
//            (__viaddmin_u16x2, one Hopper DPX instruction) folds the
//            pair's cost * DUP (the cost shifted into both halves, one
//            multiply) plus the column's keys into it. After the chunk fk
//            widens into the 32-bit f and l.
//   reverse: k = the pixel's index in the tile. Per column, each thread
//            folds its P pixels' cost * DUP plus their keys with the same
//            instruction; one transposed butterfly (GROUP - 1 shuffles,
//            and one more for each halving of 32 / GROUP) takes first and
//            last together to lane L < GROUP, which holds column L of the
//            group and stores it in the warp's key buffer. After the chunk
//            each lane widens the keys of one column in 32 and folds them
//            into rf and rl with one atomicMin each.
//
// The least 16-bit key is the least cost, then the first (or last) index;
// across chunks and tiles the 32-bit minimum decides, so the results and
// their tie order are those of a fold in 32 bits throughout, with one
// popcount per (pixel, column, word).
//
// Ranges: a pair counts only when dmin <= c0 - j <= dmax (both row-local;
// callers shift a global range into these coordinates and clamp it into
// [-wid1, wid0], and pass (-wid1, wid0) for the full row). The warp visits
// only the columns its tile can reach. A group of columns in which every
// pair is in range (the whole row when unranged, the middle of a ranged
// window) runs without masks; the others give an out-of-range pair the cost
// NONE, so its keys lie at or above NONE_KEY and fold nowhere (a pixel
// whose pairs are all out of range widens to at or above none_lim()).
//
// The right row streams through a per-warp staging buffer in shared memory
// (STAGE columns at a time, with the chunk's reverse keys beside them), so
// the warps of a block never wait for each other inside the scan.

#pragma once

#include <climits>
#include <cstddef>
#include <cstdint>

namespace bicos {
namespace cons {

constexpr int P = 2;               // left pixels a thread
constexpr int TILE = 32 * P;       // left pixels a warp tile
constexpr int WARPS = 8;           // warps a block
constexpr int TPB = 32 * WARPS;
constexpr int STAGE = 128;         // right columns a warp stages at once
constexpr int GROUP = 8;           // columns a transposed reduction serves
constexpr int NONE = 511;          // the cost of a pair outside the range
constexpr unsigned FULL = 0xffffffffu;
constexpr int KEY = 7;             // index bits of a 16-bit key
// cost * DUP puts cost << KEY in both halves of a key pair.
constexpr uint32_t DUP = 1u << KEY | 1u << (16 + KEY);
constexpr uint32_t NONE_KEY = 257u << KEY;  // keys of no pair in range
constexpr uint32_t STEP = 0xffff0001u;  // next column's keys: +1 low, -1 high

static_assert(STAGE <= 1 << KEY && TILE <= 1 << KEY,
              "chunk columns and tile pixels must fit a key's index bits");
static_assert(((NONE << KEY) | ((1 << KEY) - 1)) <= 0xffff,
              "a key must fit 16 bits");

// The blocks an SM that a kernel on this fold asks ptxas to fit
// (__launch_bounds__(TPB, min_blocks(NW, LAST))): up to 80 registers a
// thread at 3, 128 at 2; the instances with more words a pixel need the
// 128. Without a minimum, ptxas trims some instances to 64 registers (four
// blocks) and spills a few words in the scan loop.
__host__ __device__ constexpr int min_blocks(int nw, bool last) {
  return nw >= 6 || (last && nw >= 5) ? 2 : 3;
}

// Packed values at or above this come from no pair in range (cost > 256).
template <int S>
__host__ __device__ constexpr int32_t none_lim() {
  return 257 << S;
}

// Words of a warp's staging buffer: a chunk's STAGE * nw right words, then
// its STAGE reverse key pairs.
__host__ __device__ constexpr int stage_words(int nw) {
  return STAGE * (nw + 1);
}

// Bytes of the block's staging buffers, at the start of its dynamic shared
// memory (16-byte aligned, so each warp's buffer is too).
inline size_t stage_bytes(int nw) {
  return sizeof(uint32_t) * WARPS * stage_words(nw);
}

struct Row {
  const uint32_t* left;   // the row's left words: wid0 pixels x NW
  const uint32_t* right;  // the row's right words: at least wid1 x NW
  int32_t* rf;            // reverse minima by right column (shared or
  int32_t* rl;            // global; rl unused without LAST)
  int wid0, wid1;         // left pixels, right columns
  int dmin, dmax;         // row-local c0 - j range, clamped
  int fbase, lbase1;      // forward terms fbase + j and lbase1 - j
  int rbase, lbase0;      // reverse terms rbase + c0 and lbase0 - c0
};

// A 16-bit key (cost << KEY | k) as the packed value cost << S | (base + k).
template <int S>
__device__ __forceinline__ int32_t widen(uint32_t key, int32_t base) {
  return static_cast<int32_t>(((key >> KEY) << S) + (key & ((1u << KEY) - 1)) +
                              static_cast<uint32_t>(base));
}

// One right column's NW words from the staging buffer.
template <int NW>
__device__ __forceinline__ void load_col(const uint32_t* st,
                                         uint32_t (&b)[NW]) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int k = 0; k < NW; k += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(st + k);
      b[k] = v.x;
      b[k + 1] = v.y;
      b[k + 2] = v.z;
      b[k + 3] = v.w;
    }
  } else if constexpr (NW % 2 == 0) {
#pragma unroll
    for (int k = 0; k < NW; k += 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(st + k);
      b[k] = v.x;
      b[k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NW; ++k) b[k] = st[k];
  }
}

// Lane L ends with v[0] = the lane-wise 16-bit minimum over the warp's
// lanes of their v[L % K] (K a power of two up to 32). The levels recurse
// at compile time, so every index is a constant and v stays in registers.
template <int K, int OFF>
__device__ __forceinline__ void transpose_min(uint32_t (&v)[K], int lane) {
  if constexpr (OFF >= 1 && OFF < K) {
    // Halve: keep the columns of this lane's half, fold in the partner's.
    const bool up = (lane & OFF) != 0;
#pragma unroll
    for (int k = 0; k < OFF; ++k) {
      const uint32_t send = up ? v[k] : v[k + OFF];
      const uint32_t keep = up ? v[k + OFF] : v[k];
      v[k] = __vminu2(keep, __shfl_xor_sync(FULL, send, OFF));
    }
    transpose_min<K, OFF / 2>(v, lane);
  } else if constexpr (OFF >= K && OFF < 32) {
    // One column left: fold in the lanes that hold the same column.
    v[0] = __vminu2(v[0], __shfl_xor_sync(FULL, v[0], OFF));
    transpose_min<K, OFF * 2>(v, lane);
  } else if constexpr (OFF == 0) {
    transpose_min<K, K>(v, lane);
  }
}

struct Tile {
  int e[P];          // c0 - dmin: column j is in range for the pixel iff
  unsigned width;    // e - j lies in [0, width = dmax - dmin] and j < wid1
                     // (e = -1 for a pixel past the row: none is)
  uint32_t key[P];   // its reverse keys: k | (TILE - 1 - k) << 16
  int32_t rbase;     // reverse widen bases: rbase + t0 for the first keys,
  int32_t lbase;     // lbase0 - t0 - (TILE - 1) for the last keys
};

// The GROUP columns [gc, gc + GROUP) staged at st, whose forward keys start
// at kg (the first column's); their reverse key pairs go to keys. MASKED:
// some pair may be out of range (or past the window's end, for the last
// group).
template <int NW, bool MASKED>
__device__ __forceinline__ void scan_group(
    const Row& r, const uint32_t* st, uint32_t* keys, int gc, uint32_t kg,
    const uint32_t (&a)[P][NW], const Tile& t, uint32_t (&fk)[P],
    int lane) {
  uint32_t v[GROUP];
#pragma unroll
  for (int jj = 0; jj < GROUP; ++jj) {
    const uint32_t kj = kg + jj * STEP;
    const bool past = MASKED && gc + jj >= r.wid1;
    uint32_t b[NW];
    load_col<NW>(st + jj * NW, b);
    uint32_t m = FULL;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      uint32_t cost = 0;
#pragma unroll
      for (int k = 0; k < NW; ++k) cost += __popc(a[p][k] ^ b[k]);
      uint32_t c = cost * DUP;
      if (MASKED &&
          (past || static_cast<unsigned>(t.e[p] - gc - jj) > t.width))
        c = NONE * DUP;
      fk[p] = __viaddmin_u16x2(c, kj, fk[p]);
      m = __viaddmin_u16x2(c, t.key[p], m);
    }
    v[jj] = m;
  }
  transpose_min<GROUP, GROUP / 2>(v, lane);
  // Lane L < GROUP holds column gc + L.
  if (lane < GROUP) keys[lane] = v[0];
}

// The warp's scan of the left pixels [t0, t0 + TILE) (those below wid0)
// against the right row: returns each pixel's forward minima in f and l
// (INT_MAX where no column was visited, at or above none_lim<S>() where no
// pair was in range) and folds the reverse minima into r.rf and r.rl with
// atomicMin. stage: this warp's stage_words(NW) staging words. Every lane of
// the warp must call it.
template <int NW, int S, bool LAST>
__device__ __forceinline__ void scan_tile(const Row& r, uint32_t* stage,
                                          int t0, int32_t (&f)[P],
                                          int32_t (&l)[P]) {
  const int lane = threadIdx.x & 31;
  const int tend = min(t0 + TILE, r.wid0);
  uint32_t a[P][NW];
  Tile t;
  t.width = static_cast<unsigned>(r.dmax - r.dmin);
  t.rbase = r.rbase + t0;
  t.lbase = r.lbase0 - t0 - (TILE - 1);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int k = 32 * p + lane, c0 = t0 + k;
    const bool live = c0 < r.wid0;
    const uint32_t* px = r.left + static_cast<int64_t>(c0) * NW;
#pragma unroll
    for (int w = 0; w < NW; ++w) a[p][w] = live ? px[w] : 0u;
    t.e[p] = live ? c0 - r.dmin : -1;
    t.key[p] = static_cast<uint32_t>(k | (TILE - 1 - k) << 16);
    f[p] = INT_MAX;
    l[p] = INT_MAX;
  }
  // The tile's window, and the columns where every pixel of a full tile is
  // in range: [tend - 1 - dmax, t0 - dmin].
  const int wlo = max(0, t0 - r.dmax);
  const int whi = min(r.wid1, tend - r.dmin);
  const bool full = tend - t0 == TILE;
  const int ilo = tend - 1 - r.dmax, ihi = t0 - r.dmin;
  for (int base = wlo; base < whi; base += STAGE) {
    const int cols = min(STAGE, whi - base);
    __syncwarp();
    const uint32_t* src = r.right + static_cast<int64_t>(base) * NW;
    for (int i = lane; i < cols * NW; i += 32) stage[i] = src[i];
    __syncwarp();
    uint32_t fk[P];
#pragma unroll
    for (int p = 0; p < P; ++p) fk[p] = FULL;
    uint32_t* const keys = stage + STAGE * NW;
    for (int g = 0; g < cols; g += GROUP) {
      const int gc = base + g;
      // Column g's keys in the chunk: g low, STAGE - 1 - g high.
      const uint32_t kg = g * STEP + ((STAGE - 1) << 16);
      if (full && g + GROUP <= cols && gc >= ilo && gc + GROUP - 1 <= ihi)
        scan_group<NW, false>(r, stage + g * NW, keys + g, gc, kg, a, t, fk,
                              lane);
      else
        scan_group<NW, true>(r, stage + g * NW, keys + g, gc, kg, a, t, fk,
                             lane);
    }
    // The chunk's reverse minima, one column a lane; a column past the
    // window, or with no pair in range, holds only NONE keys.
    __syncwarp();
    for (int i = lane; i < cols; i += 32) {
      const uint32_t kf = keys[i] & 0xffffu, kl = keys[i] >> 16;
      if (kf < NONE_KEY) atomicMin(r.rf + base + i, widen<S>(kf, t.rbase));
      if constexpr (LAST)
        if (kl < NONE_KEY) atomicMin(r.rl + base + i, widen<S>(kl, t.lbase));
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      f[p] = min(f[p], widen<S>(fk[p] & 0xffffu, r.fbase + base));
      if constexpr (LAST)
        l[p] = min(l[p], widen<S>(fk[p] >> 16,
                                  r.lbase1 - base - (STAGE - 1)));
    }
  }
}

}  // namespace cons
}  // namespace bicos
