// One warp's fused forward + reverse Hamming scan of a tile of left pixels
// against a right row, shared by the Consistency scan (consistency.cu) and
// the fused Consistency ring step (band.cu).
//
// A warp holds a tile of TILE = 32 * P left pixels, P in each thread's
// registers (pixel t0 + 32 * p + lane), and walks the right columns of the
// tile's window in increasing order. Every (pixel, column) pair costs nw
// popcounts, and its cost serves both directions:
//
//   forward, per pixel:   f = min(f, cost << S | (fbase + j))
//                         l = min(l, cost << S | (lbase1 - j))
//   reverse, per column:  rf[j] = min(rf[j], cost << S | (rbase + c0))
//                         rl[j] = min(rl[j], cost << S | (lbase0 - c0))
//
// Every term is below 2^S, so a plain minimum keeps the least cost and,
// among equal costs, the least (first) or the greatest (last) column in
// any order: ties do not depend on the walk, the warp or the block.
//
// The reverse minima are what made the one-pixel-a-thread scan slow: two
// warp reductions and two shared-memory atomics for every (warp, column).
// Here each thread first takes the minimum over its P pixels (plain integer
// min), and the warp keeps those for a group of GROUP columns in registers;
// then one transposed butterfly (GROUP - 1 shuffles, and one more for each
// halving of 32 / GROUP) leaves lane L < GROUP with the warp's minimum for
// column L of the group, and one atomicMin instruction folds the group.
// That is about one shuffle and three ALU operations per column and
// direction, against P * nw popcounts.
//
// Ranges: a pair counts only when dmin <= c0 - j <= dmax (both row-local;
// callers shift a global range into these coordinates and clamp it into
// [-wid1, wid0], and pass (-wid1, wid0) for the full row). The warp visits
// only the columns its tile can reach. A group of columns in which every
// pair is in range (the whole row when unranged, the middle of a ranged
// window) runs without masks; the others give an out-of-range pair the cost
// NONE, so its packed values lie at or above none_lim() and fold nowhere.
//
// The right row streams through a per-warp staging buffer in shared memory
// (STAGE columns at a time), so the warps of a block never wait for each
// other inside the scan.

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

// Bytes of the block's staging buffers, at the start of its dynamic shared
// memory (16-byte aligned, so each warp's buffer is too).
inline size_t stage_bytes(int nw) {
  return sizeof(uint32_t) * WARPS * STAGE * nw;
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

// Lane L ends with v[0] = the minimum over the warp's lanes of their
// v[L % K] (K a power of two up to 32). The levels recurse at compile time,
// so every index is a constant and v stays in registers.
template <int K, int OFF>
__device__ __forceinline__ void transpose_min(int32_t (&v)[K], int lane) {
  if constexpr (OFF >= 1 && OFF < K) {
    // Halve: keep the columns of this lane's half, fold in the partner's.
    const bool up = (lane & OFF) != 0;
#pragma unroll
    for (int k = 0; k < OFF; ++k) {
      const int32_t send = up ? v[k] : v[k + OFF];
      const int32_t keep = up ? v[k + OFF] : v[k];
      v[k] = min(keep, __shfl_xor_sync(FULL, send, OFF));
    }
    transpose_min<K, OFF / 2>(v, lane);
  } else if constexpr (OFF >= K && OFF < 32) {
    // One column left: fold in the lanes that hold the same column.
    v[0] = min(v[0], __shfl_xor_sync(FULL, v[0], OFF));
    transpose_min<K, OFF * 2>(v, lane);
  } else if constexpr (OFF == 0) {
    transpose_min<K, K>(v, lane);
  }
}

struct Tile {
  int lo[P];        // each pixel's in-range columns: [lo, lo + span)
  unsigned span[P];
  int32_t rt[P];    // its reverse terms (0 for a pixel past the row)
  int32_t lt[P];
};

// The GROUP columns [gc, gc + GROUP) staged at st. MASKED: some pair may
// be out of range (or past the window's end, for the last group).
template <int NW, int S, bool LAST, bool MASKED>
__device__ __forceinline__ void scan_group(
    const Row& r, const uint32_t* st, int gc, const uint32_t (&a)[P][NW],
    const Tile& t, int32_t (&f)[P], int32_t (&l)[P], int lane) {
  int32_t vf[GROUP], vl[GROUP];
#pragma unroll
  for (int jj = 0; jj < GROUP; ++jj) {
    const int j = gc + jj;
    // Past the window (only in the last, masked group) every pair is out of
    // range: clamp the column so that its terms stay below 2^S.
    const int jt = MASKED ? min(j, r.wid1 - 1) : j;
    const int32_t tf = r.fbase + jt, tl = r.lbase1 - jt;
    uint32_t b[NW];
    load_col<NW>(st + jj * NW, b);
    int32_t mf = INT_MAX, ml = INT_MAX;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      int cost = 0;
#pragma unroll
      for (int k = 0; k < NW; ++k) cost += __popc(a[p][k] ^ b[k]);
      if (MASKED && static_cast<unsigned>(j - t.lo[p]) >= t.span[p])
        cost = NONE;
      const int32_t hi = cost << S;
      f[p] = min(f[p], hi + tf);
      mf = min(mf, hi + t.rt[p]);
      if constexpr (LAST) {
        l[p] = min(l[p], hi + tl);
        ml = min(ml, hi + t.lt[p]);
      }
    }
    vf[jj] = mf;
    if constexpr (LAST) vl[jj] = ml;
  }
  transpose_min<GROUP, GROUP / 2>(vf, lane);
  if constexpr (LAST) transpose_min<GROUP, GROUP / 2>(vl, lane);
  // Lane L < GROUP holds column gc + L; a column past the window holds only
  // NONE costs.
  if (lane < GROUP) {
    if (vf[0] < none_lim<S>()) atomicMin(r.rf + gc + lane, vf[0]);
    if constexpr (LAST)
      if (vl[0] < none_lim<S>()) atomicMin(r.rl + gc + lane, vl[0]);
  }
}

// The warp's scan of the left pixels [t0, t0 + TILE) (those below wid0)
// against the right row: returns each pixel's forward minima in f and l
// (INT_MAX where no column was visited, at or above none_lim<S>() where no
// pair was in range) and folds the reverse minima into r.rf and r.rl with
// atomicMin. stage: this warp's STAGE * NW staging words. Every lane of the
// warp must call it.
template <int NW, int S, bool LAST>
__device__ __forceinline__ void scan_tile(const Row& r, uint32_t* stage,
                                          int t0, int32_t (&f)[P],
                                          int32_t (&l)[P]) {
  const int lane = threadIdx.x & 31;
  const int tend = min(t0 + TILE, r.wid0);
  uint32_t a[P][NW];
  Tile t;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c0 = t0 + 32 * p + lane;
    const bool live = c0 < r.wid0;
    const uint32_t* px = r.left + static_cast<int64_t>(c0) * NW;
#pragma unroll
    for (int k = 0; k < NW; ++k) a[p][k] = live ? px[k] : 0u;
    t.lo[p] = max(0, c0 - r.dmax);
    const int hi = live ? min(r.wid1, c0 - r.dmin + 1) : 0;
    t.span[p] = hi > t.lo[p] ? static_cast<unsigned>(hi - t.lo[p]) : 0u;
    t.rt[p] = live ? r.rbase + c0 : 0;
    t.lt[p] = live ? r.lbase0 - c0 : 0;
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
    for (int g = 0; g < cols; g += GROUP) {
      const int gc = base + g;
      if (full && g + GROUP <= cols && gc >= ilo && gc + GROUP - 1 <= ihi)
        scan_group<NW, S, LAST, false>(r, stage + g * NW, gc, a, t, f, l,
                                       lane);
      else
        scan_group<NW, S, LAST, true>(r, stage + g * NW, gc, a, t, f, l,
                                      lane);
    }
  }
}

}  // namespace cons
}  // namespace bicos
