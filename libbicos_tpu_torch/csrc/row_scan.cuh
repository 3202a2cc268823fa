// One thread's Hamming scan of one right row, shared by the NoDuplicates
// row scan (hamming.cu) and the W-band ring step (band.cu).
//
// A block of TPB threads covers the left pixels [t0, t0 + TPB) of one row.
// Each thread holds its left descriptor in registers; the right row's
// window streams through the block's shared `tile` in chunks of CHUNK
// columns, which every thread reads as broadcasts. Each thread walks the
// columns in increasing order: cost < best moves `first`, cost <= best
// moves `last`. Only one chunk is resident at a time, so a row of any width
// is covered (a whole row at W=3300 and nw=4 is 52.8 KB, over the 48 KB
// static limit).
//
// RANGED keeps only the pairs with dmin <= c0 - col <= dmax (c0 and col are
// row-local here; callers shift a global range into these coordinates).
// Column windows [lo, hi): the block's (what its tile can reach), the
// warp's (what its 32 pixels can reach; warp-uniform) and the thread's, so
// a ranged scan visits about (32 + dmax - dmin) columns per warp: O(W *
// range), not O(W^2). A pixel with no column in range keeps first = -1,
// last = -2 (and best = INT_MAX).

#pragma once

#include <climits>
#include <cstdint>

namespace bicos {

constexpr int TPB = 128;
constexpr int CHUNK = 512;

struct ScanResult {
  int best, first, last;
};

// words0_row: the left row (wid0 x NW words); right_row: the right row,
// of which the first wid1 columns are scanned; tile: CHUNK * NW shared
// words. Every thread of the block must call it (it synchronises).
template <int NW, bool RANGED>
__device__ __forceinline__ ScanResult scan_row(
    const uint32_t* __restrict__ words0_row,
    const uint32_t* __restrict__ right_row, uint32_t* tile, int t0,
    int wid0, int wid1, int dmin, int dmax) {
  const int c0 = t0 + threadIdx.x;
  const bool live = c0 < wid0;

  uint32_t a[NW];
  const uint32_t* left = words0_row + static_cast<int64_t>(c0) * NW;
#pragma unroll
  for (int k = 0; k < NW; ++k) a[k] = live ? left[k] : 0u;

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

  int best = INT_MAX, bf = -1, bl = -2;
  for (int base = blo; base < bhi; base += CHUNK) {
    const int cols = min(CHUNK, bhi - base);
    __syncthreads();
    for (int i = threadIdx.x; i < cols * NW; i += TPB)
      tile[i] = right_row[static_cast<int64_t>(base) * NW + i];
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
  return {best, bf, bl};
}

}  // namespace bicos
