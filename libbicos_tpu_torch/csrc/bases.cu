// Dynamic-window bases for the agree kernel's window variant: per (row,
// chunk of `chunk` left columns), over the kept pixels (valid disparity d,
// matched column col1 = col - d inside [0, w)), lo = min(col1) and
// hi = max(col1) (w - 1 and 0 where none is kept); the chunk's base is
// min(lo, wp - wcap) & ~127, or -1 unless hi <= base + wcap - 1. Columns
// from the disparity's width up to the padded width wp count as invalid.
//
// Replaces the Pallas kernel libbicos_tpu/kernels/agree.py::_bases_kernel
// (via _chunk_window_bases_pallas), and serves the same values the TPU
// search kernel emits from its epilogue (hamming.py's bases output) and the
// TPU agree kernel computes in-kernel: here one small kernel reads the
// int16 disparity after the search.
//
// Bound on the card: bytes. Each disparity element is read once (2 bytes;
// 14.5 MB at 2200 x 3300) and each base written once: 4.4 us at 3.35 TB/s.
// The work is a few integer operations a column, so the kernel has to keep
// enough loads in flight to cover the memory latency, and spend few
// instructions on each column.
//
// Design (the vector path): a warp takes kChunksPerWarp chunks of a row. A
// lane reads 4 columns as one 8-byte load; the warp's 32 lanes cover a
// 128-column slab, and a lane issues the loads of up to kSlabs slabs before
// it folds any of them. When the chunk is a multiple of 128 columns every
// slab lies in one chunk, so a chunk's lo/hi is each lane's fold of its
// slabs and one warp reduction when its last slab is folded. The fold
// works on the two int16 columns of a 32-bit word at once (16-bit SIMD):
// with widths up to 32768, col1 = col - d taken modulo 2^16 is below w
// exactly for a kept pixel (an invalid d = -32768 gives col + 32768 >= w),
// and so is (w - 1 - col) + d = w - 1 - col1, so lo and w - 1 - hi are
// plain unsigned 16-bit minima, initialised to w - 1: two adds and two
// minima for two columns, no compare. The path needs 8-byte aligned rows
// (W % 4 == 0 and an 8-byte aligned base; a 3300-column row is 6600 bytes,
// a multiple of 8 but not of 16). Columns past W in the last slab load as
// invalid; chunks wholly past W get the base of an empty chunk. The loop
// keeps a countdown of the chunk's slabs and a running output pointer:
// with a division and a remainder by the runtime chunk size in each
// unrolled slab, the same design took 9.7 us at 2200 x 3300 on an H100,
// and 7.4 us without (tools/bases_variants.py).
//
// The scalar path takes every other shape (chunk % 128 != 0, W % 4 != 0,
// an unaligned base, widths above 32768): one warp per (row, chunk), each
// lane striding through the chunk's columns with 2-byte loads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInvalid = -32768;
constexpr uint32_t kInvalidPair = 0x80008000u;  // two int16 -32768
constexpr int kWarps = 8;          // warps per block
constexpr int kChunksPerWarp = 2;  // chunks a warp folds, vector path
constexpr int kSlabs = 4;          // 128-column slabs a lane loads, then folds
constexpr int kMaxPackedWidth = 32768;

__device__ __forceinline__ int chunk_base(int lo, int hi, int wp, int wcap) {
  const int base = min(lo, wp - wcap) & ~127;
  return hi <= base + (wcap - 1) ? base : -1;
}

__global__ void __launch_bounds__(32 * kWarps)
bases_vec_kernel(const int16_t* __restrict__ disp,
                 int32_t* __restrict__ out, int h, int wd, int w, int wp,
                 int wcap, int chunk) {
  const int nc = wp / chunk;
  const int warps_per_row = (nc + kChunksPerWarp - 1) / kChunksPerWarp;
  const int64_t warp =
      blockIdx.x * static_cast<int64_t>(kWarps) + threadIdx.x / 32;
  const int64_t row = warp / warps_per_row;
  if (row >= h) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int c_begin =
      static_cast<int>(warp - row * warps_per_row) * kChunksPerWarp;
  const int c_end = min(c_begin + kChunksPerWarp, nc);
  const int groups = wd / 4;             // 4-column groups in the row
  const int slabs = (groups + 31) / 32;  // 128-column slabs
  const int per_chunk = chunk / 128;     // slabs a chunk
  const int s_begin = c_begin * per_chunk;
  const int s_end = min(c_end * per_chunk, slabs);
  // This lane's 4-column group in the warp's first slab, and its columns
  // (low half: the group's first column, high half: the second).
  const uint2* src = reinterpret_cast<const uint2*>(disp + row * wd) +
                     s_begin * 32 + lane;
  int g = s_begin * 32 + lane;
  uint32_t cols = static_cast<uint32_t>(g * 4) * 0x00010001u + 0x00010000u;
  int32_t* dst = out + row * nc + c_begin;
  const uint32_t top = static_cast<uint32_t>(w - 1) * 0x00010001u;
  uint32_t lo2 = top, hi2 = top;  // per half: min col1, min w - 1 - col1
  int left = per_chunk;           // slabs left in the current chunk
  for (int s0 = s_begin; s0 < s_end; s0 += kSlabs) {
    uint2 v[kSlabs];
#pragma unroll
    for (int u = 0; u < kSlabs; ++u)
      v[u] = s0 + u < s_end && g + 32 * u < groups
                 ? src[32 * u]
                 : make_uint2(kInvalidPair, kInvalidPair);
#pragma unroll
    for (int u = 0; u < kSlabs; ++u) {
      if (s0 + u < s_end) {  // warp-uniform
        const uint32_t wcols = __vsub2(top, cols);  // w - 1 - col
        lo2 = __vminu2(lo2, __vsub2(cols, v[u].x));
        lo2 = __vminu2(lo2, __vsub2(cols + 0x00020002u, v[u].y));
        hi2 = __vminu2(hi2, __vadd2(wcols, v[u].x));
        hi2 = __vminu2(hi2, __vadd2(__vsub2(wcols, 0x00020002u), v[u].y));
        cols += 128 * 0x00010001u;
        if (--left == 0 || s0 + u + 1 == slabs) {  // the chunk ends
          const int lo = __reduce_min_sync(
              0xffffffffu, static_cast<int>(min(lo2 & 0xffffu, lo2 >> 16)));
          const int hi = (w - 1) - __reduce_min_sync(
              0xffffffffu, static_cast<int>(min(hi2 & 0xffffu, hi2 >> 16)));
          if (lane == 0) *dst = chunk_base(lo, hi, wp, wcap);
          ++dst;
          lo2 = hi2 = top;
          left = per_chunk;
        }
      }
    }
    src += 32 * kSlabs;
    g += 32 * kSlabs;
  }
  // Chunks wholly past the data: nothing kept.
  const int empty = chunk_base(w - 1, 0, wp, wcap);
  const int first_empty = (slabs + per_chunk - 1) / per_chunk;
  for (int c = max(c_begin, first_empty) + lane; c < c_end; c += 32)
    out[row * nc + c] = empty;
}

__global__ void __launch_bounds__(32 * kWarps)
bases_kernel(const int16_t* disp, int32_t* out, int64_t pairs, int nc,
             int wd, int w, int wp, int wcap, int chunk) {
  const int64_t pair =
      blockIdx.x * static_cast<int64_t>(kWarps) + threadIdx.x / 32;
  if (pair >= pairs) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int64_t row = pair / nc;
  const int oc = static_cast<int>(pair - row * nc);
  const int16_t* drow = disp + row * wd;
  int lo = w - 1, hi = 0;
  const int c0 = oc * chunk;
  const int c_end = min(c0 + chunk, wd);
  for (int col = c0 + lane; col < c_end; col += 32) {
    const int d = drow[col];
    const int col1 = col - d;
    if (d != kInvalid && col1 >= 0 && col1 < w) {
      lo = min(lo, col1);
      hi = max(hi, col1);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) out[pair] = chunk_base(lo, hi, wp, wcap);
}

}  // namespace

extern "C" int bicos_chunk_window_bases(int device, const void* disp,
                                        void* out, int h, int wd, int w,
                                        int wp, int wcap, int chunk,
                                        void* stream) {
  int current = -1;
  if (cudaError_t e = cudaGetDevice(&current)) return static_cast<int>(e);
  if (current != device) {
    if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const int16_t*>(disp);
  auto* o = static_cast<int32_t*>(out);
  const int nc = wp / chunk;
  if (chunk % 128 == 0 && wd % 4 == 0 && wd <= kMaxPackedWidth &&
      w <= kMaxPackedWidth && reinterpret_cast<uintptr_t>(disp) % 8 == 0) {
    const int64_t warps = static_cast<int64_t>(h) *
                          ((nc + kChunksPerWarp - 1) / kChunksPerWarp);
    const unsigned blocks =
        static_cast<unsigned>((warps + kWarps - 1) / kWarps);
    bases_vec_kernel<<<blocks, 32 * kWarps, 0, s>>>(d, o, h, wd, w, wp, wcap,
                                                    chunk);
  } else {
    const int64_t pairs = static_cast<int64_t>(h) * nc;
    const unsigned blocks =
        static_cast<unsigned>((pairs + kWarps - 1) / kWarps);
    bases_kernel<<<blocks, 32 * kWarps, 0, s>>>(d, o, pairs, nc, wd, w, wp,
                                                wcap, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
