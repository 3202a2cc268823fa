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
// 14.5 MB at 2200 x 3300) and each base written once, a few microseconds at
// 3.35 TB/s. Design: one warp per (row, chunk); its lanes stride through
// the chunk's columns (coalesced int16 loads), fold lo/hi in registers, and
// finish with one __reduce_min_sync / __reduce_max_sync.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInvalid = -32768;
constexpr int kWarps = 8;  // (row, chunk) pairs per block

__global__ void bases_kernel(const int16_t* disp, int32_t* out,
                             int64_t pairs, int nc, int wd, int w, int wp,
                             int wcap, int chunk) {
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
  if (lane == 0) {
    const int base = min(lo, wp - wcap) & ~127;
    out[pair] = hi <= base + (wcap - 1) ? base : -1;
  }
}

}  // namespace

extern "C" int bicos_chunk_window_bases(int device, const void* disp,
                                        void* out, int h, int wd, int w,
                                        int wp, int wcap, int chunk,
                                        void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const int nc = wp / chunk;
  const int64_t pairs = static_cast<int64_t>(h) * nc;
  const unsigned blocks = static_cast<unsigned>((pairs + kWarps - 1) / kWarps);
  bases_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(disp), static_cast<int32_t*>(out), pairs,
      nc, wd, w, wp, wcap, chunk);
  return static_cast<int>(cudaGetLastError());
}
