// Hamming row scan for the NoDuplicates search: for every left pixel, the
// first and the last column of the same right row whose packed descriptor
// has the least Hamming distance to the pixel's own.
//
// Replaces the Pallas kernel libbicos_tpu/kernels/hamming.py::_minima_kernel
// (search from packed words) and the scan half of
// hamming.py::_minima_kernel_bf16_stack (the fused stack search, whose
// descriptor half is transform.cu). The TPU computes Hamming distances as
// MXU matmuls over bit planes and packs (cost, column) into f32 values; on
// Hopper a distance is nw __popc of XOR-ed words and the argmin is kept as
// plain integers, so neither trick carries over.
//
// Bound on the card: popcount issue rate. The scan does H*W0*W1*nw
// popcounts (2200*3300*3300*4 = 9.6e10 at the headline call) and reads
// each right row once per tile of left pixels from L2.
//
// Design: one block per (row, tile of TPB left pixels). Each thread holds
// its left descriptor in registers and its (best, first, last) state; the
// right row streams through shared memory in chunks of CHUNK columns, which
// every thread reads as broadcasts. Each thread walks the columns in
// increasing order: cost < best moves `first`, cost <= best moves `last`.
// A row of any width is covered, since only one chunk is resident at a time
// (a whole row at W=3300 and nw=4 is 52.8 KB, over the 48 KB static limit).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TPB = 128;
constexpr int CHUNK = 512;

template <int NW>
__global__ void __launch_bounds__(TPB)
row_minima_kernel(const uint32_t* __restrict__ words0,
                  const uint32_t* __restrict__ words1,
                  int32_t* __restrict__ first, int32_t* __restrict__ last,
                  int wid0, int wid1, int need_last) {
  __shared__ uint32_t tile[CHUNK * NW];
  const int64_t row = blockIdx.x;
  const int c0 = blockIdx.y * TPB + threadIdx.x;
  const bool live = c0 < wid0;

  uint32_t a[NW];
  const uint32_t* left = words0 + (row * wid0 + c0) * NW;
#pragma unroll
  for (int k = 0; k < NW; ++k) a[k] = live ? left[k] : 0u;

  const uint32_t* right = words1 + row * wid1 * NW;
  int best = INT_MAX, bf = 0, bl = 0;
  for (int base = 0; base < wid1; base += CHUNK) {
    const int cols = min(CHUNK, wid1 - base);
    __syncthreads();
    for (int i = threadIdx.x; i < cols * NW; i += TPB)
      tile[i] = right[static_cast<int64_t>(base) * NW + i];
    __syncthreads();
    for (int j = 0; j < cols; ++j) {
      int cost = 0;
#pragma unroll
      for (int k = 0; k < NW; ++k) cost += __popc(a[k] ^ tile[j * NW + k]);
      if (cost < best) {
        best = cost;
        bf = base + j;
      }
      if (cost <= best) bl = base + j;
    }
  }
  if (live) {
    first[row * wid0 + c0] = bf;
    if (need_last) last[row * wid0 + c0] = bl;
  }
}

template <int NW>
void launch(const void* w0, const void* w1, void* first, void* last, int h,
            int wid0, int wid1, int need_last, cudaStream_t st) {
  const dim3 grid(h, (wid0 + TPB - 1) / TPB);
  row_minima_kernel<NW><<<grid, TPB, 0, st>>>(
      static_cast<const uint32_t*>(w0), static_cast<const uint32_t*>(w1),
      static_cast<int32_t*>(first), static_cast<int32_t*>(last), wid0, wid1,
      need_last);
}

}  // namespace

extern "C" int bicos_row_minima(int device, const void* words0,
                                const void* words1, void* first, void* last,
                                int h, int wid0, int wid1, int nw,
                                int need_last, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nw) {
    case 1:
      launch<1>(words0, words1, first, last, h, wid0, wid1, need_last, st);
      break;
    case 2:
      launch<2>(words0, words1, first, last, h, wid0, wid1, need_last, st);
      break;
    case 3:
      launch<3>(words0, words1, first, last, h, wid0, wid1, need_last, st);
      break;
    case 4:
      launch<4>(words0, words1, first, last, h, wid0, wid1, need_last, st);
      break;
    case 5:
      launch<5>(words0, words1, first, last, h, wid0, wid1, need_last, st);
      break;
    case 6:
      launch<6>(words0, words1, first, last, h, wid0, wid1, need_last, st);
      break;
    case 7:
      launch<7>(words0, words1, first, last, h, wid0, wid1, need_last, st);
      break;
    case 8:
      launch<8>(words0, words1, first, last, h, wid0, wid1, need_last, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
