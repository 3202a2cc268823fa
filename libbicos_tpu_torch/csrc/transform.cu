// Descriptor transform: (n, H, W) u8/u16 image stacks -> (H, W, nw) packed
// 32-bit descriptor words, LSB-first in the reference's bit append order
// (descriptor_transform.hpp), for LIMITED and FULL.
//
// Replaces the Pallas kernel
// libbicos_tpu/kernels/transform.py::_transform_kernel, and the descriptor
// half of libbicos_tpu/kernels/hamming.py::_minima_kernel_bf16_stack (the
// TPU builds descriptor bits on chip from MXU contractions; here they are
// written once to device memory and the scan in hamming.cu reads them
// back).
//
// Bound on the card: device memory. A pixel reads its n samples and writes
// nw words (n=33 u8 LIMITED: 33 B in, 16 B out). One thread per pixel; the
// n samples of a pixel are H*W apart, so neighbouring threads read
// neighbouring addresses and every load is coalesced. The series is read
// twice (its sum first, for the mean bits); the second pass hits the cache.
// The mean bit uses the exact integer form n*s[t] < sum: no divide.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct WordWriter {
  uint32_t* out;
  uint32_t cur;
  int pos;

  __device__ void emit(bool bit) {
    cur |= static_cast<uint32_t>(bit) << pos;
    if (++pos == 32) {
      *out++ = cur;
      cur = 0u;
      pos = 0;
    }
  }
  __device__ void flush() {
    if (pos) *out = cur;
  }
};

template <typename T>
__global__ void transform_kernel(const T* __restrict__ stack,
                                 uint32_t* __restrict__ words, int n,
                                 int64_t hw, int full, int nw) {
  const int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (p >= hw) return;
  const T* s = stack + p;
  auto at = [&](int t) { return static_cast<int>(s[t * hw]); };

  int total = 0;
  for (int t = 0; t < n; ++t) total += at(t);

  WordWriter wr{words + p * nw, 0u, 0};
  if (!full) {
    int ps2 = 0, ps1 = 0;  // pair sums of t-2 and t-1
    for (int t = 0; t < n - 2; ++t) {
      const int a = at(t), b = at(t + 1), c = at(t + 2);
      wr.emit(a < b);
      wr.emit(a < c);
      wr.emit(n * a < total);
      const int cur = a + b;
      if (t >= 2) wr.emit(ps2 < cur);
      ps2 = ps1;
      ps1 = cur;
    }
    const int a = at(n - 2), b = at(n - 1);
    wr.emit(a < b);
    wr.emit(n * a < total);
    wr.emit(n * b < total);
    // n < 4: the reference's pair-sum slot is still -1, so the bit is 1.
    wr.emit(n >= 4 ? ps2 < a + b : true);
  } else {
    for (int t = 0; t < n - 2; ++t) {
      const int a = at(t), b = at(t + 1), c = at(t + 2);
      wr.emit(a < b);
      wr.emit(a < c);
      wr.emit(n * a < total);
    }
    const int a = at(n - 2), b = at(n - 1);
    wr.emit(a < b);
    wr.emit(n * a < total);
    wr.emit(n * b < total);
    for (int t = 0; t < n - 1; ++t) {
      const int pt = at(t) + at(t + 1);
      for (int i = 0; i < n - 1; ++i) {
        if (i >= t - 1 && i <= t + 1) continue;
        wr.emit(pt < at(i) + at(i + 1));
      }
    }
  }
  wr.flush();
}

}  // namespace

extern "C" const char* bicos_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int bicos_transform(int device, const void* stack, void* words,
                               int n, int h, int w, int u16, int full, int nw,
                               void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((hw + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u16) {
    transform_kernel<uint16_t><<<blocks, threads, 0, st>>>(
        static_cast<const uint16_t*>(stack), static_cast<uint32_t*>(words),
        n, hw, full, nw);
  } else {
    transform_kernel<uint8_t><<<blocks, threads, 0, st>>>(
        static_cast<const uint8_t*>(stack), static_cast<uint32_t*>(words), n,
        hw, full, nw);
  }
  return static_cast<int>(cudaGetLastError());
}
