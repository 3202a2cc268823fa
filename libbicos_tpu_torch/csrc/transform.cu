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
// nw words (n=33 u8 LIMITED: 33 B in, 16 B out; n=16 u8 FULL: 16 B in, 32 B
// out). The design moves both sides in whole vectors and spends two
// integer instructions a bit:
// * one block takes a tile of kTile consecutive pixels and copies the
//   tile's row of every shot into shared memory with cp.async, 16 bytes a
//   copy (16 u8 or 8 u16 pixels), all n rows in flight at once; a plane
//   whose start is only 8- or 4-byte aligned (h*w*sizeof(T) not a multiple
//   of 16, a stack that is a view at an offset) copies in 8 or 4 bytes, and
//   an odd-aligned u8 plane and the ragged last tile copy element by
//   element (the scalar edge path); a dozen resident blocks an SM overlap
//   one block's copies with the others' arithmetic;
// * the series is read from device memory once: the sum and the
//   comparisons read the shared-memory copy;
// * every bit is the sign of an exact int difference, funnel-shifted into
//   a 32-bit block (push), with one bit reversal a block. The two modes are
//   two kernels, since they differ in how the bits are ordered and how many
//   there are:
//   - LIMITED (4n - 7 bits, any n): one kernel over a runtime n
//     (limited_words: 8 shot groups a block; n = 2, 3 build their one word
//     of 4 or 7 bits directly);
//   - FULL (n^2 - 2n + 3 bits, so n = 2..16 within 256): one fully unrolled
//     kernel per (T, n) (full_words). The n samples are read from shared
//     memory into registers once, and the n - 1 pair sums and n mean
//     differences formed once; each series and pair-sum bit is then one
//     int difference and one funnel shift, and every word boundary is a
//     compile-time constant;
// * a pixel's words leave as whole 16-byte stores where nw is a multiple
//   of 4 (8-byte where even), so a warp writes contiguous bytes.
// The mean bit uses the exact integer form n*s[t] < sum: no divide; every
// comparison is the sign bit of an exact int difference (|d| < 2^31).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 512;  // pixels a block

template <int SZ>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (SZ == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(SZ)
                 : "memory");
  }
}

// x < y as bit 0 (|x - y| < 2^31).
__device__ __forceinline__ uint32_t lt(int x, int y) {
  return static_cast<uint32_t>(x - y) >> 31;
}

// A LIMITED pixel's words, each into a buffer of vw words (4, 2 or 1: the
// largest dividing nw) that leaves as one store.
struct WordOut {
  uint32_t* out;
  int vw;
  uint32_t b0 = 0, b1 = 0, b2 = 0;
  int nb = 0;

  __device__ void word(uint32_t v) {
    if (nb + 1 < vw) {
      if (nb == 0) b0 = v;
      else if (nb == 1) b1 = v;
      else b2 = v;
      ++nb;
      return;
    }
    if (vw == 4) *reinterpret_cast<uint4*>(out) = make_uint4(b0, b1, b2, v);
    else if (vw == 2) *reinterpret_cast<uint2*>(out) = make_uint2(b0, v);
    else *out = v;
    out += vw;
    nb = 0;
  }
};

// Appends the bit x < y, given d = x - y (|d| < 2^31: its sign bit), to
// the low end of `acc`: one funnel shift. A block of 32 appended bits reads
// in stream order after a bit reversal.
__device__ __forceinline__ uint32_t push(uint32_t acc, int d) {
  return __funnelshift_l(static_cast<uint32_t>(d), acc, 1);
}

// LIMITED words for n >= 4. After the 6 bits of shots 0 and 1 come n - 3
// groups of 4 bits, at bit 6 + 4i: shots 2..n-3, then the closing group of
// shots n-2 and n-1. Eight groups fill a 32-bit block: 4 funnel shifts a
// group, one bit reversal a block; word m is block m shifted up by 6 over
// the top 6 bits of block m-1.
template <typename At>
__device__ __forceinline__ void limited_words(At at, int n, int total,
                                              WordOut& wr) {
  const int s0 = at(0), s1 = at(1), s2 = at(2), s3 = at(3);
  uint32_t carry = lt(s0, s1) | lt(s0, s2) << 1 | lt(n * s0, total) << 2 |
                   lt(s1, s2) << 3 | lt(s1, s3) << 4 | lt(n * s1, total) << 5;
  int ps2 = s0 + s1, ps1 = s1 + s2;  // pair sums of t-2 and t-1
  int a = s2, b = s3;                // s[t], s[t+1]
  int t = 2;
  auto group = [&](uint32_t acc) {   // shot t's group; moves on to t + 1
    const int c = at(t + 2);
    const int cur = a + b;
    acc = push(push(push(push(acc, a - b), a - c), n * a - total), ps2 - cur);
    ps2 = ps1;
    ps1 = cur;
    a = b;
    b = c;
    ++t;
    return acc;
  };
  const int full = (n - 4) / 8;  // blocks of 8 shot groups
  for (int m = 0; m < full; ++m) {
    uint32_t acc = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) acc = group(acc);
    const uint32_t blk = __brev(acc);
    wr.word(blk << 6 | carry);
    carry = blk >> 26;
  }
  // The last block: the other shot groups, then the closing group
  // (a, b = s[n-2], s[n-1]); k bits in all, 4 <= k <= 32.
  uint32_t acc = 0;
  int k = 4;
  for (; t < n - 2; k += 4) acc = group(acc);
  acc = push(push(push(push(acc, a - b), n * a - total), n * b - total),
             ps2 - (a + b));
  const uint32_t blk = __brev(acc) >> (32 - k);
  wr.word(blk << 6 | carry);
  if (6 + 4 * (n - 3) > 32 * (full + 1)) wr.word(blk >> 26);
}

// Copies the tile's row of shot t (np pixels from p0) into `dst`.
template <typename T>
__device__ __forceinline__ void stage_chunk(const T* src, T* dst, int q,
                                            int np) {
  constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte chunk
  const T* s = src + q * kPer;
  T* d = dst + q * kPer;
  const unsigned mis = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(src) & 15u);  // uniform over the row
  if (np == kTile && mis == 0) {
    cp_async<16>(d, s);
  } else if (np == kTile && mis % 8 == 0) {
    cp_async<8>(d, s);
    cp_async<8>(d + kPer / 2, s + kPer / 2);
  } else if (np == kTile && mis % 4 == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) cp_async<4>(d + k * kPer / 4, s + k * kPer / 4);
  } else {  // the scalar edge path
    for (int k = 0; k < kPer && q * kPer + k < np; ++k) d[k] = s[k];
  }
}

// Copies the tile (np pixels from p0) of each of the n shots into shared
// memory, (n, kTile), and waits for the copies.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* stack, T* tile, int n,
                                           int64_t hw, int64_t p0, int np) {
  constexpr int kChunks = kTile * sizeof(T) / 16;  // a row
  for (int k = threadIdx.x; k < n * kChunks; k += kThreads) {
    const int t = k / kChunks;
    stage_chunk(stack + t * hw + p0, tile + t * kTile, k - t * kChunks, np);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The LIMITED words of one staged tile (np pixels from p0).
template <typename T>
__device__ __forceinline__ void tile_words(const T* tile, uint32_t* words,
                                           int64_t p0, int np, int n,
                                           int nw) {
  const int vw = nw % 4 == 0 ? 4 : nw % 2 == 0 ? 2 : 1;
  for (int j = threadIdx.x; j < np; j += kThreads) {
    const T* s = tile + j;
    auto at = [&](int t) { return static_cast<int>(s[t * kTile]); };
    int total = 0;
    for (int t = 0; t < n; ++t) total += at(t);

    WordOut wr{words + (p0 + j) * nw, vw};
    if (n >= 4) {
      limited_words(at, n, total, wr);
      continue;
    }
    // n = 2, 3: one word. Shot 0's group (n = 3), then the closing group,
    // whose pair-sum bit is 1 (the reference's pair-sum slot is still -1).
    uint32_t v = 0;
    int a = at(0), b = at(1);
    if (n == 3) {
      v = lt(a, b) | lt(a, at(2)) << 1 | lt(n * a, total) << 2;
      a = b;
      b = at(2);
    }
    wr.word(v | (lt(a, b) | lt(n * a, total) << 1 | lt(n * b, total) << 2 |
                 1u << 3) << 3 * (n - 2));
  }
}

// FULL allows n^2 - 2n + 3 <= 256 bits: n = 2..16.
constexpr int kMaxFull = 16;

// FULL's words for n shots.
__host__ __device__ constexpr int full_nw(int n) {
  return (n * n - 2 * n + 3 + 31) / 32;
}

// Bits in append order, 32 to a block: one funnel shift a bit, one bit
// reversal a block. Every call site is fully unrolled, so k, and with it
// the register each block lands in, is a compile-time constant.
template <int NW>
struct Blocks {
  uint32_t w[NW] = {};
  uint32_t acc = 0;
  int k = 0;
  // Appends x < y, given d = x - y.
  __device__ __forceinline__ void bit(int d) {
    acc = push(acc, d);
    if (++k % 32 == 0) w[k / 32 - 1] = __brev(acc);
  }
  // The last block, if partial: its bits at the bottom, the rest 0.
  __device__ __forceinline__ void close() {
    if (k % 32) w[NW - 1] = __brev(acc) >> (32 - k % 32);
  }
};

// The FULL words of the staged pixel at s (shot t at s[t * kTile]) into
// out, in the reference's order: for t < N - 2 the series bits s[t] <
// s[t+1], s[t] < s[t+2] and n s[t] < sum; s[N-2] < s[N-1] and the mean bits
// of shots N-2 and N-1; then p[t] < p[i] for each pair sum p[t] = s[t] +
// s[t+1] and each i outside t-1..t+1.
template <int N, typename T>
__device__ __forceinline__ void full_words(const T* s, uint32_t* out) {
  constexpr int NW = full_nw(N);
  int x[N], m[N], p[N - 1];
  int total = 0;
#pragma unroll
  for (int t = 0; t < N; ++t) {
    x[t] = s[t * kTile];
    total += x[t];
  }
#pragma unroll
  for (int t = 0; t < N; ++t) m[t] = N * x[t] - total;
#pragma unroll
  for (int t = 0; t < N - 1; ++t) p[t] = x[t] + x[t + 1];
  Blocks<NW> b;
#pragma unroll
  for (int t = 0; t < N - 2; ++t) {
    b.bit(x[t] - x[t + 1]);
    b.bit(x[t] - x[t + 2]);
    b.bit(m[t]);
  }
  b.bit(x[N - 2] - x[N - 1]);
  b.bit(m[N - 2]);
  b.bit(m[N - 1]);
#pragma unroll
  for (int t = 0; t < N - 1; ++t) {
#pragma unroll
    for (int i = 0; i < N - 1; ++i) {
      if (i < t - 1 || i > t + 1) b.bit(p[t] - p[i]);
    }
  }
  b.close();
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NW; q += 4) {
      *reinterpret_cast<uint4*>(out + q) =
          make_uint4(b.w[q], b.w[q + 1], b.w[q + 2], b.w[q + 3]);
    }
  } else if constexpr (NW % 2 == 0) {
#pragma unroll
    for (int q = 0; q < NW; q += 2) {
      *reinterpret_cast<uint2*>(out + q) = make_uint2(b.w[q], b.w[q + 1]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < NW; ++q) out[q] = b.w[q];
  }
}

// LIMITED, any n.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    transform_kernel(const T* __restrict__ stack, uint32_t* __restrict__ words,
                     int n, int64_t hw, int nw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // (n, kTile)
  const int64_t p0 = blockIdx.x * static_cast<int64_t>(kTile);
  const int np = hw - p0 < kTile ? static_cast<int>(hw - p0) : kTile;
  stage_tile(stack, tile, n, hw, p0, np);
  tile_words(tile, words, p0, np, n, nw);
}

// FULL, N shots.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    transform_kernel(const T* __restrict__ stack, uint32_t* __restrict__ words,
                     int64_t hw) {
  __shared__ __align__(16) T tile[N * kTile];
  const int64_t p0 = blockIdx.x * static_cast<int64_t>(kTile);
  const int np = hw - p0 < kTile ? static_cast<int>(hw - p0) : kTile;
  stage_tile(stack, tile, N, hw, p0, np);
  for (int j = threadIdx.x; j < np; j += kThreads)
    full_words<N>(tile + j, words + (p0 + j) * full_nw(N));
}

template <typename K>
cudaError_t prefer_shared(K* kern) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

unsigned tiles(int64_t hw) {
  return static_cast<unsigned>((hw + kTile - 1) / kTile);
}

template <typename T>
int launch_limited(const T* stack, uint32_t* words, int n, int64_t hw,
                   int nw, cudaStream_t st) {
  const size_t bytes = static_cast<size_t>(n) * kTile * sizeof(T);
  void (*kern)(const T*, uint32_t*, int, int64_t, int) = transform_kernel<T>;
  if (cudaError_t e = prefer_shared(kern)) return static_cast<int>(e);
  if (bytes > 48 * 1024) {
    if (cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes)))
      return static_cast<int>(e);
  }
  kern<<<tiles(hw), kThreads, bytes, st>>>(stack, words, n, hw, nw);
  return static_cast<int>(cudaGetLastError());
}

// The FULL kernel of n shots (N, N + 1, ... kMaxFull are tried in turn).
template <typename T, int N = 2>
int launch_full(const T* stack, uint32_t* words, int n, int64_t hw, int nw,
                cudaStream_t st) {
  if constexpr (N > kMaxFull) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (n != N) return launch_full<T, N + 1>(stack, words, n, hw, nw, st);
    if (nw != full_nw(N)) return static_cast<int>(cudaErrorInvalidValue);
    void (*kern)(const T*, uint32_t*, int64_t) = transform_kernel<T, N>;
    if (cudaError_t e = prefer_shared(kern)) return static_cast<int>(e);
    kern<<<tiles(hw), kThreads, 0, st>>>(stack, words, hw);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch(const T* stack, uint32_t* words, int n, int64_t hw, int full,
           int nw, cudaStream_t st) {
  return full ? launch_full(stack, words, n, hw, nw, st)
              : launch_limited(stack, words, n, hw, nw, st);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u16) {
    return launch(static_cast<const uint16_t*>(stack),
                  static_cast<uint32_t*>(words), n, hw, full, nw, st);
  }
  return launch(static_cast<const uint8_t*>(stack),
                static_cast<uint32_t*>(words), n, hw, full, nw, st);
}
