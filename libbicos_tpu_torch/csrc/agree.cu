// NXCORR validation ("agree") with the optional subpixel parabola sweep:
// per pixel, recompute the normalised cross-correlation of the left series
// with the right series at the matched column, invalidate below the
// threshold, and (subpixel) refine the disparity by the x of the best
// interpolated right series. Outputs an f32 disparity (NaN where invalid)
// and the corrmap (NaN where not computed).
//
// The right stack may be wider than the left (w1 >= w): on the W-banded
// path a left column band is checked against the whole right row, with the
// band-local disparity d (col1 = col - d) and the band's global column
// col_offset; the output disparity is float(d + col_offset) - best_x, the
// offset added in exact integers before the one float rounding.
//
// Replaces the Pallas kernels libbicos_tpu/kernels/agree.py::_agree_kernel
// and ::_agree_window_kernel, which differ only in how the TPU gathers the
// matched right series (one-hot MXU matmuls, grouped windows); on Hopper a
// gather is a plain load, so one kernel covers u8 and u16, the integer and
// subpixel variants and every n up to 65.
//
// Two variants share every line of arithmetic (agree_pixel), and differ
// only in where the right series come from:
// * agree_kernel: two threads per pixel, right series read from global
//   memory (through L1/L2);
// * agree_window_kernel: the dynamic window (the TPU kernel's DYNWIN, fed by
//   the bases of bases.cu). One block per (row, chunk of left columns)
//   stages the right-series columns [base - 1, base + wcap] of all n shots,
//   clipped to [0, w1), in shared memory (plain element copies), and its
//   thread pairs loop over the chunk's pixels, reading from there. A chunk
//   whose base is -1 (its matched columns do not fit one window) reads
//   global memory, as the TPU kernel's in-kernel fallback. Now that a pixel
//   reads its right series once, the window buys nothing on Hopper: it is
//   kept for the JAX API's parity, not for speed.
// Each variant is instantiated for float (SINGLE) and double (DOUBLE): the
// statistics, NXCORR, minvar and threshold tests run in the compute type C;
// the parabola, the x grid, the rounding and the modular cast stay float, as
// the JAX XLA path computes DOUBLE.
//
// Design. What bounds the sweep is instruction issue: a kept pixel
// evaluates len(xs) x n interpolated samples (n=33, step 0.1: 660), and
// every other per-pixel term is computed once:
// * two threads (lanes 2k, 2k+1) take one pixel. Once per pixel, each
//   shot's parabola coefficients pa, pb, y1 and the left deviation
//   d0 = left - m0 go to the pixel's slice of shared memory (Slice: 16 B a
//   shot in SINGLE, 24 in DOUBLE; shot-major across the block's pixels, so
//   a warp's reads are contiguous), each thread loading and converting
//   half of the shots; both threads read the slice back for every tile;
// * the sweep takes K x values at a time (one tile; the pair's threads
//   take alternate tiles). The mean pass computes each sample once and
//   keeps the low byte (u8) or half (u16) of its rounded bits packed in
//   registers, four or two shots a 32-bit word (one PRMT a shot after the
//   first of a word), and sums a word's shots in one DP4A / DP2A (exact,
//   < 2^23). The covariance pass reads each sample back with one PRMT
//   (Pack::get) and takes its deviation d1 in one fma, scaled by a power of
//   two (Scaled: no conversion), and its 2K independent fma chains fill the
//   FP32 pipe. The pair then keeps the larger NXCORR, the smaller x on a
//   tie;
// * register arrays need compile-time indices, so the packed sweep is an
//   instance per shot bucket (n <= 16, 33, 65; u16 up to 33) with the
//   shot loops unrolled over the bucket and guarded by n, and K chosen so
//   a tile's words fit the registers (packed_x: K = 10, 5 or 2); the host
//   picks the bucket (kernels/agree.py::packed_bucket). Instance 0 is the
//   recomputing sweep (kXT = 10 x a tile, each sample computed in the mean
//   pass and again in the covariance pass), for the integer variant
//   (full16), for u16 past 33 shots, whose words would not fit, and for
//   DOUBLE but u8 at 17-33 shots: its other instances spilled registers
//   in some builds;
// * rounding and casts never touch the 16/clk conversion pipe: every sweep
//   value lies within +-2^18, so v + 1.5*2^23 rounds v half to even into
//   the low mantissa bits (whose low 16 bits are rint(v) mod 2^16, so the
//   modular cast is a byte selection), and an int u < 2^23 converts
//   exactly as (2^23 | u) - 2^23 in float or (2^52 | u) - 2^52 in double.
//   The sweep loop holds no I2F, F2I or FRND. A sample costs 6 FP32
//   instructions and about 1 PRMT / DP4A in the mean pass, and 3 FP32
//   instructions and 1 PRMT in the covariance pass (the recomputing sweep:
//   8 and 11).
// The kernel is latency-bound below about 16 warps an SM, so the pixel's
// slice is shared by its two threads: SINGLE n=33 takes 528 B a pixel,
// 24 warps an SM in the global variant.
//
// Numerics follow the reference's CUDA backend and the TPU kernel:
// * sums run serially in shot order; the covariance and variance chains are
//   fmas (__fmaf_rn / __fma_rn), and nothing else is contracted: every
//   operation is written as an _rn intrinsic and the file is compiled with
//   -fmad=false, because a contracted parabola moves values across a
//   rounding boundary and changes disparities (the packed sweep's d1 is an
//   fma whose product is exact, so it rounds as the subtraction does);
// * the mean divides by n and the norm uses an IEEE sqrt, both exact (no
//   reciprocal, no rsqrt, no fast math);
// * the interpolated sample is ((pa*x)*x + pb*x) + y1, rounded half to even,
//   cast to int and masked to the input width (modular);
// * a variance below minvar gives -1; a NaN NXCORR keeps the pixel;
// * the x grid comes from the host, f32-accumulated like the reference;
//   only a strictly better NXCORR moves the best x (the first x wins a
//   tie, NaN never wins, and with no winner corr = -1 and x = 0); border
//   columns and the integer variant take the check at col1 (the sweep's
//   arithmetic at x = 0 with pa = pb = 0, which gives y1 exactly).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kInvalid = -32768;
constexpr int kThreads = 64;         // a block of the global variant
constexpr int kWindowThreads = 128;  // a block of the window variant
constexpr int kXT = 10;              // x values swept together (one tile)

template <typename T>
struct Params {
  const int16_t* disp;
  const T* s0;
  const T* s1;
  const float* xs;
  const int32_t* bases;  // (h, nc) window bases or -1; window variant only
  float* out;
  float* corr;
  int64_t hw, hw1;  // shot strides of the left and the right stack
  int nx, n, w, w1, col_offset, mod, has_minvar;
  int nc, chunk, wcap;
  int win_bytes;  // the staged window, padded to 16 B; window variant only
  double threshold, minvar;  // rounded to the compute type in the kernel
};

__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float sqrt_rn(float v) { return __fsqrt_rn(v); }
__device__ __forceinline__ double sqrt_rn(double v) { return __dsqrt_rn(v); }

// The int 0 <= u < 2^23 as C, exactly, on the FP pipe: the exponent of 2^23
// (2^52) over u's bits, minus 2^23 (2^52).
template <typename C>
__device__ __forceinline__ C from_int(int u);
template <>
__device__ __forceinline__ float from_int<float>(int u) {
  return __fsub_rn(__int_as_float(0x4B000000 | u), 0x1p23f);
}
template <>
__device__ __forceinline__ double from_int<double>(int u) {
  return __dsub_rn(__hiloint2double(0x43300000, u), 0x1p52);
}

// The interpolated sample ((pa*x)*x + pb*x) + y1, rounded half to even:
// |v| < 2^18, so v + 1.5*2^23 lies in [2^23, 2^24), where the float's ulp is
// 1; its bits are 0x4B400000 + rint(v), and their low 16 bits are rint(v)
// mod 2^16. sample() casts it to int modulo the input width (mod = 0xFF or
// 0xFFFF); the packed sweep keeps the bits and packs their low bytes.
__device__ __forceinline__ unsigned sample_bits(float pa, float pb, float y1,
                                                float x) {
  const float v = __fadd_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(pa, x), x), __fmul_rn(pb, x)), y1);
  return __float_as_uint(__fadd_rn(v, 0x1.8p23f));
}
__device__ __forceinline__ int sample(float pa, float pb, float y1, float x,
                                      int mod) {
  return static_cast<int>(sample_bits(pa, pb, y1, x)) & mod;
}

// Samples of T packed into 32-bit words, kPer a word, slot s in the low
// bits first: slot 0 takes a sample's bits whole, put() overwrites the
// higher slots s > 0 with the low bits of another's, sum() adds the slots
// that `ones` selects (kOnes: all) to an exact int sum, and get() returns
// slot s alone, zero above it.
template <typename T>
struct Pack;

template <>
struct Pack<uint8_t> {
  static constexpr int kPer = 4;
  static constexpr unsigned kOnes = 0x01010101u;
  __device__ static unsigned put(unsigned w, unsigned r, int s) {
    return __byte_perm(w, r, s == 1 ? 0x3240 : s == 2 ? 0x3410 : 0x4210);
  }
  __device__ static unsigned get(unsigned w, int s) {
    return __byte_perm(w, 0, 0x4440 | s);
  }
  __device__ static unsigned sum(unsigned w, unsigned ones, unsigned acc) {
    return __dp4a(w, ones, acc);
  }
};

template <>
struct Pack<uint16_t> {
  static constexpr int kPer = 2;
  static constexpr unsigned kOnes = 0x0101u;
  __device__ static unsigned put(unsigned w, unsigned r, int) {
    return __byte_perm(w, r, 0x5410);
  }
  __device__ static unsigned get(unsigned w, int s) {
    return __byte_perm(w, 0, s == 0 ? 0x4410 : 0x4432);
  }
  __device__ static unsigned sum(unsigned w, unsigned ones, unsigned acc) {
    return __dp2a_lo(w, ones, acc);
  }
};

// The packed sweep's shot buckets: an instance for n in (previous bucket,
// NMAX]. kernels/agree.py::packed_bucket picks one (u16 stops at 33, DOUBLE
// takes u8's 33 alone); 0 is the recomputing sweep.
__host__ __device__ constexpr int bucket_below(int nmax) {
  return nmax == 65 ? 33 : nmax == 33 ? 16 : 1;
}
// x values a packed tile sweeps: 10, 5 or 2, the most whose samples (one
// word a shot group and x) fit 48 registers; 2 in DOUBLE, whose NXCORR
// terms take two registers each.
template <typename C, typename T, int NMAX>
__host__ __device__ constexpr int packed_x() {
  constexpr int words = (NMAX + Pack<T>::kPer - 1) / Pack<T>::kPer;
  if (sizeof(C) == 8) return 2;
  return words * 10 <= 48 ? 10 : words * 5 <= 48 ? 5 : 2;
}

// The packed covariance pass runs on d1 scaled by kScale (2^-23 in float,
// 2^-52 in double), which spares the conversion: a sample u's bits alone
// read as a denormal, u * 2^-149 (2^-1074), and one fma with kUp and
// -m1 * kScale gives rn(kScale * (u - m1)) = kScale * rn(u - m1), the
// recomputing sweep's d1 times kScale. A power of two commutes with every
// rounding while the values stay normal, and they do: a variance is 0 or at
// least 1/4, and the products' partial sums are 0 or far above 2^-126. So
// the covariance and variance chains are kScale and kScale^2 times the
// recomputing sweep's, bit for bit, their NXCORR is the same quotient, and
// only the minvar test takes the variance back up (kUp2).
template <typename C>
struct Scaled;
template <>
struct Scaled<float> {
  static constexpr float kScale = 0x1p-23f, kUp = 0x1p126f, kUp2 = 0x1p46f;
  __device__ static float denorm(unsigned u) { return __uint_as_float(u); }
};
template <>
struct Scaled<double> {
  static constexpr double kScale = 0x1p-52, kUp = 0x1p1022, kUp2 = 0x1p104;
  __device__ static double denorm(unsigned u) {
    return __hiloint2double(0, static_cast<int>(u));
  }
};

// One pixel's per-shot terms in shared memory, shot t of the block's pixel
// k at t * stride + k: (pa, pb, y1, d0) as float4 in SINGLE; DOUBLE keeps
// d0 in a plane of doubles after the n float4 rows.
template <typename C>
struct Slice;

template <>
struct Slice<float> {
  static constexpr int kBytes = 16;  // a shot
  float4* coef;
  int stride;
  __device__ Slice(unsigned char* base, int k, int pixels, int)
      : coef(reinterpret_cast<float4*>(base) + k), stride(pixels) {}
  __device__ void put(int t, float pa, float pb, float y1, float d0) const {
    coef[t * stride] = make_float4(pa, pb, y1, d0);
  }
  __device__ float4 at(int t) const { return coef[t * stride]; }
  __device__ float d0(int t, const float4& c) const { return c.w; }
  __device__ float d0(int t) const { return coef[t * stride].w; }
  __device__ void set_d0(int t, float v) const { coef[t * stride].w = v; }
};

template <>
struct Slice<double> {
  static constexpr int kBytes = 24;
  float4* coef;
  double* dev;
  int stride;
  __device__ Slice(unsigned char* base, int k, int pixels, int n)
      : coef(reinterpret_cast<float4*>(base) + k),
        dev(reinterpret_cast<double*>(reinterpret_cast<float4*>(base) +
                                      n * pixels) + k),
        stride(pixels) {}
  __device__ void put(int t, float pa, float pb, float y1, double d0) const {
    coef[t * stride] = make_float4(pa, pb, y1, 0.f);
    dev[t * stride] = d0;
  }
  __device__ float4 at(int t) const { return coef[t * stride]; }
  __device__ double d0(int t, const float4&) const { return dev[t * stride]; }
  __device__ double d0(int t) const { return dev[t * stride]; }
  __device__ void set_d0(int t, double v) const { dev[t * stride] = v; }
};

// The K NXCORRs from their covariances and variances (-1 below minvar;
// kScaled: those of Scaled<C>).
template <int K, bool kScaled = false, typename C>
__device__ __forceinline__ void nxcorr_finish(const C* covar, const C* var1,
                                              C var0, C minvar,
                                              bool has_minvar, C* nxc) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    C v = div_rn(covar[j], sqrt_rn(mul_rn(var0, var1[j])));
    const C v1 = kScaled ? mul_rn(var1[j], Scaled<C>::kUp2) : var1[j];
    if (has_minvar && (var0 < minvar || v1 < minvar)) v = -1;
    nxc[j] = v;
  }
}

// The NXCORRs of the cached left series (variance var0) against the K
// interpolated right series at xv[0..K): a mean pass (integer sums) and a
// covariance pass, each over the shots in order.
template <int K, typename C>
__device__ __forceinline__ void nxcorr_tile(const Slice<C>& sl, int n,
                                            int mod, C fn, C var0, C minvar,
                                            bool has_minvar, const float* xv,
                                            C* nxc) {
  int sum[K];
#pragma unroll
  for (int j = 0; j < K; ++j) sum[j] = 0;
#pragma unroll 2
  for (int t = 0; t < n; ++t) {
    const float4 c = sl.at(t);
#pragma unroll
    for (int j = 0; j < K; ++j) sum[j] += sample(c.x, c.y, c.z, xv[j], mod);
  }
  C m1[K], covar[K], var1[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    m1[j] = div_rn(from_int<C>(sum[j]), fn);
    covar[j] = 0;
    var1[j] = 0;
  }
#pragma unroll 2
  for (int t = 0; t < n; ++t) {
    const float4 c = sl.at(t);
    const C d0 = sl.d0(t, c);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const C d1 = sub_rn(from_int<C>(sample(c.x, c.y, c.z, xv[j], mod)),
                          m1[j]);
      covar[j] = fma_rn(d0, d1, covar[j]);
      var1[j] = fma_rn(d1, d1, var1[j]);
    }
  }
  nxcorr_finish<K>(covar, var1, var0, minvar, has_minvar, nxc);
}

// Shot slot s of a group: its K samples into the group's words `w`.
template <int K, typename P>
__device__ __forceinline__ void pack_shot(const float4& c, int s,
                                          const float* xv, unsigned (&w)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const unsigned r = sample_bits(c.x, c.y, c.z, xv[j]);
    w[j] = s == 0 ? r : P::put(w[j], r, s);
  }
}

// Shot slot s of a group: its K NXCORR terms from the group's words `w`,
// scaled (Scaled<C>; m1s: the means times kScale).
template <int K, typename P, typename C>
__device__ __forceinline__ void covary_shot(C d0, int s,
                                            const unsigned (&w)[K],
                                            const C* m1s, C* covar, C* var1) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const C d1 = fma_rn(Scaled<C>::denorm(P::get(w[j], s)), Scaled<C>::kUp,
                        -m1s[j]);
    covar[j] = fma_rn(d0, d1, covar[j]);
    var1[j] = fma_rn(d1, d1, var1[j]);
  }
}

// The packed sweep's version of nxcorr_tile, for n in (bucket_below(NMAX),
// NMAX]: the mean pass computes each sample once and keeps its bits packed,
// shot group g's samples at x j in word pk[g][j] (shot g * kPer + s in slot
// s); the covariance pass reads them back. The shot loops are unrolled over
// the bucket, so the words stay in registers. The groups below the bucket
// are whole for every n; of the others, those past n are skipped and a
// whole one runs unguarded, and the one that n cuts (if any) runs its first
// n % kPer shots and sums only their slots (`tail`).
template <int NMAX, int K, typename T, typename C>
__device__ __forceinline__ void nxcorr_tile_packed(
    const Slice<C>& sl, int n, C fn, C var0, C minvar, bool has_minvar,
    const float* xv, C* nxc) {
  using P = Pack<T>;
  constexpr int kG = (NMAX + P::kPer - 1) / P::kPer;
  constexpr int kWhole = (bucket_below(NMAX) + 1) / P::kPer;
  const unsigned tail = P::kOnes & ((1u << (8 * (n % P::kPer))) - 1);
  unsigned pk[kG][K];  // slot 0 of a word sets it whole
  unsigned sum[K];
#pragma unroll
  for (int j = 0; j < K; ++j) sum[j] = 0;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const int t0 = g * P::kPer;
    if (g >= kWhole && t0 >= n) break;
    unsigned ones = P::kOnes;
    if (g < kWhole || (t0 + P::kPer <= NMAX && t0 + P::kPer <= n)) {
#pragma unroll
      for (int s = 0; s < P::kPer; ++s)
        pack_shot<K, P>(sl.at(t0 + s), s, xv, pk[g]);
    } else {
#pragma unroll
      for (int s = 0; s < P::kPer; ++s)
        if (t0 + s < NMAX && t0 + s < n)
          pack_shot<K, P>(sl.at(t0 + s), s, xv, pk[g]);
      ones = tail;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) sum[j] = P::sum(pk[g][j], ones, sum[j]);
  }
  // m1 * kScale = rn(sum / (n / kScale)), the power of two moved into the
  // divisor.
  const C fn_up = mul_rn(fn, 1 / Scaled<C>::kScale);
  C m1s[K], covar[K], var1[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    m1s[j] = div_rn(from_int<C>(static_cast<int>(sum[j])), fn_up);
    covar[j] = 0;
    var1[j] = 0;
  }
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const int t0 = g * P::kPer;
    if (g >= kWhole && t0 >= n) break;
    if (g < kWhole || (t0 + P::kPer <= NMAX && t0 + P::kPer <= n)) {
#pragma unroll
      for (int s = 0; s < P::kPer; ++s)
        covary_shot<K, P>(sl.d0(t0 + s), s, pk[g], m1s, covar, var1);
    } else {
#pragma unroll
      for (int s = 0; s < P::kPer; ++s)
        if (t0 + s < NMAX && t0 + s < n)
          covary_shot<K, P>(sl.d0(t0 + s), s, pk[g], m1s, covar, var1);
    }
  }
  nxcorr_finish<K, true>(covar, var1, var0, minvar, has_minvar, nxc);
}

// A pixel's right series: y(t, k) is shot t at col1 + k, from global memory
// (stride h * w1) or from the window in shared memory (stride wcap + 2).
template <typename T>
struct Series {
  const T* y;  // shot 0 at col1
  int64_t stride;
  __device__ __forceinline__ int operator()(int t, int k) const {
    return y[t * stride + k];
  }
};

// The two threads of a pixel: lanes 2k and 2k+1 of a warp.
struct Pair {
  int q;          // 0 or 1
  unsigned mask;  // the pair's lanes
  __device__ Pair()
      : q(threadIdx.x & 1), mask(3u << (threadIdx.x & 30)) {}
};

// One kept pixel (flat index i, disparity d, matched column col1 in
// [0, w1)), on the two threads of `pr`: caches its shot terms in `sl`
// (each thread half of the shots), sweeps the x tiles q, q + 2, ... on
// thread q (packed for NMAX > 0, else recomputing), and writes its corrmap
// value and its disparity (thread 0).
template <int NMAX, typename C, typename T, typename Y>
__device__ __forceinline__ void agree_pixel(const Params<T>& p,
                                            const Slice<C>& sl, Pair pr,
                                            int64_t i, int d, int col1, Y y) {
  const bool sweep = p.nx != 0 && col1 != 0 && col1 != p.w1 - 1;
  const T* left = p.s0 + i;
  const C fn = from_int<C>(p.n);
  // The shot terms, once; the left sample waits in d0's place for m0. (In
  // the window variant the partner may still read the pair's last pixel.)
  __syncwarp(pr.mask);
  int lsum = 0;
  for (int t = pr.q; t < p.n; t += 2) {
    const int l = left[t * p.hw];
    lsum += l;
    const float y1 = from_int<float>(y(t, 0));
    float pa = 0.f, pb = 0.f;
    if (sweep) {
      const float y0 = from_int<float>(y(t, -1));
      const float y2 = from_int<float>(y(t, 1));
      pa = __fmul_rn(0.5f, __fadd_rn(__fsub_rn(y0, __fmul_rn(2.0f, y1)), y2));
      pb = __fmul_rn(0.5f, __fsub_rn(y2, y0));
    }
    sl.put(t, pa, pb, y1, from_int<C>(l));
  }
  lsum += __shfl_xor_sync(pr.mask, lsum, 1);  // exact integers
  __syncwarp(pr.mask);
  const C m0 = div_rn(from_int<C>(lsum), fn);
  C var0 = 0;
  for (int t = 0; t < p.n; ++t) {
    const C d0 = sub_rn(sl.d0(t, sl.at(t)), m0);
    var0 = fma_rn(d0, d0, var0);
  }
  __syncwarp(pr.mask);
  for (int t = pr.q; t < p.n; t += 2)
    sl.set_d0(t, sub_rn(sl.d0(t, sl.at(t)), m0));
  __syncwarp(pr.mask);

  const C minvar = static_cast<C>(p.minvar);
  C corr_val;
  float ret = static_cast<float>(d + p.col_offset);
  if (!sweep) {  // pa = pb = 0: the sample at x = 0 is y1 itself
    const float x0 = 0.f;
    nxcorr_tile<1>(sl, p.n, p.mod, fn, var0, minvar, p.has_minvar, &x0,
                   &corr_val);
  } else {
    // Each thread's best over its tiles, then the pair's: the larger
    // NXCORR, the smaller x index on a tie, as one sweep in x order.
    constexpr int kX = NMAX > 0 ? packed_x<C, T, NMAX>() : kXT;
    C best = -1;
    int best_j = INT_MAX;  // none
    for (int x0 = pr.q * kX; x0 < p.nx; x0 += 2 * kX) {
      float xv[kX];
#pragma unroll
      for (int j = 0; j < kX; ++j) xv[j] = p.xs[min(x0 + j, p.nx - 1)];
      C nxc[kX];
      if constexpr (NMAX > 0) {
        nxcorr_tile_packed<NMAX, kX, T>(sl, p.n, fn, var0, minvar,
                                        p.has_minvar, xv, nxc);
      } else {
        nxcorr_tile<kX>(sl, p.n, p.mod, fn, var0, minvar, p.has_minvar, xv,
                        nxc);
      }
#pragma unroll
      for (int j = 0; j < kX; ++j) {
        if (x0 + j < p.nx && best < nxc[j]) {
          best = nxc[j];
          best_j = x0 + j;
        }
      }
    }
    const C ob = __shfl_xor_sync(pr.mask, best, 1);
    const int oj = __shfl_xor_sync(pr.mask, best_j, 1);
    if (best < ob || (ob == best && oj < best_j)) {
      best = ob;
      best_j = oj;
    }
    corr_val = best;
    ret = __fsub_rn(ret, best_j == INT_MAX ? 0.f : p.xs[best_j]);
  }
  if (pr.q == 0) {
    p.corr[i] = static_cast<float>(corr_val);
    p.out[i] = (corr_val < static_cast<C>(p.threshold)) ? CUDART_NAN_F : ret;
  }
}

// The matched column of pixel i, or -1 (and NaN outputs) where none.
template <typename T>
__device__ __forceinline__ int matched(const Params<T>& p, Pair pr,
                                       int64_t i, int col, int* d_out) {
  const int d = p.disp[i];
  const int col1 = col - d;
  if (d == kInvalid || col1 < 0 || col1 >= p.w1) {
    if (pr.q == 0) {
      p.out[i] = CUDART_NAN_F;
      p.corr[i] = CUDART_NAN_F;
    }
    return -1;
  }
  *d_out = d;
  return col1;
}

// Two threads per pixel, kThreads a block; dynamic shared memory: the
// slices of the block's kThreads / 2 pixels.
template <typename C, typename T, int NMAX>
__global__ void __launch_bounds__(kThreads) agree_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Pair pr;
  const int k = threadIdx.x >> 1;
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads / 2) + k;
  if (i >= p.hw) return;
  const int64_t row = i / p.w;
  const int col = static_cast<int>(i - row * p.w);
  int d;
  const int col1 = matched(p, pr, i, col, &d);
  if (col1 < 0) return;
  agree_pixel<NMAX, C>(p, Slice<C>(smem_raw, k, kThreads / 2, p.n), pr, i, d,
                       col1, Series<T>{p.s1 + row * p.w1 + col1, p.hw1});
}

// Grid (h, nc); the blockDim.x / 2 thread pairs loop over the chunk's
// columns. Dynamic shared memory: the window (n rows of wcap + 2 samples,
// win_bytes padded to 16 B), then the pairs' slices. w1 == w and
// col_offset == 0.
template <typename C, typename T, int NMAX>
__global__ void agree_window_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  const int64_t row = blockIdx.x;
  const int oc = blockIdx.y;
  const int base = p.bases[row * p.nc + oc];
  const int ws = p.wcap + 2;
  const T* src = p.s1 + row * p.w1;
  if (base >= 0) {  // block-uniform
    for (int t = 0; t < p.n; ++t) {
      for (int k = threadIdx.x; k < ws; k += blockDim.x) {
        const int c = base - 1 + k;
        if (c >= 0 && c < p.w1) win[t * ws + k] = src[t * p.hw1 + c];
      }
    }
    __syncthreads();
  }
  const Pair pr;
  const int pairs = blockDim.x >> 1;
  const Slice<C> sl(smem_raw + p.win_bytes, threadIdx.x >> 1, pairs, p.n);
  const int end = min(p.w, (oc + 1) * p.chunk);
  for (int col = oc * p.chunk + (threadIdx.x >> 1); col < end; col += pairs) {
    const int64_t i = row * p.w + col;
    int d;
    const int col1 = matched(p, pr, i, col, &d);
    if (col1 < 0) continue;
    // A kept pixel of a windowed chunk lies in [base, base + wcap - 1]
    // (bases.cu); the test keeps shared reads in bounds for any bases.
    if (base >= 0 && col1 >= base && col1 <= base + p.wcap - 1) {
      agree_pixel<NMAX, C>(p, sl, pr, i, d, col1,
                           Series<T>{win + (col1 - base + 1), ws});
    } else {
      agree_pixel<NMAX, C>(p, sl, pr, i, d, col1,
                           Series<T>{src + col1, p.hw1});
    }
  }
}

// Lets `kern` take `bytes` of dynamic shared memory, and asks for the
// largest shared-memory carveout (the slices bound the resident blocks).
template <typename K>
cudaError_t smem_attributes(K* kern, size_t bytes) {
  if (cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared))
    return e;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename C, typename T, int NMAX>
int launch(Params<T> p, int h, int smem_limit, cudaStream_t st) {
  const size_t slice = static_cast<size_t>(p.n) * Slice<C>::kBytes;  // a pixel
  if (p.bases == nullptr) {
    const size_t bytes = kThreads / 2 * slice;
    auto* kern = agree_kernel<C, T, NMAX>;
    if (cudaError_t e = smem_attributes(kern, bytes))
      return static_cast<int>(e);
    const int64_t pixels = kThreads / 2;
    const unsigned blocks = static_cast<unsigned>((p.hw + pixels - 1) / pixels);
    kern<<<blocks, kThreads, bytes, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t win = static_cast<size_t>(p.n) * (p.wcap + 2) * sizeof(T);
  p.win_bytes = static_cast<int>((win + 15) / 16 * 16);
  // kWindowThreads threads, fewer where the window leaves no room for their
  // pixels' slices (the wrapper has checked that one pixel's slice fits).
  int threads = kWindowThreads;
  while (threads > 2 && p.win_bytes + threads / 2 * slice >
                            static_cast<size_t>(smem_limit))
    threads /= 2;
  const size_t bytes = p.win_bytes + threads / 2 * slice;
  auto* kern = agree_window_kernel<C, T, NMAX>;
  if (cudaError_t e = smem_attributes(kern, bytes))
    return static_cast<int>(e);
  kern<<<dim3(h, p.nc), threads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The instance of the packed sweep's bucket `packed` (n in
// (bucket_below(packed), packed]), or of the recomputing sweep (0).
template <typename C, typename T>
int launch_bucket(const Params<T>& p, int h, int smem_limit, int packed,
                  cudaStream_t st) {
  if (packed && (p.n > packed || p.n <= bucket_below(packed)))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool f32 = sizeof(C) == 4, u8 = sizeof(T) == 1;
  switch (packed) {
    case 0:
      return launch<C, T, 0>(p, h, smem_limit, st);
    case 16:
      if constexpr (f32) return launch<C, T, 16>(p, h, smem_limit, st);
      break;
    case 33:
      if constexpr (f32 || u8) return launch<C, T, 33>(p, h, smem_limit, st);
      break;
    case 65:
      if constexpr (f32 && u8) return launch<C, T, 65>(p, h, smem_limit, st);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* disp, const void* s0, const void* s1, const void* xs,
             int nx, void* out, void* corr, int n, int h, int w, int w1,
             int col_offset, int mod, double threshold, double minvar,
             int has_minvar, int f64, int packed, const void* bases, int nc,
             int chunk, int wcap, int smem_limit, cudaStream_t st) {
  Params<T> p;
  p.disp = static_cast<const int16_t*>(disp);
  p.s0 = static_cast<const T*>(s0);
  p.s1 = static_cast<const T*>(s1);
  p.xs = static_cast<const float*>(xs);
  p.bases = static_cast<const int32_t*>(bases);
  p.out = static_cast<float*>(out);
  p.corr = static_cast<float*>(corr);
  p.hw = static_cast<int64_t>(h) * w;
  p.hw1 = static_cast<int64_t>(h) * w1;
  p.nx = nx;
  p.n = n;
  p.w = w;
  p.w1 = w1;
  p.col_offset = col_offset;
  p.mod = mod;
  p.has_minvar = has_minvar;
  p.nc = nc;
  p.chunk = chunk;
  p.wcap = wcap;
  p.win_bytes = 0;
  p.threshold = threshold;
  p.minvar = minvar;
  return f64 ? launch_bucket<double>(p, h, smem_limit, packed, st)
             : launch_bucket<float>(p, h, smem_limit, packed, st);
}

}  // namespace

extern "C" int bicos_smem_optin(int device) {
  int limit = 0;
  if (cudaError_t e = cudaDeviceGetAttribute(
          &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device))
    return -static_cast<int>(e);
  return limit;
}

extern "C" int bicos_agree(int device, const void* disp, const void* s0,
                           const void* s1, const void* xs, int nx, void* out,
                           void* corr, int n, int h, int w, int w1,
                           int col_offset, int u16, double threshold,
                           double minvar, int has_minvar, int f64,
                           int packed, const void* bases, int nc, int chunk,
                           int wcap, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  const int limit = bicos_smem_optin(device);
  if (limit < 0) return -limit;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u16) {
    return dispatch<uint16_t>(disp, s0, s1, xs, nx, out, corr, n, h, w, w1,
                              col_offset, 0xFFFF, threshold, minvar,
                              has_minvar, f64, packed, bases, nc, chunk, wcap,
                              limit, st);
  }
  return dispatch<uint8_t>(disp, s0, s1, xs, nx, out, corr, n, h, w, w1,
                           col_offset, 0xFF, threshold, minvar, has_minvar,
                           f64, packed, bases, nc, chunk, wcap, limit, st);
}
