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
// * agree_kernel: one thread per pixel, right series read from global
//   memory (through L1/L2);
// * agree_window_kernel: the dynamic window (the TPU kernel's DYNWIN, fed by
//   the bases of bases.cu). One block per (row, chunk of left columns)
//   stages the right-series columns [base - 1, base + wcap] of all n shots,
//   clipped to [0, w1), in shared memory, and each thread sweeps from
//   there. A chunk whose base is -1 (its matched columns do not fit one
//   window) reads global memory, as the TPU kernel's in-kernel fallback.
// Each variant is instantiated for float (SINGLE) and double (DOUBLE): the
// statistics, NXCORR, minvar and threshold tests run in the compute type C;
// the parabola, the x grid, the rounding and the modular cast stay float, as
// the JAX XLA path computes DOUBLE.
//
// Bound on the card: issue rate of the sweep. A kept pixel evaluates
// (1 + len(xs)) NXCORRs of n samples (n=33, step 0.1: 21 x 33 x 2 passes);
// its conversions (rint, float<->int for the modular cast) run on the
// 16/clk/SM conversion pipe. The global variant re-reads its three right
// series and its left series from the cache on every pass instead of
// holding 4n floats in registers (which spills at n=33); the window
// variant re-reads them from shared memory.
//
// Numerics follow the reference's CUDA backend and the TPU kernel:
// * sums run serially in shot order; the covariance and variance chains are
//   fmas (__fmaf_rn / __fma_rn), and nothing else is contracted: the file is
//   compiled with -fmad=false, because a contracted parabola moves values
//   across a rintf boundary and changes disparities;
// * the mean divides by n and the norm uses an IEEE sqrt, both exact (no
//   reciprocal, no rsqrt, no fast math);
// * the interpolated sample is ((pa*x)*x + pb*x) + y1, rounded half to even
//   (rintf), cast to int and masked to the input width (modular);
// * a variance below minvar gives -1; a NaN NXCORR keeps the pixel;
// * the x grid comes from the host, f32-accumulated like the reference;
//   only a strictly better NXCORR moves the best x; border columns fall
//   back to the integer check.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kInvalid = -32768;

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
  double threshold, minvar;  // rounded to the compute type in the kernel
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float sqrt_rn(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_rn(double v) { return sqrt(v); }

// NXCORR of the left series (mean m0, variance var0) against `series`.
template <typename C, typename T, typename Series>
__device__ C nxcorr(const Params<T>& p, const T* left, C m0, C var0,
                    Series series) {
  const C fn = static_cast<C>(p.n);
  C m1 = 0;
  for (int t = 0; t < p.n; ++t) m1 = m1 + series(t);
  m1 = m1 / fn;
  C covar = 0, var1 = 0;
  for (int t = 0; t < p.n; ++t) {
    const C d0 = static_cast<C>(left[t * p.hw]) - m0;
    const C d1 = series(t) - m1;
    covar = fma_rn(d0, d1, covar);
    var1 = fma_rn(d1, d1, var1);
  }
  C nxc = covar / sqrt_rn(var0 * var1);
  const C minvar = static_cast<C>(p.minvar);
  if (p.has_minvar && (var0 < minvar || var1 < minvar)) nxc = -1;
  return nxc;
}

// Right series of the global variant: y(t, k) is shot t at col1 + k.
template <typename T>
struct GlobalSeries {
  const T* y;  // shot 0 of the pixel's row at col1
  int64_t stride;
  __device__ __forceinline__ T operator()(int t, int k) const {
    return y[t * stride + k];
  }
};

// Right series of the window variant: the staged columns [base - 1,
// base + wcap] of each shot, ws = wcap + 2 apart.
template <typename T>
struct WindowSeries {
  const T* y;  // the window of shot 0 at col1
  int ws;
  __device__ __forceinline__ T operator()(int t, int k) const {
    return y[t * ws + k];
  }
};

// One kept pixel (flat index i, disparity d, matched column col1 in
// [0, w1)): writes its corrmap value and its disparity.
template <typename C, typename T, typename Y>
__device__ __forceinline__ void agree_pixel(const Params<T>& p, int64_t i,
                                            int d, int col1, Y y) {
  const bool border = col1 == 0 || col1 == p.w1 - 1;
  const T* left = p.s0 + i;
  const C fn = static_cast<C>(p.n);
  C m0 = 0;
  for (int t = 0; t < p.n; ++t) m0 = m0 + static_cast<C>(left[t * p.hw]);
  m0 = m0 / fn;
  C var0 = 0;
  for (int t = 0; t < p.n; ++t) {
    const C d0 = static_cast<C>(left[t * p.hw]) - m0;
    var0 = fma_rn(d0, d0, var0);
  }

  C corr_val;
  float ret = static_cast<float>(d + p.col_offset);
  if (p.nx == 0 || border) {
    corr_val = nxcorr<C>(p, left, m0, var0,
                         [&](int t) { return static_cast<C>(y(t, 0)); });
  } else {
    C best = -1;
    float best_x = 0.f;
    for (int ix = 0; ix < p.nx; ++ix) {
      const float x = p.xs[ix];
      auto interp = [&](int t) {
        const float y0 = static_cast<float>(y(t, -1));
        const float y1 = static_cast<float>(y(t, 0));
        const float y2 = static_cast<float>(y(t, 1));
        const float pa = 0.5f * ((y0 - 2.0f * y1) + y2);
        const float pb = 0.5f * (y2 - y0);
        const float v = rintf(((pa * x) * x + pb * x) + y1);
        return static_cast<C>(static_cast<int>(v) & p.mod);
      };
      const C nxc = nxcorr<C>(p, left, m0, var0, interp);
      if (best < nxc) {
        best = nxc;
        best_x = x;
      }
    }
    corr_val = best;
    ret = ret - best_x;
  }
  p.corr[i] = static_cast<float>(corr_val);
  p.out[i] = (corr_val < static_cast<C>(p.threshold)) ? CUDART_NAN_F : ret;
}

// The matched column of pixel i, or -1 (and NaN outputs) where none.
template <typename T>
__device__ __forceinline__ int matched(const Params<T>& p, int64_t i,
                                       int col, int* d_out) {
  const int d = p.disp[i];
  const int col1 = col - d;
  if (d == kInvalid || col1 < 0 || col1 >= p.w1) {
    p.out[i] = CUDART_NAN_F;
    p.corr[i] = CUDART_NAN_F;
    return -1;
  }
  *d_out = d;
  return col1;
}

template <typename C, typename T>
__global__ void agree_kernel(const Params<T> p) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= p.hw) return;
  const int64_t row = i / p.w;
  const int col = static_cast<int>(i - row * p.w);
  int d;
  const int col1 = matched(p, i, col, &d);
  if (col1 < 0) return;
  agree_pixel<C>(p, i, d, col1,
                 GlobalSeries<T>{p.s1 + row * p.w1 + col1, p.hw1});
}

// blockDim.x == chunk; grid (h, nc). w1 == w and col_offset == 0.
template <typename C, typename T>
__global__ void agree_window_kernel(const Params<T> p) {
  extern __shared__ unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  const int64_t row = blockIdx.x;
  const int oc = blockIdx.y;
  const int base = p.bases[row * p.nc + oc];
  const int ws = p.wcap + 2;
  if (base >= 0) {  // block-uniform
    const T* src = p.s1 + row * p.w1;
    for (int k = threadIdx.x; k < p.n * ws; k += blockDim.x) {
      const int t = k / ws;
      const int c = base - 1 + (k - t * ws);
      if (c >= 0 && c < p.w1) win[k] = src[t * p.hw1 + c];
    }
    __syncthreads();
  }
  const int col = oc * p.chunk + static_cast<int>(threadIdx.x);
  if (col >= p.w) return;
  const int64_t i = row * p.w + col;
  int d;
  const int col1 = matched(p, i, col, &d);
  if (col1 < 0) return;
  // A kept pixel of a windowed chunk lies in [base, base + wcap - 1]
  // (bases.cu); the test keeps shared reads in bounds for any bases.
  if (base >= 0 && col1 >= base && col1 <= base + p.wcap - 1) {
    agree_pixel<C>(p, i, d, col1, WindowSeries<T>{win + (col1 - base + 1), ws});
  } else {
    agree_pixel<C>(p, i, d, col1,
                   GlobalSeries<T>{p.s1 + row * p.w1 + col1, p.hw1});
  }
}

template <typename C, typename T>
int launch(const Params<T>& p, int h, cudaStream_t st) {
  if (p.bases == nullptr) {
    const int threads = 128;
    const unsigned blocks =
        static_cast<unsigned>((p.hw + threads - 1) / threads);
    agree_kernel<C, T><<<blocks, threads, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes = static_cast<size_t>(p.n) * (p.wcap + 2) * sizeof(T);
  auto* kern = agree_window_kernel<C, T>;
  if (bytes > 48 * 1024) {
    if (cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes)))
      return static_cast<int>(e);
  }
  kern<<<dim3(h, p.nc), p.chunk, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* disp, const void* s0, const void* s1, const void* xs,
             int nx, void* out, void* corr, int n, int h, int w, int w1,
             int col_offset, int mod, double threshold, double minvar,
             int has_minvar, int f64, const void* bases, int nc, int chunk,
             int wcap, cudaStream_t st) {
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
  p.threshold = threshold;
  p.minvar = minvar;
  return f64 ? launch<double>(p, h, st) : launch<float>(p, h, st);
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
                           const void* bases, int nc, int chunk, int wcap,
                           void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u16) {
    return dispatch<uint16_t>(disp, s0, s1, xs, nx, out, corr, n, h, w, w1,
                              col_offset, 0xFFFF, threshold, minvar,
                              has_minvar, f64, bases, nc, chunk, wcap, st);
  }
  return dispatch<uint8_t>(disp, s0, s1, xs, nx, out, corr, n, h, w, w1,
                           col_offset, 0xFF, threshold, minvar, has_minvar,
                           f64, bases, nc, chunk, wcap, st);
}
