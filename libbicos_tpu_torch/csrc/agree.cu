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
// Bound on the card: issue rate of the sweep. A kept pixel evaluates
// (1 + len(xs)) NXCORRs of n samples (n=33, step 0.1: 21 x 33 x 2 passes),
// re-reading its three right series and its left series from the cache on
// every pass instead of holding 4n floats in registers (which spills at
// n=33).
//
// Numerics follow the reference's CUDA backend and the TPU kernel:
// * sums run serially in shot order; the covariance and variance chains are
//   fmas (__fmaf_rn), and nothing else is contracted: the file is compiled
//   with -fmad=false, because a contracted parabola moves values across a
//   rintf boundary and changes disparities;
// * the mean divides by n and the norm uses sqrtf, both IEEE-exact (no
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
  float* out;
  float* corr;
  int64_t hw, hw1;  // shot strides of the left and the right stack
  int nx, n, w, w1, col_offset, mod, has_minvar;
  float threshold, minvar;
};

// NXCORR of the left series (mean m0, variance var0) against `series`.
template <typename T, typename Series>
__device__ float nxcorr(const Params<T>& p, const T* left, float m0,
                        float var0, Series series) {
  const float fn = static_cast<float>(p.n);
  float m1 = 0.f;
  for (int t = 0; t < p.n; ++t) m1 = m1 + series(t);
  m1 = m1 / fn;
  float covar = 0.f, var1 = 0.f;
  for (int t = 0; t < p.n; ++t) {
    const float d0 = static_cast<float>(left[t * p.hw]) - m0;
    const float d1 = series(t) - m1;
    covar = __fmaf_rn(d0, d1, covar);
    var1 = __fmaf_rn(d1, d1, var1);
  }
  float nxc = covar / sqrtf(var0 * var1);
  if (p.has_minvar && (var0 < p.minvar || var1 < p.minvar)) nxc = -1.f;
  return nxc;
}

template <typename T>
__global__ void agree_kernel(const Params<T> p) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= p.hw) return;
  const int64_t row = i / p.w;
  const int col = static_cast<int>(i - row * p.w);
  const int d = p.disp[i];
  const int col1 = col - d;
  if (d == kInvalid || col1 < 0 || col1 >= p.w1) {
    p.out[i] = CUDART_NAN_F;
    p.corr[i] = CUDART_NAN_F;
    return;
  }
  const bool border = col1 == 0 || col1 == p.w1 - 1;

  const T* left = p.s0 + i;
  const float fn = static_cast<float>(p.n);
  float m0 = 0.f;
  for (int t = 0; t < p.n; ++t) m0 = m0 + static_cast<float>(left[t * p.hw]);
  m0 = m0 / fn;
  float var0 = 0.f;
  for (int t = 0; t < p.n; ++t) {
    const float d0 = static_cast<float>(left[t * p.hw]) - m0;
    var0 = __fmaf_rn(d0, d0, var0);
  }

  const T* y = p.s1 + row * p.w1 + col1;  // right series at the matched col
  float corr_val;
  float ret = static_cast<float>(d + p.col_offset);
  if (p.nx == 0 || border) {
    corr_val = nxcorr(p, left, m0, var0,
                      [&](int t) { return static_cast<float>(y[t * p.hw1]); });
  } else {
    float best = -1.f, best_x = 0.f;
    for (int ix = 0; ix < p.nx; ++ix) {
      const float x = p.xs[ix];
      auto interp = [&](int t) {
        const int64_t o = t * p.hw1;
        const float y0 = static_cast<float>(y[o - 1]);
        const float y1 = static_cast<float>(y[o]);
        const float y2 = static_cast<float>(y[o + 1]);
        const float pa = 0.5f * ((y0 - 2.0f * y1) + y2);
        const float pb = 0.5f * (y2 - y0);
        const float v = rintf(((pa * x) * x + pb * x) + y1);
        return static_cast<float>(static_cast<int>(v) & p.mod);
      };
      const float nxc = nxcorr(p, left, m0, var0, interp);
      if (best < nxc) {
        best = nxc;
        best_x = x;
      }
    }
    corr_val = best;
    ret = ret - best_x;
  }
  p.corr[i] = corr_val;
  p.out[i] = (corr_val < p.threshold) ? CUDART_NAN_F : ret;
}

template <typename T>
void launch(const void* disp, const void* s0, const void* s1, const void* xs,
            int nx, void* out, void* corr, int n, int h, int w, int w1,
            int col_offset, int mod, float threshold, float minvar,
            int has_minvar, cudaStream_t st) {
  Params<T> p;
  p.disp = static_cast<const int16_t*>(disp);
  p.s0 = static_cast<const T*>(s0);
  p.s1 = static_cast<const T*>(s1);
  p.xs = static_cast<const float*>(xs);
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
  p.threshold = threshold;
  p.minvar = minvar;
  const int threads = 128;
  const unsigned blocks = static_cast<unsigned>((p.hw + threads - 1) / threads);
  agree_kernel<T><<<blocks, threads, 0, st>>>(p);
}

}  // namespace

extern "C" int bicos_agree(int device, const void* disp, const void* s0,
                           const void* s1, const void* xs, int nx, void* out,
                           void* corr, int n, int h, int w, int w1,
                           int col_offset, int u16, float threshold,
                           float minvar, int has_minvar, void* stream) {
  if (cudaError_t e = cudaSetDevice(device)) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u16) {
    launch<uint16_t>(disp, s0, s1, xs, nx, out, corr, n, h, w, w1,
                     col_offset, 0xFFFF, threshold, minvar, has_minvar, st);
  } else {
    launch<uint8_t>(disp, s0, s1, xs, nx, out, corr, n, h, w, w1,
                    col_offset, 0xFF, threshold, minvar, has_minvar, st);
  }
  return static_cast<int>(cudaGetLastError());
}
