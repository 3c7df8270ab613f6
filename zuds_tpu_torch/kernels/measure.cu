// H23: windowed centroids, windowed shapes and their errors, the Kron
// radius and the AUTO flux at each detection.
//
// Replaces zuds_tpu/ops/measure.py:refine_detections (:139-244). One block
// per detection; the 33x33 windows of img and rms at the clamped rounded
// corner sit in shared memory (8.7 KB) and every pass below reads them
// from there:
//   1. four Gaussian-windowed centroid iterations (window sigma
//      max(2 fwhm / 2.355, 1)), each a block reduction of (sum w, sum w x,
//      sum w y) with w = g pos, pos = max(img, 0);
//   2. the windowed second moments and the errors of the windowed centroid
//      (seven sums);
//   3. the Kron first moment of r_ell inside r_ell <= 6 (two sums);
//   4. the AUTO sums inside r_ell <= 2.5 rkron (two sums),
// then the 11 outputs, in the order of ops/measure.py (REFINE_KEYS).
// Every block reduction is in a fixed order (each thread's pixels in turn,
// a butterfly of shuffles, the warps in turn), so two calls are
// bit-identical. Each operation is rounded on its own as PyTorch's
// elementwise kernels round the plain version (ops/measure.py:
// refine_detections_plain): __fmul_rn and friends, expf, sinf, cosf,
// atan2f and sqrtf with no fast-math intrinsics, a division by a Python
// number as PyTorch does it (a product with the f32 reciprocal), the NaN
// rules of torch.clamp and torch.maximum. The sums are taken in another
// order than torch.sum's, and the ellipse tests of passes 3 and 4 are
// decisions: a pixel whose r_ell lies on an edge can fall on either side,
// and flux_auto then moves by that pixel's value.
//
// Bound: bytes. Each detection reads its two 33x33 windows once (8712 B)
// and its six inputs, and writes 11 outputs: 4096 x 8.78 KB = 36.0 MB,
// 10.7 us at 3.35 TB/s. The operations, ~100 a pixel over the six passes,
// take ~6.7 us at the fp32 peak.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxSums = 7;
constexpr int kOutputs = 11;

// the plain version's Python constants, rounded to f32 as PyTorch rounds
// them (a double cast to float; fwhm / 2.355 is fwhm * (1 / 2.355f))
constexpr float kInvFwhm = 1.0f / (float)2.355;
constexpr float kKronInt = 6.0f;            // KRON_INT_RADIUS
constexpr float kKronFact = 2.5f;           // KRON_FACT
constexpr float kKronMin = (float)(3.5 / 2.5);  // KRON_MIN_RADIUS / FACT

// Sum each of v[0..K) over the block in a fixed order; every thread gets
// the totals. ``red`` holds kWarpsPerBlock * kMaxSums floats, ``res``
// kMaxSums.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red,
                                          float* res) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
    if (lane == 0) red[warp * kMaxSums + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = red[threadIdx.x];
    for (int w = 1; w < kWarpsPerBlock; ++w)
      s = __fadd_rn(s, red[w * kMaxSums + threadIdx.x]);
    res[threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = res[k];
}

__device__ __forceinline__ float sq(float v) { return __fmul_rn(v, v); }

// sqrt(max(x, floor)) (ops/measure.py:_sqrt0)
__device__ __forceinline__ float sqrt0(float x, float floor) {
  return sqrtf(clamp_min(x, floor));
}

// exp(-(dx^2 + dy^2) / two_s2)
__device__ __forceinline__ float gauss(float dx, float dy, float two_s2) {
  return expf(__fdiv_rn(-__fadd_rn(sq(dx), sq(dy)), two_s2));
}

__global__ void __launch_bounds__(kThreads)
    refine_kernel(const float* __restrict__ img,
                  const float* __restrict__ rms, int H, int W,
                  const float* __restrict__ xs, const float* __restrict__ ys,
                  const float* __restrict__ as, const float* __restrict__ bs,
                  const float* __restrict__ ths,
                  const float* __restrict__ fws, int N, int cut,
                  float* __restrict__ out) {
  extern __shared__ float s_tile[];        // img, then rms: 2 cut^2
  __shared__ float s_red[kWarpsPerBlock * kMaxSums];
  __shared__ float s_res[kMaxSums];
  const int n = blockIdx.x, t = threadIdx.x;
  const int npix = cut * cut;
  float* s_img = s_tile;
  float* s_rms = s_tile + npix;
  bool off;
  const int x0 = window_corner(xs[n], W, cut, &off);
  const int y0 = window_corner(ys[n], H, cut, &off);
  for (int i = t; i < npix; i += kThreads) {
    const int row = i / cut, col = i - row * cut;
    const long long at = (long long)(y0 + row) * W + x0 + col;
    s_img[i] = img[at];
    s_rms[i] = rms[at];
  }
  __syncthreads();

  const float swin = clamp_min(__fmul_rn(__fmul_rn(fws[n], kInvFwhm), 2.f),
                               1.f);
  const float two_s2 = __fmul_rn(__fmul_rn(2.f, swin), swin);

  // 1. windowed centroid
  float xw = xs[n], yw = ys[n];
  for (int it = 0; it < 4; ++it) {
    float acc[3] = {0.f, 0.f, 0.f};
    for (int i = t; i < npix; i += kThreads) {
      const int row = i / cut, col = i - row * cut;
      const float xx = (float)(x0 + col), yy = (float)(y0 + row);
      const float w = __fmul_rn(gauss(__fsub_rn(xx, xw), __fsub_rn(yy, yw),
                                      two_s2),
                                clamp_min(s_img[i], 0.f));
      acc[0] = __fadd_rn(acc[0], w);
      acc[1] = __fadd_rn(acc[1], __fmul_rn(w, xx));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(w, yy));
    }
    block_sum(acc, s_red, s_res);
    const float tot = clamp_min(acc[0], (float)1e-20);
    xw = __fdiv_rn(acc[1], tot);
    yw = __fdiv_rn(acc[2], tot);
  }

  // 2. windowed second moments and the centroid's errors
  float m[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = t; i < npix; i += kThreads) {
    const int row = i / cut, col = i - row * cut;
    const float dx = __fsub_rn((float)(x0 + col), xw);
    const float dy = __fsub_rn((float)(y0 + row), yw);
    const float g = gauss(dx, dy, two_s2);
    const float wI = __fmul_rn(g, clamp_min(s_img[i], 0.f));
    const float e = s_rms[i];
    const float g2v = __fmul_rn(__fmul_rn(__fmul_rn(g, g), e), e);
    m[0] = __fadd_rn(m[0], wI);
    m[1] = __fadd_rn(m[1], __fmul_rn(__fmul_rn(wI, dx), dx));
    m[2] = __fadd_rn(m[2], __fmul_rn(__fmul_rn(wI, dy), dy));
    m[3] = __fadd_rn(m[3], __fmul_rn(__fmul_rn(wI, dx), dy));
    m[4] = __fadd_rn(m[4], __fmul_rn(__fmul_rn(g2v, dx), dx));
    m[5] = __fadd_rn(m[5], __fmul_rn(__fmul_rn(g2v, dy), dy));
    m[6] = __fadd_rn(m[6], __fmul_rn(__fmul_rn(g2v, dx), dy));
  }
  block_sum(m, s_red, s_res);
  const float wsum = clamp_min(m[0], (float)1e-20);
  const float x2w = clamp_min(__fdiv_rn(m[1], wsum), (float)(1.0 / 12.0));
  const float y2w = clamp_min(__fdiv_rn(m[2], wsum), (float)(1.0 / 12.0));
  const float xyw = __fdiv_rn(m[3], wsum);
  const float t1w = __fmul_rn(__fadd_rn(x2w, y2w), 0.5f);
  const float t2w = sqrt0(
      __fadd_rn(sq(__fmul_rn(__fsub_rn(x2w, y2w), 0.5f)), sq(xyw)), 0.f);
  const float w2 = sq(wsum);
  const float ex2 = __fdiv_rn(m[4], w2);
  const float ey2 = __fdiv_rn(m[5], w2);
  const float exy = __fdiv_rn(m[6], w2);
  const float et1 = __fmul_rn(__fadd_rn(ex2, ey2), 0.5f);
  const float et2 = sqrt0(
      __fadd_rn(sq(__fmul_rn(__fsub_rn(ex2, ey2), 0.5f)), sq(exy)), 0.f);

  // 3. the Kron radius inside the KRON_INT_RADIUS ellipse
  const float ct = cosf(ths[n]), st = sinf(ths[n]);
  const float ai = clamp_min(as[n], 0.5f), bi = clamp_min(bs[n], 0.5f);
  float k[2] = {0.f, 0.f};
  for (int i = t; i < npix; i += kThreads) {
    const int row = i / cut, col = i - row * cut;
    const float dx = __fsub_rn((float)(x0 + col), xw);
    const float dy = __fsub_rn((float)(y0 + row), yw);
    const float xr = __fadd_rn(__fmul_rn(dx, ct), __fmul_rn(dy, st));
    const float yr = __fadd_rn(__fmul_rn(-dx, st), __fmul_rn(dy, ct));
    const float r_ell = sqrtf(__fadd_rn(sq(__fdiv_rn(xr, ai)),
                                        sq(__fdiv_rn(yr, bi))));
    const float wf = r_ell <= kKronInt ? clamp_min(s_img[i], 0.f) : 0.f;
    k[0] = __fadd_rn(k[0], __fmul_rn(wf, r_ell));
    k[1] = __fadd_rn(k[1], wf);
  }
  block_sum(k, s_red, s_res);
  const float rkron = torch_max(
      __fdiv_rn(k[0], clamp_min(k[1], (float)1e-20)),
      __fmul_rn(__fdiv_rn(1.f, ai), kKronMin));

  // 4. the AUTO sums inside KRON_FACT * rkron
  const float rk = __fmul_rn(rkron, kKronFact);
  float au[2] = {0.f, 0.f};
  for (int i = t; i < npix; i += kThreads) {
    const int row = i / cut, col = i - row * cut;
    const float dx = __fsub_rn((float)(x0 + col), xw);
    const float dy = __fsub_rn((float)(y0 + row), yw);
    const float xr = __fadd_rn(__fmul_rn(dx, ct), __fmul_rn(dy, st));
    const float yr = __fadd_rn(__fmul_rn(-dx, st), __fmul_rn(dy, ct));
    const float r_ell = sqrtf(__fadd_rn(sq(__fdiv_rn(xr, ai)),
                                        sq(__fdiv_rn(yr, bi))));
    if (r_ell <= rk) {
      au[0] = __fadd_rn(au[0], s_img[i]);
      au[1] = __fadd_rn(au[1], sq(s_rms[i]));
    }
  }
  block_sum(au, s_red, s_res);

  if (t == 0) {
    const float o[kOutputs] = {
        xw, yw, rkron, au[0], sqrtf(au[1]),
        sqrt0(__fadd_rn(t1w, t2w), (float)1e-12),
        sqrt0(__fsub_rn(t1w, t2w), (float)1e-12),
        __fmul_rn(atan2f(__fmul_rn(2.f, xyw), __fsub_rn(x2w, y2w)), 0.5f),
        sqrt0(__fadd_rn(et1, et2), (float)1e-20),
        sqrt0(__fsub_rn(et1, et2), (float)1e-20),
        __fmul_rn(atan2f(__fmul_rn(2.f, exy), __fsub_rn(ex2, ey2)), 0.5f)};
#pragma unroll
    for (int j = 0; j < kOutputs; ++j) out[(long long)j * N + n] = o[j];
  }
}

}  // namespace

// img, rms (H, W) f32; xs, ys, a, b, theta, fwhm (N,) f32; out (11, N) f32
// in the order xwin, ywin, kron_radius, flux_auto, fluxerr_auto, awin,
// bwin, thetawin, errawin, errbwin, errthetawin. The frame is at least
// cut x cut, and 2 cut^2 floats fit in 48 KB of shared memory.
extern "C" int zuds_refine_detections(const float* img, const float* rms,
                                      int H, int W, const float* xs,
                                      const float* ys, const float* a,
                                      const float* b, const float* theta,
                                      const float* fwhm, int N, int cut,
                                      float* out, cudaStream_t stream) {
  if (N > 0) {
    const size_t smem = 2 * (size_t)cut * cut * sizeof(float);
    refine_kernel<<<N, kThreads, smem, stream>>>(img, rms, H, W, xs, ys, a, b,
                                                  theta, fwhm, N, cut, out);
  }
  return (int)cudaGetLastError();
}
