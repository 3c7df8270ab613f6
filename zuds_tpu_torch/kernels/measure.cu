// H23: windowed centroids, windowed shapes and their errors, the Kron
// radius and the AUTO flux at each detection.
//
// Replaces zuds_tpu/ops/measure.py:refine_detections (:139-244). One block
// per detection; the 33x33 windows of img and rms at the clamped rounded
// corner sit in shared memory (8.7 KB, loaded as 16-byte copies of the
// aligned rows that hold them when the frame's rows allow) and every pass
// below reads them from there:
//   1. four Gaussian-windowed centroid iterations (window sigma
//      max(2 fwhm / 2.355, 1)), each a block reduction of (sum w, sum w x,
//      sum w y) with w = g pos, pos = max(img, 0);
//   2. at the centroid, in one pass, the windowed second moments and the
//      errors of the windowed centroid (seven sums) and the Kron first
//      moment of r_ell inside r_ell <= 6 (two sums), each pixel's r_ell
//      kept in shared memory;
//   3. the AUTO sums inside r_ell <= 2.5 rkron (two sums),
// then the 11 outputs, in the order of ops/measure.py (REFINE_KEYS).
// Every block reduction is in a fixed order (each thread's pixels in turn,
// a butterfly of shuffles, the warps in turn), so two calls are
// bit-identical. Each operation is rounded on its own as PyTorch's
// elementwise kernels round the plain version (ops/measure.py:
// refine_detections_plain): __fmul_rn and friends, expf, sinf, cosf,
// atan2f and sqrtf with no fast-math intrinsics, a division by a Python
// number as PyTorch does it (a product with the f32 reciprocal), the NaN
// rules of torch.clamp and torch.maximum. The sums are taken in another
// order than torch.sum's, and the ellipse tests of passes 2 and 3 are
// decisions: a pixel whose r_ell lies on an edge can fall on either side,
// and flux_auto then moves by that pixel's value.
//
// A row whose six inputs are bitwise those of the last row N - 1 has the
// last row's outputs: its block exits at once, and the last row's block,
// once its row is done, copies its outputs to every such row (it reads
// the N rows' inputs, 24 B each). The slice hands all max_det = 4096 rows
// of detect_sources, of which a flagship frame fills ~57: the rows past
// its objects carry the same fills, so ~58 blocks measure and the rest
// exit. No count from the caller and no host read: a call whose rows are
// all distinct measures them all.
//
// Bound: bytes, of the distinct work that gives the same outputs: each
// distinct row's two 33x33 windows (8712 B), every row's six inputs (24 B)
// and 11 outputs (44 B); ~58 distinct rows of 4096 on the slice: 0.79 MB,
// 0.24 us at 3.35 TB/s (all 4096 rows measured: 36.0 MB, 10.7 us). The
// operations, ~135 a pixel, take ~0.1 us for 58 rows at the fp32 peak.
// What bounds it in practice is one block's chain: six block reductions
// over nine pixels a thread at 128 threads a block (the order of the sums
// of one block a row at that width, so the outputs are the same bits),
// a thread's pixels unrolled and computed side by side.
#include "common.cuh"

namespace {

constexpr int kMaxSums = 9;
constexpr int kOutputs = 11;

// the plain version's Python constants, rounded to f32 as PyTorch rounds
// them (a double cast to float; fwhm / 2.355 is fwhm * (1 / 2.355f))
constexpr float kInvFwhm = 1.0f / (float)2.355;
constexpr float kKronInt = 6.0f;            // KRON_INT_RADIUS
constexpr float kKronFact = 2.5f;           // KRON_FACT
constexpr float kKronMin = (float)(3.5 / 2.5);  // KRON_MIN_RADIUS / FACT

// Sum each of v[0..K) over the block in a fixed order; every thread gets
// the totals. ``red`` holds kThreads / 32 * kMaxSums floats, ``res``
// kMaxSums.
template <int kThreads, int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red,
                                          float* res) {
  constexpr int kWarps = kThreads / 32;
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
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
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

// f(i, row, col) for each of a thread's pixels of the cut x cut window,
// i = t, t + kThreads, ... in turn (each thread's sums add them in that
// order). kCut > 0: the window's size at compile time, the loop unrolled
// so that a thread's pixels are computed side by side; else ``cut``.
template <int kThreads, int kCut, class F>
__device__ __forceinline__ void for_pixels(int cut, F&& f) {
  if constexpr (kCut > 0) {
    constexpr int kN = kCut * kCut;
    constexpr int kIters = (kN + kThreads - 1) / kThreads;
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < kN) f(i, i / kCut, i % kCut);
    }
  } else {
    const int npix = cut * cut, drow = kThreads / cut;
    const int dcol = kThreads - drow * cut;
    int row = threadIdx.x / cut, col = threadIdx.x - row * cut;
    for (int i = threadIdx.x; i < npix; i += kThreads) {
      f(i, row, col);
      row += drow;
      col += dcol;
      if (col >= cut) {
        col -= cut;
        ++row;
      }
    }
  }
}

// rows a thread of the last row's block compares ahead, one bit each
constexpr int kAheadRows = 32;

template <int kThreads, int kCut>
__global__ void __launch_bounds__(kThreads)
    refine_kernel(const float* __restrict__ img,
                  const float* __restrict__ rms, int H, int W,
                  const float* __restrict__ xs, const float* __restrict__ ys,
                  const float* __restrict__ as, const float* __restrict__ bs,
                  const float* __restrict__ ths,
                  const float* __restrict__ fws, int N, int cut_arg, int vec,
                  float* __restrict__ out) {
  extern __shared__ float s_tile[];        // img, rms, r_ell: 3 cut^2
  __shared__ float s_red[kThreads / 32 * kMaxSums];
  __shared__ float s_res[kMaxSums];
  __shared__ float s_out[kOutputs];
  const int n = blockIdx.x, t = threadIdx.x, last = N - 1;
  const float* ins[6] = {xs, ys, as, bs, ths, fws};
  uint32_t rep[6];
  bool dup = true;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    rep[k] = __float_as_uint(ins[k][last]);
    dup = dup && __float_as_uint(ins[k][n]) == rep[k];
  }
  if (dup && n != last) return;  // the last row's block writes this row
  // the last row's block: which of its thread's first kAheadRows rows
  // share its inputs, read now, beside the window's loads
  uint32_t ahead = 0;
  if (n == last) {
#pragma unroll 8
    for (int k = 0; k < kAheadRows; ++k) {
      const int r = t + k * kThreads;
      bool same = r < last;
#pragma unroll
      for (int j = 0; j < 6; ++j)
        same &= __float_as_uint(ins[j][min(r, last)]) == rep[j];
      ahead |= (same ? 1u : 0u) << k;
    }
  }

  const int cut = kCut > 0 ? kCut : cut_arg;
  const int npix = cut * cut;
  float* s_img = s_tile;
  float* s_rms = s_tile + npix;
  float* s_rell = s_tile + 2 * npix;
  bool off;
  const int x0 = window_corner(xs[n], W, cut, &off);
  const int y0 = window_corner(ys[n], H, cut, &off);
  if (vec) {
    // 16-byte copies of the aligned run [x4, x4 + 4 nq) of each window row
    // (W % 4 == 0 and both planes 16-byte aligned: the run stays inside
    // the frame's row)
    const int x4 = x0 & ~3;
    const int nq = (x0 + cut - x4 + 3) >> 2;
    for (int q = t; q < cut * nq; q += kThreads) {
      const int row = q / nq, k = q - row * nq;
      const long long at = (long long)(y0 + row) * W + x4 + 4 * k;
      const float4 a = *reinterpret_cast<const float4*>(img + at);
      const float4 b = *reinterpret_cast<const float4*>(rms + at);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
      const int c0 = x4 + 4 * k - x0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c0 + c;
        if (col >= 0 && col < cut) {
          s_img[row * cut + col] = av[c];
          s_rms[row * cut + col] = bv[c];
        }
      }
    }
  } else {
    for_pixels<kThreads, kCut>(cut, [&](int i, int row, int col) {
      const long long at = (long long)(y0 + row) * W + x0 + col;
      s_img[i] = img[at];
      s_rms[i] = rms[at];
    });
  }
  __syncthreads();

  const float swin = clamp_min(__fmul_rn(__fmul_rn(fws[n], kInvFwhm), 2.f),
                               1.f);
  const float two_s2 = __fmul_rn(__fmul_rn(2.f, swin), swin);

  // 1. windowed centroid
  float xw = xs[n], yw = ys[n];
  for (int it = 0; it < 4; ++it) {
    float acc[3] = {0.f, 0.f, 0.f};
    for_pixels<kThreads, kCut>(cut, [&](int i, int row, int col) {
      const float xx = (float)(x0 + col), yy = (float)(y0 + row);
      const float w = __fmul_rn(gauss(__fsub_rn(xx, xw), __fsub_rn(yy, yw),
                                      two_s2),
                                clamp_min(s_img[i], 0.f));
      acc[0] = __fadd_rn(acc[0], w);
      acc[1] = __fadd_rn(acc[1], __fmul_rn(w, xx));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(w, yy));
    });
    block_sum<kThreads>(acc, s_red, s_res);
    const float tot = clamp_min(acc[0], (float)1e-20);
    xw = __fdiv_rn(acc[1], tot);
    yw = __fdiv_rn(acc[2], tot);
  }

  // 2. at the centroid: the windowed second moments and the centroid's
  // errors (m[0..6]), the Kron moment inside the KRON_INT_RADIUS ellipse
  // (m[7], m[8]); each pixel's r_ell kept for pass 3
  const float ct = cosf(ths[n]), st = sinf(ths[n]);
  const float ai = clamp_min(as[n], 0.5f), bi = clamp_min(bs[n], 0.5f);
  float m[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for_pixels<kThreads, kCut>(cut, [&](int i, int row, int col) {
    const float dx = __fsub_rn((float)(x0 + col), xw);
    const float dy = __fsub_rn((float)(y0 + row), yw);
    const float g = gauss(dx, dy, two_s2);
    const float pos = clamp_min(s_img[i], 0.f);
    const float wI = __fmul_rn(g, pos);
    const float e = s_rms[i];
    const float g2v = __fmul_rn(__fmul_rn(__fmul_rn(g, g), e), e);
    m[0] = __fadd_rn(m[0], wI);
    m[1] = __fadd_rn(m[1], __fmul_rn(__fmul_rn(wI, dx), dx));
    m[2] = __fadd_rn(m[2], __fmul_rn(__fmul_rn(wI, dy), dy));
    m[3] = __fadd_rn(m[3], __fmul_rn(__fmul_rn(wI, dx), dy));
    m[4] = __fadd_rn(m[4], __fmul_rn(__fmul_rn(g2v, dx), dx));
    m[5] = __fadd_rn(m[5], __fmul_rn(__fmul_rn(g2v, dy), dy));
    m[6] = __fadd_rn(m[6], __fmul_rn(__fmul_rn(g2v, dx), dy));
    const float xr = __fadd_rn(__fmul_rn(dx, ct), __fmul_rn(dy, st));
    const float yr = __fadd_rn(__fmul_rn(-dx, st), __fmul_rn(dy, ct));
    const float r_ell = sqrtf(__fadd_rn(sq(__fdiv_rn(xr, ai)),
                                        sq(__fdiv_rn(yr, bi))));
    s_rell[i] = r_ell;
    const float wf = r_ell <= kKronInt ? pos : 0.f;
    m[7] = __fadd_rn(m[7], __fmul_rn(wf, r_ell));
    m[8] = __fadd_rn(m[8], wf);
  });
  block_sum<kThreads>(m, s_red, s_res);
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
  const float rkron = torch_max(
      __fdiv_rn(m[7], clamp_min(m[8], (float)1e-20)),
      __fmul_rn(__fdiv_rn(1.f, ai), kKronMin));

  // 3. the AUTO sums inside KRON_FACT * rkron
  const float rk = __fmul_rn(rkron, kKronFact);
  float au[2] = {0.f, 0.f};
  for_pixels<kThreads, kCut>(cut, [&](int i, int, int) {
    if (s_rell[i] <= rk) {
      au[0] = __fadd_rn(au[0], s_img[i]);
      au[1] = __fadd_rn(au[1], sq(s_rms[i]));
    }
  });
  block_sum<kThreads>(au, s_red, s_res);

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
    for (int j = 0; j < kOutputs; ++j) {
      out[(long long)j * N + n] = o[j];
      s_out[j] = o[j];
    }
  }
  if (n != last) return;
  // the rows whose blocks left theirs to this one
  __syncthreads();
  float o[kOutputs];
#pragma unroll
  for (int j = 0; j < kOutputs; ++j) o[j] = s_out[j];
  for (int k = 0; k < kAheadRows; ++k) {
    if (ahead >> k & 1u) {
      const int r = t + k * kThreads;
#pragma unroll
      for (int j = 0; j < kOutputs; ++j) out[(long long)j * N + r] = o[j];
    }
  }
  for (int r = t + kAheadRows * kThreads; r < last; r += kThreads) {
    bool same = true;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      same = same && __float_as_uint(ins[k][r]) == rep[k];
    if (same) {
#pragma unroll
      for (int j = 0; j < kOutputs; ++j) out[(long long)j * N + r] = o[j];
    }
  }
}

template <int kThreads, int kCut>
int launch_refine(const float* img, const float* rms, int H, int W,
                  const float* xs, const float* ys, const float* a,
                  const float* b, const float* theta, const float* fwhm,
                  int N, int cut, int vec, float* out, cudaStream_t stream) {
  const size_t smem = 3 * (size_t)cut * cut * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)refine_kernel<kThreads, kCut>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  refine_kernel<kThreads, kCut><<<N, kThreads, smem, stream>>>(
      img, rms, H, W, xs, ys, a, b, theta, fwhm, N, cut, vec, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The block width: ZUDS_REFINE_THREADS in a probe build, else 128 (nine
// of a 33x33 window's 1089 pixels a thread, 94.5% of the lanes busy,
// sixteen blocks an SM): the sums' order of the one-block-a-row design
// kept, so the outputs are its bits; the slice's ~58 measured rows are
// latency-bound, and the unrolled pixel loop computes a thread's nine
// pixels side by side.
#ifndef ZUDS_REFINE_THREADS
#define ZUDS_REFINE_THREADS 128
#endif

// img, rms (H, W) f32; xs, ys, a, b, theta, fwhm (N,) f32; out (11, N) f32
// in the order xwin, ywin, kron_radius, flux_auto, fluxerr_auto, awin,
// bwin, thetawin, errawin, errbwin, errthetawin. The frame is at least
// cut x cut; cut at most 78 (3 cut^2 floats of shared memory).
extern "C" int zuds_refine_detections(const float* img, const float* rms,
                                      int H, int W, const float* xs,
                                      const float* ys, const float* a,
                                      const float* b, const float* theta,
                                      const float* fwhm, int N, int cut,
                                      float* out, cudaStream_t stream) {
  if (N <= 0) return (int)cudaGetLastError();
  const int vec = W % 4 == 0 && (uintptr_t)img % 16 == 0 &&
                  (uintptr_t)rms % 16 == 0;
  if (cut == 33)
    return launch_refine<ZUDS_REFINE_THREADS, 33>(
        img, rms, H, W, xs, ys, a, b, theta, fwhm, N, cut, vec, out, stream);
  return launch_refine<ZUDS_REFINE_THREADS, 0>(
      img, rms, H, W, xs, ys, a, b, theta, fwhm, N, cut, vec, out, stream);
}
