// H7: the stamp-candidate stencil of the kernel-fit stamp selector.
//
// Replaces zuds_tpu/ops/measure.py:37-65 (select_stamps_device): the 3x3
// pyramid filter conv2_same(img, DEFAULT_FILTER) with zero padding, the
// 9x9 local maximum of the filtered frame (three rounds of shifted maxima,
// k = 1, 2, 1, -inf beyond the frame), and the test
//   filt >= max9x9 & filt > med + 10 sigma & img < sat & inside the margin,
// which the TPU runs as ~20 full-frame passes (9 shifted FMAs, 12 shifted
// maxima, the compare). Here one pass: each block loads its output tile
// with a 5-px halo of `img` into shared memory, computes `filt` on the tile
// plus a 4-px halo, takes the 9-wide row maxima and then the 9-tall column
// maxima of those, and writes the `cand` byte mask and `filt` at the
// candidates only (the selector reads `filt` nowhere else). `med` and
// `sigma` are device scalars (H8's outputs); the host never reads them.
//
// Bit-equality with the plain version (ops/measure.py):
// - the taps are added in row-major order from zero with __fmul_rn /
//   __fadd_rn (the weights 1/16, 2/16, 4/16 are powers of two, so each
//   product is exact and only the order matters);
// - a NaN anywhere in the 9x9 window makes its maximum NaN, as
//   torch.maximum and jnp.maximum propagate it, so no candidate is within
//   4 px of a NaN;
// - the threshold is fmaf(10, sigma, med): XLA's CPU backend contracts the
//   reference's `med + 10.0 * sigma` into one FMA, and the plain version
//   computes the same (ops/ordered.py:fma).
//
// Bound: memory. 4 B read and 1 B (cand) written per pixel, plus 4 B of
// `filt` per candidate: 47 MB at the flagship frame, 14 us at 3.35 TB/s.
// The halo re-reads (1.6x the tile) hit L2.
#include "common.cuh"

namespace {

constexpr int kTW = 32;   // output tile width
constexpr int kTH = 16;   // output tile height
constexpr int kR = 4;     // reach of the local maximum (9x9)
constexpr int kThreads = 256;
constexpr int kIW = kTW + 2 * (kR + 1);  // img tile with its 5-px halo
constexpr int kIH = kTH + 2 * (kR + 1);
constexpr int kFW = kTW + 2 * kR;        // filt tile with its 4-px halo
constexpr int kFH = kTH + 2 * kR;

__global__ void __launch_bounds__(kThreads)
    stamp_cand_kernel(const float* __restrict__ img, int H, int W,
                      const float* __restrict__ med,
                      const float* __restrict__ sigma, float sat, int margin,
                      float* __restrict__ filt_out,
                      uint8_t* __restrict__ cand_out) {
  __shared__ float s_img[kIH][kIW + 1];
  __shared__ float s_filt[kFH][kFW + 1];
  __shared__ float s_rmax[kFH][kTW + 1];
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int t = threadIdx.x;

  for (int i = t; i < kIH * kIW; i += kThreads) {
    const int iy = i / kIW, ix = i - iy * kIW;
    const int gy = y0 - kR - 1 + iy, gx = x0 - kR - 1 + ix;
    s_img[iy][ix] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                        ? img[(long long)gy * W + gx] : 0.f;
  }
  __syncthreads();

  // filt on the tile and its 4-px halo; -inf outside the frame (the
  // maxima's padding)
  for (int i = t; i < kFH * kFW; i += kThreads) {
    const int fy = i / kFW, fx = i - fy * kFW;
    const int gy = y0 - kR + fy, gx = x0 - kR + fx;
    float acc = -INFINITY;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float w = (float)((2 - (dy - 1) * (dy - 1))
                                  * (2 - (dx - 1) * (dx - 1))) * 0.0625f;
          acc = __fadd_rn(acc, __fmul_rn(w, s_img[fy + dy][fx + dx]));
        }
    }
    s_filt[fy][fx] = acc;
  }
  __syncthreads();

  for (int i = t; i < kFH * kTW; i += kThreads) {
    const int fy = i / kTW, tx = i - fy * kTW;
    float m = s_filt[fy][tx];
#pragma unroll
    for (int d = 1; d <= 2 * kR; ++d) m = nan_max(m, s_filt[fy][tx + d]);
    s_rmax[fy][tx] = m;
  }
  __syncthreads();

  const float thr = fmaf(10.f, *sigma, *med);
  for (int i = t; i < kTH * kTW; i += kThreads) {
    const int ty = i / kTW, tx = i - ty * kTW;
    const int gy = y0 + ty, gx = x0 + tx;
    if (gy >= H || gx >= W) continue;
    float m = s_rmax[ty][tx];
#pragma unroll
    for (int d = 1; d <= 2 * kR; ++d) m = nan_max(m, s_rmax[ty + d][tx]);
    const float f = s_filt[ty + kR][tx + kR];
    const float v = s_img[ty + kR + 1][tx + kR + 1];
    const bool c = f >= m && f > thr && v < sat && gx >= margin &&
                   gx < W - margin && gy >= margin && gy < H - margin;
    const long long o = (long long)gy * W + gx;
    if (c) filt_out[o] = f;
    cand_out[o] = c ? 1 : 0;
  }
}

}  // namespace

extern "C" int zuds_stamp_candidates(const float* img, int H, int W,
                                     const float* med, const float* sigma,
                                     float sat, int margin, float* filt,
                                     uint8_t* cand, cudaStream_t stream) {
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH);
  stamp_cand_kernel<<<grid, kThreads, 0, stream>>>(img, H, W, med, sigma,
                                                   sat, margin, filt, cand);
  return (int)cudaGetLastError();
}
