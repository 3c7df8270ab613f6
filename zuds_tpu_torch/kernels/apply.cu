// H3: spatially varying Alard-Lupton model convolution.
//
// Replaces the Pallas bench kernel tools/bench_apply.py:mm_kernel (:218,
// launched by mm_form at :254) and the computation it stands for, the main
// path's zuds_tpu/ops/subtract.py:apply_kernel_s2d (:412-553) reached
// through apply_kernel_fast (:380). The TPU form packs the frame
// space-to-depth so the convolution becomes 3x3 x 64 -> 64*Nm matmuls; on
// Hopper the convolution is computed directly.
//
// Per output pixel (x, y) in region r (static edges ceil(i*H/nreg), taken
// from the OUTPUT pixel):
//   model = bg[r] + sum_m T_m(xn, yn) * sum_{ky,kx} kd[r,m,ky,kx] *
//           ref[y + ky - K/2, x + kx - K/2]
// with zero padding at the frame borders; neighbours across a region
// border are real data. T_m = xn^p_m * yn^q_m with xn = (x - cx[r]) / wx,
// yn = (y - cy[r]) / wy in f32, as apply_kernel (:640-646) forms them.
// kd = einsum('rnm,nkl->rmkl', a, dense basis) is formed by the caller.
//
// Layout: one 32x32 output tile per 1024-thread block, one pixel per
// thread. Shared memory holds the tile's (32+K-1)^2 reference window and
// the kernels of the (at most 2x2) regions the tile touches: Nm*K*K
// floats each (13.5 KB at K=15, Nm=15). A warp is one tile row, so its
// kernel reads are broadcasts and its window reads are consecutive.
//
// Bound: shared-memory issue. Each pixel does K*K*Nm FMAs (3375 at the
// flagship) with one window load per tap and Nm kernel loads per tap;
// DRAM traffic is ~8 bytes per pixel. The next step is register tiling
// (several pixels per thread sharing each kernel load) or wgmma.
#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kMaxNm = 15;

__device__ __forceinline__ int region_of(int i, int n, int nreg) {
  int r = 0;
  for (int k = 1; k < nreg; ++k)
    if (i >= (k * n + nreg - 1) / nreg) r = k;   // edge k = ceil(k*n/nreg)
  return r;
}

__device__ __forceinline__ float ipow(float x, int p) {
  float out = 1.f;
  for (int i = 0; i < p; ++i) out = __fmul_rn(out, x);
  return out;
}

__global__ void __launch_bounds__(kTile * kTile)
apply_kernel(const float* __restrict__ ref, const float* __restrict__ kd,
             const float* __restrict__ bg, const float* __restrict__ cx,
             const float* __restrict__ cy, float* __restrict__ model, int H,
             int W, int K, int Nm, int nreg, const int* __restrict__ pexp,
             const int* __restrict__ qexp, float wx, float wy) {
  extern __shared__ float smem[];
  const int KK = K * K, half = K / 2, TW = kTile + K - 1;
  float* win = smem;              // TW * TW
  float* kds = smem + TW * TW;    // 4 slots of Nm * KK
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int nthr = kTile * kTile;

  for (int i = tid; i < TW * TW; i += nthr) {
    const int gy = y0 + i / TW - half, gx = x0 + i % TW - half;
    win[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                 ? ref[(size_t)gy * W + gx]
                 : 0.f;
  }
  const int ri0 = region_of(y0, H, nreg);
  const int ri1 = region_of(min(y0 + kTile, H) - 1, H, nreg);
  const int rj0 = region_of(x0, W, nreg);
  const int rj1 = region_of(min(x0 + kTile, W) - 1, W, nreg);
  for (int s = 0; s < 4; ++s) {
    const int ri = ri0 + (s >> 1), rj = rj0 + (s & 1);
    if (ri > ri1 || rj > rj1) continue;
    const float* src = kd + (size_t)(ri * nreg + rj) * Nm * KK;
    float* dst = kds + s * Nm * KK;
    for (int i = tid; i < Nm * KK; i += nthr) dst[i] = src[i];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int ri = region_of(y, H, nreg), rj = region_of(x, W, nreg);
  const int r = ri * nreg + rj;
  const float* kr = kds + ((ri - ri0) * 2 + (rj - rj0)) * Nm * KK;

  float acc[kMaxNm];
#pragma unroll
  for (int m = 0; m < kMaxNm; ++m) acc[m] = 0.f;
  for (int ky = 0; ky < K; ++ky) {
    const float* wrow = win + (threadIdx.y + ky) * TW + threadIdx.x;
    for (int kx = 0; kx < K; ++kx) {
      const float v = wrow[kx];
      const float* kt = kr + ky * K + kx;
#pragma unroll
      for (int m = 0; m < kMaxNm; ++m)
        if (m < Nm) acc[m] = fmaf(kt[m * KK], v, acc[m]);
    }
  }

  const float xn = __fdiv_rn(__fsub_rn((float)x, cx[r]), wx);
  const float yn = __fdiv_rn(__fsub_rn((float)y, cy[r]), wy);
  float out = bg[r];
#pragma unroll
  for (int m = 0; m < kMaxNm; ++m) {
    if (m < Nm) {
      const float t = __fmul_rn(ipow(xn, pexp[m]), ipow(yn, qexp[m]));
      out = __fadd_rn(out, __fmul_rn(t, acc[m]));
    }
  }
  model[(size_t)y * W + x] = out;
}

}  // namespace

extern "C" int zuds_apply(const float* ref, const float* kd, const float* bg,
                          const float* cx, const float* cy, float* model,
                          int H, int W, int K, int Nm, int nreg,
                          const int* pexp, const int* qexp, float wx, float wy,
                          cudaStream_t stream) {
  if (Nm > kMaxNm || K % 2 != 1) return (int)cudaErrorInvalidValue;
  const int TW = kTile + K - 1;
  const size_t smem = (size_t)(TW * TW + 4 * Nm * K * K) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 block(kTile, kTile);
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  apply_kernel<<<grid, block, smem, stream>>>(ref, kd, bg, cx, cy, model, H,
                                              W, K, Nm, nreg, pexp, qexp, wx,
                                              wy);
  return (int)cudaGetLastError();
}
