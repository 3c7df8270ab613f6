// H13: one convolution layer of the braai real/bogus CNN.
//
// Replaces the four nn.Conv layers of zuds_tpu/models/braai.py:27-49
// (BraaiD6, scored by rb_scores at :78-81): a direct 3x3 VALID correlation
// of an NHWC f32 batch with an HWIO kernel (no flip, as flax and F.conv2d
// compute it), plus the bias, then ReLU, and for layers 2 and 4 the 2x2/2
// max pool fused into the epilogue (floor: the odd last row and column
// are dropped, 59 -> 29 and 25 -> 12). FP32 FMAs only: no TF32, no bf16.
//
// One thread per output pixel (per pooled pixel: its 2x2 convolution
// outputs) and kCT output channels, held in registers; a block is 256
// pixels of one image and one tile of kCT output channels, whose
// 3 x 3 x Cin x kCT weights sit in shared memory (36 KB at Cin = 64, under
// the 48 KB static limit; Conv_3's whole kernel, 147 KB, does not fit, so
// the output channels are tiled). Each input value read (float4 over
// four input channels where Cin allows) feeds kCT FMAs per pixel; the
// weights are read as float4 broadcasts from shared memory. The input of
// one image (at most 476 KB) stays in L1/L2 across its nine taps and the
// channel tiles. NaN passes through ReLU and the pool as in the plain
// version (torch.relu and max_pool2d propagate it).
//
// Bound: operations. 137.8 MFLOP per triplet over the four layers (6.43,
// 62.0, 26.9 and 42.5 M: a pooled layer computes only the 58x58 and 24x24
// outputs its pool reads), against 1.7 MB of activations moved: at 67
// TFLOP/s fp32 a batch of 256 triplets needs 0.53 ms.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCT = 16;                    // output channels per block

__device__ __forceinline__ float relu_nan(float v) {
  return (v > 0.f || isnan(v)) ? v : 0.f;
}

template <int CIN, int COUT, bool POOL>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const float* __restrict__ in, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int H, int W, int tiles) {
  __shared__ __align__(16) float s_w[9 * CIN * kCT];
  const int n = blockIdx.x / tiles;
  const int tile = blockIdx.x - n * tiles;
  const int co0 = blockIdx.y * kCT;
  for (int i = threadIdx.x; i < 9 * CIN * kCT; i += kThreads) {
    const int kc = i / kCT, j = i - kc * kCT;
    s_w[i] = w[kc * COUT + co0 + j];
  }
  __syncthreads();

  const int Hc = H - 2, Wc = W - 2;       // the convolution's output
  const int Ho = POOL ? Hc / 2 : Hc, Wo = POOL ? Wc / 2 : Wc;
  const int p = tile * kThreads + threadIdx.x;
  if (p >= Ho * Wo) return;
  const int oy = p / Wo, ox = p - oy * Wo;
  constexpr int NP = POOL ? 4 : 1;        // convolution outputs per thread
  const int cy = POOL ? 2 * oy : oy, cx = POOL ? 2 * ox : ox;
  const float* img = in + (long long)n * H * W * CIN;

  float acc[NP][kCT];
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int j = 0; j < kCT; ++j) acc[q][j] = 0.f;

#pragma unroll 1
  for (int k = 0; k < 9; ++k) {
    const int ky = k / 3, kx = k - ky * 3;
    const float* ip[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q)
      ip[q] = img + ((cy + (q >> 1) + ky) * W + cx + (q & 1) + kx) * CIN;
    const float* wk = s_w + k * CIN * kCT;
    if constexpr (CIN % 4 == 0) {
#pragma unroll 2
      for (int ci = 0; ci < CIN; ci += 4) {
        float4 x[NP];
#pragma unroll
        for (int q = 0; q < NP; ++q)
          x[q] = *reinterpret_cast<const float4*>(ip[q] + ci);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4* w4 =
              reinterpret_cast<const float4*>(wk + (ci + c) * kCT);
#pragma unroll
          for (int j4 = 0; j4 < kCT / 4; ++j4) {
            const float4 wv = w4[j4];
#pragma unroll
            for (int q = 0; q < NP; ++q) {
              const float xv = c == 0 ? x[q].x : c == 1 ? x[q].y
                               : c == 2 ? x[q].z : x[q].w;
              acc[q][4 * j4 + 0] = fmaf(xv, wv.x, acc[q][4 * j4 + 0]);
              acc[q][4 * j4 + 1] = fmaf(xv, wv.y, acc[q][4 * j4 + 1]);
              acc[q][4 * j4 + 2] = fmaf(xv, wv.z, acc[q][4 * j4 + 2]);
              acc[q][4 * j4 + 3] = fmaf(xv, wv.w, acc[q][4 * j4 + 3]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) {
        const float4* w4 = reinterpret_cast<const float4*>(wk + ci * kCT);
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          const float xv = ip[q][ci];
#pragma unroll
          for (int j4 = 0; j4 < kCT / 4; ++j4) {
            const float4 wv = w4[j4];
            acc[q][4 * j4 + 0] = fmaf(xv, wv.x, acc[q][4 * j4 + 0]);
            acc[q][4 * j4 + 1] = fmaf(xv, wv.y, acc[q][4 * j4 + 1]);
            acc[q][4 * j4 + 2] = fmaf(xv, wv.z, acc[q][4 * j4 + 2]);
            acc[q][4 * j4 + 3] = fmaf(xv, wv.w, acc[q][4 * j4 + 3]);
          }
        }
      }
    }
  }

  float res[kCT];
#pragma unroll
  for (int j = 0; j < kCT; ++j) {
    const float b = bias[co0 + j];
    float v = relu_nan(acc[0][j] + b);
#pragma unroll
    for (int q = 1; q < NP; ++q) v = nan_max(v, relu_nan(acc[q][j] + b));
    res[j] = v;
  }
  float4* o = reinterpret_cast<float4*>(
      out + (((long long)n * Ho + oy) * Wo + ox) * COUT + co0);
#pragma unroll
  for (int j4 = 0; j4 < kCT / 4; ++j4)
    o[j4] = make_float4(res[4 * j4], res[4 * j4 + 1], res[4 * j4 + 2],
                        res[4 * j4 + 3]);
}

template <int CIN, int COUT, bool POOL>
int launch(const float* in, const float* w, const float* bias, float* out,
           int N, int H, int W, cudaStream_t stream) {
  const int Hc = H - 2, Wc = W - 2;
  const int npix = POOL ? (Hc / 2) * (Wc / 2) : Hc * Wc;
  const int tiles = (npix + kThreads - 1) / kThreads;
  if (N > 0 && npix > 0) {
    const dim3 grid(N * tiles, COUT / kCT);
    conv3x3_kernel<CIN, COUT, POOL>
        <<<grid, kThreads, 0, stream>>>(in, w, bias, out, H, W, tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// in (N, H, W, Cin), w (3, 3, Cin, Cout), bias (Cout,), out (N, Ho, Wo,
// Cout), all f32 and contiguous; the four layers of BraaiD6 only.
extern "C" int zuds_braai_conv3x3(const float* in, const float* w,
                                  const float* bias, float* out, int N,
                                  int H, int W, int Cin, int Cout, int pool,
                                  cudaStream_t stream) {
  if (Cin == 3 && Cout == 32 && !pool)
    return launch<3, 32, false>(in, w, bias, out, N, H, W, stream);
  if (Cin == 32 && Cout == 32 && pool)
    return launch<32, 32, true>(in, w, bias, out, N, H, W, stream);
  if (Cin == 32 && Cout == 64 && !pool)
    return launch<32, 64, false>(in, w, bias, out, N, H, W, stream);
  if (Cin == 64 && Cout == 64 && pool)
    return launch<64, 64, true>(in, w, bias, out, N, H, W, stream);
  return (int)cudaErrorInvalidValue;
}
