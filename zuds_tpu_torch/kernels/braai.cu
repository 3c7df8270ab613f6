// H13: one convolution layer of the braai real/bogus CNN, and its training
// mode H13t; H19: the layer's input gradient; H20: its weight and bias
// gradient.
//
// H13 replaces the four nn.Conv layers of zuds_tpu/models/braai.py:27-49
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
//
// H13t (the TRAIN flag of the same kernel) replaces the layers' forward
// under train_step (braai.py:90-105, BraaiD6 at train=True). It computes
// H13's values and, for the pooled layers, also writes per pooled output
// the routing byte: the index 0-3 (row-major in the 2x2 window) of the
// FIRST maximum, as XLA's select_and_scatter with `ge` and max_pool2d
// both route the gradient, or 255 where that maximum is <= 0, where ReLU
// gives every position of the window a zero gradient. Then it applies the
// dropout that follows the pool, flax's select(mask, v / keep, 0) (a
// division, rounded once). Serving keeps H13 unchanged. Backward needs
// only the byte and the mask of a pooled layer (29x29x32 and 12x12x64
// bytes a triplet, against 111 KB and 40 KB of pre-pool f32), and the
// layer's own output for an unpooled one (its ReLU mask).
//
// H19 replaces the input gradient XLA's autodiff forms for layers 2-4
// (the conv's VJP in train_step): a full 3x3 correlation of the gradient
// gz at the convolution's output with the spatially flipped kernel,
//   gx[iy, ix, ci] = sum_{ky, kx, co} gz[iy - ky, ix - kx, co] w[ky, kx, ci, co].
// Its prologue forms gz on the fly from what H13t saved: for a pooled
// layer gz = (route == position in the window and mask) ? gy / keep : 0
// (0 in the odd last row and column), for an unpooled one gz = y > 0 ? gy
// : 0 -- selects and one division, so gz is bit-equal to XLA's and the
// plain version's. The layout mirrors H13: one thread per input pixel and
// kCT input channels, a block 256 pixels of one image and one tile of kCT
// input channels, whose 3 x 3 x Cout x kCT weights sit in shared memory
// (36 KB at Cout = 64: Conv_3's whole kernel does not fit). Bound:
// operations, 62.0 + 26.9 + 42.5 = 131.4 MFLOP a triplet (the pooled
// layers count their routed 58x58 and 24x24 regions).
//
// H20 replaces the weight and bias gradient of all four layers:
//   gw[ky, kx, ci, co] = sum_{n, cy, cx} x[n, cy + ky, cx + kx, ci] gz[n, cy, cx, co]
//   gb[co] = sum_{n, cy, cx} gz[n, cy, cx, co],
// a product of the im2col matrix (M = N x the rows and columns with a
// gradient, 9 Cin) and gz (M, Cout) reduced over M (up to 256 x 58 x 58 =
// 861k terms per weight). No float atomics: pass one gives each (image,
// 32 x 32 tile of the (9 Cin, Cout) result) a block that sums its image's
// terms in a fixed order into its own partial (the tiles of row 0 also sum
// the bias), staged through shared memory 64 positions at a time; pass
// two adds the images' partials in image order. Two calls give the same
// bits, so a training run is reproducible. Bound: operations, 137.8
// MFLOP a triplet, as the forward.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCT = 16;                    // channels per block (H13, H19)
constexpr uint8_t kNoRoute = 255;

__device__ __forceinline__ float relu_nan(float v) {
  return (v > 0.f || isnan(v)) ? v : 0.f;
}

template <int CIN, int COUT, bool POOL, bool TRAIN>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const float* __restrict__ in, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   uint8_t* __restrict__ route,
                   const uint8_t* __restrict__ mask, float keep, int H,
                   int W, int tiles) {
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

  const long long off = (((long long)n * Ho + oy) * Wo + ox) * COUT + co0;
  constexpr bool kRoute = TRAIN && POOL;
  uint8_t keepb[kCT];
  if constexpr (kRoute) {
    if (mask != nullptr) {
      const uint4 m = *reinterpret_cast<const uint4*>(mask + off);
      memcpy(keepb, &m, sizeof(keepb));
    } else {
#pragma unroll
      for (int j = 0; j < kCT; ++j) keepb[j] = 1;
    }
  }
  float res[kCT];
  uint8_t rt[kCT];
#pragma unroll
  for (int j = 0; j < kCT; ++j) {
    const float b = bias[co0 + j];
    // nan_max's update rule, tracking where the first maximum sits
    float v = relu_nan(acc[0][j] + b);
    int arg = 0;
#pragma unroll
    for (int q = 1; q < NP; ++q) {
      const float u = relu_nan(acc[q][j] + b);
      if (isnan(u) || u > v) {
        v = u;
        arg = q;
      }
    }
    if constexpr (kRoute) {
      rt[j] = v > 0.f ? (uint8_t)arg : kNoRoute;
      v = keepb[j] ? __fdiv_rn(v, keep) : 0.f;
    }
    res[j] = v;
  }
  float4* o = reinterpret_cast<float4*>(out + off);
#pragma unroll
  for (int j4 = 0; j4 < kCT / 4; ++j4)
    o[j4] = make_float4(res[4 * j4], res[4 * j4 + 1], res[4 * j4 + 2],
                        res[4 * j4 + 3]);
  if constexpr (kRoute) {
    uint4 r;
    memcpy(&r, rt, sizeof(r));
    *reinterpret_cast<uint4*>(route + off) = r;
  }
}

// The gradient at the convolution's output, four channels co..co+3 at
// (n, cy, cx), from what H13t saved (see the note at the top). A pooled
// layer reads its output gradient gy, routing bytes and dropout mask at
// the pooled pixel; an unpooled one gy and its output y at the pixel. The
// caller keeps (cy, cx) inside the rows and columns with a gradient.
template <int COUT, bool POOL>
__device__ __forceinline__ float4 grad_z4(const float* __restrict__ gy,
                                          const uint8_t* __restrict__ route,
                                          const uint8_t* __restrict__ mask,
                                          const float* __restrict__ y,
                                          float keep, int n, int cy, int cx,
                                          int co, int Ho, int Wo) {
  if constexpr (POOL) {
    const long long off =
        (((long long)n * Ho + (cy >> 1)) * Wo + (cx >> 1)) * COUT + co;
    const uint8_t at = (uint8_t)(((cy & 1) << 1) | (cx & 1));
    const uchar4 r = *reinterpret_cast<const uchar4*>(route + off);
    const uchar4 m = mask != nullptr
                         ? *reinterpret_cast<const uchar4*>(mask + off)
                         : make_uchar4(1, 1, 1, 1);
    const float4 g = *reinterpret_cast<const float4*>(gy + off);
    return make_float4(r.x == at && m.x ? __fdiv_rn(g.x, keep) : 0.f,
                       r.y == at && m.y ? __fdiv_rn(g.y, keep) : 0.f,
                       r.z == at && m.z ? __fdiv_rn(g.z, keep) : 0.f,
                       r.w == at && m.w ? __fdiv_rn(g.w, keep) : 0.f);
  } else {
    const long long off = (((long long)n * Ho + cy) * Wo + cx) * COUT + co;
    const float4 v = *reinterpret_cast<const float4*>(y + off);
    const float4 g = *reinterpret_cast<const float4*>(gy + off);
    return make_float4(v.x > 0.f ? g.x : 0.f, v.y > 0.f ? g.y : 0.f,
                       v.z > 0.f ? g.z : 0.f, v.w > 0.f ? g.w : 0.f);
  }
}

template <int CIN, int COUT, bool POOL>
__global__ void __launch_bounds__(kThreads)
    dgrad_kernel(const float* __restrict__ gy,
                 const uint8_t* __restrict__ route,
                 const uint8_t* __restrict__ mask,
                 const float* __restrict__ y, float keep,
                 const float* __restrict__ w, float* __restrict__ gx, int H,
                 int W, int tiles) {
  // s_w[(k * COUT + co) * kCT + j] = w[k][ci0 + j][co]
  __shared__ __align__(16) float s_w[9 * COUT * kCT];
  const int n = blockIdx.x / tiles;
  const int tile = blockIdx.x - n * tiles;
  const int ci0 = blockIdx.y * kCT;
  for (int i = threadIdx.x; i < 9 * COUT * kCT; i += kThreads) {
    const int k = i / (COUT * kCT);
    const int r = i - k * COUT * kCT;
    const int co = r / kCT, j = r - co * kCT;
    s_w[i] = w[(k * CIN + ci0 + j) * COUT + co];
  }
  __syncthreads();

  const int Hc = H - 2, Wc = W - 2;
  const int Ho = POOL ? Hc / 2 : Hc, Wo = POOL ? Wc / 2 : Wc;
  // the rows and columns of the convolution's output with a gradient
  const int He = POOL ? 2 * Ho : Hc, We = POOL ? 2 * Wo : Wc;
  const int p = tile * kThreads + threadIdx.x;
  if (p >= H * W) return;
  const int iy = p / W, ix = p - iy * W;

  float acc[kCT];
#pragma unroll
  for (int j = 0; j < kCT; ++j) acc[j] = 0.f;
#pragma unroll 1
  for (int k = 0; k < 9; ++k) {
    const int ky = k / 3, kx = k - ky * 3;
    const int cy = iy - ky, cx = ix - kx;
    if (cy < 0 || cy >= He || cx < 0 || cx >= We) continue;
    const float* wk = s_w + k * COUT * kCT;
#pragma unroll 2
    for (int co = 0; co < COUT; co += 4) {
      const float4 g = grad_z4<COUT, POOL>(gy, route, mask, y, keep, n, cy,
                                           cx, co, Ho, Wo);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float gv = c == 0 ? g.x : c == 1 ? g.y : c == 2 ? g.z : g.w;
        const float4* w4 =
            reinterpret_cast<const float4*>(wk + (co + c) * kCT);
#pragma unroll
        for (int j4 = 0; j4 < kCT / 4; ++j4) {
          const float4 wv = w4[j4];
          acc[4 * j4 + 0] = fmaf(gv, wv.x, acc[4 * j4 + 0]);
          acc[4 * j4 + 1] = fmaf(gv, wv.y, acc[4 * j4 + 1]);
          acc[4 * j4 + 2] = fmaf(gv, wv.z, acc[4 * j4 + 2]);
          acc[4 * j4 + 3] = fmaf(gv, wv.w, acc[4 * j4 + 3]);
        }
      }
    }
  }
  float4* o = reinterpret_cast<float4*>(
      gx + (((long long)n * H + iy) * W + ix) * CIN + ci0);
#pragma unroll
  for (int j4 = 0; j4 < kCT / 4; ++j4)
    o[j4] = make_float4(acc[4 * j4], acc[4 * j4 + 1], acc[4 * j4 + 2],
                        acc[4 * j4 + 3]);
}

constexpr int kTR = 32;     // rows (tap, ci) of the weight gradient a block
constexpr int kTC = 32;     // output channels a block
constexpr int kMB = 64;     // positions staged in shared memory at a time

// Pass one of H20: block (row tile, column tile, image n) sums its image's
// terms into partial[n][(row0 + r) * COUT + col0 + c]; the blocks of row
// tile 0 also sum the bias into partial[n][9 CIN COUT + col0 + c]. Each
// thread owns one row and four columns and adds the positions in order.
template <int CIN, int COUT, bool POOL>
__global__ void __launch_bounds__(kThreads)
    wgrad_kernel(const float* __restrict__ x, const float* __restrict__ gy,
                 const uint8_t* __restrict__ route,
                 const uint8_t* __restrict__ mask,
                 const float* __restrict__ y, float keep,
                 float* __restrict__ partial, int H, int W) {
  __shared__ __align__(16) float s_x[kMB][kTR];
  __shared__ __align__(16) float s_g[kMB][kTC];
  constexpr int kRows = 9 * CIN;
  constexpr int kCount = kRows * COUT + COUT;
  const int row0 = blockIdx.x * kTR, col0 = blockIdx.y * kTC;
  const int n = blockIdx.z;
  const int Hc = H - 2, Wc = W - 2;
  const int Ho = POOL ? Hc / 2 : Hc, Wo = POOL ? Wc / 2 : Wc;
  const int He = POOL ? 2 * Ho : Hc, We = POOL ? 2 * Wo : Wc;
  const int M = He * We;
  const int tr = threadIdx.x / (kTC / 4), tc = (threadIdx.x % (kTC / 4)) * 4;
  const bool bias_sum = blockIdx.x == 0 && tr == 0;
  const float* img = x + (long long)n * H * W * CIN;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float bacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int m0 = 0; m0 < M; m0 += kMB) {
    for (int e = threadIdx.x; e < kMB * kTR; e += kThreads) {
      const int mm = e / kTR, rr = e - mm * kTR;
      const int m = m0 + mm, row = row0 + rr;
      float v = 0.f;
      if (m < M && row < kRows) {
        const int cy = m / We, cx = m - cy * We;
        const int k = row / CIN, ci = row - k * CIN;
        const int ky = k / 3, kx = k - ky * 3;
        v = img[((cy + ky) * W + cx + kx) * CIN + ci];
      }
      s_x[mm][rr] = v;
    }
    for (int e = threadIdx.x; e < kMB * kTC / 4; e += kThreads) {
      const int mm = e / (kTC / 4), c4 = (e - mm * (kTC / 4)) * 4;
      const int m = m0 + mm;
      float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M) {
        const int cy = m / We, cx = m - cy * We;
        g = grad_z4<COUT, POOL>(gy, route, mask, y, keep, n, cy, cx,
                                col0 + c4, Ho, Wo);
      }
      *reinterpret_cast<float4*>(&s_g[mm][c4]) = g;
    }
    __syncthreads();
#pragma unroll 8
    for (int mm = 0; mm < kMB; ++mm) {
      const float xv = s_x[mm][tr];
      const float4 g = *reinterpret_cast<const float4*>(&s_g[mm][tc]);
      acc[0] = fmaf(xv, g.x, acc[0]);
      acc[1] = fmaf(xv, g.y, acc[1]);
      acc[2] = fmaf(xv, g.z, acc[2]);
      acc[3] = fmaf(xv, g.w, acc[3]);
      if (bias_sum) {
        bacc[0] += g.x;
        bacc[1] += g.y;
        bacc[2] += g.z;
        bacc[3] += g.w;
      }
    }
    __syncthreads();
  }
  float* part = partial + (long long)n * kCount;
  if (row0 + tr < kRows) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      part[(row0 + tr) * COUT + col0 + tc + c] = acc[c];
  }
  if (bias_sum) {
#pragma unroll
    for (int c = 0; c < 4; ++c) part[kRows * COUT + col0 + tc + c] = bacc[c];
  }
}

// Pass two of H20: out[i] = sum over the images of partial[n][i], in
// image order.
__global__ void __launch_bounds__(kThreads)
    wgrad_sum_kernel(const float* __restrict__ partial, int N, int count,
                     float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int n = 0; n < N; ++n) s += partial[(long long)n * count + i];
  out[i] = s;
}

template <int CIN, int COUT, bool POOL, bool TRAIN>
int launch(const float* in, const float* w, const float* bias, float* out,
           uint8_t* route, const uint8_t* mask, float keep, int N, int H,
           int W, cudaStream_t stream) {
  const int Hc = H - 2, Wc = W - 2;
  const int npix = POOL ? (Hc / 2) * (Wc / 2) : Hc * Wc;
  const int tiles = (npix + kThreads - 1) / kThreads;
  if (N > 0 && npix > 0) {
    const dim3 grid(N * tiles, COUT / kCT);
    conv3x3_kernel<CIN, COUT, POOL, TRAIN><<<grid, kThreads, 0, stream>>>(
        in, w, bias, out, route, mask, keep, H, W, tiles);
  }
  return (int)cudaGetLastError();
}

template <int CIN, int COUT, bool POOL>
int launch_dgrad(const float* gy, const uint8_t* route, const uint8_t* mask,
                 const float* y, float keep, const float* w, float* gx,
                 int N, int H, int W, cudaStream_t stream) {
  const int tiles = (H * W + kThreads - 1) / kThreads;
  if (N > 0 && H > 2 && W > 2) {
    const dim3 grid(N * tiles, CIN / kCT);
    dgrad_kernel<CIN, COUT, POOL><<<grid, kThreads, 0, stream>>>(
        gy, route, mask, y, keep, w, gx, H, W, tiles);
  }
  return (int)cudaGetLastError();
}

template <int CIN, int COUT, bool POOL>
int launch_wgrad(const float* x, const float* gy, const uint8_t* route,
                 const uint8_t* mask, const float* y, float keep,
                 float* partial, float* out, int N, int H, int W,
                 cudaStream_t stream) {
  constexpr int kCount = 9 * CIN * COUT + COUT;
  if (N > 0 && H > 2 && W > 2) {
    const dim3 grid((9 * CIN + kTR - 1) / kTR, COUT / kTC, N);
    wgrad_kernel<CIN, COUT, POOL><<<grid, kThreads, 0, stream>>>(
        x, gy, route, mask, y, keep, partial, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    wgrad_sum_kernel<<<(kCount + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(partial, N, kCount, out);
  } else if (N == 0) {
    const cudaError_t err =
        cudaMemsetAsync(out, 0, kCount * sizeof(float), stream);
    if (err != cudaSuccess) return (int)err;
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
    return launch<3, 32, false, false>(in, w, bias, out, nullptr, nullptr,
                                       1.f, N, H, W, stream);
  if (Cin == 32 && Cout == 32 && pool)
    return launch<32, 32, true, false>(in, w, bias, out, nullptr, nullptr,
                                       1.f, N, H, W, stream);
  if (Cin == 32 && Cout == 64 && !pool)
    return launch<32, 64, false, false>(in, w, bias, out, nullptr, nullptr,
                                        1.f, N, H, W, stream);
  if (Cin == 64 && Cout == 64 && pool)
    return launch<64, 64, true, false>(in, w, bias, out, nullptr, nullptr,
                                       1.f, N, H, W, stream);
  return (int)cudaErrorInvalidValue;
}

// H13t: as zuds_braai_conv3x3, and for the pooled layers route (N, Ho, Wo,
// Cout) u8 and the dropout mask (u8 of the same shape, or null for none)
// applied as mask ? v / keep : 0.
extern "C" int zuds_braai_conv3x3_train(const float* in, const float* w,
                                        const float* bias, float* out,
                                        uint8_t* route, const uint8_t* mask,
                                        float keep, int N, int H, int W,
                                        int Cin, int Cout, int pool,
                                        cudaStream_t stream) {
  if (Cin == 3 && Cout == 32 && !pool)
    return launch<3, 32, false, true>(in, w, bias, out, nullptr, nullptr,
                                      1.f, N, H, W, stream);
  if (Cin == 32 && Cout == 32 && pool)
    return launch<32, 32, true, true>(in, w, bias, out, route, mask, keep,
                                      N, H, W, stream);
  if (Cin == 32 && Cout == 64 && !pool)
    return launch<32, 64, false, true>(in, w, bias, out, nullptr, nullptr,
                                       1.f, N, H, W, stream);
  if (Cin == 64 && Cout == 64 && pool)
    return launch<64, 64, true, true>(in, w, bias, out, route, mask, keep,
                                      N, H, W, stream);
  return (int)cudaErrorInvalidValue;
}

// H19: gx (N, H, W, Cin) from the layer's output gradient gy (the shape of
// its output) and, for a pooled layer, route and mask (or null), for an
// unpooled one its output y; layers 2-4 of BraaiD6 only (the triplets need
// no gradient).
extern "C" int zuds_braai_conv3x3_dgrad(const float* gy,
                                        const uint8_t* route,
                                        const uint8_t* mask, const float* y,
                                        float keep, const float* w,
                                        float* gx, int N, int H, int W,
                                        int Cin, int Cout, int pool,
                                        cudaStream_t stream) {
  if (Cin == 32 && Cout == 32 && pool)
    return launch_dgrad<32, 32, true>(gy, route, mask, y, keep, w, gx, N, H,
                                      W, stream);
  if (Cin == 32 && Cout == 64 && !pool)
    return launch_dgrad<32, 64, false>(gy, route, mask, y, keep, w, gx, N,
                                       H, W, stream);
  if (Cin == 64 && Cout == 64 && pool)
    return launch_dgrad<64, 64, true>(gy, route, mask, y, keep, w, gx, N, H,
                                      W, stream);
  return (int)cudaErrorInvalidValue;
}

// H20: out (9 Cin Cout + Cout) f32, the HWIO weight gradient then the bias
// gradient, from the layer's input x (N, H, W, Cin) and what H19 takes;
// partial is scratch of N (9 Cin Cout + Cout) floats.
extern "C" int zuds_braai_conv3x3_wgrad(const float* x, const float* gy,
                                        const uint8_t* route,
                                        const uint8_t* mask, const float* y,
                                        float keep, float* partial,
                                        float* out, int N, int H, int W,
                                        int Cin, int Cout, int pool,
                                        cudaStream_t stream) {
  if (Cin == 3 && Cout == 32 && !pool)
    return launch_wgrad<3, 32, false>(x, gy, route, mask, y, keep, partial,
                                      out, N, H, W, stream);
  if (Cin == 32 && Cout == 32 && pool)
    return launch_wgrad<32, 32, true>(x, gy, route, mask, y, keep, partial,
                                      out, N, H, W, stream);
  if (Cin == 32 && Cout == 64 && !pool)
    return launch_wgrad<32, 64, false>(x, gy, route, mask, y, keep, partial,
                                       out, N, H, W, stream);
  if (Cin == 64 && Cout == 64 && pool)
    return launch_wgrad<64, 64, true>(x, gy, route, mask, y, keep, partial,
                                      out, N, H, W, stream);
  return (int)cudaErrorInvalidValue;
}
