// H3: spatially varying Alard-Lupton model convolution, as a 3xTF32
// implicit GEMM on the tensor cores.
//
// Replaces the Pallas bench kernel tools/bench_apply.py:mm_kernel (:218,
// launched by mm_form at :254) and the computation it stands for, the main
// path's zuds_tpu/ops/subtract.py:apply_kernel_s2d (:412-553) reached
// through apply_kernel_fast (:380). The TPU form packs the frame
// space-to-depth so that the convolution becomes 3x3 x 64 -> 64*Nm matmuls
// on the MXU, split bf16 hi/lo in its 'hilo' form; here the convolution is
// an implicit GEMM on Hopper's tensor cores with a TF32 hi/lo split.
//
// Contract. Per output pixel (x, y) in region r (static edges
// ceil(i*n/nreg), taken from the OUTPUT pixel):
//   model = bg[r] + sum_m T_m(xn, yn) * sum_{ky,kx} kd[r,m,ky,kx] *
//           ref[y + ky - K/2, x + kx - K/2]
// with zero padding at the frame borders; neighbours across a region
// border are real data. T_m = xn^p_m * yn^q_m with xn = (x - cx[r]) / wx,
// yn = (y - cy[r]) / wy in f32, as apply_kernel (:640-646) forms them, and
// the blend adds the terms in order with no fused multiply-add, as the
// plain version's loop (ops/subtract.py:apply_kernel) rounds them.
// kd = einsum('rnm,nkl->rmkl', a, dense basis) is formed by the caller;
// the region centres, half-widths and exponents come by value in
// ApplyParams, so a launch copies nothing from the host.
//
// GEMM. For one output tile inside ONE region, D[m, p] = sum_t A[m, t]
// B[t, p]: m is the spatial term (a launch covers one tile of 16 terms;
// Nm > 16 takes one launch per term tile, each adding its terms to the
// model in order), t the tap (each kernel row padded from K to KP, a
// multiple of 8, so an 8-tap chunk never crosses a row: 15 x 16 = 240 taps
// at K = 15), p the output pixel. A = kd[r] is staged once per block in
// shared memory in mma fragment order, split hi/lo; padded taps and terms
// are zero. B is the implicit im2col of the reference window.
//
// Instruction: mma.sync m16n8k8 tf32 with terms on M (16) and pixels on
// N (8), so the kernel weights are the operand held in registers across a
// warp's 8 n-tiles and the window is the streamed one. wgmma was not
// chosen: it needs 64 rows on M, which would put pixels on M and restage
// the weights for every 64-pixel tile, and its operand descriptors would
// need the implicit im2col materialised in shared memory.
//
// Accuracy (3xTF32): x_hi = tf32(x), x_lo = tf32(x - x_hi) (cvt.rna), and
// a*b ~ a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, each product exact and summed
// in fp32; the dropped a_lo*b_lo is below 2^-22 of |a*b|, so the sum keeps
// fp32 accuracy. One pass (1xTF32) would keep 11 bits, ~1 count on a
// 3455-count star: the port's precision rule forbids it (package
// __init__). No bf16 or fp16 anywhere.
//
// Staging. Tiles are 64 x 32 output pixels scheduled per region rectangle
// (ragged edges masked), so a block holds one region's A. A persistent
// grid of blocks per region walks its tiles; the (32 + K - 1) x (64 + KP)
// window of the next tile is loaded with cp.async (zero fill for the frame
// border and the padded columns) into a two-stage ring while this tile
// computes, then split into (hi, lo) pairs once, in shared memory: each
// element is read K^2 times, the split is done once. cp.async rather than
// TMA: the window's left edge is at x0 - K/2, not 16-byte aligned, and a
// TMA box of 64 + KP floats per row would need a descriptor per frame.
//
// Bound. Per 8-tap chunk and warp: 8 n-tiles x 3 mma = 24 MMAs against
// 2 shared 128-bit loads of A (4 wavefronts each) and 16 64-bit window
// loads (the 11 distinct addresses of a fragment row are broadcasts), so
// ~1 shared wavefront per MMA. At the flagship (3080 x 3072, K = 15,
// Nm = 15 -> 16) a frame is 1.1e8 MMAs, 2.24e11 tensor-core FLOP (3 passes,
// padded) for 6.4e10 useful fp32 FLOP: 0.45 ms at the card's 495 TFLOP/s
// TF32 peak. Measured on an H100 80GB HBM3 at 700 W: 1.20 ms; 0.61 ms with
// one pass instead of three, 0.24 ms with no MMA loop at all (staging,
// split, power tables and epilogue: the butterfly transpose of the
// accumulators over 8 lanes and the term blend). So the MMA loop bounds
// it: ~0.97 ms for 1.1e8 MMAs, ~230 TFLOP/s issued, 47% of the peak.
// The grid is rounded down to the resident block count, so that no block
// waits for a second wave while the others idle.
// Shared memory: A K*KP/8 KB + window 16 B per element + power tables;
// at K = 15 91 KB (two blocks per SM), at K = 31 218 KB (one), which is
// the largest K that fits.
//
// One term (Nm = 1: the variance propagation, and the model at order 0).
// There the only term is the constant one, T_0 = 1, so the launch is a
// plain correlation per region, out = bg[r] + sum_{ky,kx} k[r,ky,kx] ref[..]
// (a single term of another order is blended as above, after the sum):
// 2 K^2 fp32 operations a pixel, 1.53e9 a 3080 x 3072 frame at K = 9,
// 0.023 ms on the fp32 units, level with its 8 bytes a pixel (0.023 ms).
// The GEMM above would pad the term to 16 rows of M and do 16x that work
// three times over on the tensor cores, so this case takes its own kernel,
// apply_direct_kernel: fp32 FMAs, no split. Tiles of 64 x 32 inside one
// region, walked by persistent blocks as above, each tile's (64 + K - 1) x
// (64 + K - 1) window staged by cp.async in a two-stage ring (zero fill at
// the frame border); the region's K x K kernel sits in shared memory and
// is read as a broadcast, four taps a 128-bit load. A thread computes four
// rows of 8 pixels: it loads one window row of 8 + K - 1 values into
// registers (128-bit loads) and sweeps kx across it for each output row h
// with kernel row wy - h, so a window row feeds 32 K FMAs against its
// 8 + K - 1 loads (measured on an H100 at K = 9, 15, 31: two rows 0.079,
// 0.141, 0.455 ms, four 0.080, 0.132, 0.401, eight 0.171, 0.218, 0.760,
// where a region's last tile row wastes more). Every
// pixel's chain runs ky then kx ascending from 0, and the epilogue adds
// bg[r] once (T_0 multiplies by exactly 1), so two calls are
// bit-identical. K is a template parameter (odd K <= 31): the window row
// and the sweep are unrolled into registers. Shared memory: two window
// stages and the kernel, 41 KB at K = 9, 74 KB at K = 31.
#include "common.cuh"

namespace {

constexpr int kMaxReg = 256;     // regions per axis (ApplyParams capacity)
constexpr int kMaxTerms = 256;   // spatial terms (order <= 21)
constexpr int kTileW = 64;       // output tile: 8 n-tiles of 8 pixels ...
constexpr int kTileH = 32;       // ... by 32 rows
constexpr int kWarps = 8;        // a warp computes one 64-pixel row at a time
constexpr int kThreads = kWarps * 32;
constexpr int kNT = kTileW / 8;
constexpr int kMaxK = 31;

}  // namespace

// Mirrored by build.ApplyParams (ctypes); passed to the kernel by value.
struct ApplyParams {
  int H, W, K, Nm, nreg;
  float wx, wy;                  // region half-widths, f32
  float cx[kMaxReg];             // region centre of column rj, f32
  float cy[kMaxReg];             // region centre of row ri, f32
  unsigned char pexp[kMaxTerms]; // T_m = xn^pexp[m] * yn^qexp[m]
  unsigned char qexp[kMaxTerms];
};

namespace {

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float ipow(float x, int p) {
  float out = 1.f;
  for (int i = 0; i < p; ++i) out = __fmul_rn(out, x);
  return out;
}

__host__ __device__ __forceinline__ int padded_k(int K) {
  return (K + 7) & ~7;
}

__host__ __device__ __forceinline__ int edge(int i, int n, int nreg) {
  return (int)(((long long)i * n + nreg - 1) / nreg);   // ceil(i*n/nreg)
}

size_t smem_bytes(int K, int npow) {
  const int KP = padded_k(K);
  const size_t win = (size_t)(kTileH + K - 1) * (kTileW + KP);
  // A: K*KP/8 chunks x 32 lanes x (hi, lo) float4; window: 2 raw f32
  // stages + one (hi, lo) float2 copy; the tile's xn^e and yn^e tables
  return (size_t)K * (KP / 8) * 32 * 2 * sizeof(float4) +
         win * (2 * sizeof(float) + sizeof(float2)) +
         (size_t)npow * (kTileW + kTileH) * sizeof(float);
}

// grid (R2, blocks per region); launch `mt` covers terms [16 mt, 16 mt + 16);
// npow = 1 + the largest exponent
__global__ void __launch_bounds__(kThreads, 2)
apply_mma_kernel(const float* __restrict__ ref, const float* __restrict__ kd,
                 const float* __restrict__ bg, float* __restrict__ model,
                 const __grid_constant__ ApplyParams p, int mt, int npow) {
  extern __shared__ float4 smem[];
  const int H = p.H, W = p.W, K = p.K, Nm = p.Nm, nreg = p.nreg;
  const int KP = padded_k(K), NKC = KP / 8, NCH = K * NKC, half = K / 2;
  const int WR = kTileH + K - 1;     // window rows
  const int WS = kTileW + KP;        // window row stride (elements)
  const int WC = kTileW + K - 1;     // window columns that hold data
  const int WN = WR * WS;
  float4* afr = smem;                                      // NCH*32*2
  float2* win = reinterpret_cast<float2*>(afr + NCH * 64); // WN
  float* raw = reinterpret_cast<float*>(win + WN);         // 2 * WN
  float* xpow = raw + 2 * WN;           // npow x kTileW: xn^e of each column
  float* ypow = xpow + npow * kTileW;   // npow x kTileH: yn^e of each row

  const int r = blockIdx.x, ri = r / nreg, rj = r % nreg;
  const int ry0 = edge(ri, H, nreg), ry1 = edge(ri + 1, H, nreg);
  const int rx0 = edge(rj, W, nreg), rx1 = edge(rj + 1, W, nreg);
  const int ntx = (rx1 - rx0 + kTileW - 1) / kTileW;
  const int ntiles = ntx * ((ry1 - ry0 + kTileH - 1) / kTileH);
  if ((int)blockIdx.y >= ntiles) return;                   // block-uniform

  // A = kd[r, 16 mt + m, ky, kx] in m16n8k8 A-fragment order: lane (g, t)
  // holds a0 (m=g, k=t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
  for (int i = threadIdx.x; i < NCH * 128; i += kThreads) {
    const int e = i & 3, lane = (i >> 2) & 31, c = i >> 7;
    const int m = mt * 16 + (lane >> 2) + 8 * (e & 1);
    const int ky = c / NKC, kx = (c % NKC) * 8 + (lane & 3) + 4 * (e >> 1);
    const float v = (m < Nm && kx < K)
                        ? kd[(((size_t)r * Nm + m) * K + ky) * K + kx]
                        : 0.f;
    float* dst = reinterpret_cast<float*>(afr + (c * 32 + lane) * 2);
    const float hi = tf32(v);
    dst[e] = hi;
    dst[4 + e] = tf32(v - hi);
  }

  auto load_window = [&](int tile, float* dst) {
    const int gy0 = ry0 + (tile / ntx) * kTileH - half;
    const int gx0 = rx0 + (tile % ntx) * kTileW - half;
    for (int wy = threadIdx.x >> 5; wy < WR; wy += kWarps) {
      const int gy = gy0 + wy;
      const bool row_in = gy >= 0 && gy < H;
      for (int wx = threadIdx.x & 31; wx < WS; wx += 32) {
        const int gx = gx0 + wx;
        const bool in = row_in && wx < WC && gx >= 0 && gx < W;
        cp_async4(dst + wy * WS + wx, in ? ref + (size_t)gy * W + gx : ref,
                  in ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float cxr = p.cx[rj], cyr = p.cy[ri];
  const float bgr = bg[r];
  const int mbase = mt * 16, mcount = min(16, Nm - mbase);

  load_window(blockIdx.y, raw);
  for (int it = 0, tile = blockIdx.y; tile < ntiles;
       ++it, tile += gridDim.y) {
    const int next = tile + gridDim.y;
    const float* cur = raw + (it & 1) * WN;
    if (next < ntiles)
      load_window(next, raw + ((it + 1) & 1) * WN);
    else
      cp_async_commit();                 // empty group: the count stays
    cp_async_wait_prev();
    __syncthreads();                     // cur landed; last tile done
    for (int i = threadIdx.x; i < WN; i += kThreads) {
      const float v = cur[i], hi = tf32(v);
      win[i] = make_float2(hi, tf32(v - hi));
    }
    const int ty0 = ry0 + (tile / ntx) * kTileH;
    const int tx0 = rx0 + (tile % ntx) * kTileW;
    // T_m = xn^p * yn^q from per-tile power tables; each power is the
    // same chain of __fmul_rn as ipow, so the bits do not change
    for (int i = threadIdx.x; i < npow * (kTileW + kTileH); i += kThreads) {
      const int e = i / (kTileW + kTileH), c = i - e * (kTileW + kTileH);
      if (c < kTileW)
        xpow[e * kTileW + c] =
            ipow(__fdiv_rn(__fsub_rn((float)(tx0 + c), cxr), p.wx), e);
      else
        ypow[e * kTileH + c - kTileW] = ipow(
            __fdiv_rn(__fsub_rn((float)(ty0 + c - kTileW), cyr), p.wy), e);
    }
    __syncthreads();

    for (int row = warp; row < kTileH; row += kWarps) {
      const int y = ty0 + row;
      if (y >= ry1) break;               // warp-uniform, no barrier below
      float acc[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

      // B fragment of n-tile n, chunk (ky, kc): b0 = window[row + ky]
      // [8n + g + 8kc + t], b1 the same at + 4
      const float2* wrow = win + row * WS + g + t;
      const float4* ap = afr + lane * 2;
      for (int ky = 0; ky < K; ++ky, wrow += WS) {
        for (int kc = 0; kc < NKC; ++kc, ap += 64) {
          const float4 h = ap[0], l = ap[1];
          const uint32_t ah[4] = {__float_as_uint(h.x), __float_as_uint(h.y),
                                  __float_as_uint(h.z), __float_as_uint(h.w)};
          const uint32_t al[4] = {__float_as_uint(l.x), __float_as_uint(l.y),
                                  __float_as_uint(l.z), __float_as_uint(l.w)};
          const float2* wk = wrow + kc * 8;
          float2 b0[kNT], b1[kNT];
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            b0[n] = wk[n * 8];
            b1[n] = wk[n * 8 + 4];
          }
          // pass-major: 8 independent MMAs between two on one accumulator
#pragma unroll
          for (int n = 0; n < kNT; ++n)
            mma_tf32(acc[n], al, b0[n].x, b1[n].x);   // a_lo * b_hi
#pragma unroll
          for (int n = 0; n < kNT; ++n)
            mma_tf32(acc[n], ah, b0[n].y, b1[n].y);   // a_hi * b_lo
#pragma unroll
          for (int n = 0; n < kNT; ++n)
            mma_tf32(acc[n], ah, b0[n].x, b1[n].x);   // a_hi * b_hi
        }
      }

      // Transpose the accumulators over the 8 lanes of one t: lane (g, t)
      // held terms (g, g+8) of n-tiles 0..7; afterwards acc[j] holds terms
      // (j, j+8) of n-tile g, i.e. all 16 terms of pixels 8g + 2t + {0,1}.
#pragma unroll
      for (int s = 4; s >= 1; s >>= 1) {
        const bool up = g & s;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if (j & s) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float send = up ? acc[j][e] : acc[j | s][e];
            const float recv = __shfl_xor_sync(0xffffffffu, send, 4 * s);
            if (up)
              acc[j][e] = recv;
            else
              acc[j | s][e] = recv;
          }
        }
      }

      float yq[16];
#pragma unroll
      for (int m = 0; m < 16; ++m)
        yq[m] = m < mcount ? ypow[p.qexp[mbase + m] * kTileH + row] : 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = 8 * g + 2 * t + q, x = tx0 + col;
        if (x >= rx1) continue;
        const size_t idx = (size_t)y * W + x;
        float out = mt == 0 ? bgr : model[idx];
#pragma unroll
        for (int m = 0; m < 16; ++m) {
          if (m < mcount) {
            const float tm =
                __fmul_rn(xpow[p.pexp[mbase + m] * kTileW + col], yq[m]);
            const float a = m < 8 ? acc[m][q] : acc[m - 8][2 + q];
            out = __fadd_rn(out, __fmul_rn(tm, a));
          }
        }
        model[idx] = out;
      }
    }
  }
}

// ---- one term: the direct fp32 correlation -------------------------------

constexpr int kDirStrip = 8;     // a thread's pixels along x ...
constexpr int kDirRows = 4;      // ... in this many rows
constexpr int kDirThreads = 128;
constexpr int kDirTileW = 64;    // output tile of the one-term kernel
constexpr int kDirTileH = kDirThreads / (kDirTileW / kDirStrip) * kDirRows;

// window values a thread loads per row (8 + K - 1, to a multiple of 4),
// kernel row stride, window row stride and window rows
__host__ __device__ constexpr int dir_seg(int K) {
  return (kDirStrip + K - 1 + 3) & ~3;
}
__host__ __device__ constexpr int dir_kp(int K) { return (K + 3) & ~3; }
__host__ __device__ constexpr int dir_ws(int K) {
  return kDirTileW - kDirStrip + dir_seg(K);
}
__host__ __device__ constexpr int dir_wr(int K) { return kDirTileH + K - 1; }

constexpr size_t direct_smem(int K) {
  return (2 * (size_t)dir_wr(K) * dir_ws(K) + (size_t)K * dir_kp(K)) *
         sizeof(float);
}

// acc[i] += sum_kx krow[kx] seg[kx + i], kx ascending
template <int K>
__device__ __forceinline__ void fma_row(float (&acc)[kDirStrip],
                                        const float (&seg)[dir_seg(K)],
                                        const float* krow) {
#pragma unroll
  for (int q = 0; q < dir_kp(K) / 4; ++q) {
    const float4 kq = reinterpret_cast<const float4*>(krow)[q];
    const float kv[4] = {kq.x, kq.y, kq.z, kq.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (4 * q + e < K) {
#pragma unroll
        for (int i = 0; i < kDirStrip; ++i)
          acc[i] = fmaf(kv[e], seg[4 * q + e + i], acc[i]);
      }
    }
  }
}

// grid (R2, blocks per region); kd is (R2, 1, K, K), the region's one term
template <int K>
__global__ void __launch_bounds__(kDirThreads)
apply_direct_kernel(const float* __restrict__ ref,
                    const float* __restrict__ kd,
                    const float* __restrict__ bg, float* __restrict__ model,
                    const __grid_constant__ ApplyParams p) {
  extern __shared__ float4 smem[];
  constexpr int KP = dir_kp(K), SEG = dir_seg(K), WS = dir_ws(K);
  constexpr int WR = dir_wr(K), WN = WR * WS, WC = kDirTileW + K - 1;
  constexpr int half = K / 2;
  const int H = p.H, W = p.W, nreg = p.nreg;
  float* raw = reinterpret_cast<float*>(smem);   // 2 x WN
  float* ks = raw + 2 * WN;                       // K x KP

  const int r = blockIdx.x, ri = r / nreg, rj = r % nreg;
  const int ry0 = edge(ri, H, nreg), ry1 = edge(ri + 1, H, nreg);
  const int rx0 = edge(rj, W, nreg), rx1 = edge(rj + 1, W, nreg);
  const int ntx = (rx1 - rx0 + kDirTileW - 1) / kDirTileW;
  const int ntiles = ntx * ((ry1 - ry0 + kDirTileH - 1) / kDirTileH);
  if ((int)blockIdx.y >= ntiles) return;                   // block-uniform

  for (int i = threadIdx.x; i < K * KP; i += kDirThreads) {
    const int ky = i / KP, kx = i - ky * KP;
    ks[i] = kx < K ? kd[((size_t)r * K + ky) * K + kx] : 0.f;
  }

  auto load_window = [&](int tile, float* dst) {
    const int gy0 = ry0 + (tile / ntx) * kDirTileH - half;
    const int gx0 = rx0 + (tile % ntx) * kDirTileW - half;
    for (int wy = threadIdx.x >> 5; wy < WR; wy += kDirThreads / 32) {
      const int gy = gy0 + wy;
      const bool row_in = gy >= 0 && gy < H;
      for (int wx = threadIdx.x & 31; wx < WS; wx += 32) {
        const int gx = gx0 + wx;
        const bool in = row_in && wx < WC && gx >= 0 && gx < W;
        cp_async4(dst + wy * WS + wx, in ? ref + (size_t)gy * W + gx : ref,
                  in ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  const int tx = threadIdx.x % (kDirTileW / kDirStrip);
  const int ty = threadIdx.x / (kDirTileW / kDirStrip);
  const float bgr = bg[r];
  const int pe = p.pexp[0], qe = p.qexp[0];
  load_window(blockIdx.y, raw);
  for (int it = 0, tile = blockIdx.y; tile < ntiles;
       ++it, tile += gridDim.y) {
    const int next = tile + gridDim.y;
    if (next < ntiles)
      load_window(next, raw + ((it + 1) & 1) * WN);
    else
      cp_async_commit();                 // empty group: the count stays
    cp_async_wait_prev();
    __syncthreads();                     // this tile's window landed
    const float* wrow =
        raw + (it & 1) * WN + kDirRows * ty * WS + kDirStrip * tx;
    float acc[kDirRows][kDirStrip];
#pragma unroll
    for (int h = 0; h < kDirRows; ++h)
#pragma unroll
      for (int i = 0; i < kDirStrip; ++i) acc[h][i] = 0.f;
    // window row wy is kernel row wy - h of output row h
#pragma unroll 1
    for (int wy = 0; wy < K + kDirRows - 1; ++wy, wrow += WS) {
      float seg[SEG];
#pragma unroll
      for (int q = 0; q < SEG / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(wrow)[q];
        seg[4 * q] = v.x;
        seg[4 * q + 1] = v.y;
        seg[4 * q + 2] = v.z;
        seg[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < kDirRows; ++h)
        if (wy >= h && wy - h < K)
          fma_row<K>(acc[h], seg, ks + (wy - h) * KP);
    }
    const int ty0 = ry0 + (tile / ntx) * kDirTileH + kDirRows * ty;
    const int tx0 = rx0 + (tile % ntx) * kDirTileW + kDirStrip * tx;
#pragma unroll
    for (int h = 0; h < kDirRows; ++h) {
      const int y = ty0 + h;
      if (y >= ry1) continue;
#pragma unroll
      for (int i = 0; i < kDirStrip; ++i) {
        const int x = tx0 + i;
        if (x >= rx1) continue;
        float a = acc[h][i];
        if (pe | qe)    // a term other than the constant one, as H3 blends
          a = __fmul_rn(
              __fmul_rn(
                  ipow(__fdiv_rn(__fsub_rn((float)x, p.cx[rj]), p.wx), pe),
                  ipow(__fdiv_rn(__fsub_rn((float)y, p.cy[ri]), p.wy), qe)),
              a);
        model[(size_t)y * W + x] = __fadd_rn(bgr, a);
      }
    }
    __syncthreads();                     // the window is read: reusable
  }
}

// persistent blocks: the card's resident blocks shared among regions, no
// more per region than the largest region has tiles (rounded down: one
// block past the resident count would run as a second wave and double
// the time)
dim3 region_grid(const ApplyParams& p, int resident, int tile_h,
                 int tile_w) {
  const int R2 = p.nreg * p.nreg;
  int max_tiles = 0;
  for (int ri = 0; ri < p.nreg; ++ri)
    for (int rj = 0; rj < p.nreg; ++rj) {
      const int h = edge(ri + 1, p.H, p.nreg) - edge(ri, p.H, p.nreg);
      const int w = edge(rj + 1, p.W, p.nreg) - edge(rj, p.W, p.nreg);
      const int n = ((h + tile_h - 1) / tile_h) * ((w + tile_w - 1) / tile_w);
      max_tiles = n > max_tiles ? n : max_tiles;
    }
  int per_region = resident / R2;
  per_region = per_region < max_tiles ? per_region : max_tiles;
  per_region = per_region > 0 ? per_region : 1;
  return dim3(R2, per_region);
}

// the resident blocks of `kernel` on this card at `threads` and `smem`
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                            int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, nsm = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  *out = nsm * (occ > 0 ? occ : 1);
  return cudaSuccess;
}

template <int K>
int launch_direct(const float* ref, const float* kd, const float* bg,
                  float* model, const ApplyParams& p, cudaStream_t stream) {
  constexpr size_t smem = direct_smem(K);
  int resident = 0;
  cudaError_t err = resident_blocks(apply_direct_kernel<K>, kDirThreads,
                                    smem, &resident);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = region_grid(p, resident, kDirTileH, kDirTileW);
  apply_direct_kernel<K><<<grid, kDirThreads, smem, stream>>>(ref, kd, bg,
                                                              model, p);
  return (int)cudaGetLastError();
}

int apply_one_term(const float* ref, const float* kd, const float* bg,
                   float* model, const ApplyParams& p, cudaStream_t stream) {
  switch (p.K) {
#define ZUDS_DIRECT(K) \
  case K:              \
    return launch_direct<K>(ref, kd, bg, model, p, stream);
    ZUDS_DIRECT(1) ZUDS_DIRECT(3) ZUDS_DIRECT(5) ZUDS_DIRECT(7)
    ZUDS_DIRECT(9) ZUDS_DIRECT(11) ZUDS_DIRECT(13) ZUDS_DIRECT(15)
    ZUDS_DIRECT(17) ZUDS_DIRECT(19) ZUDS_DIRECT(21) ZUDS_DIRECT(23)
    ZUDS_DIRECT(25) ZUDS_DIRECT(27) ZUDS_DIRECT(29) ZUDS_DIRECT(31)
#undef ZUDS_DIRECT
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int zuds_apply(const float* ref, const float* kd, const float* bg,
                          float* model, const ApplyParams* params,
                          cudaStream_t stream) {
  const ApplyParams& p = *params;
  if (p.K % 2 != 1 || p.K > kMaxK || p.Nm < 1 || p.Nm > kMaxTerms ||
      p.nreg < 1 || p.nreg > kMaxReg || p.H < 1 || p.W < 1)
    return (int)cudaErrorInvalidValue;
  int npow = 1;
  for (int m = 0; m < p.Nm; ++m) {
    npow = p.pexp[m] + 1 > npow ? p.pexp[m] + 1 : npow;
    npow = p.qexp[m] + 1 > npow ? p.qexp[m] + 1 : npow;
  }
  // one term: the direct correlation
  if (p.Nm == 1) return apply_one_term(ref, kd, bg, model, p, stream);
  const size_t smem = smem_bytes(p.K, npow);
  int resident = 0;
  cudaError_t err = resident_blocks(apply_mma_kernel, kThreads, smem,
                                    &resident);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = region_grid(p, resident, kTileH, kTileW);
  for (int mt = 0; mt * 16 < p.Nm; ++mt) {
    apply_mma_kernel<<<grid, kThreads, smem, stream>>>(ref, kd, bg, model, p,
                                                       mt, npow);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
