// H1: fused Lanczos-3 reference warp + significant-weight mask warp +
// coverage gate, one thread per output pixel. (H10, the gather warp for
// mappings past H1's window, follows it below.)
//
// Replaces the reference's shift-accumulate warp
// (zuds_tpu/ops/resample.py: warp_shift_image :275, warp_shift_mask :213)
// and one_frame's coverage gate (zuds_tpu/parallel/pipeline.py:162-185).
// The TPU form rolls whole frames (2*window+7)^2 times because TPU gathers
// are slow; here each thread gathers its own 6x6 Lanczos support directly.
//
// Semantics kept from the reference, so the kernel equals the plain
// version even past the displacement bucket:
//  * a tap at offset (dx, dy) counts only if |dx|, |dy| <= window + 3;
//  * weights are lanczos3(t) at t = (u - x) - dx in f32 (see axis_weights
//    for how they are formed);
//  * the normaliser is sum_dy (sum_dx wx) * wy, as the reference forms it;
//  * source indices wrap around the frame (jnp.roll);
//  * mask bit b reaches (y, x) iff sig(dv - dy) and sig(du' - dx) hold,
//    where du' = u[y+dy, x] - x is read at the INTERMEDIATE row y+dy
//    (the separable OR evaluates column significance there).
// The mask path uses only f32 subtractions and compares, so it is
// bit-equal to the plain version.
//
// An optional second float plane (the coadd's per-epoch weight map,
// pipeline.py:482-483) shares u, v, the taps and the 12 weights of the
// first: one launch warps an epoch's pixels, weight and mask. The one-plane
// instantiation compiles none of the second plane's loads or sums.
//
// Bound and design. Per pixel it must move 28 bytes (u, v, ref, mask in;
// refw, refm, cov out; 36 with the second plane): 0.079 ms a 3080x3072
// frame at 3.35 TB/s, its bound (the f32 arithmetic the function needs
// takes a third of that at the peak; chip_smoke.py's WARP_FLOP_PX). The
// first form evaluated lanczos3 twelve times a pixel, each two accurate
// sinf and three IEEE divisions, and wrapped every tap's index with a
// modulo: ~4000 SASS instructions, 1.0 ms, a third each in the weights,
// the mask path and the gathers (bench_warp.py's probes). Now:
//  * an axis's six weights come from one sinpif, one sincospif, four
//    divisions and a polynomial for the two centre taps (axis_weights);
//  * the rows are summed first with FMAs (42 FMAs a plane, not 72
//    products and sums), which is also closer to the float64 warp;
//  * where the pixel's whole support lies inside the frame (all but a
//    border of window + 9 pixels) the taps are a row pointer and
//    immediate offsets; the border wraps without a division;
//  * the mask path tests only the 4x4 taps that can pass the interval
//    test, its four intermediate-row u loads issued together;
//  * 32x4 blocks, and registers capped at 40 (1536 threads an SM; a few
//    dozen bytes spill, and it still runs 7-19% faster than at 64; PERF.md
//    keeps the other shapes and caps, and six sinpif for sin(pi t / 3),
//    as measured).
// What is left (the probes): the mask path's dependent loads, the gathers
// through L1 and the weights, in that order; ~0.32 ms a frame, a quarter
// of its bound.
#include "common.cuh"

// 32x4 blocks, and at least 12 of them resident an SM (1536 threads):
// ptxas then caps the registers at 40 a thread
#define ZUDS_WARP_BOUNDS __launch_bounds__(128, 12)

namespace {

// |lanczos3(t)| > sqrt(5e-3) as interval tests (resample.py:189-209)
constexpr float kSigA = 0.9226250948801125f;
constexpr float kSigB = 1.099650902956955f;
constexpr float kSigC = 1.7405705334521984f;
constexpr float kThird = 1.f / 3.f;
constexpr float kThreeOverPi2 = 0.30396355092701331f;   // 3 / pi^2
constexpr float kHalfSqrt3 = 0.86602540378443865f;      // sin(pi / 3)

__device__ __forceinline__ bool sig_lanczos(float t) {
  float a = fabsf(t);
  return (a < kSigA) | ((a > kSigB) & (a < kSigC));
}

// lanczos3 on |t| < 1 as (1 - t)(1 + t) Q(t^2): Q = lanczos3(t) / (1 - t^2)
// is smooth on [0, 1], here a least-squares fit of degree 7 at Chebyshev
// nodes (its error is below f32's rounding; Q(0) = 1, so lanczos3(0) = 1
// exactly). Near t = 0 the sine form below would round six times (two
// sines, three products, a division) where the plain version's
// sinf(pi t) / (pi t) cancels its argument's rounding; the polynomial
// rounds less than either, and its zero at |t| = 1 is exact.
__device__ __forceinline__ float lanczos3_centre(float t) {
  const float a = fabsf(t);
  const float s = __fmul_rn(t, t);
  float q = -0x1.8eb0acp-19f;
  q = fmaf(q, s, 0x1.fd7370p-15f);
  q = fmaf(q, s, -0x1.b32c32p-11f);
  q = fmaf(q, s, 0x1.140eaap-7f);
  q = fmaf(q, s, -0x1.f4fd36p-5f);
  q = fmaf(q, s, 0x1.2dc716p-2f);
  q = fmaf(q, s, -0x1.a7c8e2p-1f);
  q = fmaf(q, s, 1.f);
  return __fmul_rn(__fmul_rn(1.f - a, 1.f + a), q);
}

// The six Lanczos-3 weights of one axis at t_k = t0 - k, k = 0..5, where
// t0 = d - (first tap) lies in [2, 3) (exactly, inside the coverage: d is
// then a multiple of 2^-22, so every t_k is exact too). By exact
// identities:
//  * sin(pi t_k) = (-1)^k sin(pi t0): one sinpif (no rounding of pi t);
//  * sin(pi t_k / 3) = sin(a - k pi / 3), a = pi t0 / 3: one sincospif
//    turned by the constants cos(k pi / 3), sin(k pi / 3) (k = 0, 1, 4, 5:
//    |t_k| >= 1 there, so the turn never cancels where the weight is not
//    small);
//  * lanczos3(t) = 3 sin(pi t) sin(pi t / 3) / (pi^2 t^2): one division
//    a tap, 0 at |t| >= 3;
//  * the two centre taps (|t| < 1) by lanczos3_centre.
// Against lanczos3 in float64 each weight is closer than the plain f32
// version's (tests/test_torch_warp_weights.py holds an emulation of this
// function to it on a dense grid of phases).
__device__ __forceinline__ void axis_weights(float t0, float (&w)[6]) {
#ifdef ZUDS_WARP_PROBE_CONST_WEIGHTS
#pragma unroll
  for (int k = 0; k < 6; ++k) w[k] = 0.1666f + 1e-3f * t0;
#else
  const float s0 = sinpif(t0);
  float s3[6];
  float sa, ca;
  sincospif(__fmul_rn(t0, kThird), &sa, &ca);
  const float hs = 0.5f * sa;
  s3[0] = sa;
  s3[1] = fmaf(-kHalfSqrt3, ca, hs);    // sin(a - pi/3)
  s3[4] = fmaf(kHalfSqrt3, ca, -hs);    // sin(a - 4 pi/3)
  s3[5] = fmaf(kHalfSqrt3, ca, hs);     // sin(a - 5 pi/3)
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float t = __fsub_rn(t0, (float)k);
    if (k == 2 || k == 3) {
      w[k] = lanczos3_centre(t);
    } else {
      const float st = (k & 1) ? -s0 : s0;
      const float num = __fmul_rn(__fmul_rn(st, s3[k]), kThreeOverPi2);
      const float l = __fdiv_rn(num, __fmul_rn(t, t));
      w[k] = fabsf(t) < 3.f ? l : 0.f;
    }
  }
#endif
}

// first of the six candidate offsets that can carry weight: floor(d) - 2,
// clamped so a wild displacement cannot overflow an int (all taps past
// the window carry zero weight anyway: a clamped offset puts all six past
// it)
__device__ __forceinline__ int first_tap(float d, int reach) {
  float f = floorf(d);
  f = fminf(fmaxf(f, (float)(-reach - 4)), (float)(reach + 4));
  return (int)f - 2;
}

// wrap_index without its division where i lies within one period of
// [0, n) (every tap, unless the frame is narrower than the support)
__device__ __forceinline__ int wrap_near(int i, int n) {
  if (i >= n) i -= n;
  else if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : wrap_index(i, n);
}

// The 6x6 taps of one or two planes, rows summed first with FMAs, from the
// first tap (x0, y0). WRAP = false where the whole support lies inside the
// frame: a row's pointer and immediate column offsets, no index
// arithmetic. WRAP = true elsewhere: rows and columns wrapped as jnp.roll.
template <bool TWO, bool WRAP>
__device__ __forceinline__ void sum_taps(const float* __restrict__ ref,
                                         const float* __restrict__ ref2,
                                         int H, int W, int x0, int y0,
                                         const float (&wx)[6],
                                         const float (&wy)[6], float wxsum,
                                         float& acc, float& acc2,
                                         float& wacc) {
  int cols[6];
  if (WRAP) {
    cols[0] = wrap_near(x0, W);
#pragma unroll
    for (int k = 1; k < 6; ++k) cols[k] = wrap_near(cols[k - 1] + 1, W);
  }
  int row = WRAP ? wrap_near(y0, H) : y0;
#pragma unroll
  for (int ky = 0; ky < 6; ++ky) {
    const size_t off = (size_t)row * W + (WRAP ? 0 : x0);
    float racc = 0.f, racc2 = 0.f;
#pragma unroll
    for (int kx = 0; kx < 6; ++kx) {
      const size_t j = off + (WRAP ? cols[kx] : kx);
      racc = fmaf(wx[kx], ref[j], racc);
      if (TWO) racc2 = fmaf(wx[kx], ref2[j], racc2);
    }
    acc = fmaf(wy[ky], racc, acc);
    if (TWO) acc2 = fmaf(wy[ky], racc2, acc2);
    wacc = fmaf(wxsum, wy[ky], wacc);
    row = WRAP ? wrap_near(row + 1, H) : row + 1;
  }
}

// The separable significant-weight OR of the mask at (x, y), first row
// tap dy0. Of the six candidate offsets only the middle four can pass the
// interval test: d - (floor(d) - 2) >= 2 and d - (floor(d) + 3) <= -2
// after rounding, and sig needs |t| < kSigC < 2 (a clamped first tap puts
// all six past the reach). The four intermediate rows' u are loaded
// before any of their tests. WRAP as in sum_taps.
template <bool WRAP>
__device__ __forceinline__ int mask_or(const int* __restrict__ mask,
                                       const float* __restrict__ u, int H,
                                       int W, int x, int y, float dv, int dy0,
                                       int reach) {
  bool rok[4];
  int rows[4];
  float ur[4];
  rows[0] = WRAP ? wrap_near(y + dy0 + 1, H) : y + dy0 + 1;
#pragma unroll
  for (int j = 1; j < 4; ++j)
    rows[j] = WRAP ? wrap_near(rows[j - 1] + 1, H) : rows[j - 1] + 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int dy = dy0 + 1 + j;
    rok[j] = (abs(dy) <= reach) & sig_lanczos(__fsub_rn(dv, (float)dy));
    ur[j] = rok[j] ? u[(size_t)rows[j] * W + x] : 0.f;
  }
  int m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float dur = __fsub_rn(ur[j], (float)x);
    const int ex0 = first_tap(dur, reach);
    const int* mrow = mask + (size_t)rows[j] * W;
    int col = WRAP ? wrap_near(x + ex0 + 1, W) : x + ex0 + 1;
#pragma unroll
    for (int kx = 1; kx < 5; ++kx) {
      const int dx = ex0 + kx;
      if (rok[j] & (abs(dx) <= reach) &
          sig_lanczos(__fsub_rn(dur, (float)dx)))
        m |= mrow[WRAP ? col : x + ex0 + kx];
      if (WRAP) col = wrap_near(col + 1, W);
    }
  }
  return m;
}

template <bool TWO>
__global__ void ZUDS_WARP_BOUNDS
warp_kernel(const float* __restrict__ ref, const float* __restrict__ ref2,
            const int* __restrict__ mask, const float* __restrict__ u,
            const float* __restrict__ v, const float* __restrict__ covb,
            float* __restrict__ refw, float* __restrict__ refw2,
            int* __restrict__ refm, float* __restrict__ cov, int H, int W,
            int window) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t i = (size_t)y * W + x;
  const int reach = window + 3;
  const float uu = u[i], vv = v[i];
  const float du = __fsub_rn(uu, (float)x);
  const float dv = __fsub_rn(vv, (float)y);
  const bool inb = (uu >= 2.f) & (uu <= (float)(W - 3)) & (vv >= 2.f) &
                   (vv <= (float)(H - 3));
  const bool covo = (uu >= covb[0]) & (uu <= covb[1]) & (vv >= covb[2]) &
                    (vv <= covb[3]);
  const bool c = inb & covo;
  // first taps lie in [-reach - 6, reach + 2]: every tap of the pixel and
  // of its mask path is inside the frame here, unwrapped
  const bool interior = (x >= reach + 6) & (x + reach + 7 < W) &
                        (y >= reach + 6) & (y + reach + 7 < H);

  // ---- pixels: 6x6 direct gather, rows summed first ---------------------
  const int dx0 = first_tap(du, reach);
  const int dy0 = first_tap(dv, reach);
  float wx[6], wy[6];
  axis_weights(__fsub_rn(du, (float)dx0), wx);
  axis_weights(__fsub_rn(dv, (float)dy0), wy);
  float wxsum = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    if (abs(dx0 + k) > reach) wx[k] = 0.f;
    if (abs(dy0 + k) > reach) wy[k] = 0.f;
    wxsum = __fadd_rn(wxsum, wx[k]);
  }
  float acc = 0.f, acc2 = 0.f, wacc = 0.f;
  if (interior)
    sum_taps<TWO, false>(ref, ref2, H, W, x + dx0, y + dy0, wx, wy, wxsum,
                         acc, acc2, wacc);
  else
    sum_taps<TWO, true>(ref, ref2, H, W, x + dx0, y + dy0, wx, wy, wxsum,
                        acc, acc2, wacc);
  const float norm = wacc == 0.f ? 1.f : wacc;

  // ---- mask: separable significant-weight OR ------------------------------
  int m = 0;
#ifndef ZUDS_WARP_PROBE_NO_MASK
  if (c)
    m = interior ? mask_or<false>(mask, u, H, W, x, y, dv, dy0, reach)
                 : mask_or<true>(mask, u, H, W, x, y, dv, dy0, reach);
#endif
  refw[i] = c ? __fdiv_rn(acc, norm) : 0.f;
  if (TWO) refw2[i] = c ? __fdiv_rn(acc2, norm) : 0.f;
  refm[i] = m;
  cov[i] = c ? 1.f : 0.f;
}

// H28: the separable Lanczos-3 reference warp with its first-order
// cross-term correction, the mask warp and the coverage gate, fused.
//
// Replaces the reference's sep_warp=True path
// (zuds_tpu/ops/resample.py: warp_shift_sep_image_mask :414,
// warp_shift_image_sep :343, _lanczos3_d :319) and one_frame's coverage
// gate (zuds_tpu/parallel/pipeline.py:162-185). Per source row r and
// column x, pass 1 forms, at the phase du = u[r, x] - x of that row,
//   hp = sum_dx L(du - dx) ref[r, x + dx],  hd = the same with L',
//   ws = sum_dx L(du - dx),                 wsd = sum_dx L'(du - dx),
//   inner = OR of mask[r, x + dx] over the dx with sig(du - dx);
// pass 2 takes, at the output (y, x), dv = v - y, dudy = the forward
// difference of u down the column (the last row repeats the one before),
//   acc  = sum_dy L(dv - dy) (hp - dy dudy hd)[y + dy, x],
//   wacc = sum_dy L(dv - dy) (ws - dy dudy wsd)[y + dy, x],
//   out  = acc / (wacc == 0 ? 1 : wacc), refm = OR of inner[y + dy, x]
// over the dy with sig(dv - dy); both gated by the coverage as H1's. Only
// taps with |dx|, |dy| <= window + 3 count and reads wrap (jnp.roll), as in
// the reference. ORDER = 0 drops the hd and wsd terms.
//
// Design: one launch. A block of 32 x 8 threads owns 32 columns and 32
// output rows; pass 1 runs for those rows and window + 3 halo rows each
// side (a halo row is formed by two blocks), its five planes kept in
// shared memory (28 bytes a pixel: 37.6 KB at window 2, 41.2 KB at 4), so
// the intermediate never reaches device memory. Each axis's six weights
// come from axis_weights (H1's), the six derivative weights from one more
// sincospif (axis_dweights). hp and ws, and pass 2's sums, are kept in
// double and rounded once, at the output: in f32 their roundings at a
// bright star's core (a few ulps of its value) put the pixels as far from
// the float64 plain version as the f32 plain version's, by chance either
// side (an emulation, tests/test_torch_sep_weights.py); in double they
// are ~4x closer. The card's fp64 rate is half its fp32 rate, ~40 fp64
// operations a pixel against a memory-bound launch. hd and wsd stay f32
// (they enter times dy dudy, ~1e-2). The mask path uses only f32
// subtractions and compares and H1's interval tests, so mask and coverage
// are bit-equal to the plain version; chip_smoke.py holds the pixels no
// further from the float64 plain version than the f32 plain version.
//
// Bound: memory, 28 bytes a pixel (ref, mask, u, v in; refw, refm, cov
// out): 0.079 ms at 3080x3072, as H1's.

// lanczos3's centre polynomial Q (lanczos3_centre) and its derivative:
// L = (1 - s) Q(s), s = t^2, so L' = 2 t ((1 - s) Q'(s) - Q(s))
__device__ __forceinline__ float lanczos3_centre_d(float t) {
  const float s = __fmul_rn(t, t);
  float q = -0x1.8eb0acp-19f;
  q = fmaf(q, s, 0x1.fd7370p-15f);
  q = fmaf(q, s, -0x1.b32c32p-11f);
  q = fmaf(q, s, 0x1.140eaap-7f);
  q = fmaf(q, s, -0x1.f4fd36p-5f);
  q = fmaf(q, s, 0x1.2dc716p-2f);
  q = fmaf(q, s, -0x1.a7c8e2p-1f);
  q = fmaf(q, s, 1.f);
  float dq = 7.f * -0x1.8eb0acp-19f;
  dq = fmaf(dq, s, 6.f * 0x1.fd7370p-15f);
  dq = fmaf(dq, s, 5.f * -0x1.b32c32p-11f);
  dq = fmaf(dq, s, 4.f * 0x1.140eaap-7f);
  dq = fmaf(dq, s, 3.f * -0x1.f4fd36p-5f);
  dq = fmaf(dq, s, 2.f * 0x1.2dc716p-2f);
  dq = fmaf(dq, s, -0x1.a7c8e2p-1f);
  return __fmul_rn(2.f * t, fmaf(1.f - s, dq, -q));
}

// The reference's Taylor slope below |t| < 1e-3: L'(t) ~ -2 C t with
// C = float32(10/54 pi^2) (resample.py:186, :338)
constexpr float kTaylorC = 0x1.d3e472p+0f;   // 1.8277045

// The six derivative weights L'(t_k), t_k = t0 - k, of axis_weights' taps.
// Away from the centre, L' = (3 / pi^2) [(pi c1 s3 + (pi / 3) s1 c3) / t^2
// - 2 s1 s3 / t^3] with sin and cos of pi t_k turned from those of pi t0
// (signs (-1)^k) and those of pi t_k / 3 from those of a = pi t0 / 3 by the
// constants of k pi / 3; the two centre taps by lanczos3_centre_d, whose
// form does not cancel near 0. 0 at |t| >= 3, as the reference.
__device__ __forceinline__ void axis_dweights(float t0, float (&w)[6]) {
  constexpr float kPi = 3.14159265358979323846f;
  float s0, c0, sa, ca;
  sincospif(t0, &s0, &c0);
  sincospif(__fmul_rn(t0, kThird), &sa, &ca);
  const float hs = 0.5f * sa, hc = 0.5f * ca;
  const float rs = kHalfSqrt3 * sa, rc = kHalfSqrt3 * ca;
  // sin and cos of a - k pi / 3
  const float s3[6] = {sa, hs - rc, -hs - rc, -sa, rc - hs, hs + rc};
  const float c3[6] = {ca, hc + rs, rs - hc, -ca, -hc - rs, hc - rs};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float t = __fsub_rn(t0, (float)k);
    float d;
    if (k == 2 || k == 3) {
      d = lanczos3_centre_d(t);
    } else {
      const float s1 = (k & 1) ? -s0 : s0;
      const float c1 = (k & 1) ? -c0 : c0;
      const float t2 = __fmul_rn(t, t);
      const float a = fmaf(kPi * c1, s3[k], __fmul_rn(kPi * kThird * s1,
                                                      c3[k]));
      const float b = __fmul_rn(2.f * s1, s3[k]);
      d = __fmul_rn(kThreeOverPi2,
                    __fdiv_rn(__fsub_rn(a, __fdiv_rn(b, t)), t2));
    }
    if (fabsf(t) < 1e-3f) d = __fmul_rn(-2.f * kTaylorC, t);
    w[k] = fabsf(t) < 3.f ? d : 0.f;
  }
}

constexpr int kSepCols = 32;     // a block's columns (one warp wide)
constexpr int kSepRows = 32;     // a block's output rows
constexpr int kSepYThreads = 8;  // thread rows a block
// pass 1's planes in shared memory a pixel: hp, ws (double), hd, wsd
// (float), inner (int)
constexpr int kSepPlaneBytes = 28;

template <int ORDER>
__global__ void __launch_bounds__(kSepCols* kSepYThreads)
warp_sep_kernel(const float* __restrict__ ref, const int* __restrict__ mask,
                const float* __restrict__ u, const float* __restrict__ v,
                const float* __restrict__ covb, float* __restrict__ refw,
                int* __restrict__ refm, float* __restrict__ cov, int H, int W,
                int window) {
  extern __shared__ double sep_smem[];
  const int reach = window + 3;
  const int nrows = kSepRows + 2 * reach;
  const int plane = nrows * kSepCols;
  double* s_hp = sep_smem;
  double* s_ws = s_hp + plane;
  float* s_hd = reinterpret_cast<float*>(s_ws + plane);
  float* s_wsd = s_hd + plane;
  int* s_in = reinterpret_cast<int*>(s_wsd + plane);
  const int tx = threadIdx.x;
  const int x = blockIdx.x * kSepCols + tx;
  const int y0 = blockIdx.y * kSepRows;

  // ---- pass 1: the horizontal taps of each source row the block reads ----
  for (int r = threadIdx.y; r < nrows; r += kSepYThreads) {
    double hp = 0.0, ws = 0.0;
    float hd = 0.f, wsd = 0.f;
    int in = 0;
    if (x < W) {
      const int yr = wrap_near(y0 - reach + r, H);
      const size_t row = (size_t)yr * W;
      const float du = __fsub_rn(u[row + x], (float)x);
      const int dx0 = first_tap(du, reach);
      const float t0 = __fsub_rn(du, (float)dx0);
      float w[6], wd[6];
      axis_weights(t0, w);
      if (ORDER) axis_dweights(t0, wd);
      int col = wrap_near(x + dx0, W);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const int dx = dx0 + k;
        if (abs(dx) <= reach) {
          const float p = ref[row + col];
          hp = fma((double)w[k], (double)p, hp);
          ws += (double)w[k];
          if (ORDER) {
            hd = fmaf(wd[k], p, hd);
            wsd = __fadd_rn(wsd, wd[k]);
          }
          // only the middle four taps can pass the interval test (H1)
          if (k >= 1 && k <= 4 && sig_lanczos(__fsub_rn(du, (float)dx)))
            in |= mask[row + col];
        }
        col = wrap_near(col + 1, W);
      }
    }
    s_hp[r * kSepCols + tx] = hp;
    s_ws[r * kSepCols + tx] = ws;
    if (ORDER) {
      s_hd[r * kSepCols + tx] = hd;
      s_wsd[r * kSepCols + tx] = wsd;
    }
    s_in[r * kSepCols + tx] = in;
  }
  __syncthreads();
  if (x >= W) return;

  // ---- pass 2: the vertical taps at each output row ---------------------
  for (int i = threadIdx.y; i < kSepRows; i += kSepYThreads) {
    const int y = y0 + i;
    if (y >= H) break;
    const size_t o = (size_t)y * W + x;
    const float uu = u[o], vv = v[o];
    const float dv = __fsub_rn(vv, (float)y);
    const bool inb = (uu >= 2.f) & (uu <= (float)(W - 3)) & (vv >= 2.f) &
                     (vv <= (float)(H - 3));
    const bool covo = (uu >= covb[0]) & (uu <= covb[1]) & (vv >= covb[2]) &
                      (vv <= covb[3]);
    const bool c = inb & covo;
    float dudy = 0.f;
    if (ORDER)
      dudy = y + 1 < H ? __fsub_rn(u[o + W], uu)
                       : (H > 1 ? __fsub_rn(uu, u[o - W]) : 0.f);
    const int dy0 = first_tap(dv, reach);
    float wy[6];
    axis_weights(__fsub_rn(dv, (float)dy0), wy);
    double acc = 0.0, wacc = 0.0;
    int m = 0;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int dy = dy0 + k;
      if (abs(dy) > reach) continue;
      const int s = (i + reach + dy) * kSepCols + tx;
      double hrow = s_hp[s], wrow = s_ws[s];
      if (ORDER) {
        const double corr = (double)__fmul_rn((float)dy, dudy);
        hrow = fma(-corr, (double)s_hd[s], hrow);
        wrow = fma(-corr, (double)s_wsd[s], wrow);
      }
      acc = fma((double)wy[k], hrow, acc);
      wacc = fma((double)wy[k], wrow, wacc);
      if (k >= 1 && k <= 4 && sig_lanczos(__fsub_rn(dv, (float)dy)))
        m |= s_in[s];
    }
    const double norm = wacc == 0.0 ? 1.0 : wacc;
    refw[o] = c ? (float)(acc / norm) : 0.f;
    refm[o] = c ? m : 0;
    cov[o] = c ? 1.f : 0.f;
  }
}

// H10: the Lanczos-3 gather warp, one thread per output pixel.
//
// Replaces the reference's gather warps (zuds_tpu/ops/resample.py:
// warp_image :86, warp_mask :116, warp_image_mask :484): the per-pair align
// of a frame whose mapping is too far from the identity for H1's window (a
// rotation, a union grid). It is not H1 with the window taken off:
//  * the source (Hs, Ws) need not have the output's shape (Ho, Wo);
//  * taps are dx, dy in -2..3 about iu = floor(u), with weights
//    lanczos3(fu - dx) at the phase fu = u - iu (axis_weights at t0 =
//    fu + 2: inside the coverage u >= 2, so fu + 2 and each fu - dx are
//    exact and equal to t0 - k);
//  * source indices are clamped to [2, Ws - 4], never wrapped; inside the
//    coverage the clamp does nothing;
//  * the normaliser is (sum wx)(sum wy): the plain version adds the 36
//    products in tap order; the factored sum rounds 11 times instead of
//    71 and keeps the kernel at least as close to the float64 warp
//    (chip_smoke.py and the card tests check it);
//  * coverage is the integer test that the 6x6 support lies inside the
//    source, and the output is 0 outside it. The reference writes the
//    product out * cov, which XLA folds into a select on the coverage
//    test: a non-finite source pixel in a clamped window outside the
//    coverage gives 0 there, and so here;
//  * mask bit b reaches a pixel iff sig(fv - dy) and sig(fu - dx) hold at
//    the pixel's own phase (no intermediate row); only dx, dy in -1..2
//    can pass (as in H1), and the column tests are made once.
// PLANES float planes (0, 1 or 2) share u, v and the 12 weights (none are
// formed at PLANES = 0); MASK says whether a mask rides along. The mask
// path uses only f32 subtractions and compares, so it is bit-equal to the
// plain version.
//
// Bound: memory, 28 bytes a pixel with one plane and a mask (u, v and
// the source once from DRAM for a smooth mapping; the outputs), 36 with
// two; 0.079 and 0.102 ms at 3080x3072. The design is H1's: the weights
// by axis_weights, the rows summed first, the taps through L1 at
// immediate offsets from the clamped corner (no wrap). 40 registers, no
// spill; ~0.21 ms on the 0.5 degree pair (0.67 before), the weights about
// a quarter of it.
template <int PLANES, bool MASK>
__global__ void ZUDS_WARP_BOUNDS
warp_gather_kernel(const float* __restrict__ img,
                   const float* __restrict__ img2,
                   const int* __restrict__ mask, const float* __restrict__ u,
                   const float* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ out2, int* __restrict__ outm,
                   float* __restrict__ cov, int Hs, int Ws, int Ho, int Wo) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= Wo || y >= Ho) return;
  const size_t i = (size_t)y * Wo + x;
  const float uu = u[i], vv = v[i];
  // floor, kept inside what an int holds (a wild mapping is uncovered
  // either way)
  const float kBig = 1073741824.f;
  const float fiu = fminf(fmaxf(floorf(uu), -kBig), kBig);
  const float fiv = fminf(fmaxf(floorf(vv), -kBig), kBig);
  const int iu = (int)fiu, iv = (int)fiv;
  const float fu = __fsub_rn(uu, fiu);
  const float fv = __fsub_rn(vv, fiv);
  const bool inb = (iu - 2 >= 0) & (iu + 3 <= Ws - 1) & (iv - 2 >= 0) &
                   (iv + 3 <= Hs - 1);
  const int iuc = min(max(iu, 2), Ws - 4);
  const int ivc = min(max(iv, 2), Hs - 4);
  const size_t base = (size_t)(ivc - 2) * Ws + (iuc - 2);

  if (PLANES > 0) {
    float wx[6], wy[6];
    axis_weights(__fadd_rn(fu, 2.f), wx);
    axis_weights(__fadd_rn(fv, 2.f), wy);
    float wxs = 0.f, wys = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      wxs = __fadd_rn(wxs, wx[k]);
      wys = __fadd_rn(wys, wy[k]);
    }
    float acc = 0.f, acc2 = 0.f;
#pragma unroll
    for (int ky = 0; ky < 6; ++ky) {
      const size_t rowoff = base + (size_t)ky * Ws;
      float racc = 0.f, racc2 = 0.f;
#pragma unroll
      for (int kx = 0; kx < 6; ++kx) {
        racc = fmaf(wx[kx], img[rowoff + kx], racc);
        if (PLANES > 1) racc2 = fmaf(wx[kx], img2[rowoff + kx], racc2);
      }
      acc = fmaf(wy[ky], racc, acc);
      if (PLANES > 1) acc2 = fmaf(wy[ky], racc2, acc2);
    }
    const float wsum = __fmul_rn(wxs, wys);
    const float norm = wsum == 0.f ? 1.f : wsum;
    out[i] = inb ? __fdiv_rn(acc, norm) : 0.f;
    if (PLANES > 1) out2[i] = inb ? __fdiv_rn(acc2, norm) : 0.f;
  }
  if (MASK) {
    // only taps -1..2 can pass: fu + 2 >= 2 and fu - 3 <= -2
    bool sx[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sx[j] = sig_lanczos(__fsub_rn(fu, (float)(j - 1)));
    int m = 0;
#pragma unroll
    for (int jy = 0; jy < 4; ++jy) {
      const bool takey = sig_lanczos(__fsub_rn(fv, (float)(jy - 1)));
      const size_t rowoff = base + (size_t)(jy + 1) * Ws + 1;
#pragma unroll
      for (int jx = 0; jx < 4; ++jx)
        if (takey & sx[jx]) m |= mask[rowoff + jx];
    }
    outm[i] = inb ? m : 0;
  }
  cov[i] = inb ? 1.f : 0.f;
}

#ifdef ZUDS_WARP_PROBE_COPY
// the byte floor: each input plane read and each output plane written once
__global__ void probe_copy_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  const float* __restrict__ c,
                                  const int* __restrict__ d,
                                  const float* __restrict__ e,
                                  float* __restrict__ o1,
                                  float* __restrict__ o2,
                                  int* __restrict__ o3,
                                  float* __restrict__ o4, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float s = a[i] + b[i] + c[i];
  o1[i] = s;
  o3[i] = d[i] | 1;
  if (e != nullptr) o2[i] = s + e[i];
  if (o4 != nullptr) o4[i] = s - 1.f;
}
#endif

}  // namespace


// ref2 and refw2 are both null (one plane) or both set (two planes).
extern "C" int zuds_warp(const float* ref, const float* ref2, const int* mask,
                         const float* u, const float* v, const float* covb,
                         float* refw, float* refw2, int* refm, float* cov,
                         int H, int W, int window, cudaStream_t stream) {
  if ((ref2 == nullptr) != (refw2 == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 block(32, 4);
  dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  if (ref2 != nullptr)
    warp_kernel<true><<<grid, block, 0, stream>>>(
        ref, ref2, mask, u, v, covb, refw, refw2, refm, cov, H, W, window);
  else
    warp_kernel<false><<<grid, block, 0, stream>>>(
        ref, ref2, mask, u, v, covb, refw, refw2, refm, cov, H, W, window);
  return (int)cudaGetLastError();
}

// H28: window + 3 <= 11 (shared memory under 48 KB a block), order 0 or 1
extern "C" int zuds_warp_sep(const float* ref, const int* mask,
                             const float* u, const float* v,
                             const float* covb, float* refw, int* refm,
                             float* cov, int H, int W, int window, int order,
                             cudaStream_t stream) {
  const int reach = window + 3;
  if (window < 0 || reach > 11 || order < 0 || order > 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(kSepRows + 2 * reach) * kSepCols * kSepPlaneBytes;
  dim3 block(kSepCols, kSepYThreads);
  dim3 grid((W + kSepCols - 1) / kSepCols, (H + kSepRows - 1) / kSepRows);
  if (order)
    warp_sep_kernel<1><<<grid, block, smem, stream>>>(
        ref, mask, u, v, covb, refw, refm, cov, H, W, window);
  else
    warp_sep_kernel<0><<<grid, block, smem, stream>>>(
        ref, mask, u, v, covb, refw, refm, cov, H, W, window);
  return (int)cudaGetLastError();
}

// img/out, img2/out2 and mask/outm are each both null or both set; img2
// needs img. The source must hold the 6x6 support (Hs, Ws >= 6).
extern "C" int zuds_warp_gather(const float* img, const float* img2,
                                const int* mask, const float* u,
                                const float* v, float* out, float* out2,
                                int* outm, float* cov, int Hs, int Ws, int Ho,
                                int Wo, cudaStream_t stream) {
  if ((img == nullptr) != (out == nullptr) ||
      (img2 == nullptr) != (out2 == nullptr) ||
      (mask == nullptr) != (outm == nullptr) ||
      (img2 != nullptr && img == nullptr) || Hs < 6 || Ws < 6)
    return (int)cudaErrorInvalidValue;
  dim3 block(32, 4);
  dim3 grid((Wo + block.x - 1) / block.x, (Ho + block.y - 1) / block.y);
#define ZUDS_GATHER(P, M)                                                  \
  warp_gather_kernel<P, M><<<grid, block, 0, stream>>>(                    \
      img, img2, mask, u, v, out, out2, outm, cov, Hs, Ws, Ho, Wo)
  const int planes = (img != nullptr) + (img2 != nullptr);
  if (mask != nullptr) {
    if (planes == 2) ZUDS_GATHER(2, true);
    else if (planes == 1) ZUDS_GATHER(1, true);
    else ZUDS_GATHER(0, true);
  } else {
    if (planes == 2) ZUDS_GATHER(2, false);
    else if (planes == 1) ZUDS_GATHER(1, false);
    else ZUDS_GATHER(0, false);
  }
#undef ZUDS_GATHER
  return (int)cudaGetLastError();
}

#ifdef ZUDS_WARP_PROBE_COPY
extern "C" int zuds_warp_probe_copy(const float* a, const float* b,
                                    const float* c, const int* d,
                                    const float* e, float* o1, float* o2,
                                    int* o3, float* o4, long long n,
                                    cudaStream_t stream) {
  probe_copy_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      a, b, c, d, e, o1, o2, o3, o4, n);
  return (int)cudaGetLastError();
}
#endif
