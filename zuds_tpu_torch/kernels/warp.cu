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
//  * weights are lanczos3((u - x) - dx) in f32, in that order;
//  * the normaliser is sum_dy (sum_dx wx) * wy, as the reference forms it;
//  * source indices wrap around the frame (jnp.roll);
//  * mask bit b reaches (y, x) iff sig(dv - dy) and sig(du' - dx) hold,
//    where du' = u[y+dy, x] - x is read at the INTERMEDIATE row y+dy
//    (the separable OR evaluates column significance there).
// The mask path uses only f32 subtractions and compares, so it is
// bit-equal to the plain version.
//
// An optional second float plane (the coadd's per-epoch weight map,
// pipeline.py:482-483) shares u, v, the taps and the 36 weights of the
// first: one launch warps an epoch's pixels, weight and mask. The one-plane
// instantiation compiles none of the second plane's loads or sums.
//
// Bound: memory. Per pixel it reads u, v, ref and mask once from DRAM and
// ~36 neighbouring taps through L1/L2, and writes 12 bytes; ~30 bytes of
// DRAM traffic per pixel (~0.3 GB per quadrant). Consecutive threads take
// consecutive columns so every row read is coalesced.
#include "common.cuh"

namespace {

constexpr float kPi = 3.14159265358979323846f;
// |lanczos3(t)| > sqrt(5e-3) as interval tests (resample.py:189-209)
constexpr float kSigA = 0.9226250948801125f;
constexpr float kSigB = 1.099650902956955f;
constexpr float kSigC = 1.7405705334521984f;

__device__ __forceinline__ float sinc_f(float t) {
  if (t == 0.f) return 1.f;
  float pt = __fmul_rn(kPi, t);
  return __fdiv_rn(sinf(pt), pt);
}

__device__ __forceinline__ float lanczos3(float t) {
  if (!(fabsf(t) < 3.f)) return 0.f;
  return __fmul_rn(sinc_f(t), sinc_f(__fdiv_rn(t, 3.f)));
}

__device__ __forceinline__ bool sig_lanczos(float t) {
  float a = fabsf(t);
  return (a < kSigA) | ((a > kSigB) & (a < kSigC));
}

// first of the six candidate offsets that can carry weight: floor(d) - 2,
// clamped so a wild displacement cannot overflow an int (all taps past
// the window carry zero weight anyway)
__device__ __forceinline__ int first_tap(float d, int reach) {
  float f = floorf(d);
  f = fminf(fmaxf(f, (float)(-reach - 4)), (float)(reach + 4));
  return (int)f - 2;
}

template <bool TWO>
__global__ void warp_kernel(const float* __restrict__ ref,
                            const float* __restrict__ ref2,
                            const int* __restrict__ mask,
                            const float* __restrict__ u,
                            const float* __restrict__ v,
                            const float* __restrict__ covb,
                            float* __restrict__ refw,
                            float* __restrict__ refw2,
                            int* __restrict__ refm,
                            float* __restrict__ cov,
                            int H, int W, int window) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
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

  // ---- pixels: 6x6 direct gather ----------------------------------------
  const int dx0 = first_tap(du, reach);
  const int dy0 = first_tap(dv, reach);
  float wx[6], wy[6];
  float wxsum = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int dx = dx0 + k;
    wx[k] = (abs(dx) <= reach) ? lanczos3(__fsub_rn(du, (float)dx)) : 0.f;
    wxsum = __fadd_rn(wxsum, wx[k]);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int dy = dy0 + k;
    wy[k] = (abs(dy) <= reach) ? lanczos3(__fsub_rn(dv, (float)dy)) : 0.f;
  }
  float acc = 0.f, acc2 = 0.f, wacc = 0.f;
#pragma unroll
  for (int ky = 0; ky < 6; ++ky) {
    const int row = wrap_index(y + dy0 + ky, H);
    const float* rrow = ref + (size_t)row * W;
#pragma unroll
    for (int kx = 0; kx < 6; ++kx) {
      const int col = wrap_index(x + dx0 + kx, W);
      const float wgt = __fmul_rn(wx[kx], wy[ky]);
      acc = __fadd_rn(acc, __fmul_rn(rrow[col], wgt));
      if (TWO)
        acc2 = __fadd_rn(acc2, __fmul_rn(ref2[(size_t)row * W + col], wgt));
    }
    wacc = __fadd_rn(wacc, __fmul_rn(wxsum, wy[ky]));
  }
  const float norm = wacc == 0.f ? 1.f : wacc;
  const float out = __fdiv_rn(acc, norm);

  // ---- mask: separable significant-weight OR ------------------------------
  int m = 0;
  if (c) {
    for (int ky = 0; ky < 6; ++ky) {
      const int dy = dy0 + ky;
      if (abs(dy) > reach || !sig_lanczos(__fsub_rn(dv, (float)dy))) continue;
      const int row = wrap_index(y + dy, H);
      const float dur = __fsub_rn(u[(size_t)row * W + x], (float)x);
      const int ex0 = first_tap(dur, reach);
      for (int kx = 0; kx < 6; ++kx) {
        const int dx = ex0 + kx;
        if (abs(dx) > reach || !sig_lanczos(__fsub_rn(dur, (float)dx)))
          continue;
        m |= mask[(size_t)row * W + wrap_index(x + dx, W)];
      }
    }
  }
  refw[i] = c ? out : 0.f;
  if (TWO) refw2[i] = c ? __fdiv_rn(acc2, norm) : 0.f;
  refm[i] = m;
  cov[i] = c ? 1.f : 0.f;
}

// H10: the Lanczos-3 gather warp, one thread per output pixel.
//
// Replaces the reference's gather warps (zuds_tpu/ops/resample.py:
// warp_image :86, warp_mask :116, warp_image_mask :484): the per-pair align
// of a frame whose mapping is too far from the identity for H1's window (a
// rotation, a union grid). It is not H1 with the window taken off:
//  * the source (Hs, Ws) need not have the output's shape (Ho, Wo);
//  * taps are dx, dy in -2..3 about iu = floor(u), with weights
//    lanczos3(fu - dx) at the phase fu = u - iu;
//  * source indices are clamped to [2, Ws - 4], never wrapped; inside the
//    coverage the clamp does nothing;
//  * the normaliser is the sum of the 36 products wx * wy in tap order,
//    rows outer;
//  * coverage is the integer test that the 6x6 support lies inside the
//    source, and the output is 0 outside it. The reference writes the
//    product out * cov, which XLA folds into a select on the coverage
//    test: a non-finite source pixel in a clamped window outside the
//    coverage gives 0 there, and so here;
//  * mask bit b reaches a pixel iff sig(fv - dy) and sig(fu - dx) hold at
//    the pixel's own phase (no intermediate row).
// PLANES float planes (0, 1 or 2) share u, v and the 36 weights; MASK says
// whether a mask rides along. The mask path uses only f32 subtractions and
// compares, so it is bit-equal to the plain version.
//
// Bound: memory. Per pixel it reads u, v once from DRAM and the 36 taps of
// each plane through L1/L2 (each source pixel once from DRAM for a smooth
// mapping), and writes each output once: 28 bytes with one plane and a
// mask, 36 with two.
template <int PLANES, bool MASK>
__global__ void warp_gather_kernel(const float* __restrict__ img,
                                   const float* __restrict__ img2,
                                   const int* __restrict__ mask,
                                   const float* __restrict__ u,
                                   const float* __restrict__ v,
                                   float* __restrict__ out,
                                   float* __restrict__ out2,
                                   int* __restrict__ outm,
                                   float* __restrict__ cov,
                                   int Hs, int Ws, int Ho, int Wo) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
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

  float wx[6], wy[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    wx[k] = lanczos3(__fsub_rn(fu, (float)(k - 2)));
    wy[k] = lanczos3(__fsub_rn(fv, (float)(k - 2)));
  }
  float acc = 0.f, acc2 = 0.f, wacc = 0.f;
  int m = 0;
#pragma unroll
  for (int ky = 0; ky < 6; ++ky) {
    const size_t rowoff = (size_t)(ivc + ky - 2) * Ws + (iuc - 2);
    const bool takey = MASK && sig_lanczos(__fsub_rn(fv, (float)(ky - 2)));
#pragma unroll
    for (int kx = 0; kx < 6; ++kx) {
      if (PLANES > 0) {
        const float wgt = __fmul_rn(wx[kx], wy[ky]);
        acc = __fadd_rn(acc, __fmul_rn(img[rowoff + kx], wgt));
        if (PLANES > 1)
          acc2 = __fadd_rn(acc2, __fmul_rn(img2[rowoff + kx], wgt));
        wacc = __fadd_rn(wacc, wgt);
      }
      if (MASK) {
        if (takey && sig_lanczos(__fsub_rn(fu, (float)(kx - 2))))
          m |= mask[rowoff + kx];
      }
    }
  }
  if (PLANES > 0) {
    const float norm = wacc == 0.f ? 1.f : wacc;
    out[i] = inb ? __fdiv_rn(acc, norm) : 0.f;
    if (PLANES > 1) out2[i] = inb ? __fdiv_rn(acc2, norm) : 0.f;
  }
  if (MASK) outm[i] = inb ? m : 0;
  cov[i] = inb ? 1.f : 0.f;
}

}  // namespace

// ref2 and refw2 are both null (one plane) or both set (two planes).
extern "C" int zuds_warp(const float* ref, const float* ref2, const int* mask,
                         const float* u, const float* v, const float* covb,
                         float* refw, float* refw2, int* refm, float* cov,
                         int H, int W, int window, cudaStream_t stream) {
  if ((ref2 == nullptr) != (refw2 == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 block(32, 8);
  dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  if (ref2 != nullptr)
    warp_kernel<true><<<grid, block, 0, stream>>>(
        ref, ref2, mask, u, v, covb, refw, refw2, refm, cov, H, W, window);
  else
    warp_kernel<false><<<grid, block, 0, stream>>>(
        ref, ref2, mask, u, v, covb, refw, refw2, refm, cov, H, W, window);
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
  dim3 block(32, 8);
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
