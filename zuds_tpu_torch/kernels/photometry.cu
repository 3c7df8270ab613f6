// H22: circular-aperture photometry at per-source positions.
//
// Replaces zuds_tpu/ops/photometry.py:aperture_photometry_batched (:64) with
// its circle_pixel_overlap (:45), and the r = 6 px rms and bad-pixel sums
// of zuds_tpu/parallel/pipeline.py:306-328. One warp per source: it walks
// the cut x cut window at the clamped rounded corner (cut = 2 ceil(r) + 3:
// 9 at r = 3, 15 at r = 6), forms each pixel's exact overlap w with the
// circle (four signed quadrant areas, clamped to [0, 1]) and accumulates
//   mode 1 (zuds_aperture_photometry): sum img w, sum rms^2 w, sum w, and
//     the OR of mask & 0x3FFFF over pixels with w > 0 (the reference's loop
//     over 18 bits), with oob where the window about the rounded position
//     leaves the frame; rms and mask may be null (zeros);
//   mode 2 (zuds_aperture_sums): sum a w and sum b w of two float planes.
// Each lane sums its pixels in order, then a butterfly of shuffles adds
// the lanes: the same every call, another order than torch.sum's.
//
// w decides the flags: a pixel that misses the circle gets the cancelling
// sum of four quadrant areas of ~7 px^2, a residue of an ulp or two. So w
// is formed as ops/photometry.py:circle_pixel_overlap forms it on the
// card, operation by operation: every product, sum and quotient rounded
// on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn; nvcc would
// contract a product and a sum into an FMA), asinf and sqrtf as PyTorch's
// asin and sqrt call them, the NaN rules of torch.minimum and clamp, and
// the corner rounded half to even. w, the flags and oob are then bit-equal
// to the plain version's; the sums agree to their summation order.
//
// Bound: bytes. Each input read once per window: r = 3, 12 B a pixel
// (img, rms, mask) and 25 B a source (x, y; four outputs, oob): 4.08 MB
// at 4096 sources; r = 6, two planes: 8 B a pixel, 16 B a source, 7.44 MB.
// ~150 operations a pixel (four quadrant areas, each with two roots and an
// arcsine) stay well under that at the fp32 peak.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float sign_of(float v) {
  return (float)((v > 0.f) - (v < 0.f));     // torch.sign (NaN gives 0)
}

// 0.5 (t sqrt(r^2 - t^2) + r^2 asin(t / r)), t clamped to [0, r]
__device__ __forceinline__ float arc_int(float t, float r, float rr,
                                         float rs) {
  t = torch_min(clamp_min(t, 0.f), r);
  const float s = sqrtf(clamp_min(__fsub_rn(rr, __fmul_rn(t, t)), 0.f));
  const float a = asinf(clamp_to(__fdiv_rn(t, rs), -1.f, 1.f));
  return __fmul_rn(__fadd_rn(__fmul_rn(t, s), __fmul_rn(rr, a)), 0.5f);
}

// area of {u in [0, x], v in [0, y], u^2 + v^2 <= r^2}, x, y >= 0
__device__ __forceinline__ float quad_area(float x, float y, float r,
                                           float rr, float rs) {
  x = torch_min(x, r);
  y = torch_min(y, r);
  const float xc = sqrtf(clamp_min(__fsub_rn(rr, __fmul_rn(y, y)), 0.f));
  const float x1 = torch_min(x, xc);
  const float arc = x > x1 ? __fsub_rn(arc_int(x, r, rr, rs),
                                       arc_int(x1, r, rr, rs))
                           : 0.f;
  return __fadd_rn(__fmul_rn(y, x1), arc);
}

__device__ __forceinline__ float signed_area(float x, float y, float r,
                                             float rr, float rs) {
  return __fmul_rn(__fmul_rn(sign_of(x), sign_of(y)),
                   quad_area(fabsf(x), fabsf(y), r, rr, rs));
}

// overlap of the unit pixel centred at (dx, dy) from the centre with the
// circle of radius r, clamped to [0, 1]
__device__ __forceinline__ float overlap(float dx, float dy, float r,
                                         float rr, float rs) {
  const float x0 = __fsub_rn(dx, 0.5f), x1 = __fadd_rn(dx, 0.5f);
  const float y0 = __fsub_rn(dy, 0.5f), y1 = __fadd_rn(dy, 0.5f);
  const float w = __fadd_rn(
      __fsub_rn(__fsub_rn(signed_area(x1, y1, r, rr, rs),
                          signed_area(x0, y1, r, rr, rs)),
                signed_area(x1, y0, r, rr, rs)),
      signed_area(x0, y0, r, rr, rs));
  return clamp_to(w, 0.f, 1.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kSums: mode 2 (p0, p1 two planes; o0, o1 their sums). Else mode 1: p0
// img, p1 rms (or null), o0 flux, o1 fluxerr, area, flags, oob, and w (or
// null) the (N, cut, cut) overlaps.
template <bool kSums>
__global__ void __launch_bounds__(kWarps * 32)
    aperture_kernel(const float* __restrict__ p0,
                    const float* __restrict__ p1,
                    const int* __restrict__ mask,
                    const float* __restrict__ xs,
                    const float* __restrict__ ys, int N, int H, int W,
                    float r, int cut, float* __restrict__ o0,
                    float* __restrict__ o1, float* __restrict__ area,
                    int* __restrict__ flags, uint8_t* __restrict__ oob,
                    float* __restrict__ wout) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;                      // whole warps only
  const float xc = xs[n], yc = ys[n];
  bool ox, oy;
  const int x0 = window_corner(xc, W, cut, &ox);
  const int y0 = window_corner(yc, H, cut, &oy);
  const float rr = __fmul_rn(r, r);
  const float rs = clamp_min(r, (float)1e-30);
  float s0 = 0.f, s1 = 0.f, sw = 0.f;
  int f = 0;
  for (int i = lane; i < cut * cut; i += 32) {
    const int row = i / cut, col = i - row * cut;
    const float w = overlap(__fsub_rn((float)(x0 + col), xc),
                            __fsub_rn((float)(y0 + row), yc), r, rr, rs);
    const long long at = (long long)(y0 + row) * W + x0 + col;
    s0 = __fadd_rn(s0, __fmul_rn(p0[at], w));
    if (kSums) {
      s1 = __fadd_rn(s1, __fmul_rn(p1[at], w));
    } else {
      const float e = p1 ? p1[at] : 0.f;
      s1 = __fadd_rn(s1, __fmul_rn(__fmul_rn(e, e), w));
      sw = __fadd_rn(sw, w);
      if (w > 0.f && mask) f |= mask[at] & 0x3FFFF;
      if (wout) wout[(long long)n * cut * cut + i] = w;
    }
  }
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  if (kSums) {
    if (lane == 0) {
      o0[n] = s0;
      o1[n] = s1;
    }
    return;
  }
  sw = warp_sum(sw);
  f = (int)__reduce_or_sync(0xffffffffu, (unsigned)f);
  if (lane == 0) {
    o0[n] = s0;
    o1[n] = sqrtf(s1);
    area[n] = sw;
    flags[n] = f;
    oob[n] = (ox || oy) ? 1 : 0;
  }
}

int blocks_for(int N) { return (N + kWarps - 1) / kWarps; }

}  // namespace

// img, rms (or null), mask (int32, or null), xs, ys (N,) f32; flux,
// fluxerr, area (N,) f32, flags (N,) int32, oob (N,) u8, w (N, cut, cut)
// f32 or null. The frame is at least cut x cut.
extern "C" int zuds_aperture_photometry(const float* img, const float* rms,
                                        const int* mask, const float* xs,
                                        const float* ys, int N, int H, int W,
                                        float r, int cut, float* flux,
                                        float* fluxerr, float* area,
                                        int* flags, uint8_t* oob, float* w,
                                        cudaStream_t stream) {
  if (N > 0) {
    aperture_kernel<false><<<blocks_for(N), kWarps * 32, 0, stream>>>(
        img, rms, mask, xs, ys, N, H, W, r, cut, flux, fluxerr, area, flags,
        oob, w);
  }
  return (int)cudaGetLastError();
}

// a, b (H, W) f32, xs, ys (N,) f32; sa, sb (N,) f32: sum a w, sum b w.
extern "C" int zuds_aperture_sums(const float* a, const float* b,
                                  const float* xs, const float* ys, int N,
                                  int H, int W, float r, int cut, float* sa,
                                  float* sb, cudaStream_t stream) {
  if (N > 0) {
    aperture_kernel<true><<<blocks_for(N), kWarps * 32, 0, stream>>>(
        a, b, nullptr, xs, ys, N, H, W, r, cut, sa, sb, nullptr, nullptr,
        nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}
