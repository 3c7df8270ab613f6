// H9: the CLIPPED combine of a warped epoch stack, the AND of its masks and
// the no-data bit, one thread per output pixel.
//
// Replaces the reference's jitted combine (zuds_tpu/ops/coadd.py:
// clipped_coadd :42, combine_masks :93, and the no-data bit of
// zuds_tpu/parallel/pipeline.py:497-501). XLA runs it as a sort of the whole
// (N, H, W) stack plus a dozen elementwise and reduce passes; here each
// thread reads its pixel of every epoch once, keeps the N values in its own
// registers or local memory, and writes the five outputs.
//
// Per pixel, in the reference's arithmetic (see ops/coadd.py):
//  * x = img * s, w = wgt / (s * s) with the epoch's FLXSCALE s, if given;
//  * ok = w > 0; sigma = 1 / sqrt(max(w, 1e-30)), both correctly rounded;
//  * the median of the ok values: 0.5 * (s[(cnt-1)/2] + s[cnt/2]) of their
//    ascending order, 0 for cnt == 0. The two order statistics are found by
//    rank (the count of values before each value, ties by epoch), which
//    needs no writes to the per-thread arrays;
//  * keep = ok & (|x - med| <= nsigma * sigma + amp_frac * |med|), with the
//    deviation as fmaf(img, s, -med) under FLXSCALE, the threshold in two
//    roundings up to 32 epochs and as fmaf(amp_frac, |med|, nsigma * sigma)
//    beyond;
//  * sums of w and w * x over keep in epoch order; beyond 32 epochs in two
//    windows split at 32 - (64 - N) / 2, as XLA's CPU backend splits them;
//  * mask = AND over the covering epochs (0 where none covers), with the
//    no-data bit where the summed weight is 0.
//
// Bound: memory. 13 bytes read per epoch and pixel (img, wgt, mask, cov),
// 20 written per pixel; consecutive threads take consecutive pixels, so
// every plane read is coalesced, and the N loads of a thread are independent.
// The rank search is N^2 compares per pixel: 64 at N = 8, 4096 at N = 64,
// where the kernel turns compute-bound.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kSequential = 32;   // ops/coadd.py SEQUENTIAL_EPOCHS

template <int CAP>
__global__ void combine_kernel(const float* __restrict__ img,
                               const float* __restrict__ wgt,
                               const int* __restrict__ mask,
                               const uint8_t* __restrict__ cov,
                               const float* __restrict__ scales,
                               float* __restrict__ coadd,
                               float* __restrict__ weight,
                               int* __restrict__ nclip,
                               int* __restrict__ nexp,
                               int* __restrict__ omask,
                               int N, long long npix, float nsigma,
                               float amp_frac, int nodata) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npix) return;
  // fully unrolled up to 16 epochs, so the arrays stay in registers
  constexpr int kUnroll = CAP <= 16 ? CAP : 1;
  float v[CAP];    // scaled pixel, +inf where the epoch has no weight
  float w[CAP];    // scaled weight
  float xr[CAP];   // unscaled pixel (read only under FLXSCALE)
  const bool scaled = scales != nullptr;
  int cnt = 0;
  int m = -1;
  bool any = false;
#pragma unroll kUnroll
  for (int n = 0; n < CAP; ++n) {
    if (n < N) {
      const long long j = (long long)n * npix + i;
      float x = img[j], ww = wgt[j];
      xr[n] = x;
      if (scaled) {
        const float s = scales[n];
        x = __fmul_rn(x, s);
        ww = __fdiv_rn(ww, __fmul_rn(s, s));
      }
      const bool ok = ww > 0.f;
      v[n] = ok ? x : CUDART_INF_F;
      w[n] = ww;
      cnt += ok;
      if (cov[j]) {
        m &= mask[j];
        any = true;
      }
    }
  }

  // the two middle order statistics of the ok values, by rank
  const int lo = min(max((cnt - 1) / 2, 0), N - 1);
  const int hi = min(cnt / 2, N - 1);
  float slo = 0.f, shi = 0.f;
#pragma unroll kUnroll
  for (int a = 0; a < CAP; ++a) {
    if (a < N && w[a] > 0.f) {
      const float va = v[a];
      int rank = 0;
#pragma unroll kUnroll
      for (int b = 0; b < CAP; ++b) {
        if (b < N) rank += (v[b] < va) | ((v[b] == va) & (b < a));
      }
      if (rank == lo) slo = va;
      if (rank == hi) shi = va;
    }
  }
  const float med = cnt > 0 ? __fmul_rn(0.5f, __fadd_rn(slo, shi)) : 0.f;
  const float amed = fabsf(med);
  const float atol = __fmul_rn(amp_frac, amed);

  // clip and sum; beyond kSequential epochs in two windows
  const int split = N <= kSequential ? N : 32 - (64 - N) / 2;
  float wsum[2] = {0.f, 0.f}, csum[2] = {0.f, 0.f};
  int nkeep = 0;
#pragma unroll kUnroll
  for (int n = 0; n < CAP; ++n) {
    if (n < N) {
      const float ww = w[n];
      const bool ok = ww > 0.f;
      const float sigma =
          __fdiv_rn(1.f, __fsqrt_rn(fmaxf(ww, 1e-30f)));
      const float ns = __fmul_rn(nsigma, sigma);
      const float tol =
          N <= kSequential ? __fadd_rn(ns, atol) : fmaf(amp_frac, amed, ns);
      const float dev = scaled ? fabsf(fmaf(xr[n], scales[n], -med))
                               : fabsf(__fsub_rn(v[n], med));
      const bool keep = ok & (dev <= tol);
      const int h = n >= split;
      wsum[h] = __fadd_rn(wsum[h], keep ? ww : 0.f);
      csum[h] = __fadd_rn(csum[h], keep ? __fmul_rn(ww, v[n]) : 0.f);
      nkeep += keep;
    }
  }
  const float ws =
      N <= kSequential ? wsum[0] : __fadd_rn(wsum[0], wsum[1]);
  const float cs =
      N <= kSequential ? csum[0] : __fadd_rn(csum[0], csum[1]);
  coadd[i] = ws > 0.f ? __fdiv_rn(cs, ws) : 0.f;
  weight[i] = ws;
  nclip[i] = cnt - nkeep;
  nexp[i] = cnt;
  int mo = any ? m : 0;
  if (ws == 0.f) mo |= nodata;
  omask[i] = mo;
}

}  // namespace

// The stack is (N, npix) per plane; scales may be null. N <= 64.
extern "C" int zuds_clipped_combine(const float* img, const float* wgt,
                                    const int* mask, const uint8_t* cov,
                                    const float* scales, float* coadd,
                                    float* weight, int* nclip, int* nexp,
                                    int* omask, int N, long long npix,
                                    float nsigma, float amp_frac,
                                    int nodata_bit, cudaStream_t stream) {
  if (N < 1 || N > 64) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((npix + threads - 1) / threads);
  const int nodata = 1 << nodata_bit;
#define ZUDS_COMBINE(CAP)                                                  \
  combine_kernel<CAP><<<blocks, threads, 0, stream>>>(                     \
      img, wgt, mask, cov, scales, coadd, weight, nclip, nexp, omask, N,   \
      npix, nsigma, amp_frac, nodata)
  if (N <= 8) {
    ZUDS_COMBINE(8);
  } else if (N <= 16) {
    ZUDS_COMBINE(16);
  } else if (N <= 32) {
    ZUDS_COMBINE(32);
  } else {
    ZUDS_COMBINE(64);
  }
#undef ZUDS_COMBINE
  return (int)cudaGetLastError();
}
