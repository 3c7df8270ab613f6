// H9: the CLIPPED combine of a warped epoch stack, the AND of its masks and
// the no-data bit. One thread takes PX adjacent output pixels and every
// epoch of them; the epoch count picks a bucket (N to a multiple of 8, up
// to 64), each a template: the pixels and weights in shared memory, the
// keys of the order statistics in registers.
//
// Replaces the reference's jitted combine (zuds_tpu/ops/coadd.py:
// clipped_coadd :42, combine_masks :93, and the no-data bit of
// zuds_tpu/parallel/pipeline.py:497-501). XLA runs it as a sort of the whole
// (N, H, W) stack plus a dozen elementwise and reduce passes; here each
// pixel of every epoch is read once and the five outputs written once.
//
// Per pixel, in the reference's arithmetic (see ops/coadd.py):
//  * x = img * s, w = wgt / (s * s) with the epoch's FLXSCALE s, if given;
//  * ok = w > 0; sigma = 1 / sqrt(max(w, 1e-30)), both correctly rounded;
//  * the median of the ok values: 0.5 * (s[(cnt-1)/2] + s[cnt/2]) of the
//    ascending order that torch.sort gives the stack with +inf where an
//    epoch has no weight (-inf < finite < +inf < NaN), 0 for cnt == 0;
//  * keep = ok & (|x - med| <= nsigma * sigma + amp_frac * |med|), with the
//    deviation as fmaf(img, s, -med) under FLXSCALE, the threshold in two
//    roundings up to 32 epochs and as fmaf(amp_frac, |med|, nsigma * sigma)
//    beyond;
//  * sums of w and w * x over keep in epoch order; beyond 32 epochs in two
//    windows split at 32 - (64 - N) / 2, as XLA's CPU backend splits them
//    (ops/ordered.py:sum_last, whose +0 padding at 33-63 epochs only shows
//    where every term is -0);
//  * mask = AND over the covering epochs (0 where none covers), with the
//    no-data bit where the summed weight is 0.
//
// The order statistics. Each value maps to an order-preserving uint32 key
// (a float's bits with the sign flipped, or all bits for a negative one),
// so that -inf < finite < +inf as on the floats; every NaN maps to
// kNanKey, one above +inf, and the bucket's padding past N to kPadKey,
// above NaN. Sorted by a fixed network of min/max pairs (Batcher's
// odd-even merge sort: kNetComparators per bucket, against the N^2 rank
// compares of a search), the keys give torch.sort's order; the two middle
// ones are picked by a select tree on the bits of their index and mapped
// back. Equal keys are equal floats but for -0 (below +0 here, a tie in
// torch.sort): a median of +-0 enters the outputs only through |x - med|,
// fmaf(img, s, -med) under fabsf and |med|, none of which sees the sign of
// a zero median, so no tie-break by epoch is needed.
//
// Bound: memory. 13 bytes read per epoch and pixel (img, wgt, mask, cov),
// 20 written per pixel; consecutive threads take consecutive pixels. Up
// to 16 epochs a thread loads two pixels of a plane at once (float2/int2
// and a 2-byte load of the coverage bytes) where the plane size and the
// pointers allow; otherwise, and at the ragged end, one element at a time
// (on an H100 at 8 epochs of 3200^2: one pixel a thread 0.597 ms, two
// 0.582, four 0.666 with 17 local-memory instructions; at 16 epochs one
// and two alike). The network is 2 integer operations a comparator
// (kNetComparators). Each epoch costs about 40 more a pixel: the scaled
// weight's division, the key, the clip and the sums; the clip takes its
// threshold from rsqrtf (one instruction) and settles exactly, with
// sigma's root and division, only an epoch whose deviation lies within
// 4e-6 of it. Loops over epochs fully unrolled into registers (the first
// form) ran to ~20k instructions a kernel at 64 epochs, 17.8 ms on the
// canvas: the loops over epochs are rolled, over values in shared memory,
// and only the keys are registers.
#include "common.cuh"

#include <math_constants.h>

#include <utility>

namespace {

constexpr int kSequential = 32;   // ops/coadd.py SEQUENTIAL_EPOCHS
constexpr int kThreads = 128;
// keys past +inf: every NaN, then the bucket's padding
constexpr uint32_t kNanKey = 0xFF800001u;
constexpr uint32_t kPadKey = 0xFFFFFFFFu;

__host__ __device__ constexpr int pow2_at_least(int p) {
  int n = 1;
  while (n < p) n *= 2;
  return n;
}

// Batcher's odd-even merge sort of n = 2^m keys, comparator by comparator,
// keeping those that touch only the first `keep` keys: with the padding
// (the largest key) in the others, every comparator that touches one of
// them leaves both keys where they are, so the kept ones sort `keep` keys.
struct Pair {
  int a, b;
};

__host__ __device__ constexpr Pair batcher(int n, int keep, int want,
                                           int* count) {
  int c = 0;
  for (int p = 1; p < n; p *= 2)
    for (int k = p; k >= 1; k /= 2)
      for (int j = k % p; j <= n - 1 - k; j += 2 * k)
        for (int i = 0; i <= k - 1 && i <= n - j - k - 1; ++i)
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p) &&
              i + j + k < keep) {
            if (c == want) return Pair{i + j, i + j + k};
            ++c;
          }
  if (count) *count = c;
  return Pair{0, 0};
}

// the network of a bucket of P keys
__host__ __device__ constexpr int comparators(int P) {
  int c = 0;
  batcher(pow2_at_least(P), P, -1, &c);
  return c;
}

// the network's size per bucket of 8, 16, ..., 64 keys
constexpr int kNetComparators[] = {19, 63, 132, 191, 305, 384, 464, 543};
static_assert(comparators(8) == kNetComparators[0], "network of 8");
static_assert(comparators(16) == kNetComparators[1], "network of 16");
static_assert(comparators(24) == kNetComparators[2], "network of 24");
static_assert(comparators(32) == kNetComparators[3], "network of 32");
static_assert(comparators(40) == kNetComparators[4], "network of 40");
static_assert(comparators(48) == kNetComparators[5], "network of 48");
static_assert(comparators(56) == kNetComparators[6], "network of 56");
static_assert(comparators(64) == kNetComparators[7], "network of 64");

template <int P, int C>
struct Comparator {
  static constexpr Pair pair = batcher(pow2_at_least(P), P, C, nullptr);
  static constexpr int a = pair.a, b = pair.b;
};

__device__ __forceinline__ void order_pair(uint32_t& a, uint32_t& b) {
  const uint32_t lo = min(a, b);
  b = max(a, b);
  a = lo;
}

template <int N, int... C>
__device__ __forceinline__ void sort_network(
    uint32_t (&k)[N], std::integer_sequence<int, C...>) {
  (order_pair(k[Comparator<N, C>::a], k[Comparator<N, C>::b]), ...);
}

__device__ __forceinline__ uint32_t key_of(float v) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return isnan(v) ? kNanKey : k;
}

__device__ __forceinline__ float value_of(uint32_t k) {
  if (k == kNanKey) return CUDART_NAN_F;
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// k[idx] for a run-time idx < N without indexing the array at run time:
// each level halves the candidates by one bit of idx
template <int N>
__device__ __forceinline__ uint32_t pick(const uint32_t (&k)[N], int idx) {
  if constexpr (N == 1) {
    return k[0];
  } else {
    constexpr int M = (N + 1) / 2;
    uint32_t half[M];
    const bool odd = idx & 1;
#pragma unroll
    for (int i = 0; i < M; ++i)
      half[i] = (2 * i + 1 < N && odd) ? k[2 * i + 1] : k[2 * i];
    return pick(half, idx >> 1);
  }
}

// PX consecutive elements from base: one vector load when FULL, else
// element by element while fewer than `rest` (`fill` past them)
template <bool FULL, int PX, typename T>
__device__ __forceinline__ void load_px(const T* __restrict__ base,
                                        long long rest, T fill,
                                        T (&out)[PX]) {
  if constexpr (FULL && PX == 4 && sizeof(T) == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(base));
    out[0] = reinterpret_cast<const T&>(q.x);
    out[1] = reinterpret_cast<const T&>(q.y);
    out[2] = reinterpret_cast<const T&>(q.z);
    out[3] = reinterpret_cast<const T&>(q.w);
  } else if constexpr (FULL && PX == 2 && sizeof(T) == 4) {
    const int2 q = __ldg(reinterpret_cast<const int2*>(base));
    out[0] = reinterpret_cast<const T&>(q.x);
    out[1] = reinterpret_cast<const T&>(q.y);
  } else if constexpr (FULL && PX == 4 && sizeof(T) == 1) {
    const uint32_t q = __ldg(reinterpret_cast<const unsigned*>(base));
#pragma unroll
    for (int p = 0; p < 4; ++p) out[p] = (T)((q >> (8 * p)) & 0xFFu);
  } else if constexpr (FULL && PX == 2 && sizeof(T) == 1) {
    const unsigned short q =
        __ldg(reinterpret_cast<const unsigned short*>(base));
#pragma unroll
    for (int p = 0; p < 2; ++p) out[p] = (T)((q >> (8 * p)) & 0xFFu);
  } else {
#pragma unroll
    for (int p = 0; p < PX; ++p)
      out[p] = (FULL || p < rest) ? __ldg(base + p) : fill;
  }
}

// Every epoch of PX pixels from global memory into the thread's columns
// tx, tw of shared memory (element (n, p) at n * PX * kThreads + p *
// kThreads), the AND of the covering masks into m and any: a loop with no
// branch in it, so that the loads of several epochs are in flight at once
template <bool FULL, int PX>
__device__ __forceinline__ void load_stack(
    const float* __restrict__ img, const float* __restrict__ wgt,
    const int* __restrict__ mask, const uint8_t* __restrict__ cov, int N,
    long long npix, long long i0, long long rest, float* tx, float* tw,
    int (&m)[PX], bool (&any)[PX]) {
  constexpr int kCol = PX * kThreads;
  // the loads of 8 epochs in flight at once
#pragma unroll 8
  for (int n = 0; n < N; ++n) {
    const long long j = (long long)n * npix + i0;
    float xv[PX], wv[PX];
    int mv[PX];
    uint8_t cv[PX];
    load_px<FULL, PX>(img + j, rest, 0.f, xv);
    load_px<FULL, PX>(wgt + j, rest, 0.f, wv);
    load_px<FULL, PX>(mask + j, rest, 0, mv);
    load_px<FULL, PX>(cov + j, rest, (uint8_t)0, cv);
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      tx[n * kCol + p * kThreads] = xv[p];
      tw[n * kCol + p * kThreads] = wv[p];
      m[p] &= cv[p] ? mv[p] : -1;
      any[p] |= cv[p] != 0;
    }
  }
}

template <int PX, typename T>
__device__ __forceinline__ void store_px(T* __restrict__ base, long long rest,
                                         bool full, const T (&v)[PX]) {
  if (full) {
    if constexpr (PX == 4) {
      *reinterpret_cast<int4*>(base) =
          make_int4(reinterpret_cast<const int&>(v[0]),
                    reinterpret_cast<const int&>(v[1]),
                    reinterpret_cast<const int&>(v[2]),
                    reinterpret_cast<const int&>(v[3]));
      return;
    } else if constexpr (PX == 2) {
      *reinterpret_cast<int2*>(base) =
          make_int2(reinterpret_cast<const int&>(v[0]),
                    reinterpret_cast<const int&>(v[1]));
      return;
    }
  }
#pragma unroll
  for (int p = 0; p < PX; ++p)
    if (p < rest) base[p] = v[p];
}

// CAP: the bucket (epochs held per pixel, a multiple of 8); PX: pixels per
// thread; `vec`: the planes and pointers allow PX-wide loads. A thread's
// pixels and scaled weights wait in shared memory, epoch-major (element
// (n, p) of thread t at n * kCol + p * kThreads + t: conflict-free), so
// the loops over epochs stay rolled and the code small; only the keys of
// one pixel at a time are registers, for the network.
template <int CAP, int PX>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ img, const float* __restrict__ wgt,
               const int* __restrict__ mask, const uint8_t* __restrict__ cov,
               const float* __restrict__ scales, float* __restrict__ coadd,
               float* __restrict__ weight, int* __restrict__ nclip,
               int* __restrict__ nexp, int* __restrict__ omask, int N,
               long long npix, float nsigma, float amp_frac, int nodata,
               bool vec) {
  constexpr int kCol = PX * kThreads;   // one epoch's row of sx and sw
  extern __shared__ float smem[];
  float* const sx = smem;               // CAP x kCol unscaled pixels
  float* const sw = smem + CAP * kCol;  // CAP x kCol scaled weights
  float* const ssc = sw + CAP * kCol;   // CAP FLXSCALE factors
  const bool scaled = scales != nullptr;
  if (scaled && (int)threadIdx.x < N) ssc[threadIdx.x] = scales[threadIdx.x];
  __syncthreads();
  const long long i0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * PX;
  if (i0 >= npix) return;
  const long long rest = npix - i0;
  const bool full = vec && rest >= PX;
  float* const tx = sx + threadIdx.x;   // this thread's columns
  float* const tw = sw + threadIdx.x;

  int m[PX];
  bool any[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    m[p] = -1;
    any[p] = false;
  }
  // every epoch of the PX pixels, one vector load a plane where allowed;
  // the covering masks ANDed on the way
  if (full)
    load_stack<true, PX>(img, wgt, mask, cov, N, npix, i0, rest, tx, tw, m,
                         any);
  else
    load_stack<false, PX>(img, wgt, mask, cov, N, npix, i0, rest, tx, tw, m,
                          any);
  // the scaled weights, w / (s * s)
#ifndef ZUDS_COMBINE_PROBE_NO_DIV
  if (scaled) {
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float s2 = __fmul_rn(ssc[n], ssc[n]);
#pragma unroll
      for (int p = 0; p < PX; ++p)
        tw[n * kCol + p * kThreads] =
            __fdiv_rn(tw[n * kCol + p * kThreads], s2);
    }
  }
#endif

  const int split = N <= kSequential ? N : 32 - (64 - N) / 2;
  // the keep test is first made against nsigma * rsqrtf(w) + atol, within
  // 1e-6 of the exact threshold (each of its roundings and rsqrtf's 2
  // ulp; both terms >= 0, so no cancellation), for every epoch without a
  // branch; only an epoch whose deviation lies within kTolMargin of it is
  // then tested exactly (rare), and every epoch under other parameters
  constexpr float kTolMargin = 4e-6f;
  const bool fast = nsigma > 0.f && nsigma < 1e10f && amp_frac >= 0.f;
  float ocoadd[PX], oweight[PX];
  int onclip[PX], onexp[PX], omk[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const float* const px = tx + p * kThreads;
    const float* const pw = tw + p * kThreads;
#ifdef ZUDS_COMBINE_PROBE_LOADS_ONLY
    float xs = 0.f, wsum0 = 0.f;
    for (int n = 0; n < N; ++n) {
      xs += px[n * kCol];
      wsum0 += pw[n * kCol];
    }
    ocoadd[p] = xs;
    oweight[p] = wsum0;
    onclip[p] = 0;
    onexp[p] = 0;
    omk[p] = any[p] ? m[p] : 0;
#else
    // the two middle order statistics of the ok values
    uint32_t k[CAP];
    int c = 0;
#pragma unroll
    for (int n = 0; n < CAP; ++n) {
      if (n < N) {
        const float ww = pw[n * kCol];
        const float v = scaled ? __fmul_rn(px[n * kCol], ssc[n])
                               : px[n * kCol];
        k[n] = key_of(ww > 0.f ? v : CUDART_INF_F);
        c += ww > 0.f;
      } else {
        k[n] = kPadKey;
      }
    }
#ifndef ZUDS_COMBINE_PROBE_NO_SORT
    sort_network(k, std::make_integer_sequence<int, comparators(CAP)>{});
#endif
    const int lo = min(max((c - 1) / 2, 0), N - 1);
    const int hi = min(c / 2, N - 1);
    const float slo = value_of(pick(k, lo));
    const float shi = value_of(pick(k, hi));
    const float med = c > 0 ? __fmul_rn(0.5f, __fadd_rn(slo, shi)) : 0.f;
    const float amed = fabsf(med);
    const float atol = __fmul_rn(amp_frac, amed);

    // the clip: keep bits, the uncertain ones settled exactly
    uint64_t keepm = 0, uncm = 0;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float ww = pw[n * kCol];
      const float xn = px[n * kCol];
      const float dev = scaled ? fabsf(fmaf(xn, ssc[n], -med))
                               : fabsf(__fsub_rn(xn, med));
      const float ns = __fmul_rn(nsigma, rsqrtf(fmaxf(ww, 1e-30f)));
      const float ta = N <= kSequential ? __fadd_rn(ns, atol)
                                        : fmaf(amp_frac, amed, ns);
      const bool ok = ww > 0.f;
      const bool in = dev < ta * (1.f - kTolMargin);
      const bool out = dev > ta * (1.f + kTolMargin);
      keepm |= (uint64_t)(fast & ok & in) << n;
      uncm |= (uint64_t)(ok & !(fast & (in | out))) << n;
    }
    while (uncm) {
      const int n = __ffsll((long long)uncm) - 1;
      uncm &= uncm - 1;
      const float ww = pw[n * kCol];
      const float xn = px[n * kCol];
      const float dev = scaled ? fabsf(fmaf(xn, ssc[n], -med))
                               : fabsf(__fsub_rn(xn, med));
      const float sigma = __fdiv_rn(1.f, __fsqrt_rn(fmaxf(ww, 1e-30f)));
      const float ns = __fmul_rn(nsigma, sigma);
      const float tol = N <= kSequential ? __fadd_rn(ns, atol)
                                         : fmaf(amp_frac, amed, ns);
      keepm |= (uint64_t)(dev <= tol) << n;
    }

    // the sums; beyond kSequential epochs in two windows. A sum from -0 is
    // its first term exactly; sum_last pads 33..63 epochs with +0, which
    // only turns an all -0 sum into +0: start there
    const float start = N > kSequential && N < 64 ? 0.f : -0.f;
    float wsum[2] = {start, start}, csum[2] = {start, start};
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float ww = pw[n * kCol];
      const float v = scaled ? __fmul_rn(px[n * kCol], ssc[n]) : px[n * kCol];
      const bool keep = (keepm >> n) & 1;
      const int h = n >= split;
      wsum[h] = __fadd_rn(wsum[h], keep ? ww : 0.f);
      csum[h] = __fadd_rn(csum[h], keep ? __fmul_rn(ww, v) : 0.f);
    }
    const int nkeep = __popcll((long long)keepm);
    const float ws =
        N <= kSequential ? wsum[0] : __fadd_rn(wsum[0], wsum[1]);
    const float cs =
        N <= kSequential ? csum[0] : __fadd_rn(csum[0], csum[1]);
    ocoadd[p] = ws > 0.f ? __fdiv_rn(cs, ws) : 0.f;
    oweight[p] = ws;
    onclip[p] = c - nkeep;
    onexp[p] = c;
    omk[p] = (any[p] ? m[p] : 0) | (ws == 0.f ? nodata : 0);
#endif
  }
  store_px<PX>(coadd + i0, rest, full, ocoadd);
  store_px<PX>(weight + i0, rest, full, oweight);
  store_px<PX>(nclip + i0, rest, full, onclip);
  store_px<PX>(nexp + i0, rest, full, onexp);
  store_px<PX>(omask + i0, rest, full, omk);
}

// shared memory of a block: pixels and weights, and the scales
constexpr size_t combine_smem(int cap, int px) {
  return (2 * (size_t)cap * px * kThreads + cap) * sizeof(float);
}

template <int CAP, int PX>
int launch_combine(const float* img, const float* wgt, const int* mask,
                   const uint8_t* cov, const float* scales, float* coadd,
                   float* weight, int* nclip, int* nexp, int* omask, int N,
                   long long npix, float nsigma, float amp_frac, int nodata,
                   cudaStream_t stream) {
  // PX-wide loads need every plane to start on a multiple of PX elements
  // and each pointer on a multiple of its vector's size
  const uintptr_t a4 = (uintptr_t)img | (uintptr_t)wgt | (uintptr_t)mask |
                       (uintptr_t)coadd | (uintptr_t)weight |
                       (uintptr_t)nclip | (uintptr_t)nexp | (uintptr_t)omask;
  const bool vec = npix % PX == 0 && a4 % (4 * PX) == 0 &&
                   (uintptr_t)cov % PX == 0;
  const long long threads = (npix + PX - 1) / PX;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  constexpr size_t smem = combine_smem(CAP, PX);
  const cudaError_t err = cudaFuncSetAttribute(
      combine_kernel<CAP, PX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  combine_kernel<CAP, PX><<<blocks, kThreads, smem, stream>>>(
      img, wgt, mask, cov, scales, coadd, weight, nclip, nexp, omask, N,
      npix, nsigma, amp_frac, nodata, vec);
  return (int)cudaGetLastError();
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
  if (N < 1 || N > 64 || npix < 1) return (int)cudaErrorInvalidValue;
  const int nodata = 1 << nodata_bit;
#define ZUDS_COMBINE(CAP, PX)                                             \
  launch_combine<CAP, PX>(img, wgt, mask, cov, scales, coadd, weight,     \
                          nclip, nexp, omask, N, npix, nsigma, amp_frac,  \
                          nodata, stream)
  switch ((N + 7) / 8) {     // the bucket: N to a multiple of 8
    case 1: return ZUDS_COMBINE(8, 2);     // two pixels a thread
    case 2: return ZUDS_COMBINE(16, 2);
    case 3: return ZUDS_COMBINE(24, 1);
    case 4: return ZUDS_COMBINE(32, 1);
    case 5: return ZUDS_COMBINE(40, 1);
    case 6: return ZUDS_COMBINE(48, 1);
    case 7: return ZUDS_COMBINE(56, 1);
    default: return ZUDS_COMBINE(64, 1);
  }
#undef ZUDS_COMBINE
}
