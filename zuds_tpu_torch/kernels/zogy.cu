// H15: the ZOGY spectral pass; H16: the score normalisation; H17: the PSF
// star stamps; H18: the PSF clipped mean.
//
// H15 replaces zuds_tpu/ops/zogy.py:56-67 and :71 (zogy_subtract between
// its FFTs) on the four half spectra N, R, P_n, P_r (complex64 as float2,
// H x (W/2 + 1) each). Two launches: A reduces denom = c_r |P_r|^2 +
// c_n |P_n|^2 to its maximum, a grid reduction into one device scalar by
// atomicMax on the bits (denom >= 0, so the bits order as the values; a
// NaN, made positive, is the largest, as in torch.max); B forms denom
// again, clamps it at 1e-12 max, takes its root sq and writes
//   D_hat   = (f_ref P_r N - f_new P_n R) / sq
//   P_d_hat = f_rn P_r P_n / (f_d sq)
//   S_hat   = f_d D_hat conj(P_d_hat).
// The host reads nothing between A and B. Every product, sum and quotient
// is rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn: no contraction)
// as the plain version (ops/zogy.py:spectral_pass_plain) writes them, and
// |P| is XLA's complex abs, max * sqrt(fma(r, r, 1)) with r = min / max
// (hypotf is another function: PyTorch's kernels and this library may
// carry different builds of it), so B is bit-equal to the plain version
// on the card. Bound: memory: A reads 16 B per element, B reads 32 B and
// writes 24 B.
//
// H16 replaces zogy.py:74-76: sum p_d^2 over the frame into one device
// scalar, then s_corr = s / (f_d sqrt(max(sum, 1e-20))), in one
// cooperative launch of a co-resident grid (no memset, no counter). Each
// block takes a contiguous slab of 16-byte chunks (single floats where a
// pointer is not 16-byte aligned; the n % 4 floats past the chunks go to
// the last block's thread 0), first loads the first kNormHold chunks of
// its s into registers, sums its fl(p_d^2) in double (four chains a
// thread, then a fixed tree) into its partial, waits at the grid barrier,
// adds the G partials in one fixed order (every block the same bits, the
// same every call), rounds once to f32 and scales its slab. Bound:
// memory, 12 B per pixel; the barrier is hidden in part behind the held
// loads.
//
// H17 replaces zogy.py:89-114 (estimate_psf_from_stars's cuts): one block
// of 512 threads per star. The block cuts the size x size window at the
// clamped corner of the position rounded half to even and shifts it by the
// sub-pixel offset through the Fourier phase ramp, keeps the real part
// rounded once to f32, takes the median of the 4 size border values as
// jnp.median does (the midpoint of the two middle values by rank; NaN when
// one is NaN), subtracts it, sums the stamp and writes it divided by its
// sum where that is positive, and good0 = valid & (sum > 0). The real part
// of the inverse of the ramped spectrum F E is the inverse of its
// Hermitian part F (E(u, v) + conj(E(-u, -v))) / 2 (the cut is real, so F
// is Hermitian; at even n fftfreq gives -1/2 at n / 2 for both k and -k, so
// the ramp itself is not), which needs only the half spectrum, columns v
// < m = n / 2 + 1: four direct DFT passes in double over it, each one
// round of the block: P1 the real rows (columns c and n - c paired: two
// FMAs a pair), P2 and P3 along y (the conjugate rows k and n - k from
// four sums, the even and odd terms on two lanes), the ramp folded into
// P2's outputs, P4 the real part along x (columns c and n - c from two
// sums): 50,050 FMAs a 25x25 stamp. A lane's twiddles come by recurrence
// (a complex product a term, ~1e-15 from sincospi's table after 16
// terms): the passes are bound by shared-memory traffic, and a twiddle
// load would be half of it. The
// transforms run in double: in f32 a cut on a sky pedestal (an aligned
// reference keeps its ~150 counts) carries the pedestal's rounding into
// every mode, which put single stamps 1e-6 apart from an f32 cuFFT. The
// plain version transforms in double too, so the two agree to the final
// f32 rounding. The ramp is the reference's: its argument 2 pi (fy dy + fx
// dx) and fftfreq's k / n rounded in f32, its cosine and sine (one
// sincosf). The stamp's f32 sum runs in the order of 256 lanes, whatever
// the block's width. CPU emulation: tests/test_torch_zogy_passes.py. Bound:
// ~0.46 MFLOP per stamp of the reference's f32 work and 5 KB read and
// written; the block's seven phases (PERF.md) each take 800-3100 cycles.
//
// H18 replaces zogy.py:116-132: `iters` passes of the 5 sigma clip (the
// mean and variance of the good stamps per pixel, each summed in stamp
// order; a stamp stays good while max |s - mean| / (sig + 1e-12) < 5),
// then the final mean clamped at 0 over its sum. NaN flows as in the
// reference: s * g keeps a NaN of a dropped stamp. The blocks of one
// thread-block cluster split the pixels, a thread a pixel, and each block
// holds every stamp's values of its pixels in shared memory (read once,
// by cp.async, for all passes); a stamp count whose values do not fit is
// read from global memory each pass by the same kernel. The good flags
// are bit words: a pass's count is their popcount. A stamp fails a pass
// where any pixel's quotient is >= 5 or NaN, so the maximum gives way to a
// vote: a lane sets bit j of its mask where its pixel fails stamp j, one
// warp OR (__reduce_or_sync) of the masks votes 32 stamps at once, and one
// atomicOr a warp and word goes into every block of the cluster
// (distributed shared memory); after the cluster barrier each block reads
// its own words. The quotient is decided without a division where it
// can be: q = fl(|d| fl(1 / den)) is within 2^-23 of |d| / den, so q < 5
// (1 - 2^-20) means fl(|d| / den) < 5 and q > 5 (1 + 2^-20) means >= 5;
// only in between, or for a NaN, is __fdiv_rn asked, where a lane of the
// warp needs it (tests/test_torch_psf_clip_passes.py). The loops hold a
// word of 32 stamps' values in registers at a time. Every sum keeps
// the parent's order, so `good` and the per-pixel means are its bits; the
// final unit sum adds the blocks' partials in block order.
// Bound: 160 KB of stamps for 64 stamps of 25x25, 0.05 us; the passes are
// chains of S dependent adds a pixel and a cluster barrier a pass.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStamp = 32;              // H17: size <= 32
constexpr float kTwoPi = 6.2831855f;       // float(2 pi), as 2j * jnp.pi

// the bits of a non-negative float (or NaN, made the largest) as an
// unsigned key that orders as the values
__device__ __forceinline__ unsigned max_key(float v) {
  return isnan(v) ? 0x7fc00000u : __float_as_uint(v);
}

__device__ __forceinline__ float nan_maximum(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// |p|^2 with |p| as XLA's complex abs (jnp.abs): max * sqrt(1 + r^2),
// r = min / max, the square and the add one FMA; max where it is 0 or inf
__device__ __forceinline__ float abs2(float2 p) {
  const float a = fabsf(p.x), b = fabsf(p.y);
  const float mx = nan_maximum(a, b);
  float m = mx;
  if (mx != 0.f && !isinf(mx)) {
    const float r = __fdiv_rn(fminf(a, b), mx);
    m = __fmul_rn(mx, __fsqrt_rn(__fmaf_rn(r, r, 1.f)));
  }
  return __fmul_rn(m, m);
}

__device__ __forceinline__ float denom_at(float2 pr, float2 pn, float c_r,
                                          float c_n) {
  return __fadd_rn(__fmul_rn(c_r, abs2(pr)), __fmul_rn(c_n, abs2(pn)));
}

// (a)(b) on real and imaginary parts, each product and sum rounded
__device__ __forceinline__ float2 cmul(float ar, float ai, float br,
                                       float bi) {
  return make_float2(__fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi)),
                     __fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the f32 sum of one value per thread, in a fixed order; every thread
// gets it. red holds a float per warp.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = lane < nw ? red[lane] : 0.f;
  s = warp_sum(s);
  return s;
}

// ---- H15 -------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    spectral_max_kernel(const float2* __restrict__ pn,
                        const float2* __restrict__ pr, long long n, float c_r,
                        float c_n, unsigned* __restrict__ dmax) {
  __shared__ float red[kThreads / 32];
  float m = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    m = nan_max(m, denom_at(pr[i], pn[i], c_r, c_n));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = nan_max(m, red[w]);
    atomicMax(dmax, max_key(m));
  }
}

__global__ void __launch_bounds__(kThreads)
    spectral_kernel(const float2* __restrict__ N, const float2* __restrict__ R,
                    const float2* __restrict__ pn_,
                    const float2* __restrict__ pr_, long long n, float c_r,
                    float c_n, float f_ref, float f_new, float f_rn,
                    float f_d, const unsigned* __restrict__ dmax,
                    float2* __restrict__ D, float2* __restrict__ Pd,
                    float2* __restrict__ S) {
  const float thr = __fmul_rn(1e-12f, __uint_as_float(*dmax));
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float2 pr = pr_[i], pn = pn_[i], a = N[i], b = R[i];
    const float sq =
        __fsqrt_rn(nan_maximum(denom_at(pr, pn, c_r, c_n), thr));
    const float2 t1 =
        cmul(__fmul_rn(f_ref, pr.x), __fmul_rn(f_ref, pr.y), a.x, a.y);
    const float2 t2 =
        cmul(__fmul_rn(f_new, pn.x), __fmul_rn(f_new, pn.y), b.x, b.y);
    const float dr = __fdiv_rn(__fsub_rn(t1.x, t2.x), sq);
    const float di = __fdiv_rn(__fsub_rn(t1.y, t2.y), sq);
    const float2 u =
        cmul(__fmul_rn(f_rn, pr.x), __fmul_rn(f_rn, pr.y), pn.x, pn.y);
    const float fsq = __fmul_rn(f_d, sq);
    const float qr = __fdiv_rn(u.x, fsq), qi = __fdiv_rn(u.y, fsq);
    const float gr = __fmul_rn(f_d, dr), gi = __fmul_rn(f_d, di);
    D[i] = make_float2(dr, di);
    Pd[i] = make_float2(qr, qi);
    // times conj(P_d_hat)
    S[i] = make_float2(__fadd_rn(__fmul_rn(gr, qr), __fmul_rn(gi, qi)),
                       __fsub_rn(__fmul_rn(gi, qr), __fmul_rn(gr, qi)));
  }
}

// ---- H16 -------------------------------------------------------------------

// H16's block width, and the chunks of s (16 bytes each on the vector path)
// a thread loads before the grid barrier and holds in registers across it
constexpr int kNormThreads = 512;
constexpr int kNormHold = 4;

__device__ __forceinline__ void add_squares(float v, double* acc) {
  acc[0] += (double)__fmul_rn(v, v);
}
__device__ __forceinline__ void add_squares(float4 v, double* acc) {
  acc[0] += (double)__fmul_rn(v.x, v.x);
  acc[1] += (double)__fmul_rn(v.y, v.y);
  acc[2] += (double)__fmul_rn(v.z, v.z);
  acc[3] += (double)__fmul_rn(v.w, v.w);
}
__device__ __forceinline__ float divided(float v, float d) {
  return __fdiv_rn(v, d);
}
__device__ __forceinline__ float4 divided(float4 v, float d) {
  return make_float4(__fdiv_rn(v.x, d), __fdiv_rn(v.y, d), __fdiv_rn(v.z, d),
                     __fdiv_rn(v.w, d));
}

// the double sum of one value per thread in a fixed order: an xor
// butterfly in each warp (every lane ends with the same bits: each add's
// operands only swap sides), then the warps in order. Every thread gets it;
// red holds a double per warp.
__device__ double block_sum_d(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// A block's slab of the nv chunks of V floats (V = 4 on the vector path,
// 1 when a pointer is not 16-byte aligned): the chunks [lo, hi), thread t
// taking lo + t, lo + t + kNormThreads, ...; the n % V floats past the
// chunks belong to the last block's thread 0.
struct Slab {
  long long lo, hi, nv;
  __device__ Slab(long long n, int V) {
    nv = n / V;
    const long long per = (nv + gridDim.x - 1) / gridDim.x;
    lo = min((long long)blockIdx.x * per, nv);
    hi = min(lo + per, nv);
  }
};

// phase 1: the slab's sum of fl(p_d^2) in double (four chains a thread,
// then block_sum_d) into partials[block]
template <typename T>
__device__ __forceinline__ void sum_slab(const float* pd_, long long n,
                                         const Slab& sl, double* partials,
                                         double* red) {
  constexpr int V = sizeof(T) / sizeof(float);
  const T* pd = reinterpret_cast<const T*>(pd_);
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  // four loads in flight a thread, added in chunk order
  long long c = sl.lo + threadIdx.x;
  for (; c + 3 * kNormThreads < sl.hi; c += 4 * kNormThreads) {
    const T a = pd[c], b = pd[c + kNormThreads], d = pd[c + 2 * kNormThreads],
            e = pd[c + 3 * kNormThreads];
    add_squares(a, acc);
    add_squares(b, acc);
    add_squares(d, acc);
    add_squares(e, acc);
  }
  for (; c < sl.hi; c += kNormThreads) add_squares(pd[c], acc);
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0)
    for (long long i = sl.nv * V; i < n; ++i) add_squares(pd_[i], acc);
  const double v = block_sum_d((acc[0] + acc[1]) + (acc[2] + acc[3]), red);
  if (threadIdx.x == 0) partials[blockIdx.x] = v;
}

// the first kNormHold chunks of the thread's share of s
template <typename T>
__device__ __forceinline__ void hold_slab(const float* s_, const Slab& sl,
                                          T* held) {
  const T* s = reinterpret_cast<const T*>(s_);
#pragma unroll
  for (int k = 0; k < kNormHold; ++k) {
    const long long c = sl.lo + threadIdx.x + (long long)k * kNormThreads;
    if (c < sl.hi) held[k] = s[c];
  }
}

// phase 2: every block adds the G partials in one fixed order (so all hold
// the same bits), rounds the sum to f32 once, and writes its slab of
// s / (f_d sqrt(max(sum, 1e-20)))
template <typename T>
__device__ __forceinline__ void scale_slab(const float* s_, long long n,
                                           float f_d, const Slab& sl,
                                           const double* partials,
                                           const T* held, float* out_,
                                           double* red) {
  constexpr int V = sizeof(T) / sizeof(float);
  double p = 0.0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kNormThreads)
    p += __ldcg(partials + i);
  const float total = (float)block_sum_d(p, red);
  const float norm =
      __fmul_rn(f_d, __fsqrt_rn(isnan(total) ? total : fmaxf(total, 1e-20f)));
  const T* s = reinterpret_cast<const T*>(s_);
  T* out = reinterpret_cast<T*>(out_);
  const long long first = sl.lo + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kNormHold; ++k) {
    const long long c = first + (long long)k * kNormThreads;
    if (c < sl.hi) out[c] = divided(held[k], norm);
  }
  long long c = first + (long long)kNormHold * kNormThreads;
  for (; c + 3 * kNormThreads < sl.hi; c += 4 * kNormThreads) {
    const T a = s[c], b = s[c + kNormThreads], d = s[c + 2 * kNormThreads],
            e = s[c + 3 * kNormThreads];
    out[c] = divided(a, norm);
    out[c + kNormThreads] = divided(b, norm);
    out[c + 2 * kNormThreads] = divided(d, norm);
    out[c + 3 * kNormThreads] = divided(e, norm);
  }
  for (; c < sl.hi; c += kNormThreads) out[c] = divided(s[c], norm);
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0)
    for (long long i = sl.nv * V; i < n; ++i)
      out_[i] = __fdiv_rn(s_[i], norm);
}

// one cooperative launch: the grid is co-resident, so a grid barrier
// parts the phases; the held chunks of s load before it
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    normalize_kernel(const float* __restrict__ pd, const float* __restrict__ s,
                     long long n, float f_d, double* __restrict__ partials,
                     float* __restrict__ out) {
  __shared__ double red[kNormThreads / 32];
  const Slab sl(n, sizeof(T) / sizeof(float));
  T held[kNormHold];
  hold_slab<T>(s, sl, held);
  sum_slab<T>(pd, n, sl, partials, red);
  cg::this_grid().sync();
  scale_slab<T>(s, n, f_d, sl, partials, held, out, red);
}

// ---- H17 -------------------------------------------------------------------

constexpr int kStampThreads = 512;
constexpr int kHalfMax = kMaxStamp / 2 + 1;   // the half spectrum's columns
constexpr int kSumLanes = 256;   // the lanes of the stamp's sum
static_assert(kStampThreads >= kSumLanes, "the sum's lanes are threads");

// -k mod n, for k in [0, n)
__device__ __forceinline__ int partner(int k, int n) { return k ? n - k : 0; }

// a b in double (the twiddle recurrence)
__device__ __forceinline__ double2 cmul_d(double2 a, double2 b) {
  return make_double2(fma(a.x, b.x, -a.y * b.y), fma(a.x, b.y, a.y * b.x));
}

// jnp.fft.fftfreq(n)[k] in f32 (k < n): k / n up to (n - 1) / 2, then
// (k - n) / n
__device__ __forceinline__ float fftfreq(int k, int n) {
  return __fdiv_rn((float)(2 * k < n ? k : k - n), (float)n);
}

// P2 and P3: the complex DFT along the rows' axis of an n x m half
// spectrum (in, row-major, m columns), out[k][v] = sum_j w^(kj) in[j][v]
// forward and w^(-kj) inverse, w = exp(-2 pi i / n). A pair of lanes takes
// the conjugate outputs k and n - k of one column v (their twiddles are
// conjugate, so four sums over j serve both), the even j on one lane and
// the odd j on the other; the twiddle w^(kj) by recurrence (times w^(2k)
// a term, in double: ~1e-15 from sincospi's after 16 terms). The
// epilogue multiplies the forward pass by the ramp (ramp[k][v]) and the
// inverse one by the weight of its column in the real-part pass.
template <bool kForward>
__device__ __forceinline__ void pair_pass(const double2* in, double2* out,
                                          const double2* tw,
                                          const double2* ramp, int n,
                                          int m) {
  const int h = threadIdx.x & 1;
  const int pairs = m * m, lanes = blockDim.x >> 1;
  for (int base = 0; base < pairs; base += lanes) {
    const int i = base + (threadIdx.x >> 1);
    const bool live = i < pairs;
    const int k = live ? i / m : 0, v = live ? i - k * m : 0;
    double sap = 0.0, sbq = 0.0, saq = 0.0, sbp = 0.0;
    if (live) {
      // w^(kh), then times w^(2k) a term
      double2 w = tw[h ? k : 0];
      const double2 ws = tw[2 * k >= n ? 2 * k - n : 2 * k];
#pragma unroll 4
      for (int j = h; j < n; j += 2) {
        const double2 x = in[j * m + v];
        sap = fma(w.x, x.x, sap);
        sbq = fma(w.y, x.y, sbq);
        saq = fma(w.x, x.y, saq);
        sbp = fma(w.y, x.x, sbp);
        w = cmul_d(w, ws);
      }
    }
    // the pair's two halves, the same bits on both lanes
    sap += __shfl_xor_sync(0xffffffffu, sap, 1);
    sbq += __shfl_xor_sync(0xffffffffu, sbq, 1);
    saq += __shfl_xor_sync(0xffffffffu, saq, 1);
    sbp += __shfl_xor_sync(0xffffffffu, sbp, 1);
    // w^(kj) x summed: (ap - bq, aq + bp); its conjugate twiddle's:
    // (ap + bq, aq - bp). Lane h = 0 writes row k, lane 1 row n - k.
    const int row = h ? partner(k, n) : k;
    if (!live || (h && row == k)) continue;
    const bool plus = kForward == (h == 0);
    const double re = plus ? sap - sbq : sap + sbq;
    const double im = plus ? saq + sbp : saq - sbp;
    const int at = row * m + v;
    if (kForward) {
      const double2 e = ramp[at];
      out[at] = make_double2(re * e.x - im * e.y, re * e.y + im * e.x);
    } else {
      const double wv = (v == 0 || 2 * v == n) ? 1.0 : 2.0;
      out[at] = make_double2(wv * re, wv * im);
    }
  }
}

__global__ void __launch_bounds__(kStampThreads)
    psf_stamps_kernel(const float* __restrict__ img, int H, int W,
                      const float* __restrict__ xs,
                      const float* __restrict__ ys,
                      const uint8_t* __restrict__ valid, int n,
                      float* __restrict__ stamps,
                      uint8_t* __restrict__ good0) {
  __shared__ double2 tw[kMaxStamp];
  __shared__ double xin[kMaxStamp * kMaxStamp];
  __shared__ double2 ramp[kMaxStamp * kHalfMax];
  __shared__ double2 pa[kMaxStamp * kHalfMax];   // B, then C
  __shared__ double2 pb[kMaxStamp * kHalfMax];   // H
  __shared__ float st[kMaxStamp * kMaxStamp];
  __shared__ float border[4 * kMaxStamp];
  __shared__ float red[kStampThreads / 32];
  __shared__ float mid[2];
  __shared__ int has_nan;
  const int s = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  const int nn = n * n, half = n / 2, m = n / 2 + 1;
  const float x = xs[s], y = ys[s];
  const bool ok = valid[s] != 0;
  const int x0 = min(max((int)rintf(x) - half, 0), W - n);
  const int y0 = min(max((int)rintf(y) - half, 0), H - n);
  const float dx = __fsub_rn(x, (float)(x0 + half));
  const float dy = __fsub_rn(y, (float)(y0 + half));
  if (t < n) {
    double sv, cv;
    sincospi(2.0 * t / n, &sv, &cv);
    tw[t] = make_double2(cv, -sv);
  }
  if (t == 0) has_nan = 0;
  // the window's values into registers first: their loads in flight
  // under the ramp's arithmetic
  float px[kMaxStamp * kMaxStamp / kStampThreads];
#pragma unroll
  for (int k = 0; k < kMaxStamp * kMaxStamp / kStampThreads; ++k) {
    const int i = t + k * T, r = i / n, c = i - r * n;
    if (i < nn) px[k] = img[(long long)(y0 + r) * W + x0 + c];
  }
  // the ramp of the half spectrum's Hermitian part: (E(u, v) +
  // conj(E(-u, -v))) / 2, so that the real part of the inverse is the
  // inverse of the half spectrum. fftfreq(-k) is -fftfreq(k), so the
  // argument at (-u, -v) is exactly -theta and the ramp there is taken as
  // E's conjugate (sincosf's odd sine and even cosine), but on the Nyquist
  // row and column of an even n, where fftfreq gives -1/2 for both k and
  // -k: there both are formed.
  for (int i = t; i < n * m; i += T) {
    const int u = i / m, v = i - u * m;
    const float fu = fftfreq(u, n), fv = fftfreq(v, n);
    float sn, cs;
    sincosf(__fmul_rn(kTwoPi, __fadd_rn(__fmul_rn(fu, dy),
                                        __fmul_rn(fv, dx))), &sn, &cs);
    double2 e = make_double2(cs, sn);
    if (2 * u == n || 2 * v == n) {
      const float gu = 2 * u == n ? fu : -fu, gv = 2 * v == n ? fv : -fv;
      float sn2, cs2;
      sincosf(__fmul_rn(kTwoPi, __fadd_rn(__fmul_rn(gu, dy),
                                          __fmul_rn(gv, dx))), &sn2, &cs2);
      e = make_double2(0.5 * (e.x + (double)cs2), 0.5 * (e.y - (double)sn2));
    }
    ramp[i] = e;
  }
#pragma unroll
  for (int k = 0; k < kMaxStamp * kMaxStamp / kStampThreads; ++k)
    if (t + k * T < nn) xin[t + k * T] = (double)px[k];
  __syncthreads();
  // P1: the real rows along x into the half spectrum, B[r][v] = sum_c
  // x[r][c] w^(vc), v < m: the columns c and n - c paired (their twiddles
  // are conjugate), the twiddle by recurrence (times w^v a term), the
  // Nyquist column's (even n) +-1 from the table
  for (int i = t; i < n * m; i += T) {
    const int r = i / m, v = i - r * m;
    const double* row = xin + r * n;
    double re = row[0], im = 0.0;
    const double2 ws = tw[v];
    double2 w = ws;
#pragma unroll 4
    for (int c = 1; 2 * c < n; ++c) {
      re = fma(row[c] + row[n - c], w.x, re);
      im = fma(row[c] - row[n - c], w.y, im);
      w = cmul_d(w, ws);
    }
    if (n > 1 && (n & 1) == 0) re = fma(row[half], tw[(v & 1) * half].x, re);
    pa[i] = make_double2(re, im);
  }
  __syncthreads();
  // P2: along y, times the ramp
  pair_pass<true>(pa, pb, tw, ramp, n, m);
  __syncthreads();
  // P3: inverse along y, each column times its weight below
  pair_pass<false>(pb, pa, tw, ramp, n, m);
  __syncthreads();
  // P4: the real part of the inverse along x over n^2, rounded once to
  // f32: out[r][c] = sum_v wv Re(C[r][v] w^(-vc)) (wv = 2 but at v = 0 and
  // n / 2, the columns the half spectrum holds once); the columns c and
  // n - c share the sums sum wv Cr a and sum wv Ci b (the twiddle w^(vc)
  // by recurrence, times w^c a term). Both also go into the border's
  // slots (row 0, row n - 1, column 0, column n - 1).
  const double inv_nn = 1.0 / nn;
  for (int i = t; i < n * m; i += T) {
    const int r = i / m, c = i - r * m;
    const double2* row = pa + r * m;
    double s1 = 0.0, s2 = 0.0;
    const double2 ws = tw[c];
    double2 w = make_double2(1.0, 0.0);
#pragma unroll 4
    for (int v = 0; v < m; ++v) {
      const double2 cv = row[v];
      s1 = fma(cv.x, w.x, s1);
      s2 = fma(cv.y, w.y, s2);
      w = cmul_d(w, ws);
    }
    const int c2 = partner(c, n);
    for (int e = 0; e < (c2 != c ? 2 : 1); ++e) {
      const int col = e ? c2 : c;
      const float a = (float)((e ? s1 - s2 : s1 + s2) * inv_nn);
      st[r * n + col] = a;
      if (r == 0) border[col] = a;
      if (r == n - 1) border[n + col] = a;
      if (col == 0) border[2 * n + r] = a;
      if (col == n - 1) border[3 * n + r] = a;
    }
  }
  __syncthreads();
  // the border's median by rank (ties by position): four lanes a value,
  // each counting a quarter of the border, added across the four
  const int nb = 4 * n;
  const int lo = (nb - 1) / 2, hi = nb / 2;
  for (int base = 0; base < 4 * nb; base += T) {
    const int q = base + t, i = q >> 2, part = q & 3;
    const bool live = i < nb;
    const float v = live ? border[i] : 0.f;
    int rank = 0;
    if (live) {
#pragma unroll 4
      for (int j = part * n; j < (part + 1) * n; ++j) {
        const float u = border[j];
        rank += (u < v || (u == v && j < i)) ? 1 : 0;
      }
    }
    rank += __shfl_xor_sync(0xffffffffu, rank, 1);
    rank += __shfl_xor_sync(0xffffffffu, rank, 2);
    if (live && part == 0) {
      if (isnan(v)) {
        has_nan = 1;
      } else {
        if (rank == lo) mid[0] = v;
        if (rank == hi) mid[1] = v;
      }
    }
  }
  __syncthreads();
  const float bkg = has_nan ? __int_as_float(0x7fc00000)
                            : __fmul_rn(__fadd_rn(mid[0], mid[1]), 0.5f);
  // the stamp's f32 sum in the order of a 256-thread block: lane t < 256
  // the pixels t, t + 256, ..., then the warps' butterflies (the other
  // warps add zeros)
  float acc = 0.f;
  if (t < kSumLanes)
    for (int i = t; i < nn; i += kSumLanes) {
      const float v = __fsub_rn(st[i], bkg);
      st[i] = v;
      acc += v;
    }
  const float total = block_sum(acc, red);
  const bool pos = total > 0.f;
  const float div = pos ? total : 1.f;
  float* out = stamps + (long long)s * nn;
  for (int i = t; i < nn; i += T) out[i] = __fdiv_rn(st[i], div);
  if (t == 0) good0[s] = (ok && pos) ? 1 : 0;
}

// ---- H18 -------------------------------------------------------------------

// H18's cluster: the blocks that split a stamp's pixels (8 beat one block
// of 640 threads and a cluster of 16 on an H100; PERF.md has the times)
constexpr int kClipBlocks = 8;
// a block's shared memory on sm_90 (227 KB), less H18's static arrays
constexpr size_t kClipSmem = 232448 - 256;
constexpr float kBelow5 = 0x1.3fffecp+2f;   // 5 (1 - 2^-20)
constexpr float kAbove5 = 0x1.400014p+2f;   // 5 (1 + 2^-20)

// a block's threads: one a pixel of its share (npix <= 1024)
constexpr int kClipThreads = 1024 / kClipBlocks;

template <bool kStaged>
__global__ void __launch_bounds__(kClipThreads)
    psf_clip_kernel(const float* __restrict__ stamps,
                    const uint8_t* __restrict__ good0, int S, int npix,
                    int chunk, int iters, float* __restrict__ psf,
                    uint8_t* __restrict__ good_out) {
  extern __shared__ __align__(16) unsigned smem[];
  const int nw = (S + 31) >> 5;
  unsigned* g0w = smem;                 // good0's bits
  unsigned* gw = g0w + nw;              // the good bits of the pass
  unsigned* fw = gw + nw;               // 2 x nw: a pass's failures
  float* st = reinterpret_cast<float*>(fw + 2 * nw);  // 32 nw x T values
  __shared__ float red[32];
  __shared__ float part[kClipBlocks];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks(), b = (int)cluster.block_rank();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int p = b * chunk + t;
  const bool live = t < chunk && p < npix;
  const float* src = stamps + p;
  // staged: stamp s's value of the block's pixel t at st[s T + t] for the
  // 32 nw stamps of the words, 0 past S and off the pixels, so that the
  // loops read whole words without a guard
  const int T = blockDim.x;
  if (kStaged)
    for (int s = 0; s < 32 * nw; ++s) {
      if (live && s < S)
        __pipeline_memcpy_async(st + s * T + t, src + (long long)s * npix,
                                sizeof(float));
      else
        st[s * T + t] = 0.f;
    }
  __pipeline_commit();
  for (int w = warp; w < nw; w += nwarps) {
    const int s = 32 * w + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, s < S && good0[s]);
    if (lane == 0) {
      g0w[w] = gw[w] = bits;
      fw[w] = fw[nw + w] = 0u;
    }
  }
  __pipeline_wait_prior(0);
  // every block's words cleared before any block ORs into them
  cluster.sync();
  // a word of 32 stamps' values of the thread's pixel, in registers (0
  // past S and off the pixels)
  float v[32];
  auto load = [&](int w) {
    const float* col = st + 32 * w * T + t;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int s = 32 * w + j;
      v[j] = kStaged ? col[j * T]
                     : (live && s < S ? src[(long long)s * npix] : 0.f);
    }
  };
  float mean;
  for (int pass = 0;; ++pass) {
    int cnt = 0;
    for (int w = 0; w < nw; ++w) cnt += __popc(gw[w]);
    const float nf = fmaxf((float)cnt, 1.f);
    // past S a word adds 0 * 0 = +0, which leaves the sum (never -0: it
    // starts at +0) as it is
    mean = 0.f;
    for (int w = 0; w < nw; ++w) {
      load(w);
      const unsigned g = gw[w];
#pragma unroll
      for (int j = 0; j < 32; ++j)
        mean = __fadd_rn(mean, __fmul_rn(v[j], (g >> j) & 1u ? 1.f : 0.f));
    }
    mean = __fdiv_rn(mean, nf);
    if (pass == iters) break;
    float var = 0.f;
    for (int w = 0; w < nw; ++w) {
      load(w);
      const unsigned g = gw[w];
      const int m = S - 32 * w;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float d = __fsub_rn(v[j], mean);
        if (j < m)
          var = __fadd_rn(var, __fmul_rn(__fmul_rn(d, d),
                                         (g >> j) & 1u ? 1.f : 0.f));
      }
    }
    var = __fdiv_rn(var, nf);
    const float den = __fadd_rn(__fsqrt_rn(nan_maximum(var, 1e-20f)), 1e-12f);
    const float r = __frcp_rn(den);
    unsigned* out = fw + (pass & 1) * nw;
    for (int w = 0; w < nw; ++w) {
      load(w);
      const int m = S - 32 * w;
      // the lane's bits: stamp j's quotient may reach 5 (q >= kBelow5 or
      // NaN), and of those, its q lies in the band or is NaN
      unsigned fail = 0u, band = 0u;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float q = __fmul_rn(fabsf(__fsub_rn(v[j], mean)), r);
        const bool in = live && j < m && !(q < kBelow5);
        fail |= (in ? 1u : 0u) << j;
        band |= (in && !(q > kAbove5) ? 1u : 0u) << j;
      }
      // there the division decides (rare)
      if (__any_sync(0xffffffffu, band != 0u)) {
        for (unsigned rest = band; rest; rest &= rest - 1) {
          const int j = __ffs(rest) - 1, s = 32 * w + j;
          const float x = kStaged ? st[s * T + t] : src[(long long)s * npix];
          if (__fdiv_rn(fabsf(__fsub_rn(x, mean)), den) < 5.f)
            fail &= ~(1u << j);
        }
      }
      // bit j: any lane's pixel fails stamp j (the stamp's vote)
      const unsigned bad = __reduce_or_sync(0xffffffffu, fail);
      if (lane == 0 && bad)
        for (int q = 0; q < G; ++q)
          atomicOr(cluster.map_shared_rank(out + w, q), bad);
    }
    cluster.sync();
    // a word's thread reads it and clears it: the next OR into this buffer
    // comes two passes on, after the next cluster barrier
    for (int w = t; w < nw; w += blockDim.x) {
      gw[w] = g0w[w] & ~out[w];
      out[w] = 0u;
    }
    __syncthreads();
  }
  const float pos = live ? (isnan(mean) ? mean : fmaxf(mean, 0.f)) : 0.f;
  float tot = block_sum(pos, red);
  if (G > 1) {
    if (t == 0)
      for (int q = 0; q < G; ++q) *cluster.map_shared_rank(part + b, q) = tot;
    cluster.sync();
    tot = part[0];
    for (int q = 1; q < G; ++q) tot = __fadd_rn(tot, part[q]);
  }
  if (live) psf[p] = __fdiv_rn(pos, nan_maximum(tot, 1e-20f));
  if (b == 0)
    for (int s = t; s < S; s += blockDim.x)
      good_out[s] = (gw[s >> 5] >> (s & 31)) & 1u;
}

int grid_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return (int)(want < 1 ? 1 : (want > 132 * 8 ? 132 * 8 : want));
}

}  // namespace

// dmax: one uint32 of scratch (the bits of max denom), zeroed here.
extern "C" int zuds_zogy_spectral(const float2* N, const float2* R,
                                  const float2* Pn, const float2* Pr,
                                  long long n, float c_r, float c_n,
                                  float f_ref, float f_new, float f_rn,
                                  float f_d, unsigned* dmax, float2* D,
                                  float2* Pd, float2* S,
                                  cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(dmax, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  const int grid = grid_for(n);
  spectral_max_kernel<<<grid, kThreads, 0, stream>>>(Pn, Pr, n, c_r, c_n,
                                                     dmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  spectral_kernel<<<grid, kThreads, 0, stream>>>(N, R, Pn, Pr, n, c_r, c_n,
                                                 f_ref, f_new, f_rn, f_d,
                                                 dmax, D, Pd, S);
  return (int)cudaGetLastError();
}

namespace {

// H16's grid: at most the blocks that fit on the card at once (the
// cooperative launch needs them co-resident) and `max_blocks`, at least
// one, and no more than one a kNormThreads chunks
template <typename T>
cudaError_t normalize_grid(long long nv, int max_blocks, int* grid) {
  static int cap = 0;    // set once, outside any graph capture
  if (cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, normalize_kernel<T>, kNormThreads, 0);
    if (err != cudaSuccess) return err;
    cap = sms * per_sm;
  }
  const long long want = (nv + kNormThreads - 1) / kNormThreads;
  long long g = want < cap ? want : cap;
  if (g > max_blocks) g = max_blocks;
  *grid = (int)(g < 1 ? 1 : g);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_normalize(const float* pd, const float* s, long long n,
                             float f_d, int max_blocks, double* partials,
                             float* out, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = normalize_grid<T>(n / (long long)(sizeof(T) / 4),
                                      max_blocks, &grid);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kNormThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  err = cudaLaunchKernelEx(&cfg, normalize_kernel<T>, pd, s, n, f_d, partials,
                           out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// partials: `max_blocks` doubles of scratch (one a block). The vector path
// (16-byte loads and stores) where p_d, s and out are 16-byte aligned.
extern "C" int zuds_zogy_normalize(const float* pd, const float* s,
                                   long long n, float f_d, int max_blocks,
                                   double* partials, float* out,
                                   cudaStream_t stream) {
  if (max_blocks < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(pd) |
                         reinterpret_cast<uintptr_t>(s) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  return (int)(aligned ? launch_normalize<float4>(pd, s, n, f_d, max_blocks,
                                                  partials, out, stream)
                       : launch_normalize<float>(pd, s, n, f_d, max_blocks,
                                                 partials, out, stream));
}

extern "C" int zuds_psf_stamps(const float* img, int H, int W,
                               const float* xs, const float* ys,
                               const uint8_t* valid, int S, int size,
                               float* stamps, uint8_t* good0,
                               cudaStream_t stream) {
  if (size < 1 || size > kMaxStamp || size > H || size > W)
    return (int)cudaErrorInvalidValue;
  if (S > 0)
    psf_stamps_kernel<<<S, kStampThreads, 0, stream>>>(img, H, W, xs, ys,
                                                       valid, size, stamps,
                                                       good0);
  return (int)cudaGetLastError();
}

extern "C" int zuds_psf_clip(const float* stamps, const uint8_t* good0,
                             int S, int npix, int iters, float* psf,
                             uint8_t* good, cudaStream_t stream) {
  if (npix < 1 || npix > 1024 || S < 1 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const int G = min(kClipBlocks, (npix + 31) / 32);
  const int chunk = (npix + G - 1) / G;
  const int threads = (chunk + 31) / 32 * 32;
  const size_t words = 4 * (size_t)((S + 31) / 32) * sizeof(unsigned);
  const size_t staged =
      words + (size_t)((S + 31) / 32 * 32) * threads * sizeof(float);
  const bool fits = staged <= kClipSmem;
  const size_t bytes = fits ? staged : words;
  if (bytes > kClipSmem) return (int)cudaErrorInvalidValue;
  const auto kernel = fits ? psf_clip_kernel<true> : psf_clip_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, stamps, good0, S, npix, chunk, iters,
                           psf, good);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
