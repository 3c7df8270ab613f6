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
// scalar, then s_corr = s / (f_d sqrt(max(sum, 1e-20))). Launch one: each
// block sums its grid-stride share of the f32 squares in double and
// writes its partial; the last block to finish (a counter) adds the
// partials in block order, so the sum is the same every run and is
// rounded to f32 once. Launch two scales s. Bound: memory, 12 B per pixel.
//
// H17 replaces zogy.py:89-114 (estimate_psf_from_stars's cuts): one block
// per star. The block cuts the size x size window at the clamped corner
// of the position rounded half to even, shifts it by the sub-pixel offset
// through the Fourier phase ramp as a direct DFT along each axis in shared
// memory, keeps the real part rounded once to f32, takes the median of the
// 4 size border values as jnp.median does (the midpoint of the two middle
// values by rank; NaN when one is NaN), subtracts it, sums the stamp and
// writes it divided by its sum where that is positive, and good0 = valid &
// (sum > 0). The transforms run in double (twiddles from sincospi): in f32
// a cut on a sky pedestal (an aligned reference keeps its ~150 counts)
// carries the pedestal's rounding into every mode, which put single
// stamps 1e-6 apart from an f32 cuFFT. The plain version transforms in
// double too, so the two agree to the final f32 rounding. The ramp is the
// reference's: its argument 2 pi (fy dy + fx dx) and fftfreq's k / n
// rounded in f32, cosf and sinf. Bound: ~0.46 MFLOP per stamp (fp64) and
// 5 KB read and written, about a microsecond for 64.
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

__global__ void __launch_bounds__(kThreads)
    sumsq_kernel(const float* __restrict__ pd, long long n,
                 double* __restrict__ partials, unsigned* __restrict__ done,
                 float* __restrict__ total) {
  __shared__ double red[kThreads / 32];
  __shared__ bool last;
  double acc = 0.0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = pd[i];
    acc += (double)__fmul_rn(v, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
    partials[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    double s = 0.0;
    for (unsigned b = 0; b < gridDim.x; ++b)
      s += ((volatile double*)partials)[b];
    *total = (float)s;
  }
}

__global__ void __launch_bounds__(kThreads)
    scale_kernel(const float* __restrict__ s, long long n, float f_d,
                 const float* __restrict__ total, float* __restrict__ out) {
  const float t = *total;
  const float norm =
      __fmul_rn(f_d, __fsqrt_rn(isnan(t) ? t : fmaxf(t, 1e-20f)));
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = __fdiv_rn(s[i], norm);
}

// ---- H17 -------------------------------------------------------------------

// one DFT pass over the n x n complex plane (in_re, in_im; in_im null for
// a real plane) along rows (along_x) or columns, with twiddles tw[k] =
// exp(-2 pi i k / n), conjugated for the inverse
__device__ void dft_pass(const double* in_re, const double* in_im,
                         double* out_re, double* out_im, const double2* tw,
                         int n, bool along_x, bool inverse) {
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int r = i / n, c = i - r * n;
    const int k = along_x ? c : r;         // the output frequency
    double acc_re = 0.0, acc_im = 0.0;
    for (int m = 0; m < n; ++m) {
      const int j = along_x ? r * n + m : m * n + c;
      const double2 w = tw[(k * m) % n];
      const double wi = inverse ? -w.y : w.y;
      const double xr = in_re[j], xi = in_im ? in_im[j] : 0.0;
      acc_re = fma(xr, w.x, fma(-xi, wi, acc_re));
      acc_im = fma(xr, wi, fma(xi, w.x, acc_im));
    }
    out_re[i] = acc_re;
    out_im[i] = acc_im;
  }
}

__global__ void __launch_bounds__(kThreads)
    psf_stamps_kernel(const float* __restrict__ img, int H, int W,
                      const float* __restrict__ xs,
                      const float* __restrict__ ys,
                      const uint8_t* __restrict__ valid, int n,
                      float* __restrict__ stamps,
                      uint8_t* __restrict__ good0) {
  __shared__ double2 tw[kMaxStamp];
  __shared__ float fq[kMaxStamp];
  __shared__ double a_re[kMaxStamp * kMaxStamp], a_im[kMaxStamp * kMaxStamp];
  __shared__ double b_re[kMaxStamp * kMaxStamp], b_im[kMaxStamp * kMaxStamp];
  __shared__ float st[kMaxStamp * kMaxStamp];
  __shared__ float border[4 * kMaxStamp];
  __shared__ float red[kThreads / 32];
  __shared__ float mid[2];
  __shared__ int has_nan;
  const int s = blockIdx.x, t = threadIdx.x, nn = n * n, half = n / 2;
  const float x = xs[s], y = ys[s];
  const int x0 = min(max((int)rintf(x) - half, 0), W - n);
  const int y0 = min(max((int)rintf(y) - half, 0), H - n);
  const float dx = __fsub_rn(x, (float)(x0 + half));
  const float dy = __fsub_rn(y, (float)(y0 + half));
  if (t < n) {
    double sv, cv;
    sincospi(2.0 * t / n, &sv, &cv);
    tw[t] = make_double2(cv, -sv);
    fq[t] = __fdiv_rn((float)((t + n / 2) % n - n / 2), (float)n);
  }
  if (t == 0) has_nan = 0;
  for (int i = t; i < nn; i += blockDim.x) {
    const int r = i / n, c = i - r * n;
    a_re[i] = (double)img[(long long)(y0 + r) * W + x0 + c];
  }
  __syncthreads();
  // forward along x, then along y, then the phase ramp
  dft_pass(a_re, nullptr, b_re, b_im, tw, n, true, false);
  __syncthreads();
  dft_pass(b_re, b_im, a_re, a_im, tw, n, false, false);
  __syncthreads();
  for (int i = t; i < nn; i += blockDim.x) {
    const int u = i / n, v = i - u * n;
    const float th = __fmul_rn(
        kTwoPi, __fadd_rn(__fmul_rn(fq[u], dy), __fmul_rn(fq[v], dx)));
    const double er = cosf(th), ei = sinf(th), fr = a_re[i], fi = a_im[i];
    a_re[i] = fr * er - fi * ei;
    a_im[i] = fr * ei + fi * er;
  }
  __syncthreads();
  // inverse along y, then along x: the real part over n^2, rounded once
  dft_pass(a_re, a_im, b_re, b_im, tw, n, false, true);
  __syncthreads();
  dft_pass(b_re, b_im, a_re, a_im, tw, n, true, true);
  __syncthreads();
  for (int i = t; i < nn; i += blockDim.x) st[i] = (float)(a_re[i] / nn);
  __syncthreads();
  // the border: row 0, row n-1, column 0, column n-1
  const int nb = 4 * n;
  for (int i = t; i < nb; i += blockDim.x) {
    const int side = i / n, j = i - side * n;
    const int at = side == 0 ? j : side == 1 ? (n - 1) * n + j
                   : side == 2 ? j * n : j * n + n - 1;
    border[i] = st[at];
  }
  __syncthreads();
  const int lo = (nb - 1) / 2, hi = nb / 2;
  for (int i = t; i < nb; i += blockDim.x) {
    const float v = border[i];
    if (isnan(v)) {
      has_nan = 1;
      continue;
    }
    int rank = 0;
    for (int j = 0; j < nb; ++j) {
      const float u = border[j];
      rank += (u < v || (u == v && j < i)) ? 1 : 0;
    }
    if (rank == lo) mid[0] = v;
    if (rank == hi) mid[1] = v;
  }
  __syncthreads();
  const float bkg = has_nan ? __int_as_float(0x7fc00000)
                            : __fmul_rn(__fadd_rn(mid[0], mid[1]), 0.5f);
  float acc = 0.f;
  for (int i = t; i < nn; i += blockDim.x) {
    const float v = __fsub_rn(st[i], bkg);
    st[i] = v;
    acc += v;
  }
  const float total = block_sum(acc, red);
  const bool pos = total > 0.f;
  const float div = pos ? total : 1.f;
  float* out = stamps + (long long)s * nn;
  for (int i = t; i < nn; i += blockDim.x) out[i] = __fdiv_rn(st[i], div);
  if (t == 0) good0[s] = (valid[s] != 0 && pos) ? 1 : 0;
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

// partials: `blocks` doubles; done: one uint32, zeroed here; total: the
// f32 sum of squares.
extern "C" int zuds_zogy_normalize(const float* pd, const float* s,
                                   long long n, float f_d, int blocks,
                                   double* partials, unsigned* done,
                                   float* total, float* out,
                                   cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(done, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  sumsq_kernel<<<blocks, kThreads, 0, stream>>>(pd, n, partials, done,
                                                total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scale_kernel<<<grid_for(n), kThreads, 0, stream>>>(s, n, f_d, total, out);
  return (int)cudaGetLastError();
}

extern "C" int zuds_psf_stamps(const float* img, int H, int W,
                               const float* xs, const float* ys,
                               const uint8_t* valid, int S, int size,
                               float* stamps, uint8_t* good0,
                               cudaStream_t stream) {
  if (size < 1 || size > kMaxStamp || size > H || size > W)
    return (int)cudaErrorInvalidValue;
  if (S > 0)
    psf_stamps_kernel<<<S, kThreads, 0, stream>>>(img, H, W, xs, ys, valid,
                                                  size, stamps, good0);
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
