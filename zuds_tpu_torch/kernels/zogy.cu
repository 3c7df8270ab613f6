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
// H18 replaces zogy.py:116-132: one block, a thread per pixel. Each of the
// clip passes sums the good stamps in stamp order for the mean and the
// variance, and the largest |s - mean| / (sig + 1e-12) of each stamp is a
// warp-shuffle maximum and a shared atomicMax per warp; a stamp stays good
// while that stays under 5. The final mean is clamped at 0 and divided by
// its block sum. NaN flows as in the reference: s * g keeps a NaN of a
// dropped stamp.
#include "common.cuh"

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

__global__ void psf_clip_kernel(const float* __restrict__ stamps,
                                const uint8_t* __restrict__ good0, int S,
                                int npix, int iters, float* __restrict__ psf,
                                uint8_t* __restrict__ good_out) {
  extern __shared__ unsigned smem[];
  unsigned* dev = smem;                                   // S keys
  uint8_t* good = reinterpret_cast<uint8_t*>(smem + S);   // S flags
  __shared__ float red[32];
  __shared__ float s_n;
  const int p = threadIdx.x, lane = p & 31;
  const bool live = p < npix;
  for (int s = p; s < S; s += blockDim.x) good[s] = good0[s] ? 1 : 0;
  __syncthreads();
  for (int pass = 0; pass <= iters; ++pass) {
    if (p == 0) {
      int cnt = 0;
      for (int s = 0; s < S; ++s) cnt += good[s];
      s_n = fmaxf((float)cnt, 1.f);
    }
    for (int s = p; s < S; s += blockDim.x) dev[s] = 0u;
    __syncthreads();
    const float nf = s_n;
    float mean = 0.f;
    if (live) {
      for (int s = 0; s < S; ++s)
        mean = __fadd_rn(mean, __fmul_rn(stamps[(long long)s * npix + p],
                                         good[s] ? 1.f : 0.f));
      mean = __fdiv_rn(mean, nf);
    }
    if (pass == iters) {              // the final mean
      float v = live ? (isnan(mean) ? mean : fmaxf(mean, 0.f)) : 0.f;
      const float tot = block_sum(v, red);
      if (live) psf[p] = __fdiv_rn(v, nan_maximum(tot, 1e-20f));
      break;
    }
    float den = 1.f;
    if (live) {
      float var = 0.f;
      for (int s = 0; s < S; ++s) {
        const float d = __fsub_rn(stamps[(long long)s * npix + p], mean);
        var = __fadd_rn(var, __fmul_rn(__fmul_rn(d, d), good[s] ? 1.f : 0.f));
      }
      var = __fdiv_rn(var, nf);
      den = __fadd_rn(__fsqrt_rn(nan_maximum(var, 1e-20f)), 1e-12f);
    }
    for (int s = 0; s < S; ++s) {
      float v = live ? __fdiv_rn(fabsf(__fsub_rn(
                                     stamps[(long long)s * npix + p], mean)),
                                 den)
                     : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane == 0) atomicMax(&dev[s], max_key(v));
    }
    __syncthreads();
    for (int s = p; s < S; s += blockDim.x)
      good[s] = (good0[s] && __uint_as_float(dev[s]) < 5.f) ? 1 : 0;
    __syncthreads();
  }
  for (int s = p; s < S; s += blockDim.x) good_out[s] = good[s];
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
  const int threads = (npix + 31) / 32 * 32;
  const size_t shared = (size_t)S * (sizeof(unsigned) + 1);
  psf_clip_kernel<<<1, threads, shared, stream>>>(stamps, good0, S, npix,
                                                  iters, psf, good);
  return (int)cudaGetLastError();
}
