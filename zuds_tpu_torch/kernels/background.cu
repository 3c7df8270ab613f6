// H2: background-mesh cell statistics, one CTA per box x box cell.
//
// Replaces the per-cell part of zuds_tpu/ops/background.py:background_mesh
// (:121-196): the 3 sigma-clip iterations on the stride-5 subsample of the
// cell's row-major pixels, each a 12-step value-space bisection median
// (bisect_median, :48-69) plus the clipped sigma; the subempty guard; the
// final full-resolution keep, mean / sigma / n, bisection median, sigma0
// and SExtractor's crowded-field mode rule. The TPU runs these as ~45
// full-frame reductions over a (ncy, ncx, box^2) tensor; here each cell is
// one block and every reduction is a block reduction.
//
// Layout: 512 threads; thread t holds pixels k = t + 512 j (j < box^2/512,
// at most 32) of the cell's row-major flattening in registers, with bit
// masks for valid / subsample / keep. Nothing of the cell is re-read from
// DRAM after the first load.
//
// Numerics kept from the reference: the one-pass variance s2/n - mean^2,
// the "cnt < half" bisection rule, and f32 rounding of every formula
// (__f*_rn intrinsics stop nvcc from contracting them). The sums s and s2
// are added in the order of the reference's CPU backend (sequential
// windows of 32, see ops/ordered.py) from a copy of the cell in shared
// memory, and the variance is rounded once (fmaf), as that backend
// evaluates it: a formula that cancels this much moves the sigma by 1e-4
// for one ulp of s2. The plain PyTorch version does the same, bit for bit.
//
// Bound: latency of ~75 block reductions per cell (600 cells per quadrant
// over 132 SMs); DRAM traffic is one read of the frame.
#include "common.cuh"
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPer = 32;

struct Shared {
  int i[kWarps];
  float f[kWarps];
  float g[kWarps];
};

__device__ __forceinline__ int block_sum_int(int v, Shared& sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();
  if (l == 0) sh.i[w] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) t += sh.i[k];
  return t;
}

__device__ __forceinline__ void block_minmax(float& lo, float& hi,
                                             Shared& sh) {
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();
  if (l == 0) {
    sh.f[w] = lo;
    sh.g[w] = hi;
  }
  __syncthreads();
  lo = INFINITY;
  hi = -INFINITY;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    lo = fminf(lo, sh.f[k]);
    hi = fmaxf(hi, sh.g[k]);
  }
}

struct Moments {
  float mean, sigma;
  int n;
};

// Dynamic shared memory of one cell: its pixel values, a per-pixel
// selection byte, and ping-pong buffers for the partial sums.
struct CellSmem {
  float* vals;           // box*box
  unsigned char* selb;   // box*box
  float* pa[2];          // kThreads each
  float* pb[2];
};

// One level of XLA:CPU's windowed sum (see ops/ordered.py): n > 32
// inputs, zero padding split evenly at both ends, sequential windows of
// 32. Returns the number of windows.
__device__ int sum_level(const float* ina, const float* inb, float* outa,
                         float* outb, int n) {
  const int p = (32 - n % 32) % 32, lo = p / 2, nw = (n + p) / 32;
  for (int w = threadIdx.x; w < nw; w += kThreads) {
    float a = 0.f, b = 0.f;
    for (int i = 0; i < 32; ++i) {
      const int s = 32 * w + i - lo;
      if (s >= 0 && s < n) {
        a = __fadd_rn(a, ina[s]);
        b = __fadd_rn(b, inb[s]);
      }
    }
    outa[w] = a;
    outb[w] = b;
  }
  return nw;
}

// stats() of background.py:138-144 over the selected pixels: the sums
// are added in the reference's order (the n elements are the cell's
// pixels k = s * stride, unselected ones counting as zeros), and the
// variance is the one-pass formula with one rounding (fmaf), as XLA's
// CPU backend evaluates it.
__device__ Moments moments(unsigned sel, int nv, int stride, int box2,
                           const CellSmem& cs, Shared& sh) {
  int c = 0;
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    if (j < nv) {
      const unsigned bit = (sel >> j) & 1u;
      c += (int)bit;
      cs.selb[threadIdx.x + kThreads * j] = (unsigned char)bit;
    }
  }
  c = block_sum_int(c, sh);   // also orders the selb writes
  int n = (box2 + stride - 1) / stride;
  int cur = 0;
  if (n > 32) {
    const int p = (32 - n % 32) % 32, lo = p / 2, nw = (n + p) / 32;
    for (int w = threadIdx.x; w < nw; w += kThreads) {
      float a = 0.f, b = 0.f;
      for (int i = 0; i < 32; ++i) {
        const int s = 32 * w + i - lo;
        if (s >= 0 && s < n) {
          const int k = s * stride;
          if (cs.selb[k]) {
            const float v = cs.vals[k];
            a = __fadd_rn(a, v);
            b = __fadd_rn(b, __fmul_rn(v, v));
          }
        }
      }
      cs.pa[0][w] = a;
      cs.pb[0][w] = b;
    }
    n = nw;
    __syncthreads();
    while (n > 32) {
      n = sum_level(cs.pa[cur], cs.pb[cur], cs.pa[cur ^ 1], cs.pb[cur ^ 1],
                    n);
      cur ^= 1;
      __syncthreads();
    }
  } else {
    for (int s = threadIdx.x; s < n; s += kThreads) {
      const int k = s * stride;
      const float v = cs.selb[k] ? cs.vals[k] : 0.f;
      cs.pa[0][s] = v;
      cs.pb[0][s] = cs.selb[k] ? __fmul_rn(v, v) : 0.f;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int i = 0; i < n; ++i) {
      a = __fadd_rn(a, cs.pa[cur][i]);
      b = __fadd_rn(b, cs.pb[cur][i]);
    }
    sh.f[0] = a;
    sh.g[0] = b;
  }
  __syncthreads();
  const float sf = sh.f[0], s2f = sh.g[0];
  __syncthreads();   // sh.f / sh.g are reused by the next reduction
  Moments m;
  m.n = c > 1 ? c : 1;
  const float nf = (float)m.n;
  m.mean = __fdiv_rn(sf, nf);
  m.sigma = sqrtf(fmaxf(fmaf(-m.mean, m.mean, __fdiv_rn(s2f, nf)), 0.f));
  return m;
}

// bisect_median of background.py:48-69 over the pixels in `sel`
__device__ float bisect_median(const float* x, unsigned sel, int nv,
                               int iters, Shared& sh) {
  float lo = INFINITY, hi = -INFINITY;
  int c = 0;
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    if (j < nv && ((sel >> j) & 1u)) {
      lo = fminf(lo, x[j]);
      hi = fmaxf(hi, x[j]);
      ++c;
    }
  }
  block_minmax(lo, hi, sh);
  const float half = __fmul_rn((float)block_sum_int(c, sh), 0.5f);
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int k = 0;
#pragma unroll
    for (int j = 0; j < kMaxPer; ++j)
      k += (j < nv && ((sel >> j) & 1u) && x[j] <= mid) ? 1 : 0;
    const bool go_up = (float)block_sum_int(k, sh) < half;
    lo = go_up ? mid : lo;
    hi = go_up ? hi : mid;
  }
  return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

__device__ __forceinline__ unsigned clip_keep(const float* x, unsigned sel,
                                              int nv, float lo, float hi) {
  unsigned out = 0u;
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j)
    if (j < nv && ((sel >> j) & 1u) && x[j] >= lo && x[j] <= hi)
      out |= 1u << j;
  return out;
}

__global__ void __launch_bounds__(kThreads)
background_cells_kernel(const float* __restrict__ img,
                        const unsigned char* __restrict__ valid,
                        float* __restrict__ back_out,
                        float* __restrict__ sigma_out, int* __restrict__ n_out,
                        int H, int W, int box, int iters, int sstep) {
  __shared__ Shared sh;
  extern __shared__ float dyn[];
  const int box2 = box * box;
  CellSmem cs;
  cs.vals = dyn;
  cs.pa[0] = dyn + box2;
  cs.pa[1] = cs.pa[0] + kThreads;
  cs.pb[0] = cs.pa[1] + kThreads;
  cs.pb[1] = cs.pb[0] + kThreads;
  cs.selb = reinterpret_cast<unsigned char*>(cs.pb[1] + kThreads);
  const int ncx = (W + box - 1) / box;
  const int cell_y = blockIdx.x / ncx, cell_x = blockIdx.x % ncx;
  const int nv = box2 / kThreads;

  float x[kMaxPer];
  unsigned vbits = 0u, subbits = 0u;
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    x[j] = 0.f;
    if (j < nv) {
      const int k = threadIdx.x + kThreads * j;
      const int yy = cell_y * box + k / box, xx = cell_x * box + k % box;
      if (yy < H && xx < W) {
        const size_t i = (size_t)yy * W + xx;
        const float val = img[i];
        if (valid[i] && isfinite(val)) {
          x[j] = val;
          vbits |= 1u << j;
        }
      }
      cs.vals[k] = x[j];
      if (k % sstep == 0) subbits |= 1u << j;
    }
  }
  const unsigned vsub = vbits & subbits;
  const bool subempty = block_sum_int(__popc(vsub), sh) == 0;

  // sigma-clip iterations on the subsample (background.py:172-179)
  unsigned keeps = vsub;
  for (int it = 0; it < iters; ++it) {
    const float med = bisect_median(x, keeps, nv, 12, sh);
    const float sig = moments(keeps, nv, sstep, box2, cs, sh).sigma;
    const float t = __fmul_rn(3.f, sig);
    keeps = clip_keep(x, vsub, nv, __fsub_rn(med, t), __fadd_rn(med, t));
  }
  const float med_s = bisect_median(x, keeps, nv, 12, sh);
  const float t_s = __fmul_rn(3.f, moments(keeps, nv, sstep, box2, cs, sh).sigma);
  const float lo = subempty ? -INFINITY : __fsub_rn(med_s, t_s);
  const float hi = subempty ? INFINITY : __fadd_rn(med_s, t_s);

  // final full-resolution estimators (background.py:184-196)
  const unsigned keep = clip_keep(x, vbits, nv, lo, hi);
  const Moments m = moments(keep, nv, 1, box2, cs, sh);
  const float med = bisect_median(x, keep, nv, 12, sh);
  const float sigma0 = moments(vbits, nv, 1, box2, cs, sh).sigma;
  const bool uncrowded =
      subempty || fabsf(__fsub_rn(m.sigma, sigma0)) <
                      __fmul_rn(0.2f, sigma0 == 0.f ? 1.f : sigma0);
  const float back =
      uncrowded ? m.mean
                : __fsub_rn(__fmul_rn(2.5f, med), __fmul_rn(1.5f, m.mean));
  if (threadIdx.x == 0) {
    back_out[blockIdx.x] = back;
    sigma_out[blockIdx.x] = m.sigma;
    n_out[blockIdx.x] = m.n;
  }
}

}  // namespace

extern "C" int zuds_background_cells(const float* img,
                                     const unsigned char* valid, float* back,
                                     float* sigma, int* n, int H, int W,
                                     int box, int iters, cudaStream_t stream) {
  const int ncy = (H + box - 1) / box, ncx = (W + box - 1) / box;
  const int sstep = box * box >= 4096 ? 5 : 1;
  const size_t smem = (size_t)box * box * (sizeof(float) + 1) +
                      4 * kThreads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      background_cells_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  background_cells_kernel<<<ncy * ncx, kThreads, smem, stream>>>(
      img, valid, back, sigma, n, H, W, box, iters, sstep);
  return (int)cudaGetLastError();
}
