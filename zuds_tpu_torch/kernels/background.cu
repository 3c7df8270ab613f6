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
// Layout: box^2 / 32 threads (512 at box 128). The cell's row-major pixels
// k sit in shared memory at k + k / 32 (NaN where invalid or not finite),
// so a thread's window of 32 and a lane's stride-5 samples read without
// bank conflicts. A selection is never stored: "kept" is clo <= v <= chi
// with block-uniform bounds (NaN fails both), so each pass re-derives it.
//
// Bisection, L rounds a block reduction. The mids of the next L rounds
// follow from (lo, hi) before any is decided (node j of the pass's tree
// holds the mid the plain version forms if its descent reaches j, with the
// same f32 arithmetic), so each thread counts its kept values <= each of
// the 2^L - 1 mids, one block reduction (a REDUX a word in each warp, one
// shared-memory step, two 16-bit counts a word) sums them, and every
// thread replays the L rounds from the sums with the plain version's
// update, bit for bit. A median is one min / max / count reduction and
// 12 / L count reductions (7 at L = 2, against 14 one round a reduction).
// L = 2 beat L = 3 and 4: the compares (2^L - 1 a kept value a pass) cost
// more than the reductions they save.
//
// Sums: XLA:CPU's order (sequential windows of 32, zero padding split at
// both ends, see ops/ordered.py), each window's 32 terms loaded before its
// serial adds, the last <= 32 partials added by every thread. Their levels
// ride on the barriers of the bisection over the same keep (no barrier of
// their own); the final mean / sigma over the keep and sigma0 over the
// valid pixels are one pass whose second level is a warp's ordered shuffle
// sum. Numerics kept from the reference: the one-pass variance s2/n -
// mean^2 rounded once (fmaf, as XLA's CPU backend evaluates it), the "cnt
// < half" rule, and f32 rounding of every formula (__f*_rn intrinsics stop
// nvcc from contracting them). The plain PyTorch version does the same,
// bit for bit.
//
// Bound: latency. A cell is 36 barriers (the load, 7 a median) and the
// compares of its counts; two 512-thread blocks an SM (600 cells per
// quadrant in three waves). DRAM traffic is one read of the frame.
#include "common.cuh"
#include <math.h>

// rounds settled per block reduction (1, 2, 3 or 4)
#define ZUDS_BG_L 2

namespace {

constexpr int kPer = 32;                 // a thread's window of the cell
constexpr int kMaxThreads = 512;         // box 128: 16384 / 32
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kRounds = 12;              // bisect_median's iters
constexpr int kL = ZUDS_BG_L;
static_assert(kL >= 1 && kL <= 4 && kRounds % kL == 0,
              "L must divide 12, with at most 15 mids");
constexpr int kMids = (1 << kL) - 1;
constexpr int kWords = (kMids + 1) / 2;  // two 16-bit counts a word
constexpr int kRedWords = kWords > 4 ? kWords : 4;
// the largest cell's shared memory: 16384 pixels and a pad word a window
constexpr int kMaxCellBytes = (16384 + 16384 / 32) * 4;

// windows of the subsample's first level (box 128: 3277 samples, 103)
constexpr int kSubWindows = 128;
// samples a thread keeps in registers: ceil(box^2 / 5 / (box^2 / 32)) for
// box >= 64
constexpr int kSubRegs = 7;

struct Shared {
  unsigned red[2][kMaxWarps][kRedWords]; // block reductions, two buffers
  float pa[2][kSubWindows];              // the subsample's first level
  float pb[4][32];                       // a second level
};

// pixel k of the cell in shared memory
__device__ __forceinline__ int at(int k) { return k + (k >> 5); }

__device__ __forceinline__ float mid_of(float lo, float hi) {
  return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

__device__ __forceinline__ bool kept(float v, float clo, float chi) {
  return v >= clo && v <= chi;
}

// Float order as signed int order (the values here are never NaN), for
// the warp's integer min / max.
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// Block sum of N words; every thread gets the totals: a warp reduction
// (one REDUX a word), one shared-memory step, a second warp reduction. One
// barrier: the two buffers alternate (`flip`), so a buffer is written again
// only after the next reduction's barrier, which every reader has passed.
template <int N>
__device__ __forceinline__ void block_sum(unsigned (&v)[N], Shared& sh,
                                          int& flip) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __reduce_add_sync(0xffffffffu, v[i]);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) sh.red[flip][warp][i] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = __reduce_add_sync(0xffffffffu,
                             lane < nw ? sh.red[flip][lane][i] : 0u);
  flip ^= 1;
}

// The block's min and max of lo / hi and sums of c / cv, as block_sum.
__device__ __forceinline__ void block_minmax_count(float& lo, float& hi,
                                                   unsigned& c, unsigned& cv,
                                                   Shared& sh, int& flip) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int ilo = __reduce_min_sync(0xffffffffu, ordered(lo));
  int ihi = __reduce_max_sync(0xffffffffu, ordered(hi));
  c = __reduce_add_sync(0xffffffffu, c);
  cv = __reduce_add_sync(0xffffffffu, cv);
  if (lane == 0) {
    sh.red[flip][warp][0] = (unsigned)ilo;
    sh.red[flip][warp][1] = (unsigned)ihi;
    sh.red[flip][warp][2] = c;
    sh.red[flip][warp][3] = cv;
  }
  __syncthreads();
  const bool in = lane < nw;
  ilo = __reduce_min_sync(0xffffffffu,
                          in ? (int)sh.red[flip][lane][0] : 0x7fffffff);
  ihi = __reduce_max_sync(0xffffffffu,
                          in ? (int)sh.red[flip][lane][1] : (int)0x80000000);
  c = __reduce_add_sync(0xffffffffu, in ? sh.red[flip][lane][2] : 0u);
  cv = __reduce_add_sync(0xffffffffu, in ? sh.red[flip][lane][3] : 0u);
  lo = unordered(ilo);
  hi = unordered(ihi);
  flip ^= 1;
}

// The pass's mids in order: node j at depth d lies between its nearest
// ancestors j -+ 2^(L-1-d) (lo, hi past the ends), formed level by level
// as the plain version forms each along its descent.
__device__ __forceinline__ void pass_mids(float lo, float hi,
                                          float (&t)[kMids]) {
#pragma unroll
  for (int d = 0; d < kL; ++d) {
    const int h = 1 << (kL - 1 - d);
#pragma unroll
    for (int j = h - 1; j < kMids; j += 2 * h)
      t[j] = mid_of(j - h < 0 ? lo : t[j - h], j + h >= kMids ? hi : t[j + h]);
  }
}

// The pass's L rounds from le[j], the kept values <= the mid of node j.
__device__ __forceinline__ void replay(float& lo, float& hi, float half,
                                       const unsigned (&le)[kMids]) {
  int node = (1 << (kL - 1)) - 1;
#pragma unroll
  for (int d = kL - 2; d >= -1; --d) {
    const float mid = mid_of(lo, hi);
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < kMids; ++j) c = j == node ? le[j] : c;
    const bool up = __uint2float_rn(c) < half;
    lo = up ? mid : lo;
    hi = up ? hi : mid;
    if (d >= 0) node += up ? (1 << d) : -(1 << d);
  }
}

// bisect_median of background.py:48-69 over the values that `each(f)`
// hands this thread, the kept ones as they are and the others as NaN
// (never <= a mid, and fminf / fmaxf pass over it); *count: the block's
// kept values; *valid: the block's sum of `cv`. `side.stage(k)` runs
// before the bisection's k-th block reduction (k = 0, 1, 2), so that a
// windowed sum's levels share its barriers.
template <typename Each, typename Side>
__device__ __forceinline__ float bisect(Each each, unsigned cv, int* count,
                                        int* valid, Side& side, Shared& sh,
                                        int& flip) {
  float lo = INFINITY, hi = -INFINITY;
  unsigned c = 0;
  each([&](float v) {
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
    c += v == v;
  });
  side.stage(0, sh);
  block_minmax_count(lo, hi, c, cv, sh, flip);
  *count = (int)c;
  *valid = (int)cv;
  const float half = __fmul_rn(__uint2float_rn(c), 0.5f);
#ifdef ZUDS_BG_PROBE_ONE_PASS
  for (int r = 0; r < kL; r += kL) {
#else
  for (int r = 0; r < kRounds; r += kL) {
#endif
    float t[kMids];
    pass_mids(lo, hi, t);
    unsigned le[kMids];
#pragma unroll
    for (int j = 0; j < kMids; ++j) le[j] = 0;
    each([&](float v) {
#pragma unroll
      for (int j = 0; j < kMids; ++j) le[j] += v <= t[j] ? 1 : 0;
    });
    unsigned w[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      w[i] = le[2 * i] | (2 * i + 1 < kMids ? le[2 * i + 1] << 16 : 0u);
    if (r / kL < 2) side.stage(1 + r / kL, sh);
    block_sum(w, sh, flip);
#pragma unroll
    for (int j = 0; j < kMids; ++j)
      le[j] = (w[j / 2] >> (16 * (j & 1))) & 0xffffu;
    replay(lo, hi, half, le);
  }
#ifdef ZUDS_BG_PROBE_ONE_PASS
  side.stage(2, sh);
  __syncthreads();
#endif
  return mid_of(lo, hi);
}

// Every thread adds the first m <= 32 of each channel's partials in order.
template <int C, int N>
__device__ __forceinline__ void add_up(const float (*p)[N], int m,
                                       float (&out)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < m) a = __fadd_rn(a, p[c][i]);
    out[c] = a;
  }
}

// (sum, sum of squares) of the kept subsample values, added in the
// reference's order over all nsub samples (others count as zeros), in
// stages that ride on a bisection's barriers: stage 0 leaves the first
// level's n1 window sums in sh.pa; stage 1 sums windows of those into
// sh.pb where n1 > 32, or else adds them up; stage 2 adds up sh.pb.
struct SubSums {
  const float* cell;
  int nsub, sstep, n1;
  float clo, chi;
  float out[2];

  __device__ SubSums(const float* cell_, int nsub_, int sstep_, float clo_,
                     float chi_)
      : cell(cell_), nsub(nsub_), sstep(sstep_), clo(clo_), chi(chi_) {
    n1 = (nsub + (32 - nsub % 32) % 32) / 32;
  }

  __device__ __forceinline__ void stage(int k, Shared& sh) {
    if (k == 0) {
      const int lo = (32 - nsub % 32) % 32 / 2;
      for (int w = threadIdx.x; w < n1; w += blockDim.x) {
        float v[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int s = 32 * w + i - lo;
          const float x = s >= 0 && s < nsub ? cell[at(s * sstep)] : NAN;
          v[i] = kept(x, clo, chi) ? x : 0.f;
        }
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          a = __fadd_rn(a, v[i]);
          b = __fadd_rn(b, __fmul_rn(v[i], v[i]));
        }
        sh.pa[0][w] = a;
        sh.pa[1][w] = b;
      }
      return;
    }
    if (n1 <= 32) {
      if (k == 1) add_up(sh.pa, n1, out);
      return;
    }
    const int pad = (32 - n1 % 32) % 32, lo = pad / 2;
    const int nw = (n1 + pad) / 32;   // n1 <= kSubWindows: at most 4
    if (k == 2) {
      add_up(sh.pb, nw, out);
      return;
    }
    for (int q = threadIdx.x; q < 2 * nw; q += blockDim.x) {
      const int c = q / nw, w = q - c * nw;
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int s = 32 * w + i - lo;
        v[i] = s >= 0 && s < n1 ? sh.pa[c][s] : 0.f;
      }
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) a = __fadd_rn(a, v[i]);
      sh.pb[c][w] = a;
    }
  }
};

// The final sums, (sum, sum of squares) over the keep and over the valid
// pixels: a thread's window of 32 (n = box^2, no padding) gives the first
// level; 32 consecutive windows are a warp, so the second level is the
// warp's ordered shuffle sum (all of it where the block is one warp);
// stage 1 adds up the warps' sums.
struct FinalSums {
  const float* cell;
  float clo, chi;
  float out[4];

  __device__ __forceinline__ void stage(int k, Shared& sh) {
    const int nw = blockDim.x >> 5;
    if (k == 0) {
      float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float v = cell[at(kPer * threadIdx.x + j)];
        const float vk = kept(v, clo, chi) ? v : 0.f, v0 = v == v ? v : 0.f;
        p[0] = __fadd_rn(p[0], vk);
        p[1] = __fadd_rn(p[1], __fmul_rn(vk, vk));
        p[2] = __fadd_rn(p[2], v0);
        p[3] = __fadd_rn(p[3], __fmul_rn(v0, v0));
      }
      float w[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          w[c] = __fadd_rn(w[c], __shfl_sync(0xffffffffu, p[c], i));
      if (nw == 1) {
#pragma unroll
        for (int c = 0; c < 4; ++c) out[c] = w[c];
      } else if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) sh.pb[c][threadIdx.x >> 5] = w[c];
      }
    } else if (k == 1 && nw > 1) {
      add_up(sh.pb, nw, out);
    }
  }
};

// No sums (the moments probe).
struct NoSums {
  float out[4] = {0.f, 0.f, 0.f, 0.f};
  __device__ __forceinline__ void stage(int, Shared&) {}
};

// stats() of background.py:138-144: the mean and the one-pass sigma of
// n = max(count, 1) values with sums s, s2.
__device__ __forceinline__ float2 mean_sigma(float s, float s2, int count) {
  const float nf = __int2float_rn(count > 1 ? count : 1);
  const float mean = __fdiv_rn(s, nf);
  return make_float2(
      mean, sqrtf(fmaxf(fmaf(-mean, mean, __fdiv_rn(s2, nf)), 0.f)));
}

__global__ void __launch_bounds__(kMaxThreads, 2)
background_cells_kernel(const float* __restrict__ img,
                        const unsigned char* __restrict__ valid,
                        float* __restrict__ back_out,
                        float* __restrict__ sigma_out, int* __restrict__ n_out,
                        int H, int W, int box, int iters, int sstep,
                        int vec) {
  extern __shared__ float cell[];
  __shared__ Shared sh;
  const int n = box * box, nthr = blockDim.x;   // nthr = n / 32
  const int ncx = (W + box - 1) / box;
  const int y0 = blockIdx.x / ncx * box, x0 = blockIdx.x % ncx * box;

  // the cell into shared memory: 8 groups of 4 pixels a thread
  if (vec) {
#pragma unroll
    for (int i = 0; i < kPer / 4; ++i) {
      const int k = 4 * (threadIdx.x + nthr * i);
      const int yy = y0 + k / box, xx = x0 + k % box;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      uchar4 m = make_uchar4(0, 0, 0, 0);
      if (yy < H && xx < W) {   // W % 4 == 0: all four in, or all out
        const size_t o = (size_t)yy * W + xx;
        v = __ldg(reinterpret_cast<const float4*>(img + o));
        m = *reinterpret_cast<const uchar4*>(valid + o);
      }
      float* dst = cell + at(k);
      dst[0] = m.x && isfinite(v.x) ? v.x : NAN;
      dst[1] = m.y && isfinite(v.y) ? v.y : NAN;
      dst[2] = m.z && isfinite(v.z) ? v.z : NAN;
      dst[3] = m.w && isfinite(v.w) ? v.w : NAN;
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < kPer; ++i) {
      const int k = threadIdx.x + nthr * i;
      const int yy = y0 + k / box, xx = x0 + k % box;
      float val = NAN;
      if (yy < H && xx < W) {
        const size_t o = (size_t)yy * W + xx;
        const float x = img[o];
        if (valid[o] && isfinite(x)) val = x;
      }
      cell[at(k)] = val;
    }
  }
  __syncthreads();

  int flip = 0, count, nvalid;
  const int nsub = (n + sstep - 1) / sstep;
  // a thread's samples s = threadIdx.x + nthr i: the first kSubRegs in
  // registers, masked to the keep once a median (NaN elsewhere); more
  // (only where box^2 / 32 threads hold over kSubRegs samples each: box
  // 32) from shared memory
  float xs[kSubRegs];
  float clo = -INFINITY, chi = INFINITY;
  const auto sub = [&](auto f) {
#pragma unroll
    for (int i = 0; i < kSubRegs; ++i) f(xs[i]);
    for (int s = threadIdx.x + kSubRegs * nthr; s < nsub; s += nthr) {
      const float v = cell[at(s * sstep)];
      f(kept(v, clo, chi) ? v : NAN);
    }
  };

  // sigma-clip iterations on the subsample (background.py:172-179); the
  // first keep is every valid sample, the last pass gives med_s, sigma_s
  bool subempty = false;
  for (int it = 0; it <= iters; ++it) {
#pragma unroll
    for (int i = 0; i < kSubRegs; ++i) {
      const int s = threadIdx.x + nthr * i;
      const float v = s < nsub ? cell[at(s * sstep)] : NAN;
      xs[i] = kept(v, clo, chi) ? v : NAN;
    }
#ifdef ZUDS_BG_PROBE_NO_MOMENTS
    NoSums sums;
    const float med = bisect(sub, 0u, &count, &nvalid, sums, sh, flip);
    const float sig = 1.f;
#else
    SubSums sums(cell, nsub, sstep, clo, chi);
    const float med = bisect(sub, 0u, &count, &nvalid, sums, sh, flip);
    const float sig = mean_sigma(sums.out[0], sums.out[1], count).y;
#endif
    if (it == 0) subempty = count == 0;
    const float t = __fmul_rn(3.f, sig);
    if (it < iters) {
      clo = __fsub_rn(med, t);
      chi = __fadd_rn(med, t);
    } else {   // the final bounds (background.py:180-183)
      clo = subempty ? -INFINITY : __fsub_rn(med, t);
      chi = subempty ? INFINITY : __fadd_rn(med, t);
    }
  }

  // final full-resolution estimators (background.py:184-196) over the
  // thread's window of 32 in registers, masked to the keep; mean / sigma
  // over the keep and sigma0 over the valid pixels in one pass beside the
  // median
  float x[kPer];
  unsigned cv = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float v = cell[at(kPer * threadIdx.x + j)];
    cv += v == v;
    x[j] = kept(v, clo, chi) ? v : NAN;
  }
  const auto mine = [&](auto f) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) f(x[j]);
  };
#ifdef ZUDS_BG_PROBE_NO_MOMENTS
  NoSums sums;
  const float med = bisect(mine, cv, &count, &nvalid, sums, sh, flip);
  const float2 m = make_float2(0.f, 1.f), m0 = make_float2(0.f, 1.f);
#else
  FinalSums sums{cell, clo, chi};
  const float med = bisect(mine, cv, &count, &nvalid, sums, sh, flip);
  const float2 m = mean_sigma(sums.out[0], sums.out[1], count);
  const float2 m0 = mean_sigma(sums.out[2], sums.out[3], nvalid);
#endif
  const float sigma = m.y, sigma0 = m0.y;
  const bool uncrowded =
      subempty || fabsf(__fsub_rn(sigma, sigma0)) <
                      __fmul_rn(0.2f, sigma0 == 0.f ? 1.f : sigma0);
  const float back =
      uncrowded ? m.x : __fsub_rn(__fmul_rn(2.5f, med), __fmul_rn(1.5f, m.x));
  if (threadIdx.x == 0) {
    back_out[blockIdx.x] = back;
    sigma_out[blockIdx.x] = sigma;
    n_out[blockIdx.x] = count > 1 ? count : 1;
  }
}

}  // namespace

// box: a multiple of 32 up to 128 (the wrapper checks), so a cell is
// box^2 / 32 <= 512 threads of 32 pixels.
extern "C" int zuds_background_cells(const float* img,
                                     const unsigned char* valid, float* back,
                                     float* sigma, int* n, int H, int W,
                                     int box, int iters, cudaStream_t stream) {
  const int ncy = (H + box - 1) / box, ncx = (W + box - 1) / box;
  const int sstep = box * box >= 4096 ? 5 : 1;
  const int threads = box * box / kPer;
  const size_t smem = (size_t)(box * box + box * box / 32) * sizeof(float);
  static bool sized = false;   // set once, outside any graph capture
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        background_cells_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxCellBytes);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(valid) % 4 == 0;
  background_cells_kernel<<<ncy * ncx, threads, smem, stream>>>(
      img, valid, back, sigma, n, H, W, box, iters, sstep, vec);
  return (int)cudaGetLastError();
}
