// H8: frame-wide masked bisection median.
//
// Replaces one row of zuds_tpu/ops/background.py:48-69 (bisect_median),
// as zuds_tpu/ops/measure.py:39-43 and the pipeline's whole-frame medians
// (zuds_tpu/parallel/pipeline.py: the reference rms, rms_med and the
// negative-pixel veto) call it: lo/hi start at the min/max of the valid
// values, then 12 rounds each count the valid values <= mid = (lo+hi)/2 and
// keep the half that holds `half = count * 0.5`.
//
// Several rounds a pass. The mids of the next L rounds all follow from the
// pass's (lo, hi) before any of them is decided: node j of the pass's
// binary tree has the mid that the plain version forms if its descent
// reaches j, with the same f32 arithmetic (mid_at). Rounding is monotone,
// so a mid lies in its [lo, hi] and the tree's mids, read in order, never
// decrease; where lo + hi overflows, the whole subtree is +-inf and sits at
// the end the overflow points to; where lo or hi makes a mid NaN, every
// mid of the pass is NaN. So one binary search of each value over the
// 2^L - 1 sorted mids (`!(v <= t)` goes up: NaN values and NaN mids go to
// the top bucket) puts it in one of 2^L buckets, and the count of values
// <= the mid of node j is the sum of the buckets up to j. The last block
// replays the L rounds from those sums with the plain version's update,
// bit for bit (replay). tests/test_torch_median_passes.py emulates this
// pass structure on the CPU against the plain version.
//
// Launches (all from one call, no host read in between): a memset of the
// arrival counters and histograms; minmax_kernel (min, max with NaN
// propagating as torch.amin does, valid count; its last block forms the
// first pass's mids); ceil(iters / L) x count_kernel (each thread counts
// into its own 16-bit column of buckets in shared memory, no atomics
// there; each block adds its buckets to one of kCopies copies of the
// pass's histogram with one integer atomic a bucket, exact in any order;
// the last block to arrive adds the copies up, replays the pass and forms
// the next pass's mids, or writes the median). A count pass is launched as
// a programmatic dependent of the kernel before it, so its blocks start
// and zero their counters while that kernel's last block finishes. At
// iters = 12 and L = 6: the memset and three kernels, three reads of the
// data (minmax forward, the count passes backward then forward, so that
// each starts on what the L2 cache still holds).
//
// The input is a 2-D view with element strides (a ::4 subsample is read in
// place, no copy; a whole row-contiguous view is read as one row with
// 16-byte loads), an optional bool mask with its own strides (null: all
// valid), and an optional device scalar `center` (then the values are
// |x - center|, which saves writing that frame: the MAD of the stamp
// selector).
//
// Bound: memory. One read of x (and the mask) per call is the least: 37.8
// MB for a flagship frame, 11 us at 3.35 TB/s; the ::4 view of a frame
// reads every sector of its rows (a quarter of the frame's bytes). The
// kernel reads the data three times; a count pass also issues its search
// (L levels, or for L >= 5 one interpolated guess checked against two
// mids) and a 16-bit shared-memory add per bucket change.
#include "common.cuh"

// rounds settled per count pass (1..6: 2^L 16-bit buckets a thread); 6
// beat 3 and 4 (more passes over the data)
#define ZUDS_MEDIAN_L 6

namespace {

constexpr int kThreads = 256;
constexpr int kL = ZUDS_MEDIAN_L;
static_assert(kL >= 1 && kL <= 6, "a thread keeps at most 2^6 buckets");
constexpr int kBins = 1 << kL;
// copies of a pass's histogram: block b adds to copy b % kCopies, so that
// the grid's integer atomics spread over cache lines (the last block adds
// the copies up)
constexpr int kCopies = 16;
// columns of one row a block takes at once on the strided path
constexpr int kSegment = kThreads * 16;

struct View {
  const float* x;
  const uint8_t* ok;       // null: every element valid
  const float* center;     // null: the values themselves
  long long cols;          // a whole contiguous view: one row of rows*cols
  int rows, seg, segs_per_row, ntiles;
  long long sxr, sxc, sor, soc;
  int vec;                 // 1: one row, unit strides, x 16-byte aligned
};

struct Partial {
  float mn, mx;
  unsigned n;
};

// Scratch (see zuds_frame_median_scratch): arrival counters and histograms
// (zeroed by the call's memset), the state between passes, the minmax
// pass's per-block partials.
struct Scratch {
  unsigned* arrive;        // 1 + passes
  unsigned* hist;          // passes x kCopies x kBins
  float* state;            // lo, hi, half, then the pass's kBins - 1 mids
  Partial* part;           // nb
};

__device__ __forceinline__ float value_of(float x, float ctr, bool centred) {
  return centred ? fabsf(__fsub_rn(x, ctr)) : x;
}

// f(value, valid) for every element this block takes; `rev`: the grid
// walks the data from its end (a pass after a forward one then starts on
// what the L2 cache still holds).
template <typename F>
__device__ __forceinline__ void for_each_value(const View& v, bool rev,
                                               F&& f) {
  const bool centred = v.center != nullptr;
  const float ctr = centred ? *v.center : 0.f;
  if (v.vec) {
    const long long nvec = v.cols >> 2;
    const long long stride = (long long)gridDim.x * kThreads;
    const float4* x4 = reinterpret_cast<const float4*>(v.x);
    const uchar4* o4 = reinterpret_cast<const uchar4*>(v.ok);
    long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    // two 16-byte loads in flight a thread
    for (; i + stride < nvec; i += 2 * stride) {
      const long long ia = rev ? nvec - 1 - i : i;
      const long long ib = rev ? ia - stride : ia + stride;
      const float4 a = __ldg(&x4[ia]), b = __ldg(&x4[ib]);
      uchar4 ma = make_uchar4(1, 1, 1, 1), mb = ma;
      if (v.ok != nullptr) {
        ma = o4[ia];
        mb = o4[ib];
      }
      f(value_of(a.x, ctr, centred), ma.x != 0);
      f(value_of(a.y, ctr, centred), ma.y != 0);
      f(value_of(a.z, ctr, centred), ma.z != 0);
      f(value_of(a.w, ctr, centred), ma.w != 0);
      f(value_of(b.x, ctr, centred), mb.x != 0);
      f(value_of(b.y, ctr, centred), mb.y != 0);
      f(value_of(b.z, ctr, centred), mb.z != 0);
      f(value_of(b.w, ctr, centred), mb.w != 0);
    }
    for (; i < nvec; i += stride) {
      const long long ia = rev ? nvec - 1 - i : i;
      const float4 a = __ldg(&x4[ia]);
      uchar4 ma = make_uchar4(1, 1, 1, 1);
      if (v.ok != nullptr) ma = o4[ia];
      f(value_of(a.x, ctr, centred), ma.x != 0);
      f(value_of(a.y, ctr, centred), ma.y != 0);
      f(value_of(a.z, ctr, centred), ma.z != 0);
      f(value_of(a.w, ctr, centred), ma.w != 0);
    }
    // the last cols % 4 elements
    const long long t = (nvec << 2) + (long long)blockIdx.x * kThreads +
                        threadIdx.x;
    if (t < v.cols)
      f(value_of(__ldg(&v.x[t]), ctr, centred),
        v.ok == nullptr || v.ok[t] != 0);
    return;
  }
  for (int i = blockIdx.x; i < v.ntiles; i += gridDim.x) {
    const int tile = rev ? v.ntiles - 1 - i : i;
    const int r = tile / v.segs_per_row;
    const long long c0 = (long long)(tile - r * v.segs_per_row) * v.seg;
    const long long c1 = min(c0 + v.seg, v.cols);
    const float* xr = v.x + r * v.sxr;
    const uint8_t* orow = v.ok != nullptr ? v.ok + r * v.sor : nullptr;
#pragma unroll 4
    for (long long c = c0 + threadIdx.x; c < c1; c += kThreads)
      f(value_of(__ldg(&xr[c * v.sxc]), ctr, centred),
        orow == nullptr || orow[c * v.soc] != 0);
  }
}

// NaN-propagating min (nan_max is in common.cuh): once NaN, stays NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(b) || b < a) ? b : a;
}

// Float order as signed int order (NaN aside), for the warp's integer min
// and max.
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// (min, max) over the block with NaN propagating as torch.amin / amax do,
// and the sum of n; every thread gets them. One barrier: `buf` serves one
// call.
__device__ void block_minmax_count(float& mn, float& mx, unsigned& n,
                                   unsigned (*buf)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned nan = __reduce_or_sync(0xffffffffu, isnan(mn) || isnan(mx));
  int lo = __reduce_min_sync(0xffffffffu, ordered(mn));
  int hi = __reduce_max_sync(0xffffffffu, ordered(mx));
  n = __reduce_add_sync(0xffffffffu, n);
  if (lane == 0) {
    buf[warp][0] = (unsigned)lo;
    buf[warp][1] = (unsigned)hi;
    buf[warp][2] = n;
    buf[warp][3] = nan;
  }
  __syncthreads();
  const bool in = lane < kThreads / 32;
  lo = __reduce_min_sync(0xffffffffu, in ? (int)buf[lane][0] : 0x7fffffff);
  hi = __reduce_max_sync(0xffffffffu,
                         in ? (int)buf[lane][1] : (int)0x80000000);
  n = __reduce_add_sync(0xffffffffu, in ? buf[lane][2] : 0u);
  nan = __reduce_or_sync(0xffffffffu, in ? buf[lane][3] : 0u);
  mn = nan ? NAN : unordered(lo);
  mx = nan ? NAN : unordered(hi);
}

// True in every thread of the block that arrives last; the block's global
// writes before the call are then visible to it.
__device__ bool arrive_last(unsigned* arrive) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrive, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ float mid_of(float lo, float hi) {
  return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

// The mid of in-order node j of an L-level pass from (lo, hi): the plain
// version's mids along the descent to j (left: hi = mid; right: lo = mid).
__device__ float mid_at(float lo, float hi, int j, int L) {
  int node = (1 << (L - 1)) - 1;
  for (int d = L - 2;; --d) {
    const float mid = mid_of(lo, hi);
    if (j == node || d < 0) return mid;
    if (j < node) {
      hi = mid;
      node -= 1 << d;
    } else {
      lo = mid;
      node += 1 << d;
    }
  }
}

// The pass's L rounds from the count of values <= each node's mid,
// `le[j]` (the buckets summed up to j), with the plain version's update.
__device__ void replay(float& lo, float& hi, float half, const unsigned* le,
                       int L) {
  int node = (1 << (L - 1)) - 1;
  for (int d = L - 2; d >= -1; --d) {
    const float mid = mid_of(lo, hi);
    const bool up = __uint2float_rn(le[node]) < half;
    lo = up ? mid : lo;
    hi = up ? hi : mid;
    if (d >= 0) node += up ? (1 << d) : -(1 << d);
  }
}

// Every thread of the block: the mids of the next pass into the state.
__device__ void write_mids(float* state, float lo, float hi, int L) {
  for (int j = threadIdx.x; j < (1 << L) - 1; j += kThreads)
    state[3 + j] = mid_at(lo, hi, j, L);
}

__global__ void __launch_bounds__(kThreads)
    minmax_kernel(View v, Scratch s, int L0) {
  __shared__ unsigned buf[2][kThreads / 32][4];
  float mn = INFINITY, mx = -INFINITY;
  unsigned n = 0;
  for_each_value(v, false, [&](float val, bool ok) {
    if (ok) {
      mn = nan_min(mn, val);
      mx = nan_max(mx, val);
      ++n;
    }
  });
  block_minmax_count(mn, mx, n, buf[0]);
  if (threadIdx.x == 0) s.part[blockIdx.x] = Partial{mn, mx, n};
  if (!arrive_last(&s.arrive[0])) return;
  asm volatile("griddepcontrol.launch_dependents;");
  mn = INFINITY;
  mx = -INFINITY;
  n = 0;
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads) {
    mn = nan_min(mn, __ldcg(&s.part[b].mn));
    mx = nan_max(mx, __ldcg(&s.part[b].mx));
    n += __ldcg(&s.part[b].n);
  }
  block_minmax_count(mn, mx, n, buf[1]);
  if (threadIdx.x == 0) {
    s.state[0] = mn;
    s.state[1] = mx;
    s.state[2] = __fmul_rn(__uint2float_rn(n), 0.5f);
  }
  write_mids(s.state, mn, mx, L0);
}

// One count pass of LP rounds: bucket every valid value among the pass's
// 2^LP - 1 mids, add the buckets over the grid, and let the last block
// replay the rounds. next_L: the next pass's rounds, 0 after the last pass
// (then the median goes to `out`).
//
// A value's bucket is first estimated from where it lies in [lo, hi] (the
// mids split it evenly but for their rounding) and checked against the two
// mids about it; a value that fails the check (within a few ulps of a mid,
// NaN, or a pass whose mids collapse) takes the binary search. Each
// thread's counts are 16-bit (the wrapper sizes the grid so that a thread
// takes under 2^16 values a pass); a run of values in one bucket is
// counted in a register.
template <int LP>
__global__ void __launch_bounds__(kThreads)
    count_kernel(View v, Scratch s, int pass, int next_L, float* out) {
  constexpr int kB = 1 << LP;
  extern __shared__ unsigned short cnt[];   // kB x kThreads: a column each
  __shared__ float t[kB - 1];
  __shared__ unsigned le[kB];
  __shared__ float lohi[2];
#pragma unroll
  for (int b = 0; b < kB; ++b) cnt[b * kThreads + threadIdx.x] = 0;
  // launched while the previous pass's last block replays: wait for it
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int j = threadIdx.x; j < kB - 1; j += kThreads) t[j] = s.state[3 + j];
  __syncthreads();
  const float lo = s.state[0], hi = s.state[1];
  const float scale = __fdiv_rn((float)kB, __fsub_rn(hi, lo));
  int run_b = 0;
  unsigned run_n = 0;
  // the first two levels of the search from registers
  const float t0 = t[kB / 2 - 1];
  const float tl = LP >= 2 ? t[kB / 4 - 1] : 0.f;
  const float tr = LP >= 2 ? t[kB / 2 + kB / 4 - 1] : 0.f;
  for_each_value(v, (pass & 1) == 0, [&](float val, bool ok) {
    if (!ok) return;
    int b;
    if (LP >= 5) {
      // deep trees: the interpolated bucket, checked against its two mids
      const float e = fminf(
          fmaxf(__fmul_rn(__fsub_rn(val, lo), scale), 0.f), (float)kB);
      b = max(__float2int_ru(e) - 1, 0);
      if (!((b == 0 || !(val <= t[max(b - 1, 0)])) &&
            (b == kB - 1 || val <= t[min(b, kB - 2)]))) {
        b = 0;
#pragma unroll
        for (int h = kB / 2; h > 0; h >>= 1)
          if (!(val <= t[b + h - 1])) b += h;
      }
    } else {
      b = val <= t0 ? 0 : kB / 2;
      if (LP >= 2 && !(val <= (b ? tr : tl))) b += kB / 4;
#pragma unroll
      for (int h = kB / 8; h > 0; h >>= 1)
        if (!(val <= t[b + h - 1])) b += h;
    }
#ifdef ZUDS_MEDIAN_PROBE_NO_COUNT
    run_n += b;
    return;
#endif
    if (b == run_b) {
      ++run_n;
    } else {
      cnt[run_b * kThreads + threadIdx.x] += run_n;
      run_b = b;
      run_n = 1;
    }
  });
  cnt[run_b * kThreads + threadIdx.x] += run_n;
  __syncthreads();
  unsigned* hist = s.hist + pass * kCopies * kBins;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#ifdef ZUDS_MEDIAN_PROBE_NO_COUNT
  if (run_n == 0x7fffffff) *out = 0.f;   // keeps the search
  if (false)
#endif
  for (int b = warp; b < kB; b += kThreads / 32) {
    unsigned c = 0;
#pragma unroll
    for (int q = 0; q < kThreads / 32; ++q)
      c += cnt[b * kThreads + q * 32 + lane];
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0 && c != 0)
      atomicAdd(&hist[(blockIdx.x % kCopies) * kBins + b], c);
  }
  if (!arrive_last(&s.arrive[1 + pass])) return;
  asm volatile("griddepcontrol.launch_dependents;");
  // le[j]: the buckets summed up to j, a warp's scan of bucket pairs
  if (warp == 0) {
    unsigned a = 0, c = 0;
#pragma unroll
    for (int k = 0; k < kCopies; ++k) {
      if (2 * lane < kB) a += __ldcg(&hist[k * kBins + 2 * lane]);
      if (2 * lane + 1 < kB) c += __ldcg(&hist[k * kBins + 2 * lane + 1]);
    }
    unsigned sum = a + c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned up = __shfl_up_sync(0xffffffffu, sum, o);
      if (lane >= o) sum += up;
    }
    if (2 * lane < kB) le[2 * lane] = sum - c;
    if (2 * lane + 1 < kB) le[2 * lane + 1] = sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = lo, h = hi;
    replay(l, h, s.state[2], le, LP);
    if (next_L == 0) {
      *out = mid_of(l, h);
    } else {
      s.state[0] = l;
      s.state[1] = h;
    }
    lohi[0] = l;
    lohi[1] = h;
  }
  __syncthreads();
  if (next_L != 0) write_mids(s.state, lohi[0], lohi[1], next_L);
}

template <int LP>
cudaError_t launch_count(const View& v, const Scratch& s, int nb, int pass,
                         int next_L, float* out, cudaStream_t stream) {
  const int smem = (1 << LP) * kThreads * (int)sizeof(unsigned short);
  static bool sized = false;   // set once, outside any graph capture
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        count_kernel<LP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  // programmatic dependent launch: the pass may start (and zero its
  // counters) while the previous kernel's last block finishes
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, count_kernel<LP>, v, s, pass, next_L, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_pass(int L, const View& v, const Scratch& s, int nb,
                        int pass, int next_L, float* out,
                        cudaStream_t stream) {
  switch (L) {
    case 1: return launch_count<1>(v, s, nb, pass, next_L, out, stream);
    case 2: return launch_count<2>(v, s, nb, pass, next_L, out, stream);
    case 3: return launch_count<3>(v, s, nb, pass, next_L, out, stream);
    case 4: return launch_count<4>(v, s, nb, pass, next_L, out, stream);
    case 5: return launch_count<5>(v, s, nb, pass, next_L, out, stream);
    default: return launch_count<6>(v, s, nb, pass, next_L, out, stream);
  }
}

int passes_of(int iters) { return (iters + kL - 1) / kL; }

}  // namespace

// Bytes of scratch for nb blocks and `iters` rounds: the counters and
// histograms (the part the call zeroes), the state, the partials.
extern "C" long long zuds_frame_median_scratch(int nb, int iters) {
  const int p = passes_of(iters);
  return 4LL * ((1 + p) + (long long)p * kCopies * kBins + 3 + (kBins - 1)) +
         (long long)sizeof(Partial) * nb;
}

// iters >= 1, rows * cols < 2^31 (the wrapper checks).
extern "C" int zuds_frame_median(const float* x, const uint8_t* ok,
                                 const float* center, int rows, int cols,
                                 long long sxr, long long sxc, long long sor,
                                 long long soc, int nb, int iters,
                                 void* scratch, float* out,
                                 cudaStream_t stream) {
  View v;
  v.x = x;
  v.ok = ok;
  v.center = center;
  v.rows = rows;
  v.cols = cols;
  v.sxr = sxr;
  v.sxc = sxc;
  v.sor = sor;
  v.soc = soc;
  // a view whose rows follow each other in memory is one row
  if (rows > 1 && sxc == 1 && sxr == cols &&
      (ok == nullptr || (soc == 1 && sor == cols))) {
    v.rows = 1;
    v.cols = (long long)rows * cols;
  }
  v.vec = v.rows == 1 && sxc == 1 && (ok == nullptr || soc == 1) &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          (ok == nullptr || reinterpret_cast<uintptr_t>(ok) % 4 == 0);
  v.seg = (int)min(v.cols, (long long)kSegment);
  if (v.seg < 1) v.seg = 1;
  v.segs_per_row = (int)((v.cols + v.seg - 1) / v.seg);
  v.ntiles = v.rows * v.segs_per_row;

  const int p = passes_of(iters);
  unsigned* w = static_cast<unsigned*>(scratch);
  Scratch s;
  s.arrive = w;
  s.hist = w + 1 + p;
  s.state = reinterpret_cast<float*>(s.hist + (size_t)p * kCopies * kBins);
  s.part = reinterpret_cast<Partial*>(s.state + 3 + (kBins - 1));
  cudaError_t err = cudaMemsetAsync(
      w, 0, sizeof(unsigned) * ((1 + p) + (size_t)p * kCopies * kBins),
      stream);
  if (err != cudaSuccess) return (int)err;
  const int L0 = iters < kL ? iters : kL;
  minmax_kernel<<<nb, kThreads, 0, stream>>>(v, s, L0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int pass = 0, left = iters; pass < p; ++pass) {
    const int L = left < kL ? left : kL;
    left -= L;
    const int next = left < kL ? left : kL;
    err = launch_pass(L, v, s, nb, pass, next, out, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
