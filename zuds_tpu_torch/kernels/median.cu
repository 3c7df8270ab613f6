// H8: frame-wide masked bisection median.
//
// Replaces one row of zuds_tpu/ops/background.py:48-69 (bisect_median),
// as zuds_tpu/ops/measure.py:39-43 and the pipeline's whole-frame medians
// (zuds_tpu/parallel/pipeline.py: the reference rms, rms_med and the
// negative-pixel veto) call it: lo/hi start at the min/max of the valid
// values, then 12 rounds each count the valid values <= mid = (lo+hi)/2 and
// keep the half that holds `half = count * 0.5`. The plain version costs
// ~50 small launches and, in the TPU form, 13 full reductions.
//
// Launches (all from one call, no host read in between):
//   1. minmax_kernel: per-block min, max (NaN propagates, as jnp.min and
//      torch.amin do) and valid count;
//   2. 12 x round_kernel: every block reduces the previous round's
//      per-block partials in index order (integer sums, exact), applies the
//      previous round's update with the plain version's f32 arithmetic,
//      then counts its own chunks at the new mid; block 0 writes lo/hi/half
//      for the next round. Partials and state ping-pong between two
//      buffers, since a block may still read round k-1's partials while
//      another writes round k's;
//   3. finish_kernel: the last update and 0.5f * (lo + hi).
// Every block computes the same update from the same integers, so the
// result equals the plain version bit for bit.
//
// The input is a 2-D view with element strides (a ::4 subsample is read in
// place, no copy), an optional bool mask with its own strides (null: all
// valid), and an optional device scalar `center` (then the values are
// |x - center|, which saves writing that frame: the MAD of the stamp
// selector).
//
// Bound: memory. One read of x (and the mask) per call is the least: 37.8
// MB for a flagship frame, 11 us at 3.35 TB/s. The kernel reads it 13
// times; a frame of 37.8 MB fits the 50 MB L2, so rounds 2-13 can be
// served from L2 where nothing evicts it in between.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;  // columns per chunk

struct View {
  const float* x;
  const uint8_t* ok;       // null: every element valid
  const float* center;     // null: the values themselves
  int rows, cols, chunks_per_row, nchunks;
  long long sxr, sxc, sor, soc;
};

struct State {
  float lo, hi, half;
};

__device__ __forceinline__ bool value_at(const View& v, int r, int c,
                                         float ctr, float* out) {
  if (v.ok != nullptr && v.ok[r * v.sor + c * v.soc] == 0) return false;
  const float x = v.x[r * v.sxr + c * v.sxc];
  *out = v.center != nullptr ? fabsf(x - ctr) : x;
  return true;
}

// NaN-propagating min (nan_max is in common.cuh): once NaN, stays NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(b) || b < a) ? b : a;
}

// Reduce over the block; every thread gets the result. `ident` is the
// operation's identity (it fills the lanes past the block's warps).
template <typename T, typename Op>
__device__ T block_reduce(T val, Op op, T ident, T* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    val = op(val, __shfl_down_sync(0xffffffffu, val, o));
  if (lane == 0) smem[warp] = val;
  __syncthreads();
  if (warp == 0) {
    val = lane < kThreads / 32 ? smem[lane] : ident;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      val = op(val, __shfl_down_sync(0xffffffffu, val, o));
    if (lane == 0) smem[0] = val;
  }
  __syncthreads();
  val = smem[0];
  __syncthreads();
  return val;
}

struct MinOp {
  __device__ float operator()(float a, float b) const { return nan_min(a, b); }
};
struct MaxOp {
  __device__ float operator()(float a, float b) const { return nan_max(a, b); }
};
struct AddOp {
  __device__ long long operator()(long long a, long long b) const {
    return a + b;
  }
};

__global__ void __launch_bounds__(kThreads)
    minmax_kernel(View v, float* pmin, float* pmax, long long* pn) {
  __shared__ float sf[32];
  __shared__ long long sl[32];
  const float ctr = v.center != nullptr ? *v.center : 0.f;
  float mn = INFINITY, mx = -INFINITY;
  long long n = 0;
  for (int ch = blockIdx.x; ch < v.nchunks; ch += gridDim.x) {
    const int r = ch / v.chunks_per_row;
    const int c0 = (ch - r * v.chunks_per_row) * kChunk;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int c = c0 + j * kThreads + threadIdx.x;
      float val;
      if (c < v.cols && value_at(v, r, c, ctr, &val)) {
        mn = nan_min(mn, val);
        mx = nan_max(mx, val);
        ++n;
      }
    }
  }
  mn = block_reduce(mn, MinOp(), INFINITY, sf);
  mx = block_reduce(mx, MaxOp(), -INFINITY, sf);
  n = block_reduce(n, AddOp(), 0LL, sl);
  if (threadIdx.x == 0) {
    pmin[blockIdx.x] = mn;
    pmax[blockIdx.x] = mx;
    pn[blockIdx.x] = n;
  }
}

// The state before round k's count: lo, hi and half after applying round
// k-1's count (or, for k = 0, the min/max pass), reduced from the
// per-block partials in index order by every block alike.
__device__ State next_state(int nb, bool first, const float* pmin,
                            const float* pmax, const long long* pn,
                            const State* st_in, float* sf, long long* sl) {
  State s;
  if (first) {
    float mn = INFINITY, mx = -INFINITY;
    long long n = 0;
    for (int b = threadIdx.x; b < nb; b += kThreads) {
      mn = nan_min(mn, pmin[b]);
      mx = nan_max(mx, pmax[b]);
      n += pn[b];
    }
    s.lo = block_reduce(mn, MinOp(), INFINITY, sf);
    s.hi = block_reduce(mx, MaxOp(), -INFINITY, sf);
    s.half = __ll2float_rn(block_reduce(n, AddOp(), 0LL, sl)) * 0.5f;
  } else {
    long long cnt = 0;
    for (int b = threadIdx.x; b < nb; b += kThreads) cnt += pn[b];
    cnt = block_reduce(cnt, AddOp(), 0LL, sl);
    s = *st_in;
    const float mid = 0.5f * (s.lo + s.hi);
    const bool go_up = __ll2float_rn(cnt) < s.half;
    s.lo = go_up ? mid : s.lo;
    s.hi = go_up ? s.hi : mid;
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
    round_kernel(View v, int nb, int first, const float* pmin,
                 const float* pmax, const long long* cnt_in,
                 const State* st_in, State* st_out, long long* cnt_out) {
  __shared__ float sf[32];
  __shared__ long long sl[32];
  const State s = next_state(nb, first != 0, pmin, pmax, cnt_in, st_in, sf,
                             sl);
  if (blockIdx.x == 0 && threadIdx.x == 0) *st_out = s;
  const float mid = 0.5f * (s.lo + s.hi);
  const float ctr = v.center != nullptr ? *v.center : 0.f;
  long long cnt = 0;
  for (int ch = blockIdx.x; ch < v.nchunks; ch += gridDim.x) {
    const int r = ch / v.chunks_per_row;
    const int c0 = (ch - r * v.chunks_per_row) * kChunk;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int c = c0 + j * kThreads + threadIdx.x;
      float val;
      if (c < v.cols && value_at(v, r, c, ctr, &val) && val <= mid) ++cnt;
    }
  }
  cnt = block_reduce(cnt, AddOp(), 0LL, sl);
  if (threadIdx.x == 0) cnt_out[blockIdx.x] = cnt;
}

__global__ void __launch_bounds__(kThreads)
    finish_kernel(int nb, const long long* cnt_in, const State* st_in,
                  float* out) {
  __shared__ float sf[32];
  __shared__ long long sl[32];
  const State s = next_state(nb, false, nullptr, nullptr, cnt_in, st_in, sf,
                             sl);
  if (threadIdx.x == 0) *out = 0.5f * (s.lo + s.hi);
}

}  // namespace

// iters >= 1 (the wrapper checks). Scratch layout (bytes, from the
// wrapper): pmin, pmax (nb floats each), two count buffers (nb long longs
// each), two States: 24 * nb + 24 bytes.
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
  v.chunks_per_row = (cols + kChunk - 1) / kChunk;
  v.nchunks = rows * v.chunks_per_row;
  v.sxr = sxr;
  v.sxc = sxc;
  v.sor = sor;
  v.soc = soc;
  char* p = static_cast<char*>(scratch);
  float* pmin = reinterpret_cast<float*>(p);
  float* pmax = pmin + nb;
  long long* cnt[2];
  cnt[0] = reinterpret_cast<long long*>(p + 8 * ((2 * 4 * nb + 7) / 8));
  cnt[1] = cnt[0] + nb;
  State* st = reinterpret_cast<State*>(cnt[1] + nb);
  minmax_kernel<<<nb, kThreads, 0, stream>>>(v, pmin, pmax, cnt[1]);
  for (int k = 0; k < iters; ++k) {
    round_kernel<<<nb, kThreads, 0, stream>>>(
        v, nb, k == 0, pmin, pmax, cnt[(k + 1) & 1], &st[(k + 1) & 1],
        &st[k & 1], cnt[k & 1]);
  }
  finish_kernel<<<1, kThreads, 0, stream>>>(nb, cnt[(iters - 1) & 1],
                                            &st[(iters - 1) & 1], out);
  return (int)cudaGetLastError();
}
