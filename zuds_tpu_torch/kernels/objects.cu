// H26 (per-object statistics) and H27 (CLEAN) of the detect stage.
//
// H26 replaces zuds_tpu/ops/detect.py:840-953: one sort of the compact
// list by object id, eight segmented scans of sums, six of maxima, two of
// minima and one of ORs, read at each row's last entry, and the shape and
// flag epilogue, into nseg = max_det + 2 rows. The sums cancel
// (x2 = sxx / wsum - xbar^2), so the reference's pairing
// (jax.lax.associative_scan, ops/ordered.py:segmented_scan) is kept bit
// for bit:
//   1. a stable counting sort of the ids: one warp a tile of 1024 entries
//      ranks each entry among the tile's equal ids in order
//      (__match_any_sync) and counts the tile's ids in shared memory;
//   2. one block scans each row's counts over the tiles and the rows'
//      totals into their starts, which replace the searchsorted calls;
//   3. each entry goes to start[row] + earlier tiles' count + its rank
//      (the permutation torch.sort(stable=True) gives) with its eight
//      summands and its segment flag, level 0 of the scan's tree;
//   4. the tree's levels a_{L+1}[k] = op(a_L[2k], a_L[2k+1]),
//      op((va,sa),(vb,sb)) = (sb ? vb : va + vb, sa | sb), ten per block
//      of 1024 entries in shared memory, then the upper ones in one block;
//   5. one block a row: the order-free maxima, minima and OR over its
//      sorted span; eight threads walk the tree from the row's last entry
//      (ops/ordered.py:tree_scan_at, the plain twin of the walk); one
//      thread forms the epilogue, rounding each step as the plain version
//      does on the card (the "c - a*b" of ordered.fma in double, true
//      divisions, __fsqrt_rn, the products by 0.5 of PyTorch's division by
//      a Python 2.0).
// Bound: memory, a few bytes: each of the 65,536 entries' 30 bytes read
// once, 81 bytes written a row (2.3 MB, 0.7 us at 3.35 TB/s); the sort,
// the tree and the row pass are chains of short launches.
//
// H27 replaces zuds_tpu/ops/detect.py:954-1008 (the port's
// ops/detect.py:_clean_plain): the Moffat-wing contribution of every
// brighter valid row at each valid row's centroid, summed in 512-column
// blocks in XLA:CPU's windowed order (ops/ordered.py:sum_last: 32-wide
// sequential windows, their partials in sequence), the blocks in
// sequence; the dominant contributor (the first column of a block's
// largest wing, taken only on a strictly larger value, block by block);
// then the merge of each cleaned row's flux and npix into its contributor.
// One block a valid row, one thread a window; the merge is one block that
// adds the cleaned rows in ascending row order, as index_add does on the
// CPU (on the card index_add adds in atomic order). pow(x, -2.5) is
// powf, as torch.pow on the card.
// Bound: operations, ~14 a (valid row, column) pair and a powf for each
// brighter valid neighbour; 4098^2 pairs would take ~0.01 ms at fp32's
// 67 TFLOP/s, the flagship frames' ~60 valid rows far less.
#include "common.cuh"

namespace {

constexpr int kRankTile = 1024;   // entries a warp ranks in the counting sort
constexpr int kScanThreads = 1024;
constexpr int kChunk = 1024;      // level-0 entries of a low-levels block
constexpr int kLowLevels = 10;    // log2(kChunk)
constexpr int kSums = 8;
constexpr int kRowThreads = 256;
constexpr int kCleanThreads = 128;
constexpr int kCleanBlock = 512;  // columns of a block (the plain blk)
constexpr int kWin = 32;          // sum_last's window

struct Scratch {
  int* hist;        // (ntiles, nseg) id counts, then their offsets
  int* rank;        // (cap,) rank among the tile's equal ids
  int* starts;      // (nseg,)
  int* counts;      // (nseg,)
  int* pidx_s;      // (cap,) sorted flat indices
  int* mask_s;      // (cap,)
  float* vals_s;    // (cap,)
  float* thr_s;     // (cap,)
  uint8_t* fl_s;    // (cap,) bit 0: weight not ok, bit 1: deblend overflow
  float* tree;      // (kSums, nodes) the scan tree's values, level by level
  uint8_t* tflag;   // (nodes,) its segment flags
};

__host__ __device__ inline long long tree_nodes(int cap) {
  long long t = 0;
  for (int n = cap; n >= 1; n >>= 1) t += n;
  return t;
}

inline size_t carve(char* base, int cap, int nseg, Scratch* s) {
  const int ntiles = (cap + kRankTile - 1) / kRankTile;
  const long long nodes = tree_nodes(cap);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) & ~size_t(255);
    return p;
  };
  s->hist = (int*)take(sizeof(int) * (size_t)ntiles * nseg);
  s->rank = (int*)take(sizeof(int) * (size_t)cap);
  s->starts = (int*)take(sizeof(int) * (size_t)nseg);
  s->counts = (int*)take(sizeof(int) * (size_t)nseg);
  s->pidx_s = (int*)take(sizeof(int) * (size_t)cap);
  s->mask_s = (int*)take(sizeof(int) * (size_t)cap);
  s->vals_s = (float*)take(sizeof(float) * (size_t)cap);
  s->thr_s = (float*)take(sizeof(float) * (size_t)cap);
  s->fl_s = (uint8_t*)take((size_t)cap);
  s->tree = (float*)take(sizeof(float) * (size_t)kSums * nodes);
  s->tflag = (uint8_t*)take((size_t)nodes);
  return off;
}

__device__ __forceinline__ int valid_id(long long c, int nseg) {
  return (c >= 0 && c < nseg) ? (int)c : -1;
}

// 1. per tile: each entry's rank among the tile's equal ids, in order, and
// the tile's count of each id (one warp; nseg ints of shared memory)
__global__ void __launch_bounds__(32)
    rank_kernel(const long long* __restrict__ cid, int cap, int nseg,
                int* __restrict__ rank, int* __restrict__ hist) {
  extern __shared__ int cnt[];
  const int lane = threadIdx.x;
  for (int r = lane; r < nseg; r += 32) cnt[r] = 0;
  __syncwarp();
  const int base = blockIdx.x * kRankTile;
  for (int s = 0; s < kRankTile; s += 32) {
    const int i = base + s + lane;
    const int key = i < cap ? valid_id(cid[i], nseg) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0) rank[i] = cnt[key] + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
    if (key >= 0 && lane == __ffs(peers) - 1) cnt[key] += __popc(peers);
    __syncwarp();
  }
  for (int r = lane; r < nseg; r += 32)
    hist[(size_t)blockIdx.x * nseg + r] = cnt[r];
}

// 2. each row's counts over the tiles -> offsets; the rows' totals ->
// starts (one block)
__global__ void __launch_bounds__(kScanThreads)
    offsets_kernel(int* __restrict__ hist, int ntiles, int nseg,
                   int* __restrict__ starts, int* __restrict__ counts) {
  extern __shared__ int tot[];
  __shared__ int wsum[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int r = t; r < nseg; r += kScanThreads) {
    int run = 0;
    for (int k = 0; k < ntiles; ++k) {
      const size_t h = (size_t)k * nseg + r;
      const int c = hist[h];
      hist[h] = run;
      run += c;
    }
    tot[r] = run;
    counts[r] = run;
  }
  __syncthreads();
  const int per = (nseg + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, nseg), hi = min(lo + per, nseg);
  int s = 0;
  for (int r = lo; r < hi; ++r) s += tot[r];
  int v = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = wsum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  int run = v - s + (warp > 0 ? wsum[warp - 1] : 0);
  for (int r = lo; r < hi; ++r) {
    starts[r] = run;
    run += tot[r];
  }
}

// 3. each entry to its sorted slot, with level 0 of the tree: the eight
// summands of ops/detect.py:object_stats_plain and the segment flag
__global__ void __launch_bounds__(256)
    place_kernel(const long long* __restrict__ cid,
                 const long long* __restrict__ pidx,
                 const float* __restrict__ vals,
                 const int* __restrict__ mask,
                 const uint8_t* __restrict__ wok,
                 const float* __restrict__ thr,
                 const uint8_t* __restrict__ debovf, int cap, int nseg,
                 int W, long long nodes, Scratch s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const int key = valid_id(cid[i], nseg);
  if (key < 0) return;
  const int start = s.starts[key];
  const int p = start + s.hist[(size_t)(i / kRankTile) * nseg + key] +
                s.rank[i];
  const long long f = pidx[i];
  const float v = vals[i];
  s.pidx_s[p] = (int)f;
  s.mask_s[p] = mask[i];
  s.vals_s[p] = v;
  s.thr_s[p] = thr[i];
  s.fl_s[p] = (wok[i] ? 0 : 1) | (debovf[i] ? 2 : 0);
  s.tflag[p] = p == start;
  const float pos = clamp_min(v, 0.0f);
  const float px = (float)(f % W), py = (float)(f / W);
  const float ppx = __fmul_rn(pos, px), ppy = __fmul_rn(pos, py);
  float* t = s.tree + p;
  t[0] = 1.0f;
  t[nodes] = v;
  t[2 * nodes] = pos;
  t[3 * nodes] = ppx;
  t[4 * nodes] = ppy;
  t[5 * nodes] = __fmul_rn(ppx, px);
  t[6 * nodes] = __fmul_rn(ppy, py);
  t[7 * nodes] = __fmul_rn(ppx, py);
}

// 4a. levels 1..kLowLevels of the tree over each chunk of kChunk entries
__global__ void __launch_bounds__(kChunk / 2)
    tree_low_kernel(float* tree, uint8_t* tflag, int cap, long long nodes) {
  __shared__ float sv[kSums][kChunk / 2];
  __shared__ uint8_t sf[kChunk / 2];
  const int t = threadIdx.x;
  long long off = cap;  // level 1's offset
  float v[kSums] = {};
  uint8_t f = 0;
  {
    const long long k = (long long)blockIdx.x * (kChunk / 2) + t;
    if (k < (cap >> 1)) {
      const long long a = 2 * k, b = a + 1;
      const uint8_t sb = tflag[b];
#pragma unroll
      for (int q = 0; q < kSums; ++q) {
        const float va = tree[q * nodes + a], vb = tree[q * nodes + b];
        v[q] = sb ? vb : __fadd_rn(va, vb);
        tree[q * nodes + off + k] = v[q];
      }
      f = tflag[a] | sb;
      tflag[off + k] = f;
    }
#pragma unroll
    for (int q = 0; q < kSums; ++q) sv[q][t] = v[q];
    sf[t] = f;
  }
  __syncthreads();
  for (int L = 2; L <= kLowLevels; ++L) {
    off += cap >> (L - 1);
    const int width = kChunk >> L;
    const bool act = t < width;
    const long long k = (long long)blockIdx.x * width + t;
    if (act) {
      const uint8_t sb = sf[2 * t + 1];
#pragma unroll
      for (int q = 0; q < kSums; ++q)
        v[q] = sb ? sv[q][2 * t + 1] : __fadd_rn(sv[q][2 * t], sv[q][2 * t + 1]);
      f = sf[2 * t] | sb;
    }
    __syncthreads();
    if (act) {
#pragma unroll
      for (int q = 0; q < kSums; ++q) sv[q][t] = v[q];
      sf[t] = f;
      if (k < (cap >> L)) {
#pragma unroll
        for (int q = 0; q < kSums; ++q) tree[q * nodes + off + k] = v[q];
        tflag[off + k] = f;
      }
    }
    __syncthreads();
  }
}

// 4b. the levels above kLowLevels, in one block (no __restrict__: this
// block reads what it wrote one level before)
__global__ void __launch_bounds__(kScanThreads)
    tree_high_kernel(float* tree, uint8_t* tflag, int cap, long long nodes) {
  long long off = 0;
  for (int L = 0; L < kLowLevels; ++L) off += cap >> L;
  for (int L = kLowLevels + 1; (cap >> L) >= 1; ++L) {
    const long long prev = off;
    off += cap >> (L - 1);
    const long long n = cap >> L;
    for (long long k = threadIdx.x; k < n; k += blockDim.x) {
      const long long a = prev + 2 * k, b = a + 1;
      const uint8_t sb = tflag[b];
      for (int q = 0; q < kSums; ++q) {
        const float va = tree[q * nodes + a], vb = tree[q * nodes + b];
        tree[q * nodes + off + k] = sb ? vb : __fadd_rn(va, vb);
      }
      tflag[off + k] = tflag[a] | sb;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = torch_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = torch_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_or(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ordered.fma on the card: the product exact in double, one double add,
// one rounding to f32 (as (a.double() * b.double() + c.double()).float())
__device__ __forceinline__ float fma_plain(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// 5. one block a row: the order-free reductions over its sorted span, the
// eight sums walked up the tree from its last entry, the epilogue
__global__ void __launch_bounds__(kRowThreads)
    rows_kernel(const long long* __restrict__ pidx,
                const long long* __restrict__ ndet, int cap, int H, int W,
                int nseg, float minarea, int max_det, long long nodes,
                Scratch s, float* __restrict__ outf, int* __restrict__ outi,
                uint8_t* __restrict__ valid) {
  enum { kMax = 6, kMin = 2 };
  __shared__ float red[kRowThreads / 32][kMax + kMin];
  __shared__ int redi[kRowThreads / 32][2];
  __shared__ float sums[kSums];
  const int row = blockIdx.x, t = threadIdx.x;
  const int cnt = s.counts[row], st = s.starts[row];
  // peak, xmax, ymax, thresh; xmin, ymin; the mask OR; the flag bits
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float mn[2] = {INFINITY, INFINITY};
  int mor = 0, fl = 0;
  for (int p = st + t; p < st + cnt; p += blockDim.x) {
    const int f = s.pidx_s[p];
    mx[0] = torch_max(mx[0], s.vals_s[p]);
    const float px = (float)(f % W), py = (float)(f / W);
    mx[1] = torch_max(mx[1], px);
    mx[2] = torch_max(mx[2], py);
    mx[3] = torch_max(mx[3], s.thr_s[p]);
    mn[0] = torch_min(mn[0], px);
    mn[1] = torch_min(mn[1], py);
    mor |= s.mask_s[p];
    fl |= s.fl_s[p];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) mx[q] = warp_max(mx[q]);
#pragma unroll
  for (int q = 0; q < 2; ++q) mn[q] = warp_min(mn[q]);
  mor = warp_or(mor);
  fl = warp_or(fl);
  const int lane = t & 31, warp = t >> 5;
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) red[warp][q] = mx[q];
    red[warp][4] = mn[0];
    red[warp][5] = mn[1];
    redi[warp][0] = mor;
    redi[warp][1] = fl;
  }
  if (t < kSums) {
    float acc = 0.0f;
    if (cnt > 0) {
      // the walk of ops/ordered.py:tree_scan_at: up from the row's last
      // entry, collecting the even positions' nodes, to the first 0
      long long ops[64];
      int nops = 0;
      long long i = (long long)st + cnt - 1, off = 0;
      int L = 0;
      while (i != 0) {
        if (i & 1) {
          i = (i - 1) >> 1;
        } else {
          ops[nops++] = off + i;
          i = (i >> 1) - 1;
        }
        off += cap >> L;
        ++L;
      }
      const float* tv = s.tree + (long long)t * nodes;
      acc = tv[off];
      for (int q = nops - 1; q >= 0; --q) {
        const float v = tv[ops[q]];
        acc = s.tflag[ops[q]] ? v : __fadd_rn(acc, v);
      }
    }
    sums[t] = acc;
  }
  __syncthreads();
  if (t != 0) return;
  for (int w = 1; w < kRowThreads / 32; ++w) {
#pragma unroll
    for (int q = 0; q < 4; ++q) red[0][q] = torch_max(red[0][q], red[w][q]);
    red[0][4] = torch_min(red[0][4], red[w][4]);
    red[0][5] = torch_min(red[0][5], red[w][5]);
    redi[0][0] |= redi[w][0];
    redi[0][1] |= redi[w][1];
  }
  const bool present = cnt > 0;
  const float peak = present ? red[0][0] : 0.0f;
  const float xmax = present ? red[0][1] : -INFINITY;
  const float ymax = present ? red[0][2] : -INFINITY;
  const float thresh = present ? red[0][3] : 0.0f;
  const float xmin = present ? red[0][4] : INFINITY;
  const float ymin = present ? red[0][5] : INFINITY;
  const int imaflags = present ? redi[0][0] : 0;
  const int bits = present ? redi[0][1] : 0;
  const float npix = sums[0], flux = sums[1];
  const float wsum = clamp_min(sums[2], 1e-20f);
  const float xbar = __fdiv_rn(sums[3], wsum);
  const float ybar = __fdiv_rn(sums[4], wsum);
  const float x2 =
      clamp_min(fma_plain(-xbar, xbar, __fdiv_rn(sums[5], wsum)), 1.0f / 12.0f);
  const float y2 =
      clamp_min(fma_plain(-ybar, ybar, __fdiv_rn(sums[6], wsum)), 1.0f / 12.0f);
  const float xy = fma_plain(-xbar, ybar, __fdiv_rn(sums[7], wsum));
  const float t1 = __fmul_rn(__fadd_rn(x2, y2), 0.5f);
  const float d = __fmul_rn(__fsub_rn(x2, y2), 0.5f);
  const float t2 = __fsqrt_rn(
      clamp_min(__fadd_rn(__fmul_rn(d, d), __fmul_rn(xy, xy)), 0.0f));
  const float a = __fsqrt_rn(clamp_min(__fadd_rn(t1, t2), 1e-12f));
  const float b = __fsqrt_rn(clamp_min(__fsub_rn(t1, t2), 1e-12f));
  const float theta =
      __fmul_rn(atan2f(__fmul_rn(2.0f, xy), __fsub_rn(x2, y2)), 0.5f);
  const float elong = __fdiv_rn(a, clamp_min(b, 1e-12f));
  // np.float32(np.log(2.0))
  const float fwhm = __fmul_rn(
      __fsqrt_rn(__fmul_rn(0.693147182464599609375f, __fadd_rn(x2, y2))),
      2.0f);
  const bool ok = row >= 1 && row <= max_det && npix >= minarea;
  const bool edge = xmin <= 0.0f || ymin <= 0.0f || xmax >= (float)(W - 1) ||
                    ymax >= (float)(H - 1);
  const long long nd = *ndet;
  const float trunc_row =
      nd > cap ? __fsub_rn((float)(pidx[cap - 1] / W), 1.0f) : (float)H;
  const int flags = ((bits & 1) ? 1 : 0) | (edge ? 8 : 0) |
                    ((bits & 2) ? 64 : 0) | (ymax >= trunc_row ? 128 : 0);
  // the float fields in launch.OBJECT_FLOAT_KEYS' order
  const float f[18] = {xbar, ybar, x2,   y2,    xy,   a,    b,    theta, elong,
                       fwhm, flux, peak, npix, xmin, xmax, ymin, ymax, thresh};
#pragma unroll
  for (int q = 0; q < 18; ++q) outf[(size_t)q * nseg + row] = f[q];
  outi[row] = imaflags;
  outi[nseg + row] = flags;
  valid[row] = ok;
}

// ---- H27 -----------------------------------------------------------------

struct CleanScratch {
  float* contrib;    // (nseg,) the summed wings (0 on invalid rows), output
  int* tgt;          // (nseg,) each row's target, output
  float* coef;       // (4, nseg): cxx, cyy, cxy, peak_f
  int* list;         // (nseg,) the cleaned rows, ascending
  uint8_t* cleaned;  // (nseg,)
};

inline size_t carve_clean(char* base, int nseg, CleanScratch* s) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) & ~size_t(255);
    return p;
  };
  s->coef = (float*)take(sizeof(float) * 4 * (size_t)nseg);
  s->list = (int*)take(sizeof(int) * (size_t)nseg);
  s->cleaned = (uint8_t*)take((size_t)nseg);
  return off;
}

// the ellipse coefficients and the masked peak of each row, rounded as
// ops/detect.py:clean_pass on the card (1.0 / d is reciprocal(d) * 1.0)
__global__ void __launch_bounds__(256)
    clean_coef_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ theta,
                      const float* __restrict__ peak,
                      const uint8_t* __restrict__ valid, int nseg,
                      CleanScratch s) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nseg) return;
  const float aj = a[j], bj = b[j];
  const float da = clamp_min(__fmul_rn(aj, aj), 1e-6f);
  const float db = clamp_min(__fmul_rn(bj, bj), 1e-6f);
  const float ct = cosf(theta[j]), st = sinf(theta[j]);
  const float cc = __fmul_rn(ct, ct), ss = __fmul_rn(st, st);
  s.coef[j] = __fadd_rn(__fdiv_rn(cc, da), __fdiv_rn(ss, db));
  s.coef[nseg + j] = __fadd_rn(__fdiv_rn(ss, da), __fdiv_rn(cc, db));
  s.coef[2 * nseg + j] =
      __fmul_rn(__fmul_rn(__fmul_rn(2.0f, ct), st),
                __fsub_rn(__frcp_rn(da), __frcp_rn(db)));
  s.coef[3 * nseg + j] = valid[j] ? peak[j] : 0.0f;
}

__device__ __forceinline__ int clean_width(int nseg, int blk) {
  return min(kCleanBlock, nseg - blk * kCleanBlock);
}
// sum_last's windows of a block of m columns: one sequential run when
// m <= 32, else ceil(m / 32) windows over the zero-padded block
__device__ __forceinline__ int clean_windows(int m) {
  return m <= kWin ? 1 : (m + kWin - 1) / kWin;
}

// one block a valid row: each thread sums one window of one column block
// in order and keeps its first largest wing; thread 0 then adds the
// windows and the blocks in sequence and picks the dominant contributor
__global__ void __launch_bounds__(kCleanThreads)
    clean_rows_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ peak,
                      const float* __restrict__ thr,
                      const uint8_t* __restrict__ valid, int nseg,
                      float inv_scale, int npairs, CleanScratch s) {
  extern __shared__ float wsum[];
  float* wmax = wsum + npairs;
  int* warg = (int*)(wmax + npairs);
  uint8_t* wnan = (uint8_t*)(warg + npairs);
  const int i = blockIdx.x;
  if (!valid[i]) {
    if (threadIdx.x == 0) {
      s.contrib[i] = 0.0f;
      s.cleaned[i] = 0;
      s.tgt[i] = nseg - 1;
    }
    return;
  }
  const float xi = x[i], yi = y[i];
  const float* cxx = s.coef;
  const float* cyy = s.coef + nseg;
  const float* cxy = s.coef + 2 * nseg;
  const float* pf = s.coef + 3 * nseg;
  const float pfi = pf[i];
  const int nfull = nseg / kCleanBlock;  // blocks of 512 columns, 16 windows
  for (int q = threadIdx.x; q < npairs; q += blockDim.x) {
    const int blk = q < nfull * 16 ? q / 16 : nfull;
    const int w = q - blk * 16;
    const int m = clean_width(nseg, blk);
    const int pad = m <= kWin ? 0 : (kWin - m % kWin) % kWin;
    const int lo = pad / 2;
    const int len = m <= kWin ? m : kWin;
    float acc = 0.0f, best = -INFINITY;
    int arg = -1;
    bool nan = false;
    for (int u = 0; u < len; ++u) {
      const int col = w * kWin + u - lo;  // column within the block
      float c = 0.0f;
      if (col >= 0 && col < m) {
        const int j = blk * kCleanBlock + col;
        if (valid[j] && pf[j] > pfi && j != i) {
          const float dx = __fsub_rn(xi, x[j]), dy = __fsub_rn(yi, y[j]);
          const float r2 = __fadd_rn(
              __fadd_rn(__fmul_rn(__fmul_rn(cxx[j], dx), dx),
                        __fmul_rn(__fmul_rn(cyy[j], dy), dy)),
              __fmul_rn(__fmul_rn(cxy[j], dx), dy));
          c = __fmul_rn(pf[j],
                        powf(__fadd_rn(__fmul_rn(r2, inv_scale), 1.0f), -2.5f));
        }
        if (isnan(c)) {
          nan = true;
        } else if (arg < 0 || c > best) {
          best = c;
          arg = j;
        }
      }
      acc = u == 0 ? c : __fadd_rn(acc, c);
    }
    wsum[q] = acc;
    wmax[q] = best;
    warg[q] = arg;
    wnan[q] = nan;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float contrib = 0.0f, best_c = 0.0f;
  int best_j = 0;
  const int nblk = (nseg + kCleanBlock - 1) / kCleanBlock;
  for (int blk = 0, q = 0; blk < nblk; ++blk) {
    const int nw = clean_windows(clean_width(nseg, blk));
    float bsum = wsum[q], bmax = wmax[q];
    int barg = warg[q];
    bool bnan = wnan[q];
    for (int w = 1; w < nw; ++w) {
      bsum = __fadd_rn(bsum, wsum[q + w]);
      bnan |= wnan[q + w];
      if (warg[q + w] >= 0 && (barg < 0 || wmax[q + w] > bmax)) {
        bmax = wmax[q + w];
        barg = warg[q + w];
      }
    }
    q += nw;
    contrib = __fadd_rn(contrib, bsum);
    if (!bnan && barg >= 0 && bmax > best_c) {
      best_c = bmax;
      best_j = barg;
    }
  }
  const bool cleaned = __fsub_rn(peak[i], contrib) <= thr[i];
  s.contrib[i] = contrib;
  s.cleaned[i] = cleaned;
  s.tgt[i] = cleaned ? best_j : nseg - 1;
}

// the merge, one block: the cleaned rows listed in ascending order, then
// each target adds theirs in that order
__global__ void __launch_bounds__(kScanThreads)
    clean_merge_kernel(const float* __restrict__ flux,
                       const float* __restrict__ npix,
                       const int* __restrict__ flags,
                       const uint8_t* __restrict__ valid, int nseg,
                       CleanScratch s, float* __restrict__ flux_out,
                       float* __restrict__ npix_out,
                       int* __restrict__ flags_out,
                       uint8_t* __restrict__ valid_out) {
  __shared__ int wsum[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (nseg + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, nseg), hi = min(lo + per, nseg);
  int c = 0;
  for (int r = lo; r < hi; ++r) c += s.cleaned[r];
  int v = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = wsum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  int pos = v - c + (warp > 0 ? wsum[warp - 1] : 0);
  for (int r = lo; r < hi; ++r)
    if (s.cleaned[r]) s.list[pos++] = r;
  __syncthreads();
  const int m = wsum[31];
  for (int r = t; r < nseg; r += blockDim.x) {
    float af = 0.0f, an = 0.0f;
    bool got = false;
    for (int q = 0; q < m; ++q) {
      const int src = s.list[q];
      if (s.tgt[src] == r) {
        af = __fadd_rn(af, flux[src]);
        an = __fadd_rn(an, npix[src]);
        got = true;
      }
    }
    flux_out[r] = __fadd_rn(flux[r], af);
    npix_out[r] = __fadd_rn(npix[r], an);
    flags_out[r] = flags[r] | (got ? 2 : 0);
    valid_out[r] = valid[r] && !s.cleaned[r];
  }
}

inline int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 32 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" long long zuds_object_stats_scratch(int cap, int nseg) {
  Scratch s;
  return (long long)carve(nullptr, cap, nseg, &s);
}

extern "C" int zuds_object_stats(
    const long long* cid, const long long* pidx, const float* vals,
    const int* mask, const uint8_t* wok, const float* thr,
    const uint8_t* debovf, const long long* ndet, int cap, int H, int W,
    int nseg, float minarea, int max_det, void* scratch, float* outf,
    int* outi, uint8_t* valid, cudaStream_t stream) {
  Scratch s;
  carve((char*)scratch, cap, nseg, &s);
  const long long nodes = tree_nodes(cap);
  const int ntiles = (cap + kRankTile - 1) / kRankTile;
  const size_t smem = sizeof(int) * (size_t)nseg;
  int err = set_smem((const void*)rank_kernel, smem);
  if (!err) err = set_smem((const void*)offsets_kernel, smem);
  if (err) return err;
  rank_kernel<<<ntiles, 32, smem, stream>>>(cid, cap, nseg, s.rank, s.hist);
  offsets_kernel<<<1, kScanThreads, smem, stream>>>(s.hist, ntiles, nseg,
                                                    s.starts, s.counts);
  place_kernel<<<(cap + 255) / 256, 256, 0, stream>>>(
      cid, pidx, vals, mask, wok, thr, debovf, cap, nseg, W, nodes, s);
  tree_low_kernel<<<(cap + kChunk - 1) / kChunk, kChunk / 2, 0, stream>>>(
      s.tree, s.tflag, cap, nodes);
  if ((cap >> (kLowLevels + 1)) >= 1)
    tree_high_kernel<<<1, kScanThreads, 0, stream>>>(s.tree, s.tflag, cap,
                                                     nodes);
  rows_kernel<<<nseg, kRowThreads, 0, stream>>>(pidx, ndet, cap, H, W, nseg,
                                                minarea, max_det, nodes, s,
                                                outf, outi, valid);
  return (int)cudaGetLastError();
}

extern "C" long long zuds_clean_scratch(int nseg) {
  CleanScratch s;
  return (long long)carve_clean(nullptr, nseg, &s);
}

extern "C" int zuds_clean(const float* x, const float* y, const float* a,
                          const float* b, const float* theta,
                          const float* peak, const float* thr,
                          const float* flux, const float* npix,
                          const int* flags, const uint8_t* valid, int nseg,
                          float inv_scale, void* scratch, float* contrib,
                          int* tgt, float* flux_out, float* npix_out,
                          int* flags_out, uint8_t* valid_out,
                          cudaStream_t stream) {
  CleanScratch s;
  carve_clean((char*)scratch, nseg, &s);
  s.contrib = contrib;
  s.tgt = tgt;
  const int nfull = nseg / kCleanBlock, rest = nseg % kCleanBlock;
  const int npairs =
      nfull * 16 + (rest == 0 ? 0 : (rest <= kWin ? 1 : (rest + kWin - 1) / kWin));
  const size_t smem = (size_t)npairs * (2 * sizeof(float) + sizeof(int) + 1);
  const int err = set_smem((const void*)clean_rows_kernel, smem);
  if (err) return err;
  clean_coef_kernel<<<(nseg + 255) / 256, 256, 0, stream>>>(a, b, theta, peak,
                                                            valid, nseg, s);
  clean_rows_kernel<<<nseg, kCleanThreads, smem, stream>>>(
      x, y, peak, thr, valid, nseg, inv_scale, npairs, s);
  clean_merge_kernel<<<1, kScanThreads, 0, stream>>>(
      flux, npix, flags, valid, nseg, s, flux_out, npix_out, flags_out,
      valid_out);
  return (int)cudaGetLastError();
}
