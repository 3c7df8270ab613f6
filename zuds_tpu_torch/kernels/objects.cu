// H26 (per-object statistics) and H27 (CLEAN) of the detect stage.
//
// H26 replaces zuds_tpu/ops/detect.py:840-953: one sort of the compact
// list by object id, eight segmented scans of sums, six of maxima, two of
// minima and one of ORs, read at each row's last entry, and the shape and
// flag epilogue, into nseg = max_det + 2 rows. The sums cancel
// (x2 = sxx / wsum - xbar^2), so the reference's pairing
// (jax.lax.associative_scan, ops/ordered.py:segmented_scan) is kept bit
// for bit. The scan read at a row's last entry depends only on the row's
// own sorted entries and its absolute start s: it is the left fold, in
// position order, of the maximal aligned dyadic blocks inside the row's
// span [s, s + count), each a perfect pairwise tree (ops/ordered.py:
// row_tree_sum, the CPU twin). Four launches:
//   1. a stable counting sort's ranks: one warp a tile of 1024 entries
//      ranks each entry among the tile's equal ids in order
//      (__match_any_sync) and counts the tile's ids in shared memory;
//   2. one thread a row: its tiles' counts loaded 16 at a time, their
//      offsets, a block scan of the rows' totals; an empty row writes its
//      fixed outputs here, a non-empty one joins the list of live rows;
//   3. each entry to its sorted slot (the permutation torch.sort(stable=
//      True) gives), the rows' starts and the windows of 1024 entries that
//      lie whole in one row marked;
//   4. the row pass: a block a window marked whole sums it (a lane an
//      entry, a butterfly of shuffles for levels 1-5 of its tree, one warp
//      over the 32 group sums for levels 6-10) with its order-free maxima,
//      minima and ORs; blocks striding over the live rows sum the blocks
//      of levels 0-9 in the row's first and last windows the same way,
//      pair the whole windows' sums into the blocks of levels past 9, and
//      fold them in position order; a row with whole windows is finished
//      by whichever of its blocks arrives last (an atomic count, no
//      wait), its edge windows' sums stored beforehand by its own block,
//      at the time its windows' blocks run. One thread forms the
//      epilogue, rounding each step as the plain version does on the
//      card (the "c - a*b" of ordered.fma in double, true divisions,
//      __fsqrt_rn, the products by 0.5 of PyTorch's division by a Python
//      2.0).
// Bound: memory, a few bytes: each of the 65,536 entries' 30 bytes read
// once, 81 bytes written a row (2.3 MB, 0.7 us at 3.35 TB/s). The time
// is four launches' latency: two dependent scans of a few thousand rows,
// the scatter, and one block's chain of shuffles a live row.
//
// H27 replaces zuds_tpu/ops/detect.py:954-1008 (the port's
// ops/detect.py:_clean_plain): the Moffat-wing contribution of every
// brighter valid row at each valid row's centroid, summed in 512-column
// blocks in XLA:CPU's windowed order (ops/ordered.py:sum_last: 32-wide
// sequential windows, their partials in sequence), the blocks in
// sequence; the dominant contributor (the first column of a block's
// largest wing, taken only on a strictly larger value, block by block);
// then the merge of each cleaned row's flux and npix into its contributor.
// An invalid row's wing is +0, and a +0 term changes no bit of a sum that
// starts from +0, so only the valid rows are visited. Two launches:
//   1. a warp a valid row, the k-th on block k % G (a short list spreads
//      over the card): each block lists the valid rows in shared memory
//      (ballots of the valid flags, a thread a window or two, one block
//      scan) with the non-empty windows, writes its 32 rows as no merge
//      leaves them, and exits there if it holds no listed row; then 32
//      windows at a time it stages their columns' ellipse coefficients in
//      shared memory, a lane folds one window for its warp's row (where
//      the group has few windows, the lanes first compute a column's wing
//      each) and the warp the windows' partials in order (shuffles);
//   2. one block merges, launched as a programmatic dependent launch so
//      that its start overlaps launch 1: the cleaned rows in ascending
//      order, a chunk at a time sorted by (target, position), each
//      target's run added in that order, as index_add does on the CPU (on
//      the card index_add adds in atomic order), and the target's flux,
//      npix and flags written again. pow(x, -2.5) is powf, as torch.pow on
//      the card.
// Bound: operations, ~3 a pair of valid rows and ~14 more with a powf for
// each brighter valid neighbour, and 60 B a row; the flagship frames' ~60
// valid rows are far below a launch's latency (the time is two launches'
// chains of dependent reads, scans and barriers), 3,300 (a crowded
// 4098-row set) take ~0.002 ms at fp32's 67 TFLOP/s.
#include "common.cuh"

namespace {

constexpr int kRankTile = 1024;   // entries a warp ranks in the counting sort
constexpr int kSpanLog = 10;      // the row pass's aligned windows
constexpr int kSpan = 1 << kSpanLog;
constexpr int kOffThreads = 256;  // rows a block of the offsets pass
constexpr int kMaxRowBlocks = 256; // such blocks (nseg <= 65,536)
constexpr int kSums = 8;
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kGroups = kSpan / 32;               // of 32 entries a window
constexpr int kGroupsPerWarp = kGroups / kRowWarps;
constexpr int kMidChunk = 128;    // whole windows' sums staged at once
constexpr int kLevels = 32;       // levels of the tree over < 2^31 entries
// a row's edge passes as stored for its last arriver: the cover sums of
// levels 0-9 (both ends), the six order-free extrema, the two ORs
constexpr int kEdge = kSpanLog * 2 * kSums + 8;
constexpr int kCleanThreads = 1024; // H27's rows: a warp a listed row
constexpr int kMergeThreads = 256;  // H27's merge block: a chunk's rows
constexpr int kCleanMaxRows = 50000; // launch.OBJECT_MAX_ROWS
constexpr int kCleanBlock = 512;  // columns of a block (the plain blk)
constexpr int kWin = 32;          // sum_last's window
constexpr int kBlockWins = kCleanBlock / kWin;
static_assert(kSpan == kRankTile, "a window is a tile of the sort");
static_assert(kGroupsPerWarp * kRowWarps == kGroups, "whole groups a warp");
static_assert(kMaxRowBlocks == kOffThreads, "one row block's total a thread");

struct Scratch {
  int* hist;        // (ntiles, nseg) each tile's count of each id
  int* toff;        // (ntiles, nseg) each tile's offset in its id's span
  int* rank;        // (cap,) rank among the tile's equal ids
  int* local;       // (nseg,) the counts' exclusive scan in its block
  int* blocksum;    // (kMaxRowBlocks,) each row block's total
  int* starts;      // (nseg,) the rows' starts (non-empty rows)
  int* counts;      // (nseg,)
  int* list;        // (nseg,) the non-empty rows, in no order
  int* nlist;       // (1,)
  int* arrive;      // (nseg,) blocks of a row done with their part
  int* win_row;     // (ntiles,) the row a window lies whole in, or -1
  float* win_sum;   // (ntiles, kSums) such a window's eight tree sums
  float* win_mm;    // (ntiles, 6) its peak, xmax, ymax, thresh; xmin, ymin
  int* win_or;      // (ntiles, 2) its mask OR and flag bits
  float* edge;      // (nseg, kEdge) a long row's first and last windows'
                    // cover sums and order-free reductions
  int* pidx_s;      // (cap,) sorted flat indices
  int* mask_s;      // (cap,)
  float* vals_s;    // (cap,)
  float* thr_s;     // (cap,)
  uint8_t* fl_s;    // (cap,) bit 0: weight not ok, bit 1: deblend overflow
};

inline size_t carve(char* base, int cap, int nseg, Scratch* s) {
  const int ntiles = (cap + kRankTile - 1) / kRankTile;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) & ~size_t(255);
    return p;
  };
  const size_t tn = (size_t)ntiles * nseg;
  s->hist = (int*)take(sizeof(int) * tn);
  s->toff = (int*)take(sizeof(int) * tn);
  s->rank = (int*)take(sizeof(int) * (size_t)cap);
  s->local = (int*)take(sizeof(int) * (size_t)nseg);
  s->blocksum = (int*)take(sizeof(int) * kMaxRowBlocks);
  s->starts = (int*)take(sizeof(int) * (size_t)nseg);
  s->counts = (int*)take(sizeof(int) * (size_t)nseg);
  s->list = (int*)take(sizeof(int) * (size_t)nseg);
  s->nlist = (int*)take(sizeof(int));
  s->arrive = (int*)take(sizeof(int) * (size_t)nseg);
  s->win_row = (int*)take(sizeof(int) * (size_t)ntiles);
  s->win_sum = (float*)take(sizeof(float) * kSums * (size_t)ntiles);
  s->win_mm = (float*)take(sizeof(float) * 6 * (size_t)ntiles);
  s->win_or = (int*)take(sizeof(int) * 2 * (size_t)ntiles);
  s->edge = (float*)take(sizeof(float) * kEdge * (size_t)nseg);
  s->pidx_s = (int*)take(sizeof(int) * (size_t)cap);
  s->mask_s = (int*)take(sizeof(int) * (size_t)cap);
  s->vals_s = (float*)take(sizeof(float) * (size_t)cap);
  s->thr_s = (float*)take(sizeof(float) * (size_t)cap);
  s->fl_s = (uint8_t*)take((size_t)cap);
  return off;
}

__device__ __forceinline__ int valid_id(long long c, int nseg) {
  return (c >= 0 && c < nseg) ? (int)c : -1;
}

// The order-free reductions of a row: peak, xmax, ymax, thresh (maxima),
// xmin, ymin (minima), the mask OR and the flag bits.
struct Part {
  float mx[4], mn[2];
  int mor, fl;
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int q = 0; q < 4; ++q) mx[q] = -INFINITY;
    mn[0] = mn[1] = INFINITY;
    mor = fl = 0;
  }
  __device__ __forceinline__ void add(const float* m6, int m, int f) {
#pragma unroll
    for (int q = 0; q < 4; ++q) mx[q] = torch_max(mx[q], m6[q]);
    mn[0] = torch_min(mn[0], m6[4]);
    mn[1] = torch_min(mn[1], m6[5]);
    mor |= m;
    fl |= f;
  }
  __device__ __forceinline__ void to(float* m6) const {
#pragma unroll
    for (int q = 0; q < 4; ++q) m6[q] = mx[q];
    m6[4] = mn[0];
    m6[5] = mn[1];
  }
};

// ordered.fma on the card: the product exact in double, one double add,
// one rounding to f32 (as (a.double() * b.double() + c.double()).float())
__device__ __forceinline__ float fma_plain(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// The epilogue's arguments, passed by value to the launches that write
// rows.
struct RowOut {
  const long long* pidx;
  const long long* ndet;
  int cap, H, W, nseg;
  float minarea;
  int max_det;
  float* outf;
  int* outi;
  uint8_t* valid;
};

// One row's outputs from its eight sums and its order-free reductions
// (``present``: the row has entries; else the plain version's fills).
__device__ void write_row(int row, bool present, const float* sums,
                          const float* m6, int mor, int fl, const RowOut& o) {
  const int cap = o.cap, H = o.H, W = o.W, nseg = o.nseg;
  const float peak = present ? m6[0] : 0.0f;
  const float xmax = present ? m6[1] : -INFINITY;
  const float ymax = present ? m6[2] : -INFINITY;
  const float thresh = present ? m6[3] : 0.0f;
  const float xmin = present ? m6[4] : INFINITY;
  const float ymin = present ? m6[5] : INFINITY;
  const int imaflags = present ? mor : 0;
  const int bits = present ? fl : 0;
  const float npix = present ? sums[0] : 0.0f;
  const float flux = present ? sums[1] : 0.0f;
  const float wsum = clamp_min(present ? sums[2] : 0.0f, 1e-20f);
  const float xbar = __fdiv_rn(present ? sums[3] : 0.0f, wsum);
  const float ybar = __fdiv_rn(present ? sums[4] : 0.0f, wsum);
  const float x2 = clamp_min(
      fma_plain(-xbar, xbar, __fdiv_rn(present ? sums[5] : 0.0f, wsum)),
      1.0f / 12.0f);
  const float y2 = clamp_min(
      fma_plain(-ybar, ybar, __fdiv_rn(present ? sums[6] : 0.0f, wsum)),
      1.0f / 12.0f);
  const float xy =
      fma_plain(-xbar, ybar, __fdiv_rn(present ? sums[7] : 0.0f, wsum));
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
  const bool ok = row >= 1 && row <= o.max_det && npix >= o.minarea;
  const bool edge = xmin <= 0.0f || ymin <= 0.0f || xmax >= (float)(W - 1) ||
                    ymax >= (float)(H - 1);
  const long long nd = *o.ndet;
  const float trunc_row =
      nd > cap ? __fsub_rn((float)(o.pidx[cap - 1] / W), 1.0f) : (float)H;
  const int flags = ((bits & 1) ? 1 : 0) | (edge ? 8 : 0) |
                    ((bits & 2) ? 64 : 0) | (ymax >= trunc_row ? 128 : 0);
  // the float fields in launch.OBJECT_FLOAT_KEYS' order
  const float f[18] = {xbar, ybar, x2,   y2,    xy,   a,    b,    theta, elong,
                       fwhm, flux, peak, npix, xmin, xmax, ymin, ymax, thresh};
#pragma unroll
  for (int q = 0; q < 18; ++q) o.outf[(size_t)q * nseg + row] = f[q];
  o.outi[row] = imaflags;
  o.outi[nseg + row] = flags;
  o.valid[row] = ok;
}

// 1. per tile: each entry's rank among the tile's equal ids, in order, and
// the tile's count of each id (one warp; nseg ints of shared memory); the
// tile's window unmarked, the list of live rows emptied
__global__ void __launch_bounds__(32)
    rank_kernel(const long long* __restrict__ cid, int cap, int nseg,
                Scratch s) {
  extern __shared__ int cnt[];
  const int lane = threadIdx.x;
  for (int r = lane; r < nseg; r += 32) cnt[r] = 0;
  if (lane == 0) {
    s.win_row[blockIdx.x] = -1;
    if (blockIdx.x == 0) *s.nlist = 0;
  }
  __syncwarp();
  const int base = blockIdx.x * kRankTile;
#pragma unroll 4
  for (int k = 0; k < kRankTile; k += 32) {
    const int i = base + k + lane;
    const int key = i < cap ? valid_id(cid[i], nseg) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0) s.rank[i] = cnt[key] + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
    if (key >= 0 && lane == __ffs(peers) - 1) cnt[key] += __popc(peers);
    __syncwarp();
  }
  for (int r = lane; r < nseg; r += 32)
    s.hist[(size_t)blockIdx.x * nseg + r] = cnt[r];
}

// An exclusive scan of v over the block of kOffThreads threads; ``wsum``
// holds kOffThreads / 32 ints. Returns the thread's prefix and writes the
// block's total to *total.
__device__ __forceinline__ int block_scan(int v, int* wsum, int* total) {
  constexpr int kWarps = kOffThreads / 32;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? wsum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) wsum[lane] = w;
  }
  __syncthreads();
  *total = wsum[kWarps - 1];
  return x - v + (warp > 0 ? wsum[warp - 1] : 0);
}

// 2. one thread a row: its counts over the tiles -> their offsets and its
// total; the totals' exclusive scan within the block of kOffThreads rows
// and the block's total; empty rows written, live rows listed
__global__ void __launch_bounds__(kOffThreads)
    offsets_kernel(const int* __restrict__ hist, int ntiles, Scratch s,
                   RowOut o) {
  __shared__ int wsum[kOffThreads / 32];
  const int nseg = o.nseg;
  const int t = threadIdx.x, lane = t & 31;
  const int r = blockIdx.x * kOffThreads + t;
  int run = 0;
  if (r < nseg) {
    int k = 0;
    for (; k + 16 <= ntiles; k += 16) {
      int c[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) c[j] = hist[(size_t)(k + j) * nseg + r];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        s.toff[(size_t)(k + j) * nseg + r] = run;
        run += c[j];
      }
    }
    for (; k < ntiles; ++k) {
      const int c = hist[(size_t)k * nseg + r];
      s.toff[(size_t)k * nseg + r] = run;
      run += c;
    }
  }
  int total;
  const int excl = block_scan(run, wsum, &total);
  if (r < nseg) {
    s.local[r] = excl;
    s.counts[r] = run;
    s.arrive[r] = 0;
  }
  if (t == 0) s.blocksum[blockIdx.x] = total;
  const bool live = r < nseg && run > 0;
  const unsigned m = __ballot_sync(0xffffffffu, live);
  if (m) {
    const int leader = __ffs(m) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(s.nlist, __popc(m));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (live) s.list[base + __popc(m & ((1u << lane) - 1u))] = r;
  }
  if (r < nseg && run == 0) {
    const float zero[kSums] = {};
    Part p;
    p.init();
    float m6[6];
    p.to(m6);
    write_row(r, false, zero, m6, 0, 0, o);
  }
}

// 3. each entry to its sorted slot; the first entry of a row writes its
// start, the entry at a window's first slot marks the window when it lies
// whole in the entry's row
__global__ void __launch_bounds__(kOffThreads)
    place_kernel(const long long* __restrict__ cid,
                 const long long* __restrict__ pidx,
                 const float* __restrict__ vals,
                 const int* __restrict__ mask,
                 const uint8_t* __restrict__ wok,
                 const float* __restrict__ thr,
                 const uint8_t* __restrict__ debovf, int cap, int nseg,
                 int nrowblk, Scratch s) {
  __shared__ int bpre[kMaxRowBlocks];
  __shared__ int wsum[kOffThreads / 32];
  {
    // the row blocks' exclusive prefix, one block a thread
    const int b = (int)threadIdx.x < nrowblk ? s.blocksum[threadIdx.x] : 0;
    int total;
    bpre[threadIdx.x] = block_scan(b, wsum, &total);
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const int key = valid_id(cid[i], nseg);
  if (key < 0) return;
  const int start = s.local[key] + bpre[key / kOffThreads];
  const int p = start + s.toff[(size_t)(i / kRankTile) * nseg + key] +
                s.rank[i];
  if (p == start) s.starts[key] = start;
  if ((p & (kSpan - 1)) == 0 && p + kSpan <= start + s.counts[key])
    s.win_row[p >> kSpanLog] = key;
  s.pidx_s[p] = (int)pidx[i];
  s.mask_s[p] = mask[i];
  s.vals_s[p] = vals[i];
  s.thr_s[p] = thr[i];
  s.fl_s[p] = (wok[i] ? 0 : 1) | (debovf[i] ? 2 : 0);
}

// The row [st, m)'s cover at level L: the block (node index) it takes at
// the left end and at the right end, or -1 (the segment tree's loop:
// l = ceil(st / 2^L), r = floor(m / 2^L); l's block when l is odd, r - 1's
// when r is odd, while l < r).
__device__ __forceinline__ void cover_at(long long st, long long m, int L,
                                         long long* left, long long* right) {
  const long long l = (st + (1LL << L) - 1) >> L, r = m >> L;
  const bool hl = (l & 1) && l < r;
  const bool hr = (r & 1) && l + (hl ? 1 : 0) < r;
  *left = hl ? l : -1;
  *right = hr ? r - 1 : -1;
}

struct RowShared {
  float gsum[kGroups][kSums];         // a window's group sums
  float piece[kSpanLog][2][kSums];    // the cover's blocks of levels 0-9
  float ws[kMidChunk * kSums];        // whole windows' sums, a chunk
  float stk[kSums][kLevels];          // each sum's pairing stack
  float mm[kRowWarps][6];
  int mi[kRowWarps][2];
  int midsz[2 * kLevels];             // the cover's blocks past level 9
  float sums[kSums];
  float fin[6];
  int fini[2];
  int last;
};

// The block's reduction of each thread's Part into sh.fin / sh.fini
// (thread 0 merges the warps in order).
__device__ __forceinline__ void reduce_part(Part p, RowShared& sh) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float m6[6];
  p.to(m6);
  int mor = p.mor, fl = p.fl;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      m6[q] = torch_max(m6[q], __shfl_xor_sync(0xffffffffu, m6[q], d));
#pragma unroll
    for (int q = 4; q < 6; ++q)
      m6[q] = torch_min(m6[q], __shfl_xor_sync(0xffffffffu, m6[q], d));
    mor |= __shfl_xor_sync(0xffffffffu, mor, d);
    fl |= __shfl_xor_sync(0xffffffffu, fl, d);
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 6; ++q) sh.mm[warp][q] = m6[q];
    sh.mi[warp][0] = mor;
    sh.mi[warp][1] = fl;
  }
  __syncthreads();
  if (t == 0) {
    Part all;
    all.init();
    for (int w = 0; w < kRowWarps; ++w) all.add(sh.mm[w], sh.mi[w][0],
                                                sh.mi[w][1]);
    all.to(sh.fin);
    sh.fini[0] = all.mor;
    sh.fini[1] = all.fl;
  }
  __syncthreads();
}

// A block's pass over the sorted entries [a, b) of the aligned window w:
// their order-free reductions into ``part``; the sums of the row
// [st, m)'s cover blocks of levels 0-9 that lie in the window into
// sh.piece; with ``win_out``, the whole window's eight sums (level 10).
// Levels 0-5 in each group of 32 entries (a lane an entry, a butterfly of
// shuffles: after step L every lane holds its aligned 2^L-block's sum, the
// tree's pairing, as a + b == b + a), levels 6-10 in warp 0 over the 32
// group sums the same way.
__device__ void window_pass(const Scratch& s, int W, long long w, long long a,
                            long long b, long long st, long long m,
                            float* win_out, RowShared& sh, Part& part) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long base = w << kSpanLog;
  int ef[kGroupsPerWarp], em[kGroupsPerWarp], eb[kGroupsPerWarp];
  float ev[kGroupsPerWarp], et[kGroupsPerWarp];
#pragma unroll
  for (int j = 0; j < kGroupsPerWarp; ++j) {
    const long long p = base + (warp + j * kRowWarps) * 32 + lane;
    const bool in = p >= a && p < b;
    ef[j] = in ? s.pidx_s[p] : 0;
    ev[j] = in ? s.vals_s[p] : 0.0f;
    et[j] = in ? s.thr_s[p] : 0.0f;
    em[j] = in ? s.mask_s[p] : 0;
    eb[j] = in ? (int)s.fl_s[p] : -1;
  }
#pragma unroll
  for (int j = 0; j < kGroupsPerWarp; ++j) {
    const int g = warp + j * kRowWarps;
    const long long g0 = base + g * 32;
    if (g0 + 32 <= a || g0 >= b) continue;  // the warp's group is outside
    float v[kSums];
    if (eb[j] >= 0) {
      const int f = ef[j];
      const float val = ev[j];
      const float px = (float)(f % W), py = (float)(f / W);
      const float pos = clamp_min(val, 0.0f);
      const float ppx = __fmul_rn(pos, px), ppy = __fmul_rn(pos, py);
      v[0] = 1.0f;
      v[1] = val;
      v[2] = pos;
      v[3] = ppx;
      v[4] = ppy;
      v[5] = __fmul_rn(ppx, px);
      v[6] = __fmul_rn(ppy, py);
      v[7] = __fmul_rn(ppx, py);
      const float m6[6] = {val, px, py, et[j], px, py};
      part.add(m6, em[j], eb[j]);
    } else {
#pragma unroll
      for (int q = 0; q < kSums; ++q) v[q] = 0.0f;
    }
#pragma unroll
    for (int L = 0; L <= 5; ++L) {
      if (L > 0) {
#pragma unroll
        for (int q = 0; q < kSums; ++q)
          v[q] = __fadd_rn(v[q],
                           __shfl_xor_sync(0xffffffffu, v[q], 1 << (L - 1)));
      }
      long long nl, nr;
      cover_at(st, m, L, &nl, &nr);
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const long long n = side ? nr : nl;
        if (n >= 0 && ((n << L) >> 5) == (g0 >> 5) &&
            lane == (int)((n << L) & 31)) {
#pragma unroll
          for (int q = 0; q < kSums; ++q) sh.piece[L][side][q] = v[q];
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kSums; ++q) sh.gsum[g][q] = v[q];
    }
  }
  __syncthreads();
  if (warp == 0) {
    const long long g0 = base + lane * 32;
    const bool whole = g0 >= a && g0 + 32 <= b;
    float v[kSums];
#pragma unroll
    for (int q = 0; q < kSums; ++q) v[q] = whole ? sh.gsum[lane][q] : 0.0f;
#pragma unroll
    for (int L = 6; L <= kSpanLog; ++L) {
#pragma unroll
      for (int q = 0; q < kSums; ++q)
        v[q] = __fadd_rn(v[q],
                         __shfl_xor_sync(0xffffffffu, v[q], 1 << (L - 6)));
      if (L < kSpanLog) {
        long long nl, nr;
        cover_at(st, m, L, &nl, &nr);
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const long long n = side ? nr : nl;
          if (n >= 0 && ((n << L) >> kSpanLog) == w &&
              lane == (int)(((n << L) - base) >> 5)) {
#pragma unroll
            for (int q = 0; q < kSums; ++q) sh.piece[L][side][q] = v[q];
          }
        }
      }
    }
    if (win_out != nullptr && lane == 0) {
#pragma unroll
      for (int q = 0; q < kSums; ++q) win_out[q] = v[q];
    }
  }
  __syncthreads();
}

// The row's outputs, by the whole block: its first and last windows'
// passes (those not whole), the whole windows' sums (written by their
// blocks, read past L1) paired into the cover's blocks past level 9, the
// fold of the cover in position order by eight threads (one a sum), the
// order-free reductions, the epilogue.
__device__ __forceinline__ void edge_passes(int row, const Scratch& s,
                                            const RowOut& o, RowShared& sh) {
  const long long st = s.starts[row], m = st + s.counts[row];
  const long long wa = st >> kSpanLog, wb = (m - 1) >> kSpanLog;
  // the whole windows [hw, tw)
  const long long hw = (st + kSpan - 1) >> kSpanLog, tw = m >> kSpanLog;
  Part part;
  part.init();
  if (!(hw <= wa && wa < tw))
    window_pass(s, o.W, wa, st, min(m, (wa + 1) << kSpanLog), st, m, nullptr,
                sh, part);
  if (wb != wa && !(hw <= wb && wb < tw))
    window_pass(s, o.W, wb, wb << kSpanLog, m, st, m, nullptr, sh, part);
  reduce_part(part, sh);
}

// A long row's edge passes (sh.piece, sh.fin, sh.fini) to global memory
// for the last of its blocks, and back.
__device__ __forceinline__ void edge_store(int row, const Scratch& s,
                                           const RowShared& sh) {
  float* e = s.edge + (size_t)row * kEdge;
  const float* p = &sh.piece[0][0][0];
  for (int j = threadIdx.x; j < kEdge; j += kRowThreads)
    e[j] = j < kEdge - 8 ? p[j]
                         : (j < kEdge - 2 ? sh.fin[j - (kEdge - 8)]
                                          : __int_as_float(
                                                sh.fini[j - (kEdge - 2)]));
}
__device__ __forceinline__ void edge_load(int row, const Scratch& s,
                                          RowShared& sh) {
  const float* e = s.edge + (size_t)row * kEdge;
  float* p = &sh.piece[0][0][0];
  for (int j = threadIdx.x; j < kEdge; j += kRowThreads) {
    const float v = __ldcg(e + j);
    if (j < kEdge - 8)
      p[j] = v;
    else if (j < kEdge - 2)
      sh.fin[j - (kEdge - 8)] = v;
    else
      sh.fini[j - (kEdge - 2)] = __float_as_int(v);
  }
  __syncthreads();
}

// The row's outputs, by the whole block, after its edge passes: the whole
// windows' order-free reductions merged, their sums (written by their
// blocks, read past L1) paired into the cover's blocks past level 9, the
// fold of the cover in position order by eight threads (one a sum), the
// epilogue.
__device__ __forceinline__ void finish_row(int row, const Scratch& s,
                                           const RowOut& o, RowShared& sh) {
  const int t = threadIdx.x;
  const long long st = s.starts[row], m = st + s.counts[row];
  // the whole windows [hw, tw)
  const long long hw = (st + kSpan - 1) >> kSpanLog, tw = m >> kSpanLog;
  if (tw > hw) {
    Part part;
    part.init();
    if (t == 0) {
      part.add(sh.fin, sh.fini[0], sh.fini[1]);
      int k = 0;
      long long nl, nr;
      for (int L = kSpanLog; L < kLevels; ++L) {
        cover_at(st, m, L, &nl, &nr);
        if (nl >= 0) sh.midsz[k++] = 1 << (L - kSpanLog);
      }
      for (int L = kLevels - 1; L >= kSpanLog; --L) {
        cover_at(st, m, L, &nl, &nr);
        if (nr >= 0) sh.midsz[k++] = 1 << (L - kSpanLog);
      }
    }
    for (long long w = hw + t; w < tw; w += kRowThreads) {
      float m6[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) m6[q] = __ldcg(s.win_mm + w * 6 + q);
      part.add(m6, __ldcg(s.win_or + w * 2), __ldcg(s.win_or + w * 2 + 1));
    }
    reduce_part(part, sh);
  }

  // the cover in position order: the left blocks of levels 0-9, the
  // blocks past level 9 (left ascending, right descending), the right
  // blocks of levels 9-0
  float acc = 0.0f;
  bool have = false;
  if (t < kSums) {
    for (int L = 0; L < kSpanLog; ++L) {
      long long nl, nr;
      cover_at(st, m, L, &nl, &nr);
      if (nl >= 0) {
        const float v = sh.piece[L][0][t];
        acc = have ? __fadd_rn(acc, v) : v;
        have = true;
      }
    }
  }
  if (tw > hw) {
    int pi = 0, inpiece = 0, top = 0;
    for (long long c0 = hw; c0 < tw; c0 += kMidChunk) {
      const int n = (int)min((long long)kMidChunk, tw - c0);
      for (int j = t; j < n * kSums; j += kRowThreads)
        sh.ws[j] = __ldcg(s.win_sum + c0 * kSums + j);
      __syncthreads();
      if (t < kSums) {
        for (int j = 0; j < n; ++j) {
          // the binary counter of the block's windows: a pair of equal
          // levels merges, left + right
          float v = sh.ws[j * kSums + t];
          for (int c = inpiece; c & 1; c >>= 1)
            v = __fadd_rn(sh.stk[t][--top], v);
          sh.stk[t][top++] = v;
          if (++inpiece == sh.midsz[pi]) {
            acc = have ? __fadd_rn(acc, sh.stk[t][0]) : sh.stk[t][0];
            have = true;
            top = inpiece = 0;
            ++pi;
          }
        }
      }
      __syncthreads();
    }
  }
  if (t < kSums) {
    for (int L = kSpanLog - 1; L >= 0; --L) {
      long long nl, nr;
      cover_at(st, m, L, &nl, &nr);
      if (nr >= 0) {
        const float v = sh.piece[L][1][t];
        acc = have ? __fadd_rn(acc, v) : v;
        have = true;
      }
    }
    sh.sums[t] = acc;
  }
  __syncthreads();
  if (t == 0) write_row(row, true, sh.sums, sh.fin, sh.fini[0], sh.fini[1], o);
  __syncthreads();
}

// 4. the row pass: blocks [0, nwin) one window each (those marked whole
// sum it, then the last of a row's blocks finishes the row), the rest
// striding over the live rows
__global__ void __launch_bounds__(kRowThreads)
    rows_kernel(int nwin, Scratch s, RowOut o) {
  __shared__ RowShared sh;
  const int t = threadIdx.x;
  const bool wblock = (int)blockIdx.x < nwin;
  int row = -1;
  if (wblock) {
    const int w = blockIdx.x;
    row = s.win_row[w];
    if (row < 0) return;
    Part part;
    part.init();
    const long long a = (long long)w << kSpanLog;
    window_pass(s, o.W, w, a, a + kSpan, 0, 0, s.win_sum + (size_t)w * kSums,
                sh, part);
    reduce_part(part, sh);
    if (t == 0) {
#pragma unroll
      for (int q = 0; q < 6; ++q) s.win_mm[(size_t)w * 6 + q] = sh.fin[q];
      s.win_or[(size_t)w * 2] = sh.fini[0];
      s.win_or[(size_t)w * 2 + 1] = sh.fini[1];
      __threadfence();
      const long long st = s.starts[row], m = st + s.counts[row];
      const long long nmid = (m >> kSpanLog) - ((st + kSpan - 1) >> kSpanLog);
      sh.last = atomicAdd(s.arrive + row, 1) == (int)nmid;
    }
    __syncthreads();
#if ZUDS_STATS_PROBE_ROWS == 1
    return;  // the whole windows' sums alone
#endif
    if (!sh.last) return;
  }
#if ZUDS_STATS_PROBE_ROWS == 1
  return;
#endif
  // a window block's one row to finish, or the live rows in turn
  const int nlive = wblock ? 1 : *s.nlist;
  const int step = wblock ? 1 : gridDim.x - nwin;
  for (int q = wblock ? 0 : blockIdx.x - nwin; q < nlive; q += step) {
    if (wblock) {
      __threadfence();
      edge_load(row, s, sh);
    } else {
      row = s.list[q];
      edge_passes(row, s, o, sh);
      const long long st = s.starts[row], m = st + s.counts[row];
      const long long nmid =
          (m >> kSpanLog) - ((st + kSpan - 1) >> kSpanLog);
      if (nmid > 0) {
        // a long row: its edges stored, then the last of its blocks
        // finishes it
        edge_store(row, s, sh);
        __threadfence();
        __syncthreads();
        if (t == 0) sh.last = atomicAdd(s.arrive + row, 1) == (int)nmid;
        __syncthreads();
        const bool last = sh.last;
        __syncthreads();
        if (!last) continue;
        __threadfence();
      }
    }
    finish_row(row, s, o, sh);
  }
}

// ---- H27 -----------------------------------------------------------------

struct CleanScratch {
  int* ctgt;          // (nseg,) the k-th listed row's target, -1 if kept
  float* cflux;       // (nseg,) its flux and npix
  float* cnpix;
  float* accf;        // (nseg,) a target's merged flux and npix, past
  float* accn;        // the merge's shared memory
  int* cnt;           // the number of listed rows
};

inline size_t carve_clean(char* base, int nseg, CleanScratch* s) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) & ~size_t(255);
    return p;
  };
  const size_t n = (size_t)nseg;
  s->ctgt = (int*)take(sizeof(int) * n);
  s->cflux = (float*)take(sizeof(float) * n);
  s->cnpix = (float*)take(sizeof(float) * n);
  s->accf = (float*)take(sizeof(float) * n);
  s->accn = (float*)take(sizeof(float) * n);
  s->cnt = (int*)take(sizeof(int));
  return off;
}

// An exclusive sum of v over the block, and its total; sh holds 32 ints,
// and a barrier must pass before sh is written again. Every thread of the
// block calls it.
__device__ __forceinline__ int block_exclusive_sum(int v, int* sh,
                                                   int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    sh[lane] = w;
  }
  __syncthreads();
  const int ex = x - v + (warp > 0 ? sh[warp - 1] : 0);
  *total = sh[nwarps - 1];
  return ex;
}

// The windows of sum_last over nseg columns, numbered across the
// 512-column blocks (16 a full block; the partial last block's over its
// centred zero padding, one when it has at most 32 columns): their count,
// and the columns [lo, hi) of window g.
__host__ __device__ __forceinline__ int clean_windows(int nseg) {
  const int nfull = nseg / kCleanBlock, m = nseg - nfull * kCleanBlock;
  const int last = m == 0 ? 0 : (m <= kWin ? 1 : (m + kWin - 1) / kWin);
  return nfull * kBlockWins + last;
}
__device__ __forceinline__ void clean_window_cols(int g, int nseg, int* lo,
                                                  int* hi) {
  const int blk = g / kBlockWins, w = g - blk * kBlockWins;
  const int base = blk * kCleanBlock;
  const int m = min(kCleanBlock, nseg - base);
  if (m <= kWin) {
    *lo = base;
    *hi = base + m;
    return;
  }
  const int pad = ((kWin - m % kWin) % kWin) / 2;
  *lo = base + max(0, w * kWin - pad);
  *hi = base + min(m, w * kWin - pad + kWin);
}

// the rows launch's dynamic shared memory: the column tile (a 32-column
// window's columns skewed by one entry, so that the lanes' windows fall in
// other banks), the warps' wings of a sparse group, the non-empty
// windows' first list positions and blocks, the list of valid rows
// (uint16), the valid flags as bits
constexpr int kTile = kCleanThreads + kCleanThreads / 32;
// a group of fewer windows than this (so fewer than kSparseCols columns)
// has its wings computed a lane a column, a larger one a lane a window
constexpr int kLaneColumnsBelow = 8;
constexpr int kSparseCols = kLaneColumnsBelow * kWin;
struct CleanSmem {
  float4* tileA;  // x, y, cxx, cyy
  float2* tileB;  // cxy, peak
  float* wings;   // a warp's wings of a sparse group (kSparseCols a warp)
  int* wstart;
  int* wblk;
  uint16_t* list;
  uint32_t* vbits;  // the valid flags, 32 rows a word, a zero word after
};
__host__ __device__ __forceinline__ size_t clean_smem(int nseg,
                                                     char* base,
                                                     CleanSmem* m) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 15) & ~size_t(15);
    return p;
  };
  const int nw = clean_windows(nseg);
  m->tileA = (float4*)take(sizeof(float4) * kTile);
  m->tileB = (float2*)take(sizeof(float2) * kTile);
  m->wings = (float*)take(sizeof(float) * kCleanThreads / 32 * kSparseCols);
  m->wstart = (int*)take(sizeof(int) * (nw + 1));
  m->wblk = (int*)take(sizeof(int) * nw);
  m->list = (uint16_t*)take(sizeof(uint16_t) * nseg);
  m->vbits = (uint32_t*)take(sizeof(uint32_t) * ((nseg + 31) / 32 + 1));
  return off;
}

// the wing of tile column e at the row (xi, yi, pfi), list position k,
// column position q: kept where the column is brighter and not the row
__device__ __forceinline__ float clean_wing(const CleanSmem& m, int e, int q,
                                            int k, float xi, float yi,
                                            float pfi, float inv_scale) {
  const float4 cj = m.tileA[e];
  const float2 dj = m.tileB[e];
  const float dx = __fsub_rn(xi, cj.x), dy = __fsub_rn(yi, cj.y);
  const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(cj.z, dx), dx),
                                       __fmul_rn(__fmul_rn(cj.w, dy), dy)),
                             __fmul_rn(__fmul_rn(dj.x, dx), dy));
  const float pw = powf(__fadd_rn(__fmul_rn(r2, inv_scale), 1.0f), -2.5f);
  return dj.y > pfi && q != k ? __fmul_rn(dj.y, pw) : 0.0f;
}

// a fold of wings in order: the sum, the first largest and its position,
// whether one was NaN
struct WingFold {
  float sum, best;
  int arg;
  bool nan;
  __device__ void init() {
    sum = 0.0f;
    best = -INFINITY;
    arg = -1;
    nan = false;
  }
  __device__ void add(float c, int q) {
    const bool isn = isnan(c);
    const bool take = !isn && (arg < 0 || c > best);
    best = take ? c : best;
    arg = take ? q : arg;
    nan = nan || isn;
    sum = __fadd_rn(sum, c);
  }
};

// a row's windows folded in order: the open block's fold, and the
// contribution and dominant contributor of the blocks closed
struct RowFold {
  float contrib, best_c;
  int best_q, cur;
  WingFold blk;
  __device__ void init() {
    contrib = 0.0f;
    best_c = 0.0f;
    best_q = -1;
    cur = -1;
  }
  __device__ void close() {
    if (cur < 0) return;
    contrib = __fadd_rn(contrib, blk.sum);
    if (!blk.nan && blk.arg >= 0 && blk.best > best_c) {
      best_c = blk.best;
      best_q = blk.arg;
    }
  }
  __device__ void add(const WingFold& w, int b) {
    if (b != cur) {
      close();
      cur = b;
      blk = w;
    } else {
      blk.sum = __fadd_rn(blk.sum, w.sum);
      blk.nan |= w.nan;
      if (w.arg >= 0 && (blk.arg < 0 || w.best > blk.best)) {
        blk.best = w.best;
        blk.arg = w.arg;
      }
    }
  }
};

// Launch 1, a warp a valid row: the k-th listed row on block k % G (G
// blocks), so that a short list spreads over the card. Each block lists
// the valid rows itself: the valid flags as ballots in shared memory, a
// thread's count of the valid rows of its windows (at most two), one
// block scan numbering the rows and the non-empty windows. It writes its
// own 32 rows as no merge leaves them; a block past the list exits there.
// Then, 32 windows at a time, the block stages their columns' ellipse
// coefficients (rounded as ops/detect.py:clean_pass on the card: 1.0 / d
// is reciprocal(d) * 1.0) and peaks in shared memory, a lane folds one
// window (its listed columns in order) for its warp's row, and the warp
// folds the windows' partials in order, block by block. A window, a block
// or a column the list skips adds +0 in the plain version: it changes no
// bit of the sum, which starts from +0 (only a zero's sign could differ),
// and a +0 wing is never a block's maximum that is taken (bmax > best_c
// >= 0). The wing is computed for every listed column and kept where the
// column is brighter, so that the lanes do not diverge.
__global__ void __launch_bounds__(kCleanThreads, 1)
    clean_rows_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ theta,
                      const float* __restrict__ peak,
                      const float* __restrict__ thr,
                      const float* __restrict__ flux,
                      const float* __restrict__ npix,
                      const int* __restrict__ flags,
                      const uint8_t* __restrict__ valid, int nseg,
                      float inv_scale, CleanScratch s,
                      float* __restrict__ contrib, int* __restrict__ tgt,
                      float* __restrict__ flux_out,
                      float* __restrict__ npix_out,
                      int* __restrict__ flags_out,
                      uint8_t* __restrict__ valid_out) {
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ int sh[32];
  CleanSmem m;
  clean_smem(nseg, smem_raw, &m);
  // the merge may start: it waits for this grid before reading its rows
  asm volatile("griddepcontrol.launch_dependents;");
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // the block's 32 rows as no merge leaves them (the merge rewrites its
  // targets' flux, npix and flags), an invalid row's contribution, target
  // and valid flag: read now, written after the list
  const int own = blockIdx.x * 32 + t;
  float own_f = 0.0f, own_n = 0.0f;
  int own_fl = 0;
  bool own_v = true;
  if (t < 32 && own < nseg) {
    own_f = flux[own];
    own_n = npix[own];
    own_fl = flags[own];
    own_v = valid[own];
  }
  // the valid flags as words of 32 rows: a warp's ballots, its loads first
  const int nwords = (nseg + 31) / 32;
  constexpr int kLoads = 8;
  for (int j0 = warp; j0 < nwords; j0 += 32 * kLoads) {
    bool v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int r = (j0 + 32 * u) * 32 + lane;
      v[u] = r < nseg && valid[r];
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const uint32_t w = __ballot_sync(0xffffffffu, v[u]);
      if (lane == 0 && j0 + 32 * u < nwords) m.vbits[j0 + 32 * u] = w;
    }
  }
  if (t == 0) m.vbits[nwords] = 0;
  __syncthreads();
  // a thread's windows g0 and g0 + 1 (of nwin; at most two a thread):
  // their valid rows' bits
  const int nwin = clean_windows(nseg);
  const int wpt = (nwin + kCleanThreads - 1) / kCleanThreads;
  const int g0 = t * wpt;
  auto window_bits = [&](int g) -> uint32_t {
    if (g >= nwin || g >= g0 + wpt) return 0u;
    int wl, wh;
    clean_window_cols(g, nseg, &wl, &wh);
    const uint32_t word = __funnelshift_r(m.vbits[wl >> 5],
                                          m.vbits[(wl >> 5) + 1], wl & 31);
    return wh - wl == 32 ? word : word & ((1u << (wh - wl)) - 1u);
  };
  const uint32_t bits0 = window_bits(g0), bits1 = window_bits(g0 + 1);
  const int count = __popc(bits0) + __popc(bits1);
  const int opens = (bits0 != 0) + (bits1 != 0);
  // rows in bits 0-16, windows from bit 17 (nseg <= 65,536 rows, fewer
  // than 2^14 windows)
  int total;
  const int ex = block_exclusive_sum(count | (opens << 17), sh, &total);
  const int nv = total & 0x1ffff, nw = total >> 17;
  int pos = ex & 0x1ffff, wp = ex >> 17;
  for (int h = 0; h < 2; ++h) {
    uint32_t u = h ? bits1 : bits0;
    if (!u) continue;
    int wl, wh;
    clean_window_cols(g0 + h, nseg, &wl, &wh);
    m.wstart[wp] = pos;
    m.wblk[wp++] = (g0 + h) / kBlockWins;
    for (; u; u &= u - 1) m.list[pos++] = (uint16_t)(wl + __ffs(u) - 1);
  }
  if (t == 0) {
    m.wstart[nw] = nv;
    if (blockIdx.x == 0) s.cnt[0] = nv;
  }
  __syncthreads();
  if (t < 32 && own < nseg) {
    flux_out[own] = __fadd_rn(own_f, 0.0f);
    npix_out[own] = __fadd_rn(own_n, 0.0f);
    flags_out[own] = own_fl;
    if (!own_v) {
      contrib[own] = 0.0f;
      tgt[own] = nseg - 1;
      valid_out[own] = 0;
    }
  }
  if ((int)blockIdx.x >= nv) return;
  // the warp's row
  const int k = warp * (int)gridDim.x + blockIdx.x;
  const bool live = k < nv;
  const int i = live ? m.list[k] : 0;
  const float xi = x[i], yi = y[i], pfi = peak[i];
  float thr_i = 0.0f, flux_i = 0.0f, npix_i = 0.0f;
  if (lane == 0) {
    thr_i = thr[i];
    flux_i = flux[i];
    npix_i = npix[i];
  }
  RowFold row;
  row.init();
  for (int w0 = 0; w0 < nw; w0 += 32) {
    const int q0 = m.wstart[w0], q1 = m.wstart[min(w0 + 32, nw)];
    if (t < q1 - q0) {
      const int r = m.list[q0 + t];
      const float ar = a[r], br = b[r], th = theta[r];
      const float xr = x[r], yr = y[r], pr = peak[r];
      const float da = clamp_min(__fmul_rn(ar, ar), 1e-6f);
      const float db = clamp_min(__fmul_rn(br, br), 1e-6f);
      const float ct = cosf(th), st = sinf(th);
      const float cc = __fmul_rn(ct, ct), ss = __fmul_rn(st, st);
      const int e = t + (t >> 5);
      m.tileA[e] = make_float4(
          xr, yr, __fadd_rn(__fdiv_rn(cc, da), __fdiv_rn(ss, db)),
          __fadd_rn(__fdiv_rn(ss, da), __fdiv_rn(cc, db)));
      m.tileB[e] = make_float2(
          __fmul_rn(__fmul_rn(__fmul_rn(2.0f, ct), st),
                    __fsub_rn(__frcp_rn(da), __frcp_rn(db))),
          pr);
    }
    __syncthreads();
    if (live) {
      // lane l's window g = w0 + l, then the windows folded in order
      const int g = w0 + lane;
      const int ws = g < nw ? m.wstart[g] : q1;
      const int we = g < nw ? m.wstart[g + 1] : q1;
      WingFold win;
      win.init();
      if (min(32, nw - w0) < kLaneColumnsBelow) {
        // a lane a column's wing into the warp's buffer, then each
        // window's lane folds its own columns from it
        float* wb = m.wings + warp * kSparseCols;
#pragma unroll 4
        for (int c = lane; c < q1 - q0; c += 32)
          wb[c] = clean_wing(m, c + (c >> 5), q0 + c, k, xi, yi, pfi,
                             inv_scale);
        __syncwarp();
#pragma unroll 8
        for (int q = ws; q < we; ++q) win.add(wb[q - q0], q);
        __syncwarp();
      } else {
        // a lane a window, its columns in order
#pragma unroll 4
        for (int q = ws; q < we; ++q)
          win.add(clean_wing(m, (q - q0) + ((q - q0) >> 5), q, k, xi, yi,
                             pfi, inv_scale), q);
      }
      const int blk = g < nw ? m.wblk[g] : -1;
      for (int l = 0; l < 32 && w0 + l < nw; ++l) {
        WingFold wl;
        wl.sum = __shfl_sync(0xffffffffu, win.sum, l);
        wl.best = __shfl_sync(0xffffffffu, win.best, l);
        wl.arg = __shfl_sync(0xffffffffu, win.arg, l);
        wl.nan = __shfl_sync(0xffffffffu, (int)win.nan, l);
        row.add(wl, __shfl_sync(0xffffffffu, blk, l));
      }
    }
    __syncthreads();
  }
  if (!live || lane != 0) return;
  row.close();
  const int best_j = row.best_q >= 0 ? m.list[row.best_q] : 0;
  const bool cleaned = __fsub_rn(pfi, row.contrib) <= thr_i;
  contrib[i] = row.contrib;
  tgt[i] = cleaned ? best_j : nseg - 1;
  valid_out[i] = !cleaned;
  s.ctgt[k] = cleaned ? best_j : -1;
  s.cflux[k] = flux_i;
  s.cnpix[k] = npix_i;
}

// Launch 2, one block: the merge. It may start beside launch 1 (a
// programmatic dependent launch): up to kMergeSmemRows rows it copies the
// rows' flux, npix and flags into shared memory, then waits for launch 1.
// The cleaned rows come in ascending order, kMergeThreads list positions
// at a time; each chunk's (target, position) keys are sorted (a key's rank
// is the count of the chunk's smaller keys: keys are distinct, so the
// order is stable), and each target's run is added in that order onto its
// sums, which start at +0 as the plain version's. The run's first row
// writes its target's flux, npix and flags (launch 1 wrote every row as
// no merge leaves it); a target of several chunks is written after each.
constexpr int kMergeSmemRows = 8192;  // the rows' fields in shared memory
__global__ void __launch_bounds__(kMergeThreads, 1)
    clean_merge_kernel(const float* __restrict__ flux,
                       const float* __restrict__ npix,
                       const int* __restrict__ flags, int nseg,
                       CleanScratch s, float* __restrict__ flux_out,
                       float* __restrict__ npix_out,
                       int* __restrict__ flags_out) {
  __shared__ uint32_t got[kCleanMaxRows / 32 + 1];
  __shared__ uint32_t key[kMergeThreads], sorted[kMergeThreads];
  __shared__ float mf[kMergeThreads], mn[kMergeThreads];
  // up to kMergeSmemRows rows: the targets' merged sums and the rows'
  // flux, npix and flags in shared memory; past it, in device memory
  extern __shared__ float msm[];
  const bool in_smem = nseg <= kMergeSmemRows;
  float* accf = in_smem ? msm : s.accf;
  float* accn = in_smem ? msm + nseg : s.accn;
  const float* rflux = in_smem ? msm + 2 * nseg : flux;
  const float* rnpix = in_smem ? msm + 3 * nseg : npix;
  const int* rflags = in_smem ? (const int*)(msm + 4 * nseg) : flags;
  const int t = threadIdx.x;
  for (int w = t; w <= nseg / 32; w += kMergeThreads) got[w] = 0;
  constexpr int kCopy = 8;  // rows a thread loads before it stores
  for (int r0 = t; in_smem && r0 < nseg; r0 += kCopy * kMergeThreads) {
    float f[kCopy], n[kCopy];
    int fl[kCopy];
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      const int r = r0 + u * kMergeThreads;
      if (r < nseg) {
        f[u] = flux[r];
        n[u] = npix[r];
        fl[u] = flags[r];
      }
    }
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      const int r = r0 + u * kMergeThreads;
      if (r < nseg) {
        msm[2 * nseg + r] = f[u];
        msm[3 * nseg + r] = n[u];
        ((int*)msm)[4 * nseg + r] = fl[u];
      }
    }
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int nv = s.cnt[0];
  for (int c0 = 0; c0 < nv; c0 += kMergeThreads) {
    const int k = c0 + t;
    // read before the count is known: the scratch holds nseg entries
    const int tk = k < nseg ? s.ctgt[k] : -1;
    const float fk = k < nseg ? s.cflux[k] : 0.0f;
    const float nk = k < nseg ? s.cnpix[k] : 0.0f;
    const int to = k < nv ? tk : -1;
    key[t] = to >= 0 ? ((uint32_t)to << 16) | (uint32_t)t : 0xffffffffu;
    mf[t] = fk;
    mn[t] = nk;
    const int mcount = __syncthreads_count(to >= 0);
    if (mcount == 0) continue;
    if (to >= 0) {
      const uint32_t mine = key[t];
      const int len = min(kMergeThreads, nv - c0);
      int rank = 0;
      for (int q = 0; q < len; ++q) rank += key[q] < mine;
      sorted[rank] = mine;
    }
    __syncthreads();
    if (t < mcount && (t == 0 || (sorted[t - 1] >> 16) != (sorted[t] >> 16))) {
      const int r = (int)(sorted[t] >> 16);
      const bool again = (got[r >> 5] >> (r & 31)) & 1u;
      float af = again ? accf[r] : 0.0f, an = again ? accn[r] : 0.0f;
      for (int q = t; q < mcount && (int)(sorted[q] >> 16) == r; ++q) {
        const int idx = (int)(sorted[q] & 0xffffu);
        af = __fadd_rn(af, mf[idx]);
        an = __fadd_rn(an, mn[idx]);
      }
      accf[r] = af;
      accn[r] = an;
      atomicOr(got + (r >> 5), 1u << (r & 31));
      flux_out[r] = __fadd_rn(rflux[r], af);
      npix_out[r] = __fadd_rn(rnpix[r], an);
      flags_out[r] = rflags[r] | 2;
    }
    __syncthreads();
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

// The row pass's blocks that stride over the live rows: two a
// multiprocessor, at most one a row.
inline int row_blocks(int nseg) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return nseg < 2 * sms ? nseg : 2 * sms;
}

extern "C" int zuds_object_stats(
    const long long* cid, const long long* pidx, const float* vals,
    const int* mask, const uint8_t* wok, const float* thr,
    const uint8_t* debovf, const long long* ndet, int cap, int H, int W,
    int nseg, float minarea, int max_det, void* scratch, float* outf,
    int* outi, uint8_t* valid, cudaStream_t stream) {
  const int nrowblk = (nseg + kOffThreads - 1) / kOffThreads;
  if (nrowblk > kMaxRowBlocks) return (int)cudaErrorInvalidValue;
  Scratch s;
  carve((char*)scratch, cap, nseg, &s);
  const RowOut o{pidx, ndet, cap, H, W, nseg, minarea, max_det,
                 outf, outi, valid};
  const int ntiles = (cap + kRankTile - 1) / kRankTile;
  const size_t smem = sizeof(int) * (size_t)nseg;
  const int err = set_smem((const void*)rank_kernel, smem);
  if (err) return err;
  rank_kernel<<<ntiles, 32, smem, stream>>>(cid, cap, nseg, s);
#if ZUDS_STATS_PROBE_STOP == 1
  return (int)cudaGetLastError();
#endif
  offsets_kernel<<<nrowblk, kOffThreads, 0, stream>>>(s.hist, ntiles, s, o);
#if ZUDS_STATS_PROBE_STOP == 2
  return (int)cudaGetLastError();
#endif
  place_kernel<<<(cap + kOffThreads - 1) / kOffThreads, kOffThreads, 0,
                 stream>>>(
      cid, pidx, vals, mask, wok, thr, debovf, cap, nseg, nrowblk, s);
#if ZUDS_STATS_PROBE_STOP == 3
  return (int)cudaGetLastError();
#endif
  rows_kernel<<<ntiles + row_blocks(nseg), kRowThreads, 0, stream>>>(ntiles,
                                                                     s, o);
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
  if (nseg < 1 || nseg > kCleanMaxRows) return (int)cudaErrorInvalidValue;
  CleanScratch s;
  carve_clean((char*)scratch, nseg, &s);
  CleanSmem m;
  const size_t smem = clean_smem(nseg, nullptr, &m);
  const int err = set_smem((const void*)clean_rows_kernel, smem);
  if (err) return err;
  constexpr int kWarps = kCleanThreads / 32;
  clean_rows_kernel<<<(nseg + kWarps - 1) / kWarps, kCleanThreads, smem,
                      stream>>>(x, y, a, b, theta, peak, thr, flux, npix,
                                flags, valid, nseg, inv_scale, s, contrib,
                                tgt, flux_out, npix_out, flags_out,
                                valid_out);
  // the merge as a programmatic dependent launch
  const size_t msmem =
      nseg <= kMergeSmemRows ? 5 * sizeof(float) * (size_t)nseg : 0;
  const int merr = set_smem((const void*)clean_merge_kernel, msmem);
  if (merr) return merr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.dynamicSmemBytes = msmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, clean_merge_kernel, flux, npix, flags, nseg, s,
                         flux_out, npix_out, flags_out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
