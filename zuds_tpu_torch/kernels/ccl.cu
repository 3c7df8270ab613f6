// H24 and H25: the detect stage's base connected components.
//
// H24 replaces zuds_tpu/ops/detect.py:657-665 (the label seeds: 12 masked
// 3x3 min-pool sweeps of flat indices over the full detection mask, +inf
// or INT_MAX off it), which the TPU runs as 12 full-frame passes of six
// shifted minimums. Both callers read the seeds only at the compact
// list's entries (ops/detect.py _extract, label_components), so H24 takes
// that list (pidx, the H6 compaction of the same mask: its first
// min(count, cap) entries are the detected pixels in raster order) and
// writes the (cap,) seeds of its entries, +inf past the listed ones.
// After k sweeps a pixel depends only on the pixels within Chebyshev
// distance k, so a 32x32 output tile needs its 12-pixel halo (a 56x56
// span). One block of 128 threads a tile: it reads the tile's centre in
// 16-byte words, and a tile with no detected pixel is done (85% of the
// flagship's tiles). Otherwise warps 0-2 read the span in 16-byte words
// (the halo's rereads from L2), hold it as span-local indices r * 56 + c
// (uint16: the same order as the flat indices, 0xFFFF off the mask or the
// frame), list its detected cells with one shared atomic a warp (a prefix
// of the lanes' counts by shuffles) and run all the sweeps over them
// (sweep s recomputes only the cells at least s from the span's edge, the
// only ones still exact; the three warps meet at a named barrier), while
// warp 3 finds, for each of the tile's 32 rows that holds a detected
// pixel, the list position of that row's first one (a binary search of
// pidx); a detected pixel's position is then that plus its rank in the
// row. When the compaction overflowed (count > cap), pixels past the list
// still carry the sweeps and get no position. The minimum of exact
// integers is exact in any order, so the seeds are bit-equal to
// ops/detect.py:seed_labels_plain.
// Bound: memory. The mask read once (1 B a pixel), the list's positions
// read and its seeds written once (8 + 4 B a listed entry, 4 B a padded
// one): 10.0 MB at the flagship's 3080x3072 and 34,254 of 65,536 entries
// listed, 0.0030 ms at 3.35 TB/s.
//
// H25 replaces zuds_tpu/ops/detect.py:667-700 (the base components on the
// compact list: Shiloach-Vishkin hook and compress rounds in a while loop
// of at most 64 rounds; the port's plain loop reads a flag back to the
// host every round). The fixed point is unique: per class of positions,
// joined by the `okb` neighbour edges and the seed pointers i -> lab0[i],
// the smallest position in it (the seeds point down: a seed is the
// minimum of its own neighbourhood, and the compaction keeps raster
// order). A union-find reaches the same fixed point with no host read,
// whatever the order of its unions: pass 1 sets parent = lab0 (a forest:
// lab0[i] <= i), followed up to kInitHops steps down the seed
// pointers (each a smaller position in the same class: in a large blob a
// chain of seeds 12 px apart, which every find would otherwise walk);
// pass 2 unites the ends of the edges by hooking the larger root under the
// smaller with atomicCAS (a lost race finds the roots again), the finds
// halving their paths (as ECL-CC); pass 3 writes each entry's root, the
// smallest position of its tree.
// Pass 2 unites each undirected edge once, from its larger end: rows 0-3
// of okb, the up-left, up, up-right and left neighbours (ops/detect.py
// _adjacency), whose positions are smaller. It must be that half. okb is
// symmetric but at one entry: when the frame's last pixel is detected and
// the list has padding, inv[H*W-1] is -1 (ops/detect.py _extract, as the
// reference's padded writes leave it), so no neighbour's edge reaches
// that pixel while its own backward edges are valid; the backward half
// keeps them, the forward half would join that pixel through its seed
// pointer alone and label it apart from its neighbours wherever lab0 is
// the identity. Of the four, an entry unites only those its neighbours'
// own backward edges do not already join (the scan mask of 8-connected
// labelling): with its up neighbour U, U alone (U's left edge joins the
// up-left one, the up-right one's left edge joins U, and the left one's
// up-right edge is U); without it, the up-right one and the left one, or
// the up-left one where there is no left one (the left one's up edge
// joins them). The list keeps raster order and every detected pixel
// before a listed one is listed, so those edges are there. An edge whose
// two ends share their lab0 is skipped before any find: parent = lab0 (or
// the hook of a seed that points up) already joins both ends to that
// seed. In a large blob every pixel's seed differs from its neighbours'
// (12 px up and left), so there the mask, not the skip, cuts the unions
// to one an entry.
// Input contract: okb is ops/detect.py _adjacency's over such a list (its
// two producers are _extract and label_components); for another
// neighbour graph the labels are wrong, with no error.
// Bound: memory, one read of rows 0-3 of the (8, n) int64 positions and
// bool edges and of lab0, one write of the labels: 52 B an entry, 3.4 MB
// at the flagship's 65,536 entries. The time is the finds' chains of
// dependent L2 loads and the CAS retries.
#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kHalo = 12;                  // the most sweeps one launch runs
constexpr int kSpan = kTile + 2 * kHalo;   // 56
constexpr int kSeedThreads = 128;
constexpr int kSweepThreads = kSeedThreads - 32;  // all warps but the last
constexpr uint16_t kOff = 0xFFFF;          // a cell off the mask
constexpr int kThreads = 256;

// the 16 mask bytes of row y from column x (a multiple of 16) as a 16-bit
// set of the nonzero ones, none off the frame; vec: 16-byte loads (W a
// multiple of 16, the mask 16-byte aligned)
__device__ __forceinline__ uint32_t mask_bits(const uint8_t* __restrict__ det,
                                              int H, int W, int y, int x,
                                              bool vec) {
  if (y < 0 || y >= H || x >= W || x + 16 <= 0) return 0;
  const uint8_t* row = det + (size_t)y * W;
  uint32_t bits = 0;
  if (vec) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + x));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        bits |= ((w[k] >> (8 * b)) & 0xFFu ? 1u : 0u) << (4 * k + b);
    return bits;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = x + j;
    if (c >= 0 && c < W && row[c]) bits |= 1u << j;
  }
  return bits;
}

// the sweep warps only, while the last warp searches
__device__ __forceinline__ void sweep_barrier() {
  asm volatile("bar.sync 1, %0;" ::"r"(kSweepThreads) : "memory");
}

// One block a tile (blockIdx.x, blockIdx.y).
__global__ void __launch_bounds__(kSeedThreads)
    seed_kernel(const uint8_t* __restrict__ det, int H, int W, int sweeps,
                bool vec, const long long* __restrict__ pidx,
                const long long* __restrict__ count, int cap,
                float* __restrict__ out) {
  __shared__ uint16_t buf[2][kSpan][kSpan];
  __shared__ uint16_t live[kSpan * kSpan];  // the span's detected cells
  __shared__ uint32_t rowbits[kTile];       // the centre's, a word a row
  __shared__ int first[kTile];              // each row's first position
  __shared__ int nlive;
  const int t = threadIdx.x, lane = t & 31;
  const int tx = blockIdx.x, ty = blockIdx.y;
  const long long c = __ldg(count);
  const int nl = (int)(c < cap ? c : cap);  // the listed entries
  // +inf past them, a share a block
  const long long nblk = (long long)gridDim.x * gridDim.y;
  for (long long k = nl + ((long long)ty * gridDim.x + tx) * kSeedThreads + t;
       k < cap; k += nblk * kSeedThreads)
    out[k] = INFINITY;
  // the tile's centre, one 16-byte word a thread: row t / 2, half t % 2
  const bool any =
      t < 2 * kTile && mask_bits(det, H, W, ty * kTile + t / 2,
                                 tx * kTile + 16 * (t & 1), vec) != 0;
  if (t == 0) nlive = 0;
  if (!__syncthreads_or(any) || nl == 0) return;

  const int x0 = tx * kTile - kHalo, y0 = ty * kTile - kHalo;
  if (t < kSweepThreads) {
    for (int i0 = 0; i0 < kSpan * 4; i0 += kSweepThreads) {
      // row r, word w: span columns 16 w - 4 .. 16 w + 11
      const int i = i0 + t, r = i >> 2, w = i & 3, c0 = 16 * w - 4;
      uint32_t bits = 0;
      if (i < kSpan * 4) {
        bits = mask_bits(det, H, W, y0 + r, x0 + c0, vec);
        bits &= w == 0 ? 0xFFF0u : (w == 3 ? 0x0FFFu : 0xFFFFu);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int cc = c0 + j;
          if (cc >= 0 && cc < kSpan) {
            const uint16_t v =
                (bits >> j) & 1u ? (uint16_t)(r * kSpan + cc) : kOff;
            buf[0][r][cc] = v;
            buf[1][r][cc] = v;  // cells off det stay off in both buffers
          }
        }
        // the centre's rows, a 16-bit half each from words 1 and 2
        if ((w == 1 || w == 2) && r >= kHalo && r < kHalo + kTile)
          reinterpret_cast<uint16_t*>(rowbits)[2 * (r - kHalo) + w - 1] =
              (uint16_t)bits;
      }
      // append the word's detected cells: one shared atomic a warp
      const int cnt = __popc(bits);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      int base = 0;
      if (lane == 31 && incl) base = atomicAdd(&nlive, incl);
      base = __shfl_sync(0xffffffffu, base, 31) + incl - cnt;
      while (bits) {
        const int j = __ffs(bits) - 1;
        bits &= bits - 1;
        live[base++] = (uint16_t)((r << 8) | (c0 + j));
      }
    }
  }
  __syncthreads();
  if (t < kSweepThreads) {
    const int m = nlive;
    int cur = 0;
    for (int s = 1; s <= sweeps; ++s) {
      // only the cells at least s from the span's edge are still exact
      for (int q = t; q < m; q += kSweepThreads) {
        const int r = live[q] >> 8, cc = live[q] & 0xFF;
        if (r < s || cc < s || r >= kSpan - s || cc >= kSpan - s) continue;
        uint16_t v = kOff;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx)
            v = min(v, buf[cur][r + dy][cc + dx]);
        buf[cur ^ 1][r][cc] = v;
      }
      cur ^= 1;
      sweep_barrier();
    }
  } else {
    // the last warp: a lane a tile row; the first list position at or
    // past the row's first pixel in the tile (a lower bound over the
    // listed entries)
    const uint32_t bits = rowbits[lane];
    int lo = 0;
    if (bits) {
      const long long key = (long long)(ty * kTile + lane) * W + tx * kTile;
      int hi = nl;
      while (lo < hi) {
        const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
        if (__ldg(&pidx[mid]) < key) lo = mid + 1; else hi = mid;
      }
    }
    first[lane] = lo;
  }
  __syncthreads();
  const int cur = sweeps & 1;  // the buffer the sweeps ended in
  for (int k = t; k < kTile * kTile; k += kSeedThreads) {
    const int rr = k / kTile, cc = k % kTile;
    const uint32_t bits = rowbits[rr];
    if (!((bits >> cc) & 1u)) continue;
    const int pos = first[rr] + __popc(bits & ((1u << cc) - 1u));
    if (pos >= nl) continue;  // past the list (an overflowing compaction)
    const uint16_t v = buf[cur][kHalo + rr][kHalo + cc];
    const int r = v / kSpan, c2 = v - r * kSpan;
    out[pos] = (float)((y0 + r) * W + x0 + c2);
  }
}

// The root of x, halving the path on the way: each node passed points
// on to its grandparent. Parents only point down, so the chain ends; a
// halving write moves a non-root to one of its ancestors, and hooks write
// only roots, so the two never undo each other (as ECL-CC). Volatile:
// other blocks hook roots and halve paths while this one walks.
__device__ __forceinline__ int find_root(volatile int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    const int g = parent[p];
    if (g == p) return p;
    parent[x] = g;
    x = g;
    p = parent[x];
  }
  return x;
}

__device__ void unite(volatile int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    // hook root b under the smaller root a; if b stopped being a root
    // meanwhile, find the roots again
    if (atomicCAS((int*)&parent[b], b, a) == b) return;
  }
}

// pass 1: parent[i] = lab0[i], followed down the seed pointers while they
// fall
constexpr int kInitHops = 16;
__global__ void __launch_bounds__(kThreads)
    ccl_init_kernel(const long long* __restrict__ lab0, int n,
                    int* __restrict__ parent) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long p = i, l = __ldg(&lab0[i]);
#pragma unroll
  for (int h = 0; h < kInitHops; ++h) {
    if (l < 0 || l >= p) break;
    p = l;
    l = __ldg(&lab0[p]);
  }
  parent[i] = (int)p;
}

__global__ void __launch_bounds__(kThreads)
    ccl_hook_kernel(const long long* __restrict__ nbr_pos,
                    const uint8_t* __restrict__ okb,
                    const long long* __restrict__ lab0, int n,
                    int* parent) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long l = __ldg(&lab0[i]);
  bool ok[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) ok[k] = __ldg(&okb[(size_t)k * n + i]) != 0;
  // the rows to unite: 0 up-left, 1 up, 2 up-right, 3 left
  const int use = ok[1] ? 2 : ((ok[2] ? 4 : 0) | (ok[3] ? 8 : ok[0] ? 1 : 0));
  // every load first (the unions below write parent, not these)
  long long j[4], lj[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    j[k] = (use >> k) & 1 ? __ldg(&nbr_pos[(size_t)k * n + i]) : -1;
    if (j[k] >= n || j[k] == i) j[k] = -1;
    lj[k] = j[k] >= 0 ? __ldg(&lab0[j[k]]) : l;
  }
  if (l > i && l < n) unite(parent, i, (int)l);  // a seed that points up
  // i is joined to its seed l (by pass 1 or the line above) when l is a
  // position; so is j to its own
  const bool seeded = l >= 0 && l < n;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (j[k] >= 0 && !(seeded && lj[k] == l)) unite(parent, i, (int)j[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
    ccl_flatten_kernel(int* parent, int n, long long* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = find_root(parent, i);
}

}  // namespace

// det (H, W) u8, pidx (cap,) i64 its compaction, count (i64 scalar) its
// detected pixels; out (cap,) f32.
extern "C" int zuds_seed_sweeps(const uint8_t* det, int H, int W, int sweeps,
                                const long long* pidx,
                                const long long* count, int cap, float* out,
                                cudaStream_t stream) {
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  const bool vec = W % 16 == 0 && reinterpret_cast<uintptr_t>(det) % 16 == 0;
  seed_kernel<<<grid, kSeedThreads, 0, stream>>>(det, H, W, sweeps, vec, pidx,
                                                  count, cap, out);
  return (int)cudaGetLastError();
}

extern "C" int zuds_ccl_fixpoint(const long long* nbr_pos,
                                 const uint8_t* okb, const long long* lab0,
                                 int n, int* parent, long long* out,
                                 cudaStream_t stream) {
  const int grid = (n + kThreads - 1) / kThreads;
  ccl_init_kernel<<<grid, kThreads, 0, stream>>>(lab0, n, parent);
  ccl_hook_kernel<<<grid, kThreads, 0, stream>>>(nbr_pos, okb, lab0, n,
                                                 parent);
  ccl_flatten_kernel<<<grid, kThreads, 0, stream>>>(parent, n, out);
  return (int)cudaGetLastError();
}
