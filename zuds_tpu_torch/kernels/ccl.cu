// H24 and H25: the detect stage's base connected components.
//
// H24 replaces zuds_tpu/ops/detect.py:657-665 (the label seeds: 12 masked
// 3x3 min-pool sweeps of flat indices over the full detection mask, +inf
// or INT_MAX off it), which the TPU runs as 12 full-frame passes of six
// shifted minimums. After k sweeps a pixel depends only on the pixels
// within Chebyshev distance k, so one block takes a 32x32 output tile with
// a 12-pixel halo (56x56, two ping-pong buffers of f32 in shared memory),
// lists the span's detected cells, runs all the sweeps over them there
// (a cell off the mask stays +inf; sweep s recomputes only the cells at
// least s from the span's edge, the only ones still exact) and writes the
// tile once: a span without a detected pixel costs its load and its
// store. Cells outside the frame hold +inf, as max_pool2d's padding and the
// reference's INT_MAX rows do. The minimum of exact integers and +inf is
// exact in any order, so the seeds are bit-equal to
// ops/detect.py:seed_labels_plain.
// Bound: memory. The mask is read once (1 B a pixel; the halo's rereads,
// 3.1x, hit L2) and the seeds written once (4 B a pixel): 47.3 MB at the
// flagship's 3080x3072, 0.014 ms at 3.35 TB/s.
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
constexpr int kSeedThreads = 256;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kSeedThreads)
    seed_kernel(const uint8_t* __restrict__ det, int H, int W, int sweeps,
                float* __restrict__ out) {
  __shared__ float buf[2][kSpan][kSpan];
  __shared__ short live[kSpan * kSpan];  // the span's detected cells
  __shared__ int nlive;
  const int x0 = blockIdx.x * kTile - kHalo;
  const int y0 = blockIdx.y * kTile - kHalo;
  if (threadIdx.x == 0) nlive = 0;
  __syncthreads();
  for (int k = threadIdx.x; k < kSpan * kSpan; k += blockDim.x) {
    const int r = k / kSpan, c = k % kSpan;
    const int y = y0 + r, x = x0 + c;
    const bool d = y >= 0 && y < H && x >= 0 && x < W &&
                   det[(size_t)y * W + x] != 0;
    const float v = d ? (float)(y * W + x) : INFINITY;
    buf[0][r][c] = v;
    buf[1][r][c] = v;  // cells off det stay +inf in both buffers
    if (d) live[atomicAdd(&nlive, 1)] = (short)k;
  }
  __syncthreads();
  const int m = nlive;
  int cur = 0;
  for (int s = 1; s <= sweeps && m > 0; ++s) {
    // only the cells at least s from the span's edge are still exact
    for (int q = threadIdx.x; q < m; q += blockDim.x) {
      const int r = live[q] / kSpan, c = live[q] % kSpan;
      if (r < s || c < s || r >= kSpan - s || c >= kSpan - s) continue;
      float v = INFINITY;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx)
          v = fminf(v, buf[cur][r + dy][c + dx]);
      buf[cur ^ 1][r][c] = v;
    }
    cur ^= 1;
    __syncthreads();
  }
  for (int k = threadIdx.x; k < kTile * kTile; k += blockDim.x) {
    const int r = kHalo + k / kTile, c = kHalo + k % kTile;
    const int y = y0 + r, x = x0 + c;
    if (y < H && x < W) out[(size_t)y * W + x] = buf[cur][r][c];
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

extern "C" int zuds_seed_sweeps(const uint8_t* det, int H, int W, int sweeps,
                                float* out, cudaStream_t stream) {
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  seed_kernel<<<grid, kSeedThreads, 0, stream>>>(det, H, W, sweeps, out);
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
