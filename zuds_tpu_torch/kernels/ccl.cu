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
// order). A union-find reaches the same fixed point with no host read:
// pass 1 sets parent = lab0 (a forest: lab0[i] <= i), pass 2 unites the
// ends of every edge by hooking the larger root under the smaller with
// atomicCAS (a lost race finds the roots again), the finds halving their
// paths (as ECL-CC: a component of many seed regions would otherwise hook
// into chains that every find walks), pass 3 writes each entry's root,
// the smallest position of its tree.
// Bound: memory, one read of the (8, n) int64 positions and bool edges
// and of lab0, one write of the labels: 88 B an entry, 5.8 MB at the
// flagship's 65,536 entries; the finds' pointer chases are short and stay
// in L2.
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

__global__ void __launch_bounds__(kThreads)
    ccl_init_kernel(const long long* __restrict__ lab0, int n,
                    int* __restrict__ parent) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long l = lab0[i];
  parent[i] = (l >= 0 && l <= i) ? (int)l : i;
}

__global__ void __launch_bounds__(kThreads)
    ccl_hook_kernel(const long long* __restrict__ nbr_pos,
                    const uint8_t* __restrict__ okb,
                    const long long* __restrict__ lab0, int n,
                    int* parent) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long l = lab0[i];
  if (l > i && l < n) unite(parent, i, (int)l);  // a seed that points up
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const size_t e = (size_t)k * n + i;
    if (!okb[e]) continue;
    const long long j = nbr_pos[e];
    if (j >= 0 && j < n && j != i) unite(parent, i, (int)j);
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
