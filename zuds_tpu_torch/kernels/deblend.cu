// H5: the exact deblend tree's level labels in cell space.
//
// Replaces zuds_tpu/ops/detect.py:482-517 (_round and its capped
// while_loop inside _deblend_exact). Input: the compact cross-cell edge
// list (e_src, e_dst, e_w; an edge joins its two cells at every level
// lev < e_w), ccap cells and L levels. Output: bl (L, ccap) int32, each
// level's label of every cell, equal to the reference bit for bit.
//
// A round, per level, on labels `lab` (start: lab[c] = c):
//   hook:  lab'[c] = min(lab[c], min over edges c->d live at this level of
//          lab[d]) -- the reference's sorted segmented min-scan;
//   jumps: three synchronous pointer jumps lab = min(lab, lab[lab]).
// At most max_rounds rounds, counting the first. A level stops once a round
// leaves it unchanged: a round is a function of the level's labels alone,
// so this equals the reference's global any(changed) test.
//
// Design: one block per level with the level's labels in shared memory,
// two buffers of ccap int32 (64 KB at ccap = 8192, above the 48 KB static
// limit, hence the dynamic shared memory attribute). The hook is a
// shared-memory atomicMin into the second buffer, which starts as a copy
// of the first, so every edge reads the labels of the round's start as
// the reference does; the jumps ping-pong between the buffers, so each is
// synchronous. Labels only fall, so "changed" is "some step lowered some
// label", OR-ed over the block by __syncthreads_or.
//
// Bound: latency. Per round each level reads the edge list (12 B per edge,
// 786 KB at the flagship's 65,536 slots; it stays in L2 across the 31
// blocks and the rounds) and does a few integer operations per edge and
// per cell; the bytes that must move once are ~1.8 MB (~0.5 us at
// 3.35 TB/s). What costs is the chain of block barriers (5 per round) and
// the serial rounds, on 31 of the 132 SMs.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

// dst[c] = min(src[c], src[src[c]]); returns whether any label fell
__device__ __forceinline__ int jump(const int* __restrict__ src,
                                   int* __restrict__ dst, int ccap) {
  int changed = 0;
  for (int c = threadIdx.x; c < ccap; c += kThreads) {
    const int x = src[c];
    const int y = src[x];
    dst[c] = min(x, y);
    changed |= y < x;
  }
  return changed;
}

__global__ void __launch_bounds__(kThreads)
    deblend_labels_kernel(const int* __restrict__ e_src,
                          const int* __restrict__ e_dst,
                          const int* __restrict__ e_w, int ecap, int ccap,
                          int rounds, int* __restrict__ bl) {
  extern __shared__ int smem[];
  int* a = smem;          // labels at the start and end of a round
  int* b = smem + ccap;   // the hooked labels, then the middle jump
  const int lev = blockIdx.x;
  for (int c = threadIdx.x; c < ccap; c += kThreads) a[c] = c;
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    int changed = 0;
    for (int c = threadIdx.x; c < ccap; c += kThreads) b[c] = a[c];
    __syncthreads();
    for (int e = threadIdx.x; e < ecap; e += kThreads) {
      if (lev < e_w[e]) {
        const int s = e_src[e];
        const int v = a[e_dst[e]];
        if (v < b[s]) changed |= v < atomicMin(&b[s], v);
      }
    }
    __syncthreads();
    changed |= jump(b, a, ccap);
    __syncthreads();
    changed |= jump(a, b, ccap);
    __syncthreads();
    changed |= jump(b, a, ccap);
    if (!__syncthreads_or(changed)) break;
  }
  int* out = bl + (size_t)lev * ccap;
  for (int c = threadIdx.x; c < ccap; c += kThreads) out[c] = a[c];
}

}  // namespace

extern "C" int zuds_deblend_labels(const int* e_src, const int* e_dst,
                                   const int* e_w, int ecap, int ccap,
                                   int nlev, int max_rounds, int* bl,
                                   cudaStream_t stream) {
  const int smem = 2 * ccap * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      deblend_labels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  // the reference always runs its first round
  const int rounds = max_rounds > 1 ? max_rounds : 1;
  deblend_labels_kernel<<<nlev, kThreads, smem, stream>>>(
      e_src, e_dst, e_w, ecap, ccap, rounds, bl);
  return (int)cudaGetLastError();
}
