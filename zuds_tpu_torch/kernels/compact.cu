// H6: fixed-capacity stream compaction of a flat bool mask.
//
// Replaces zuds_tpu/ops/detect.py:86-154 (compact_indices): the flat
// indices of the first `size` set entries, ascending, padded with `fill`,
// and the total count of set entries as a device scalar, so the host never
// waits (torch.nonzero makes it wait for the card to learn the length).
// The TPU form packs 256-px bitmaps and selects from the output side with
// SWAR popcounts because a TPU scatter costs ~45 ms per frame; here each
// set entry learns its rank from a block scan and is written directly.
//
// Reduce, then scan, in two launches over tiles of 256 threads x VEC
// 16-byte vectors: VEC = 4 (16 KB a tile) where that still gives two tiles
// an SM (a frame mask: 578 tiles), else VEC = 1 (4 KB), so that a small
// dense mask is spread over more blocks (at a 65,536-entry list half set,
// VEC = 4 alone took 0.0095 ms on an H100, over torch.nonzero_static's
// 0.0085; PERF.md, H6):
//   1. count: each thread loads its VEC vectors as uint4 (16 entries a
//      load, coalesced), turns each word into a "nonzero byte" mask and
//      counts it with __popc; a warp reduction and one through shared
//      memory give the tile's count.
//   2. write: each block sums the counts of the tiles before it (its
//      exclusive offset) and of all tiles (the total, which every block
//      then knows) over the tile counts in L2, re-reads its tile (from L2:
//      the frame mask is 9.5 MB of the 50 MB), ranks its set entries by a
//      block-wide exclusive scan of the VEC per-thread counts packed into
//      one 64-bit word (16 bits a round: a tile holds at most 4096 set
//      entries a round), stages each round's entries at their ranks in
//      shared memory and copies those whose rank is below `size` out in
//      order (coalesced, also where a star makes a tile dense); then it
//      writes `fill` into its grid-stride share of [min(total, size),
//      size). Block 0 writes the total.
// No pass is carried by one block, nothing is initialised, no atomics.
// The mask may start at any byte: the entries before its first 16-byte
// boundary (the head, tile 0) and after its last whole vector (the tail,
// the last tile) are read as bytes by one thread, so no misaligned uint4
// load is ever issued. Entries past `size` are dropped, as
// torch.nonzero(mask)[:size] drops them, so the output equals the plain
// version bit for bit.
//
// Bound: memory. The mask is read once (1 B an entry) and `size` int64
// indices are written: at the flagship's frame mask (9,461,760 entries,
// size 65,536) ~10 MB, 3.0 us at 3.35 TB/s; the second read of the mask
// comes from L2. The two launches and the scan add latency, not bytes.
// ptxas (sm_90a): count 28-30 registers, write 32 (VEC 1) and 48 (VEC 4),
// no spill. On an H100 the pair's device time (CUDA graph replay,
// chip_smoke.py) on a frame mask is ~0.010 ms, under
// torch.nonzero_static's ~0.028; a call from Python costs ~0.016-0.023 ms
// on the host, more than either's device time (PERF.md, H6).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// 0x80 in each byte of w that is not zero
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
}

__device__ __forceinline__ int count_vec(const uint4& q) {
  return __popc(nonzero_bytes(q.x)) + __popc(nonzero_bytes(q.y)) +
         __popc(nonzero_bytes(q.z)) + __popc(nonzero_bytes(q.w));
}

// set entries among mask[lo, hi), read as bytes
__device__ __forceinline__ int count_bytes(const uint8_t* __restrict__ mask,
                                           int lo, int hi) {
  int c = 0;
  for (int i = lo; i < hi; ++i) c += mask[i] != 0;
  return c;
}

// this thread's VEC vectors of tile `tile` (zero past the last one)
template <int VEC>
__device__ __forceinline__ void load_tile(const uint4* __restrict__ body,
                                          int nvec, int tile,
                                          uint4 (&q)[VEC]) {
#pragma unroll
  for (int r = 0; r < VEC; ++r) {
    const int v = (tile * VEC + r) * kThreads + threadIdx.x;
    q[r] = v < nvec ? body[v] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// sum of v over the block, known to every thread (added in warp order)
__device__ __forceinline__ int block_sum(int v, int* __restrict__ red) {
  v = (int)__reduce_add_sync(0xffffffffu, (unsigned)v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    count_kernel(const uint8_t* __restrict__ mask, int n, int head, int nvec,
                 int* __restrict__ tile_count) {
  __shared__ int red[kWarps];
  const int tile = blockIdx.x;
  const uint4* body = reinterpret_cast<const uint4*>(mask + head);
  uint4 q[VEC];
  load_tile<VEC>(body, nvec, tile, q);
  int c = 0;
#pragma unroll
  for (int r = 0; r < VEC; ++r) c += count_vec(q[r]);
  if (threadIdx.x == 0) {
    if (tile == 0) c += count_bytes(mask, 0, head);
    if (tile == gridDim.x - 1) c += count_bytes(mask, head + 16 * nvec, n);
  }
  c = block_sum(c, red);
  if (threadIdx.x == 0) tile_count[tile] = c;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    write_kernel(const uint8_t* __restrict__ mask, int n, int head, int nvec,
                 const int* __restrict__ tile_count, int size, long long fill,
                 long long* __restrict__ out, long long* __restrict__ total) {
  __shared__ int red[2][kWarps];
  __shared__ unsigned long long wsum[kWarps];
  __shared__ int s_idx[17 * kThreads];   // 16 entries a thread, padded
  const int tile = blockIdx.x, ntiles = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the counts of the tiles before this one, and of all tiles
  int before = 0, all = 0;
  for (int i = threadIdx.x; i < ntiles; i += kThreads) {
    const int c = tile_count[i];
    all += c;
    if (i < tile) before += c;
  }
  const int off = block_sum(before, red[0]);
  const int tot = block_sum(all, red[1]);
  if (tile == 0 && threadIdx.x == 0) *total = tot;

  if (off < size) {        // block-uniform
    const uint4* body = reinterpret_cast<const uint4*>(mask + head);
    uint4 q[VEC];
    load_tile<VEC>(body, nvec, tile, q);
    // the VEC counts of this thread, 16 bits each, scanned over the block
    unsigned long long mine = 0;
#pragma unroll
    for (int r = 0; r < VEC; ++r)
      mine |= (unsigned long long)count_vec(q[r]) << (16 * r);
    unsigned long long inc = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) wsum[warp] = inc;
    __syncthreads();
    unsigned long long wbefore = 0, blk = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) wbefore += wsum[w];
      blk += wsum[w];
    }
    const unsigned long long excl = wbefore + inc - mine;
    // tile 0 starts with the head, read as bytes by thread 0
    int base = off;
    if (tile == 0) {
      const int hc = count_bytes(mask, 0, head);
      if (threadIdx.x == 0) {
        int r = 0;
        for (int i = 0; i < head; ++i)
          if (mask[i] != 0) {
            if (r < size) out[r] = i;
            ++r;
          }
      }
      base += hc;
    }
    // round r: vector (tile VEC + r) 256 + thread, in ascending order. The
    // round's entries are staged in shared memory at their rank in the
    // round (one pad slot every 16: a dense vector's 16 entries go to 16
    // banks), then copied out in order, coalesced.
#pragma unroll
    for (int r = 0; r < VEC; ++r) {
      const int nr = (int)((blk >> (16 * r)) & 0xFFFFu);
      if (base < size) {     // block-uniform
        int p = (int)((excl >> (16 * r)) & 0xFFFFu);
        const int v = (tile * VEC + r) * kThreads + threadIdx.x;
        const uint32_t words[4] = {q[r].x, q[r].y, q[r].z, q[r].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          for (uint32_t m = nonzero_bytes(words[k]); m != 0u; m &= m - 1u) {
            const int j = __ffs(m) - 1;          // bit 8 b + 7 of byte b
            s_idx[p + (p >> 4)] = head + 16 * v + 4 * k + (j >> 3);
            ++p;
          }
        }
        __syncthreads();
        const int lim = nr < size - base ? nr : size - base;
        for (int i = threadIdx.x; i < lim; i += kThreads)
          out[base + i] = s_idx[i + (i >> 4)];
        __syncthreads();     // the next round reuses s_idx
      }
      base += nr;
    }
    // the last tile ends with the tail, read as bytes by thread 0
    if (tile == ntiles - 1 && threadIdx.x == 0) {
      int r = base;
      for (int i = head + 16 * nvec; i < n && r < size; ++i)
        if (mask[i] != 0) out[r++] = i;
    }
  }
  const int start = tot < size ? tot : size;
  for (long long j = start + (long long)tile * kThreads + threadIdx.x;
       j < size; j += (long long)ntiles * kThreads)
    out[j] = fill;
}

template <int VEC>
int launch(const uint8_t* mask, int n, int head, int nvec, int size,
           long long fill, int* tile_count, long long* out,
           long long* total, cudaStream_t stream) {
  const int per = VEC * kThreads;
  const int ntiles = nvec > 0 ? (nvec + per - 1) / per : 1;
  count_kernel<VEC><<<ntiles, kThreads, 0, stream>>>(mask, n, head, nvec,
                                                     tile_count);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  write_kernel<VEC><<<ntiles, kThreads, 0, stream>>>(
      mask, n, head, nvec, tile_count, size, fill, out, total);
  return (int)cudaGetLastError();
}

}  // namespace

// tile_scratch: at least max(1, ceil(n / 4096)) ints (a tile holds at
// least 4096 entries).
extern "C" int zuds_compact(const uint8_t* mask, int n, int size,
                            long long fill, int* tile_scratch,
                            long long* out, long long* total,
                            cudaStream_t stream) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(mask) & 15);
  const int head = mis == 0 ? 0 : (16 - mis < n ? 16 - mis : n);
  const int nvec = (n - head) / 16;
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err != 0) return err;
  if (nvec >= 4 * kThreads * 2 * sms)
    return launch<4>(mask, n, head, nvec, size, fill, tile_scratch, out,
                     total, stream);
  return launch<1>(mask, n, head, nvec, size, fill, tile_scratch, out, total,
                   stream);
}
