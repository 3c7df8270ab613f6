// H6: fixed-capacity stream compaction of a flat bool mask.
//
// Replaces zuds_tpu/ops/detect.py:86-154 (compact_indices): the flat
// indices of the first `size` set entries, ascending, padded with `fill`,
// and the total count of set entries as a device scalar, so the host never
// waits (torch.nonzero makes it wait for the card to learn the length).
// The TPU form packs 256-px bitmaps and selects from the output side with
// SWAR popcounts because a TPU scatter costs ~45 ms per frame; here a
// ballot per warp step gives each set entry its rank directly.
//
// Three short passes over warp segments of kSeg = 1024 entries:
//   1. each warp counts its segment's set entries (ballot + popc);
//   2. one block turns the segment counts into exclusive offsets (warp
//      shuffle scan) and writes the total;
//   3. each warp walks its segment again and writes every set entry whose
//      rank is below `size`; all threads then write `fill` into the slots
//      from min(total, size) on.
// Entries past `size` are dropped, as torch.nonzero(mask)[:size] drops
// them, so the output equals the plain version bit for bit.
//
// Bound: memory. The mask is read twice (one byte per entry, coalesced
// 32-byte warp reads) and `size` int64 indices are written: at the
// flagship's frame mask (9,461,760 entries, size 65,536) ~19.5 MB of
// traffic, a few microseconds at 3.35 TB/s; the single-block scan of
// 9,240 counts and three launches add latency, not bytes.
#include "common.cuh"

namespace {

constexpr int kSeg = 1024;           // entries per warp segment
constexpr int kThreads = 256;        // 8 warps per block
constexpr int kScanThreads = 1024;   // the one block of pass 2

__global__ void __launch_bounds__(kThreads)
    count_kernel(const uint8_t* __restrict__ mask, int n, int nseg,
                 int* __restrict__ seg_count) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= nseg) return;  // whole warps leave together
  const int base = warp * kSeg;
  int cnt = 0;
  for (int s = 0; s < kSeg; s += 32) {
    const int i = base + s + lane;
    const bool m = i < n && mask[i] != 0;
    cnt += __popc(__ballot_sync(0xffffffffu, m));
  }
  if (lane == 0) seg_count[warp] = cnt;
}

// Exclusive scan of the segment counts in place; *total = their sum.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(int* __restrict__ seg_count, int nseg,
                long long* __restrict__ total) {
  __shared__ int wsum[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (nseg + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, nseg), hi = min(lo + per, nseg);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += seg_count[i];
  int v = s;  // inclusive scan over the warp
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
  for (int i = lo; i < hi; ++i) {
    const int c = seg_count[i];
    seg_count[i] = run;
    run += c;
  }
  if (t == 0) *total = wsum[31];
}

__global__ void __launch_bounds__(kThreads)
    write_kernel(const uint8_t* __restrict__ mask, int n, int nseg,
                 const int* __restrict__ seg_off,
                 const long long* __restrict__ total, int size,
                 long long fill, long long* __restrict__ out) {
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int warp = gtid >> 5, lane = threadIdx.x & 31;
  if (warp < nseg) {
    int off = seg_off[warp];  // warp-uniform
    const int base = warp * kSeg;
    const unsigned below = (1u << lane) - 1u;
    for (int s = 0; s < kSeg && off < size; s += 32) {
      const int i = base + s + lane;
      const bool m = i < n && mask[i] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, m);
      const int r = off + __popc(bal & below);
      if (m && r < size) out[r] = i;
      off += __popc(bal);
    }
  }
  const long long t = *total;
  const int start = t < size ? (int)t : size;
  for (int j = start + gtid; j < size; j += gridDim.x * blockDim.x)
    out[j] = fill;
}

}  // namespace

extern "C" int zuds_compact(const uint8_t* mask, int n, int size,
                            long long fill, int* seg_scratch,
                            long long* out, long long* total,
                            cudaStream_t stream) {
  const int nseg = (n + kSeg - 1) / kSeg;
  const int warps_per_block = kThreads / 32;
  const int grid = nseg > 0 ? (nseg + warps_per_block - 1) / warps_per_block
                            : 1;
  count_kernel<<<grid, kThreads, 0, stream>>>(mask, n, nseg, seg_scratch);
  scan_kernel<<<1, kScanThreads, 0, stream>>>(seg_scratch, nseg, total);
  write_kernel<<<grid, kThreads, 0, stream>>>(mask, n, nseg, seg_scratch,
                                              total, size, fill, out);
  return (int)cudaGetLastError();
}
