// H12: the braai triplet cutter, and H14: the negative-pixel veto stencil.
//
// H12 replaces zuds_tpu/filterobjects.py:64-90 (make_triplets_batch): for
// each candidate and each of the three frames (new, ref, sub, all on the
// reference frame's grid) the 63x63 window at the clamped rounded corner,
// divided by sqrt(max(sum c^2, 1e-20)), written as channel 0/1/2 of the
// NHWC (N, 63, 63, 3) triplet. One block a candidate: three groups of 256
// threads, one a frame. A group's thread squares and adds its ~16 window
// values (fmaf, in window order), the group reduces sum c^2 (warp
// shuffles, then one warp over the eight partials) and stages its raw
// values interleaved in shared memory (pixel i of frame f at 3 i + f,
// offset so that the triplet's 16-byte aligned floats sit 16-byte aligned
// there). The block then writes the candidate's contiguous 11,907 floats,
// each divided by its frame's norm: scalar stores to the first 16-byte
// boundary, 16-byte stores, scalar stores at the end. The sum's order is
// not XLA:CPU's, so the output agrees with the plain version to a few ulp.
//
// H14 replaces the per-candidate part of zuds_tpu/filterobjects.py:37-61
// (_negpix_veto): the 13x13 window at the clamped corner standardised by
// the frame's median and 1.48 MAD (device scalars from the library sort;
// the host reads neither), the 3x3 maximum with -inf outside the window,
// and any(s < -5 & max > 5) over the central 11x11. The central 11x11's
// 3x3 neighbourhoods lie inside the 13x13 window, so the -inf padding is
// never reached there. The maximum carries a NaN as torch.max_pool2d and
// XLA's max do. Bit-equal to the plain version: s = (v - med) / max(sig,
// 1e-12) with __fsub_rn and __fdiv_rn.
//
// One warp a row: its lanes load the window's raw values into the warp's
// shared row (six loads a lane, all issued at once) and test s < -5 at
// their inner pixels first; the 3x3 maximum is taken only where that
// holds, which on a sky frame is almost nowhere. It is the maximum of the
// nine raw values, standardised once: v -> fl(fl(v - med) / d) never
// decreases for d > 0, so the largest standardised value is the
// standardised largest value, and a NaN among the nine stays a NaN either
// way (max > 5 false). Where med or d is infinite the centre test or the
// maximum's test fails in both forms (tests/test_torch_negpix_rows.py).
// So a lane divides once an inner pixel, and once more where its centre
// passes.
//
// A row whose corner (x0, y0) is bitwise row N - 1's has row N - 1's
// verdict: its warp exits at once, and block 0, whose warp 0 decides row
// N - 1, writes that verdict to every such row (its threads compare the
// rows' corners while warp 0's window loads). The slice hands all max_det
// = 4096 rows of detect_sources, of which a flagship frame fills ~57: the
// rows past its objects repeat one corner, so ~60 warps read a window. No
// count from the caller and no host read: a call whose corners are all
// distinct decides every row.
//
// Bound: memory, and tiny at the main path's sizes. H12 reads 3 x 63 x 63
// floats and writes as many per candidate (95 KB); H14 reads 13 x 13
// floats a distinct corner, and a row's corner (8 B) and verdict (1 B).
// Both are launch-bound for a few hundred candidates.
#include "common.cuh"

namespace {

constexpr int kCut = 63;                  // CUTOUT_SIZE
constexpr int kCutThreads = 256;
constexpr int kCutPix = kCut * kCut;
constexpr int kTriplet = 3 * kCutPix;     // floats of a candidate's triplet
constexpr int kPerThread = (kCutPix + kCutThreads - 1) / kCutThreads;
constexpr int kBig = 13;                  // ops/cutouts.NEGPIX_BOX
constexpr int kInner = 11;                // ops/cutouts.NEGPIX_INNER
constexpr int kBox = kBig * kBig;
constexpr int kVetoWarps = 8;
constexpr int kVetoThreads = kVetoWarps * 32;
// chunks of kVetoThreads rows block 0 compares ahead, a bit each: 4096
// rows
constexpr int kVetoAhead = 16;

__global__ void __launch_bounds__(3 * kCutThreads, 2)
    triplet_cut_kernel(const float* __restrict__ f0,
                       const float* __restrict__ f1,
                       const float* __restrict__ f2,
                       const int* __restrict__ x0,
                       const int* __restrict__ y0, int W,
                       float* __restrict__ out) {
  // the raw values, shifted by up to 3 floats (see the stores); 16-byte
  // aligned for the float4 reads
  __shared__ __align__(16) float s_val[kTriplet + 4];
  __shared__ float s_part[3][kCutThreads / 32];
  __shared__ float s_norm[3];
  const int n = blockIdx.x, f = threadIdx.x / kCutThreads;
  const int t = threadIdx.x - f * kCutThreads;
  float* dst = out + (long long)n * kTriplet;
  // dst[e] is 16-byte aligned where (e + shift) % 4 == 0
  const int shift = (int)(((size_t)dst >> 2) & 3);
  const float* frame = f == 0 ? f0 : (f == 1 ? f1 : f2);
  const long long corner = (long long)y0[n] * W + x0[n];
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = t + k * kCutThreads;
    if (i < kCutPix) {
      const int r = i / kCut, c = i - r * kCut;
      const float v = frame[corner + (long long)r * W + c];
      s_val[shift + 3 * i + f] = v;
      acc = fmaf(v, v, acc);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((t & 31) == 0) s_part[f][t >> 5] = acc;
  __syncthreads();
  if (t < 32) {
    float s = t < kCutThreads / 32 ? s_part[f][t] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (t == 0) s_norm[f] = sqrtf(fmaxf(s, 1e-20f));
  }
  __syncthreads();
  const int tid = threadIdx.x;
  const int head = (4 - shift) & 3;            // floats before the boundary
  const int nvec = (kTriplet - head) / 4;
  const int tail = head + 4 * nvec;
  if (tid < head) dst[tid] = __fdiv_rn(s_val[shift + tid], s_norm[tid % 3]);
  const float4* v4 = reinterpret_cast<const float4*>(s_val + shift + head);
  float4* o4 = reinterpret_cast<float4*>(dst + head);
  for (int q = tid; q < nvec; q += 3 * kCutThreads) {
    const int f0q = (head + 4 * q) % 3;        // the frame of its first float
    const float4 v = v4[q];
    float4 w;
    w.x = __fdiv_rn(v.x, s_norm[f0q]);
    w.y = __fdiv_rn(v.y, s_norm[f0q == 2 ? 0 : f0q + 1]);
    w.z = __fdiv_rn(v.z, s_norm[f0q == 0 ? 2 : f0q - 1]);
    w.w = __fdiv_rn(v.w, s_norm[f0q]);
    o4[q] = w;
  }
  if (tail + tid < kTriplet)
    dst[tail + tid] = __fdiv_rn(s_val[shift + tail + tid],
                              s_norm[(tail + tid) % 3]);
}

// The veto of the window at ``corner`` for one warp: its raw values into
// the warp's shared row ``s``, then the inner pixels, centre first.
__device__ __forceinline__ bool window_veto(const float* __restrict__ img,
                                            int W, long long corner,
                                            float m, float d, float* s,
                                            int lane) {
  constexpr int kPer = (kBox + 31) / 32;
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = lane + 32 * j;
    if (i < kBox) {
      const int r = i / kBig, c = i - r * kBig;
      v[j] = img[corner + (long long)r * W + c];
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (lane + 32 * j < kBox) s[lane + 32 * j] = v[j];
  __syncwarp();
  bool hit = false;
#pragma unroll
  for (int j = 0; j < (kInner * kInner + 31) / 32; ++j) {
    const int i = lane + 32 * j;
    if (i >= kInner * kInner) break;
    const int r = 1 + i / kInner, c = 1 + i % kInner;
    if (__fdiv_rn(__fsub_rn(s[r * kBig + c], m), d) < -5.f) {
      float mx = -INFINITY;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx)
          mx = nan_max(mx, s[(r + dy) * kBig + c + dx]);
      hit |= __fdiv_rn(__fsub_rn(mx, m), d) > 5.f;
    }
  }
  return __any_sync(0xffffffffu, hit);
}

// Block 0 decides row N - 1 (warp 0) and writes its verdict to every row
// of that corner; block b > 0 rows 8 (b - 1) .. 8 b - 1, a warp each, short
// of the last and of the rows of its corner.
__global__ void __launch_bounds__(kVetoThreads)
    negpix_veto_kernel(const float* __restrict__ img, int W,
                       const float* __restrict__ med,
                       const float* __restrict__ sig,
                       const int* __restrict__ x0,
                       const int* __restrict__ y0, int N,
                       uint8_t* __restrict__ veto) {
  __shared__ float s_win[kVetoWarps][kBox];
  __shared__ uint8_t s_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int last = N - 1;
  const bool lead = blockIdx.x == 0;
  const int lx = x0[last], ly = y0[last];
  int n = last;
  if (!lead) {
    n = (blockIdx.x - 1) * kVetoWarps + warp;
    if (n >= last || (x0[n] == lx && y0[n] == ly)) return;
  }
  // block 0: which rows of its thread's first kVetoAhead chunks share the
  // last row's corner, all read at once, beside warp 0's window
  uint32_t ahead = 0;
  if (lead) {
    int qx[kVetoAhead], qy[kVetoAhead];
#pragma unroll
    for (int k = 0; k < kVetoAhead; ++k) {
      const int q = min((int)threadIdx.x + k * kVetoThreads, last);
      qx[k] = x0[q];
      qy[k] = y0[q];
    }
#pragma unroll
    for (int k = 0; k < kVetoAhead; ++k) {
      const bool same = (int)threadIdx.x + k * kVetoThreads < last &&
                        qx[k] == lx && qy[k] == ly;
      ahead |= (same ? 1u : 0u) << k;
    }
  }
  if (!lead || warp == 0) {
    const float m = *med;
    const float d = fmaxf(*sig, 1e-12f);
    const long long corner = (long long)(lead ? ly : y0[n]) * W +
                             (lead ? lx : x0[n]);
    const bool hit = window_veto(img, W, corner, m, d, s_win[warp], lane);
    if (lane == 0) {
      veto[n] = hit ? 1 : 0;
      if (lead) s_last = hit ? 1 : 0;
    }
  }
  if (!lead) return;
  __syncthreads();
  const uint8_t v = s_last;
  for (int b = 0; b < last; b += kVetoThreads) {
    const int k = b / kVetoThreads, q = b + threadIdx.x;
    const bool dup = k < kVetoAhead
                         ? (ahead >> k) & 1u
                         : q < last && x0[q] == lx && y0[q] == ly;
    if (dup) veto[q] = v;
  }
}

}  // namespace

extern "C" int zuds_triplet_cut(const float* f0, const float* f1,
                                const float* f2, const int* x0,
                                const int* y0, int N, int W, float* out,
                                cudaStream_t stream) {
  if (N > 0) {
    triplet_cut_kernel<<<N, 3 * kCutThreads, 0, stream>>>(f0, f1, f2, x0,
                                                          y0, W, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int zuds_negpix_veto(const float* img, int W, const float* med,
                                const float* sig, const int* x0,
                                const int* y0, int N, uint8_t* veto,
                                cudaStream_t stream) {
  if (N > 0) {
    const int blocks = 1 + (N - 1 + kVetoWarps - 1) / kVetoWarps;
    negpix_veto_kernel<<<blocks, kVetoThreads, 0, stream>>>(
        img, W, med, sig, x0, y0, N, veto);
  }
  return (int)cudaGetLastError();
}
