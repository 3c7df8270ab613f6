// H22: circular-aperture photometry at per-source positions.
//
// Replaces zuds_tpu/ops/photometry.py:aperture_photometry_batched (:64) with
// its circle_pixel_overlap (:45), and the r = 6 px rms and bad-pixel sums
// of zuds_tpu/parallel/pipeline.py:306-328. One warp per source: it walks
// the cut x cut window at the clamped rounded corner (cut = 2 ceil(r) + 3:
// 9 at r = 3, 15 at r = 6), forms each pixel's exact overlap w with the
// circle (four signed quadrant areas at its corners, summed, clamped to
// [0, 1]) and accumulates
//   mode 1 (zuds_aperture_photometry): sum img w, sum rms^2 w, sum w, and
//     the OR of mask & 0x3FFFF over pixels with w > 0 (the reference's loop
//     over 18 bits), with oob where the window about the rounded position
//     leaves the frame; rms and mask may be null (zeros);
//   mode 2 (zuds_aperture_sums): sum a w and sum b w of two float planes.
// Each lane sums its pixels (lane, lane + 32, ...) in order, then a
// butterfly of shuffles adds the lanes: the same every call, another order
// than torch.sum's.
//
// w decides the flags: a pixel that misses the circle gets the cancelling
// sum of four quadrant areas of ~7 px^2, a residue of an ulp or two. So w
// is formed as ops/photometry.py:circle_pixel_overlap forms it on the
// card, operation by operation: every product, sum and quotient rounded
// on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn; nvcc would
// contract a product and a sum into an FMA), asinf and sqrtf as PyTorch's
// asin and sqrt call them, the NaN rules of torch.minimum and clamp, and
// the corner rounded half to even. w, the flags and oob are then bit-equal
// to the plain version's; the sums agree to their summation order.
//
// Neighbouring pixels share corners: pixel c's right edge fl(fl(X_c - x)
// + 0.5) and pixel c + 1's left edge fl(fl(X_c + 1 - x) - 0.5) are most
// often the same float, and then so is the quadrant area there. A warp
// tests that for every pair of neighbouring columns and rows of its
// window, bit for bit; where all hold, it computes the (cut + 1)^2 corner
// areas once into shared memory (100 at r = 3 against 324 a pixel at a
// time, 256 against 900 at r = 6) and each pixel's w is the same four-term
// sum of them, in the same order, so the same bits. A corner's area needs
// its arc term only through two arc integrals, one of min(|x|, r) of its
// column's edge and one of the circle's x at min(|y|, r) of its row's: a
// lane an edge forms those (and the clamps and signs) once, 2 (cut + 1)
// of them, and the corners combine them, the same operations on the same
// values. A window where one pair differs (a position within a few px of
// 0, where X - x keeps bits below the half pixel) forms each pixel's four
// areas itself, as do windows past kMaxGridCut; NaN, +-inf and far-off
// positions pass (all their edges are one float). Windows of 9 (r = 3)
// and 15 (r = 6) are fixed at compile time: each lane loads its pixels
// before the grid is formed.
//
// A row whose position (x, y) is bitwise that of the last row N - 1 has
// the last row's outputs: its warp exits at once, and block 0, which
// measures the last row with all its warps (the corner grid in one pass,
// warp 0's sums in the lanes' order above), copies them to every such row
// (and, when w is asked for, its overlaps). Block 0's threads compare the
// rows' positions while the window is computed. The slice hands all
// max_det = 4096 rows of detect_sources, of which a flagship frame fills
// ~57: the rows past its objects carry the same fill, so ~58 warps
// measure. No count from the caller and no host read: a call whose rows
// are all distinct measures them all.
//
// Bound: bytes of the distinct work that gives the same outputs: each
// distinct row's window (r = 3: 81 x 12 B, img, rms, mask; r = 6: 225 x
// 8 B, two planes) and every row's position and outputs (25 B; 16 B):
// 0.16 MB, 0.047 us, for 58 distinct rows of 4096 at r = 3; 4.08 MB,
// 1.22 us, at 4096 distinct rows. The operations (an edge's terms ~40, a
// corner's area 6, a pixel's four-term sum and clamp 4 besides its sums)
// stay under that at the fp32 peak.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// the largest window that shares its corners: eight warps' (cut + 1)^2
// corner areas and edge terms in 45 KB of shared memory
constexpr int kMaxGridCut = 33;
// chunks of kThreads rows block 0 compares ahead, a bit each: 4096 rows
constexpr int kAhead = 16;

__device__ __forceinline__ float sign_of(float v) {
  return (float)((v > 0.f) - (v < 0.f));     // torch.sign (NaN gives 0)
}

// 0.5 (t sqrt(r^2 - t^2) + r^2 asin(t / r)), t clamped to [0, r]
__device__ __forceinline__ float arc_int(float t, float r, float rr,
                                         float rs) {
  t = torch_min(clamp_min(t, 0.f), r);
  const float s = sqrtf(clamp_min(__fsub_rn(rr, __fmul_rn(t, t)), 0.f));
  const float a = asinf(clamp_to(__fdiv_rn(t, rs), -1.f, 1.f));
  return __fmul_rn(__fadd_rn(__fmul_rn(t, s), __fmul_rn(rr, a)), 0.5f);
}

// area of {u in [0, x], v in [0, y], u^2 + v^2 <= r^2}, x, y >= 0
__device__ __forceinline__ float quad_area(float x, float y, float r,
                                           float rr, float rs) {
  x = torch_min(x, r);
  y = torch_min(y, r);
  const float xc = sqrtf(clamp_min(__fsub_rn(rr, __fmul_rn(y, y)), 0.f));
  const float x1 = torch_min(x, xc);
  const float arc = x > x1 ? __fsub_rn(arc_int(x, r, rr, rs),
                                       arc_int(x1, r, rr, rs))
                           : 0.f;
  return __fadd_rn(__fmul_rn(y, x1), arc);
}

__device__ __forceinline__ float signed_area(float x, float y, float r,
                                             float rr, float rs) {
  return __fmul_rn(__fmul_rn(sign_of(x), sign_of(y)),
                   quad_area(fabsf(x), fabsf(y), r, rr, rs));
}

// the four-term sum of a pixel's corner areas, clamped to [0, 1]: a11 at
// its (right, top) corner, a01 (left, top), a10 (right, bottom), a00
__device__ __forceinline__ float corner_sum(float a11, float a01, float a10,
                                            float a00) {
  return clamp_to(__fadd_rn(__fsub_rn(__fsub_rn(a11, a01), a10), a00), 0.f,
                  1.f);
}

// overlap of the unit pixel centred at (dx, dy) from the centre with the
// circle of radius r, clamped to [0, 1]
__device__ __forceinline__ float overlap(float dx, float dy, float r,
                                         float rr, float rs) {
  const float x0 = __fsub_rn(dx, 0.5f), x1 = __fadd_rn(dx, 0.5f);
  const float y0 = __fsub_rn(dy, 0.5f), y1 = __fadd_rn(dy, 0.5f);
  return corner_sum(signed_area(x1, y1, r, rr, rs),
                    signed_area(x0, y1, r, rr, rs),
                    signed_area(x1, y0, r, rr, rs),
                    signed_area(x0, y0, r, rr, rs));
}

// Edge i (0..cut) of a window at p0 about the position c along one axis:
// pixel i's low edge, and past the last pixel its high edge.
__device__ __forceinline__ float edge_at(int p0, int i, int cut, float c) {
  const float d = __fsub_rn((float)(p0 + min(i, cut - 1)), c);
  return i < cut ? __fsub_rn(d, 0.5f) : __fadd_rn(d, 0.5f);
}

// Whether every pixel's high edge is bitwise its next neighbour's low edge
// along one axis (the whole warp gets the answer).
__device__ __forceinline__ bool edges_shared(int p0, int cut, float c,
                                             int lane) {
  bool ok = true;
  for (int i = lane; i < cut - 1; i += 32) {
    const float hi = __fadd_rn(__fsub_rn((float)(p0 + i), c), 0.5f);
    const float lo = __fsub_rn(__fsub_rn((float)(p0 + i + 1), c), 0.5f);
    ok = ok && __float_as_uint(hi) == __float_as_uint(lo);
  }
  return __all_sync(0xffffffffu, ok);
}

// a warp's floats of shared memory: the corner areas and seven terms an
// edge
__host__ __device__ constexpr int grid_floats(int cut) {
  return (cut + 1) * (cut + 1) + 7 * (cut + 1);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool same_position(const float* xs,
                                              const float* ys, int r,
                                              uint32_t bx, uint32_t by) {
  return __float_as_uint(xs[r]) == bx && __float_as_uint(ys[r]) == by;
}

// kSums: mode 2 (p0, p1 two planes; o0, o1 their sums). Else mode 1: p0
// img, p1 rms (or null), o0 flux, o1 fluxerr, area, flags, oob, and w (or
// null) the (N, cut, cut) overlaps. Block 0 measures the last row; block
// b > 0 rows 8 (b - 1) .. 8 b - 1, a warp each, short of the last. kCut >
// 0: the window's side, fixed (each lane loads its pixels before the
// corner grid is computed, so the loads overlap it); 0: any side (cut).
template <bool kSums, int kCut>
__global__ void __launch_bounds__(kThreads)
    aperture_kernel(const float* __restrict__ p0,
                    const float* __restrict__ p1,
                    const int* __restrict__ mask,
                    const float* __restrict__ xs,
                    const float* __restrict__ ys, int N, int H, int W,
                    float r, int cut_arg, float* __restrict__ o0,
                    float* __restrict__ o1, float* __restrict__ area,
                    int* __restrict__ flags, uint8_t* __restrict__ oob,
                    float* __restrict__ wout) {
  extern __shared__ float s_corner[];  // a warp's corner areas, or block 0's
  __shared__ float s_out[4];
  __shared__ uint8_t s_dup[kThreads];
  constexpr int kPer = kCut > 0 ? (kCut * kCut + 31) / 32 : 1;
  const int cut = kCut > 0 ? kCut : cut_arg;
  const int npix = cut * cut;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int last = N - 1;
  const bool lead = blockIdx.x == 0;
  const uint32_t bx = __float_as_uint(xs[last]);
  const uint32_t by = __float_as_uint(ys[last]);
  int n = last;
  if (!lead) {
    n = (blockIdx.x - 1) * kWarps + warp;
    if (n >= last || same_position(xs, ys, n, bx, by)) return;
  }
  // block 0: which of its thread's first kAhead chunks' rows share the
  // last row's position, all read at once, beside the window's work
  uint32_t ahead = 0;
  if (lead) {
    uint32_t qx[kAhead], qy[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int q = min((int)threadIdx.x + k * kThreads, last);
      qx[k] = __float_as_uint(xs[q]);
      qy[k] = __float_as_uint(ys[q]);
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const bool same = (int)threadIdx.x + k * kThreads < last &&
                        qx[k] == bx && qy[k] == by;
      ahead |= (same ? 1u : 0u) << k;
    }
  }
  const float xc = xs[n], yc = ys[n];
  bool ox, oy;
  const int x0 = window_corner(xc, W, cut, &ox);
  const int y0 = window_corner(yc, H, cut, &oy);
  const bool measures = !lead || warp == 0;
  // a fixed window: the lane's pixels (lane, lane + 32, ...) now
  float v0[kPer], v1[kPer];
  int vm[kPer];
  if (kCut > 0 && measures) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = lane + 32 * j;
      v0[j] = v1[j] = 0.f;
      vm[j] = 0;
      if (i < npix) {
        const int row = i / cut, col = i - row * cut;
        const long long at = (long long)(y0 + row) * W + x0 + col;
        v0[j] = p0[at];
        if (p1) v1[j] = p1[at];
        if (!kSums && mask) vm[j] = mask[at];
      }
    }
  }
  const float rr = __fmul_rn(r, r);
  const float rs = clamp_min(r, (float)1e-30);
  const int side = cut + 1;
  const bool grid = cut <= kMaxGridCut && edges_shared(x0, cut, xc, lane) &&
                    edges_shared(y0, cut, yc, lane);
  float* corners = s_corner + (lead ? 0 : warp) * grid_floats(cut);
  if (grid) {
    // quad_area's terms that depend on one axis alone, a lane an edge:
    // x = min(|ex|, r), its arc integral and sign; y = min(|ey|, r), the
    // circle's x at y and its arc integral, the sign. Where quad_area
    // takes the arc (x > min(x, xc)), it is arc_int(x) - arc_int(xc): the
    // same two values (the lead block's warps each form their own copy)
    float* gx = s_corner + warp * grid_floats(cut) + side * side;
    float* gxa = gx + side;
    float* gxs = gxa + side;
    float* gy = gxs + side;
    float* gyc = gy + side;
    float* gya = gyc + side;
    float* gys = gya + side;
    for (int i = lane; i < 2 * side; i += 32) {
      if (i < side) {
        const float e = edge_at(x0, i, cut, xc);
        const float x = torch_min(fabsf(e), r);
        gx[i] = x;
        gxa[i] = arc_int(x, r, rr, rs);
        gxs[i] = sign_of(e);
      } else {
        const float e = edge_at(y0, i - side, cut, yc);
        const float y = torch_min(fabsf(e), r);
        const float c = sqrtf(clamp_min(__fsub_rn(rr, __fmul_rn(y, y)), 0.f));
        gy[i - side] = y;
        gyc[i - side] = c;
        gya[i - side] = arc_int(c, r, rr, rs);
        gys[i - side] = sign_of(e);
      }
    }
    __syncwarp();
    const int from = lead ? threadIdx.x : lane;
    const int step = lead ? kThreads : 32;
    for (int i = from; i < side * side; i += step) {
      const int j = i / side, k = i - j * side;
      // signed_area(ex_k, ey_j) from the terms
      const float x = gx[k], x1 = torch_min(x, gyc[j]);
      const float arc = x > x1 ? __fsub_rn(gxa[k], gya[j]) : 0.f;
      corners[i] = __fmul_rn(__fmul_rn(gxs[k], gys[j]),
                             __fadd_rn(__fmul_rn(gy[j], x1), arc));
    }
  }
  if (lead) {
    __syncthreads();
  } else {
    __syncwarp();
  }
  if (measures) {
    float s0 = 0.f, s1 = 0.f, sw = 0.f;
    int f = 0;
#pragma unroll
    for (int j = 0; j < (kCut > 0 ? kPer : 1); ++j) {
      for (int i = lane + 32 * j; i < npix; i += (kCut > 0 ? npix : 32)) {
        const int row = i / cut, col = i - row * cut;
        float w;
        if (grid) {
          const float* a = corners + row * side + col;
          w = corner_sum(a[side + 1], a[side], a[1], a[0]);
        } else {
          w = overlap(__fsub_rn((float)(x0 + col), xc),
                      __fsub_rn((float)(y0 + row), yc), r, rr, rs);
        }
        float e0, e1;
        int em;
        if (kCut > 0) {
          e0 = v0[j];
          e1 = v1[j];
          em = vm[j];
        } else {
          const long long at = (long long)(y0 + row) * W + x0 + col;
          e0 = p0[at];
          e1 = p1 ? p1[at] : 0.f;
          em = !kSums && mask ? mask[at] : 0;
        }
        s0 = __fadd_rn(s0, __fmul_rn(e0, w));
        if (kSums) {
          s1 = __fadd_rn(s1, __fmul_rn(e1, w));
        } else {
          s1 = __fadd_rn(s1, __fmul_rn(__fmul_rn(e1, e1), w));
          sw = __fadd_rn(sw, w);
          if (w > 0.f) f |= em & 0x3FFFF;
          if (wout) wout[(long long)n * npix + i] = w;
        }
      }
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (!kSums) {
      sw = warp_sum(sw);
      f = (int)__reduce_or_sync(0xffffffffu, (unsigned)f);
      s1 = sqrtf(s1);
    }
    if (lane == 0) {
      o0[n] = s0;
      o1[n] = s1;
      if (!kSums) {
        area[n] = sw;
        flags[n] = f;
        oob[n] = (ox || oy) ? 1 : 0;
      }
      if (lead) {
        s_out[0] = s0;
        s_out[1] = s1;
        s_out[2] = sw;
        s_out[3] = __int_as_float(f);
      }
    }
  }
  if (!lead) return;
  // block 0: the rows whose warps left theirs to it, a chunk of kThreads
  // rows at a time
  __syncthreads();
  const float v0s = s_out[0], v1s = s_out[1], vws = s_out[2];
  const int vfs = __float_as_int(s_out[3]);
  const uint8_t vos = (ox || oy) ? 1 : 0;
  for (int b = 0; b < last; b += kThreads) {
    const int k = b / kThreads, q = b + threadIdx.x;
    const bool dup = k < kAhead ? (ahead >> k) & 1u
                                : q < last && same_position(xs, ys, q, bx, by);
    if (dup) {
      o0[q] = v0s;
      o1[q] = v1s;
      if (!kSums) {
        area[q] = vws;
        flags[q] = vfs;
        oob[q] = vos;
      }
    }
    if (!kSums && wout) {
      s_dup[threadIdx.x] = dup;
      __syncthreads();
      for (int j = warp; j < kThreads; j += kWarps) {
        if (!s_dup[j]) continue;
        const long long to = (long long)(b + j) * npix;
        for (int i = lane; i < npix; i += 32)
          wout[to + i] = wout[(long long)last * npix + i];
      }
      __syncthreads();
    }
  }
}

int blocks_for(int N) { return 1 + (N - 1 + kWarps - 1) / kWarps; }

// block 0's grid is one (cut + 1)^2, the other blocks' one a warp; each
// warp's seven edge terms beside it
size_t corner_bytes(int cut) {
  return cut <= kMaxGridCut ? (size_t)kWarps * grid_floats(cut) * sizeof(float)
                            : 0;
}

}  // namespace

// img, rms (or null), mask (int32, or null), xs, ys (N,) f32; flux,
// fluxerr, area (N,) f32, flags (N,) int32, oob (N,) u8, w (N, cut, cut)
// f32 or null. The frame is at least cut x cut.
extern "C" int zuds_aperture_photometry(const float* img, const float* rms,
                                        const int* mask, const float* xs,
                                        const float* ys, int N, int H, int W,
                                        float r, int cut, float* flux,
                                        float* fluxerr, float* area,
                                        int* flags, uint8_t* oob, float* w,
                                        cudaStream_t stream) {
  if (N > 0) {
    const auto kernel = cut == 9 ? aperture_kernel<false, 9>
                                 : aperture_kernel<false, 0>;
    kernel<<<blocks_for(N), kThreads, corner_bytes(cut), stream>>>(
        img, rms, mask, xs, ys, N, H, W, r, cut, flux, fluxerr, area, flags,
        oob, w);
  }
  return (int)cudaGetLastError();
}

// a, b (H, W) f32, xs, ys (N,) f32; sa, sb (N,) f32: sum a w, sum b w.
extern "C" int zuds_aperture_sums(const float* a, const float* b,
                                  const float* xs, const float* ys, int N,
                                  int H, int W, float r, int cut, float* sa,
                                  float* sb, cudaStream_t stream) {
  if (N > 0) {
    const auto kernel = cut == 15 ? aperture_kernel<true, 15>
                                  : aperture_kernel<true, 0>;
    kernel<<<blocks_for(N), kThreads, corner_bytes(cut), stream>>>(
        a, b, nullptr, xs, ys, N, H, W, r, cut, sa, sb, nullptr, nullptr,
        nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}
