// H7: the stamp-candidate stencil of the kernel-fit stamp selector.
//
// Replaces zuds_tpu/ops/measure.py:37-65 (select_stamps_device): the 3x3
// pyramid filter conv2_same(img, DEFAULT_FILTER) with zero padding, the
// 9x9 local maximum of the filtered frame (three rounds of shifted maxima,
// k = 1, 2, 1, -inf beyond the frame), and the test
//   filt >= max9x9 & filt > med + 10 sigma & img < sat & inside the margin,
// which the TPU runs as ~20 full-frame passes (9 shifted FMAs, 12 shifted
// maxima, the compare). `med` and `sigma` are device scalars (H8's
// outputs); the host never reads them. The selector reads `filt` only at
// the candidates, so it is written there only.
//
// Bound: memory. 4 B read and 1 B (cand) written a pixel, plus 4 B of
// `filt` a candidate: 47 MB at 3080x3072, 14 us at 3.35 TB/s. The filter is
// 18 operations a pixel.
//
// Design: one read of the frame, the 9x9 maximum only where it can matter.
// A block of 256 threads owns a kTW x kTH output tile. It copies the tile
// and a 5-px halo of `img` into shared memory by 16-byte cp.async copies of
// an aligned superset of columns (x0 - 8 ... x0 + kTW + 8; zero fill off
// the frame), stepping its copy index without a division. Each thread then
// computes `filt` on its own 4 x 4 pixels in registers: six image rows of
// one 16-byte shared load and a halo value each side from the neighbouring
// lanes' shuffles. The cheap test comes first: pass = filt > fmaf(10,
// sigma, med) && img < sat && inside the margin, taken only by a thread
// whose largest `filt` is over the threshold (its values read back from
// shared memory). Only a block with a passing pixel (__syncthreads_or)
// computes `filt` on its 4-px ring (the rest of the 9x9 windows; -inf off
// the frame), and of the ring only the bands of 4 rows or columns that
// its passing pixels' windows reach (a pixel 4 px or more inside the tile
// reads none). Only a warp with a passing lane (__any_sync) then queues its
// passing pixels in shared memory (an exclusive scan of the lanes' counts)
// and takes them a pixel a lane: the 3x3 neighbours first (a pixel that is
// no 3x3 maximum is no 9x9 one), the survivors compacted by a ballot, then
// all 81 values of a survivor's window, directly in shared memory. So a
// warp's lanes stay busy on a crowded frame, where some 14% of the pixels
// pass and one in ~35 of those is a candidate; on a night frame ~500 of
// 9.46 M pixels are candidates and a few 10^4 pass. The candidate bytes go
// through a byte map in shared memory (the queues and the map reuse the
// image tile), so each lane writes 16 bytes of one row; a block with no
// passing pixel writes zeros.
//
// Bit-equality with the plain version (ops/measure.py):
// - the taps are added in row-major order from zero with __fmul_rn /
//   __fadd_rn (the weights 1/16, 2/16, 4/16 are powers of two, so a product
//   rounds only when it is subnormal, as the plain version's does);
// - cand = pass && every value v of the 9x9 window has v <= filt: a NaN
//   there fails it, as the plain version's NaN-propagating maximum does
//   (filt >= NaN is false), -inf off the frame never does, and a maximum
//   is exact, so this is the plain version's filt >= max9x9;
// - the threshold is fmaf(10, sigma, med): XLA's CPU backend contracts the
//   reference's `med + 10.0 * sigma` into one FMA, and the plain version
//   computes the same (ops/ordered.py:fma).
#include "common.cuh"

namespace {

constexpr int kTW = 128;                 // output tile: 32 lanes x 4 columns
constexpr int kTH = 32;                  // by 8 warps x 4 rows
constexpr int kR = 4;                    // reach of the local maximum (9x9)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTW == 32 * 4 && kTH == kWarps * 4,
              "a thread owns 4 x 4 pixels of the tile");
// img: rows y0 - 5 ... y0 + kTH + 4, columns x0 - 8 ... x0 + kTW + 7
constexpr int kIH = kTH + 2 * (kR + 1);
constexpr int kIW = kTW + 16;
constexpr int kIX = 8;                   // the tile's first column in s_img
constexpr int kIG = kIW / 4;             // 16-byte groups of a row
// filt: the tile and its 4-px ring, rows y0 - 4 ..., columns x0 - 4 ...
constexpr int kFH = kTH + 2 * kR;
constexpr int kFW = kTW + 2 * kR;
constexpr int kRing = kFH * kFW - kTH * kTW;
// the candidate stage's queues (2 x 512 uint16 a warp) and byte map
// (4 x kTW a warp) fit in s_img
static_assert(kWarps * (2048 + 4 * kTW) <= kIH * kIW * 4,
              "queues in the image tile");

__device__ __forceinline__ float tap_weight(int dy, int dx) {
  return (float)((2 - (dy - 1) * (dy - 1)) * (2 - (dx - 1) * (dx - 1)))
         * 0.0625f;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The image tile and its halo into s_img, zero off the frame. VEC: 16-byte
// copies (W % 4 == 0 and img 16-byte aligned: a group of four columns is
// wholly on or off the frame); else one float at a time.
template <bool VEC>
__device__ __forceinline__ void load_tile(const float* __restrict__ img,
                                          int H, int W, int x0, int y0,
                                          float (*s_img)[kIW]) {
  const int t = threadIdx.x;
  const int gx0 = x0 - kIX, gy0 = y0 - (kR + 1);
  if (VEC) {
    // the copy index t + k kThreads as (row, group), stepped without a
    // division
    constexpr int kDr = kThreads / kIG, kDg = kThreads % kIG;
    int r = t / kIG, g = t % kIG;
    for (; r < kIH;) {
      const int gy = gy0 + r, gx = gx0 + 4 * g;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(&s_img[r][4 * g], in ? img + gy * W + gx : img,
                 in ? 16 : 0);
      r += kDr;
      g += kDg;
      if (g >= kIG) {
        g -= kIG;
        ++r;
      }
    }
    cp_async_wait_all();
  } else {
    constexpr int kDr = kThreads / kIW, kDc = kThreads % kIW;
    int r = t / kIW, c = t % kIW;
    for (; r < kIH;) {
      const int gy = gy0 + r, gx = gx0 + c;
      s_img[r][c] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                        ? img[gy * W + gx] : 0.f;
      r += kDr;
      c += kDc;
      if (c >= kIW) {
        c -= kIW;
        ++r;
      }
    }
  }
}

// filt at ring point (fy, fx) of s_filt from nine shared taps; -inf off the
// frame
__device__ __forceinline__ float ring_filt(const float (*s_img)[kIW], int H,
                                           int W, int x0, int y0, int fy,
                                           int fx) {
  const int gy = y0 - kR + fy, gx = x0 - kR + fx;
  if (gy < 0 || gy >= H || gx < 0 || gx >= W) return -INFINITY;
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      acc = __fadd_rn(acc, __fmul_rn(tap_weight(dy, dx),
                                     s_img[fy + dy][fx + kIX - kR - 1 + dx]));
  return acc;
}

// no value of the (2 reach + 1)^2 window about tile pixel (ty, tx) exceeds
// f or is NaN
template <int REACH>
__device__ __forceinline__ bool window_peak(const float (*s_filt)[kFW],
                                            int ty, int tx, float f) {
  for (int dy = kR - REACH; dy <= kR + REACH; ++dy)
#pragma unroll
    for (int dx = kR - REACH; dx <= kR + REACH; ++dx)
      if (!(s_filt[ty + dy][tx + dx] <= f)) return false;
  return true;
}

// The candidates of a block with a passing pixel, after the barrier that
// ends the dense pass: the ring bands its windows reach (``need``), then a
// warp's passing pixels a pixel a lane. Returns this lane's 16 bytes of the
// warp's candidate rows (row l / 8, columns 16 (l % 8) ...); writes `filt`
// at the candidates.
// Not inlined: the dense pass's code stays small.
__device__ __noinline__ uint4
block_candidates(float (*s_img)[kIW], float (*s_filt)[kFW], unsigned need,
                 unsigned pass, int H, int W, int x0, int y0,
                 float* __restrict__ filt_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty0 = 4 * warp, tx0 = 4 * lane;
  if (need) {
    for (int k = threadIdx.x; k < kRing; k += kThreads) {
      int fy, fx;
      unsigned band;
      if (k < 2 * kR * kFW) {              // the kR rows above and below
        const int r = k / kFW;
        fy = r < kR ? r : r + kTH;
        fx = k - r * kFW;
        band = r < kR ? 1u : 2u;
      } else {                             // the kR columns left and right
        const int q = k - 2 * kR * kFW, c = q % (2 * kR);
        fy = kR + q / (2 * kR);
        fx = c < kR ? c : c + kTW;
        band = c < kR ? 4u : 8u;
      }
      if (need & band)
        s_filt[fy][fx] = ring_filt(s_img, H, W, x0, y0, fy, fx);
    }
    __syncthreads();
  }
  // s_img is free from here (the barrier above, or the caller's after the
  // last read of s_img). A warp's queues of its passing pixels ((row - 4
  // warp) << 7 | column) and its candidate bytes live there: the passing
  // pixels go through the 3x3 test a pixel a lane, the survivors through
  // the 9x9 test.
  uint16_t* qa = reinterpret_cast<uint16_t*>(&s_img[0][0]) + warp * 1024;
  uint16_t* qb = qa + 512;
  uint8_t* cmap = reinterpret_cast<uint8_t*>(&s_img[0][0]) +
                  kWarps * 2048 + warp * 4 * kTW;
  *reinterpret_cast<uint4*>(cmap + 16 * lane) = make_uint4(0, 0, 0, 0);
  if (__any_sync(kFull, pass != 0)) {
    const unsigned lt = (1u << lane) - 1u;
    int off = __popc(pass);                // exclusive prefix over lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, off, d);
      if (lane >= d) off += v;
    }
    const int total = __shfl_sync(kFull, off, 31);
    off -= __popc(pass);
    for (unsigned b = pass; b; b &= b - 1) {
      const int bit = __ffs(b) - 1;
      qa[off++] = (uint16_t)((bit >> 2) << 7 | (tx0 + (bit & 3)));
    }
    __syncwarp();
    int nb = 0;
    for (int k0 = 0; k0 < total; k0 += 32) {
      const int k = k0 + lane;
      bool ok = false;
      uint16_t q = 0;
      if (k < total) {
        q = qa[k];
        const int ty = ty0 + (q >> 7), tx = q & 127;
        ok = window_peak<1>(s_filt, ty, tx, s_filt[ty + kR][tx + kR]);
      }
      const unsigned m = __ballot_sync(kFull, ok);
      if (ok) qb[nb + __popc(m & lt)] = q;
      nb += __popc(m);
    }
    __syncwarp();
    for (int k = lane; k < nb; k += 32) {
      const uint16_t q = qb[k];
      const int ty = ty0 + (q >> 7), tx = q & 127;
      const float f = s_filt[ty + kR][tx + kR];
      if (window_peak<kR>(s_filt, ty, tx, f)) {
        cmap[(q >> 7) * kTW + tx] = 1;
        filt_out[(y0 + ty) * W + x0 + tx] = f;
      }
    }
    __syncwarp();
  }
  return *reinterpret_cast<const uint4*>(cmap + (lane >> 3) * kTW +
                                         16 * (lane & 7));
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 4)  // 4 blocks an SM by smem
    stamp_cand_kernel(const float* __restrict__ img, int H, int W,
                      const float* __restrict__ med,
                      const float* __restrict__ sigma, float sat, int margin,
                      float* __restrict__ filt_out,
                      uint8_t* __restrict__ cand_out) {
  __shared__ __align__(16) float s_img[kIH][kIW];
  __shared__ __align__(16) float s_filt[kFH][kFW];
  __shared__ unsigned s_sides;   // ring bands a passing pixel's window needs
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the threshold's scalars before the copies: the copies' wait is a
  // memory clobber, which no load after it crosses
  const float thr = fmaf(10.f, __ldg(sigma), __ldg(med));
  if (threadIdx.x == 0) s_sides = 0;
  load_tile<VEC>(img, H, W, x0, y0, s_img);
  __syncthreads();

  // this thread's pixels: tile rows 4 warp + i, columns 4 lane + j. Rows
  // 4 warp + kR + k (k = 0..5) of s_img are its pixels' rows -1 ... +4,
  // columns 4 lane + kIX - 1 + c (c = 0..5) their columns -1 ... +4
  float e[6][6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float* row = s_img[4 * warp + kR + k];
    const float4 q = *reinterpret_cast<const float4*>(row + 4 * lane + kIX);
    float outer = 0.f;                     // lanes 0 and 31 only
    if (lane == 0) outer = row[kIX - 1];
    if (lane == 31) outer = row[4 * lane + kIX + 4];
    const float left = __shfl_up_sync(kFull, q.w, 1);
    const float right = __shfl_down_sync(kFull, q.x, 1);
    e[k][0] = lane == 0 ? outer : left;
    e[k][1] = q.x;
    e[k][2] = q.y;
    e[k][3] = q.z;
    e[k][4] = q.w;
    e[k][5] = lane == 31 ? outer : right;
  }
  const int ty0 = 4 * warp, tx0 = 4 * lane;
  float top = -INFINITY;                   // NaN never wins it
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gy = y0 + ty0 + i;
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          acc = __fadd_rn(acc, __fmul_rn(tap_weight(dy, dx),
                                         e[i + dy][j + dx]));
      f[j] = gy < H && x0 + tx0 + j < W ? acc : -INFINITY;
      top = fmaxf(top, f[j]);
    }
    *reinterpret_cast<float4*>(&s_filt[ty0 + i + kR][tx0 + kR]) =
        make_float4(f[0], f[1], f[2], f[3]);
  }
  // the full test only where some pixel of the thread is over the
  // threshold (exact: NaN and -inf off the frame fail filt > thr either
  // way), its filt and img read back from shared memory
  unsigned pass = 0;                       // bit 4 i + j
  if (top > thr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gy = y0 + ty0 + i;
      const bool rowok = gy >= margin && gy < H - margin;
      const float4 f = *reinterpret_cast<const float4*>(
          &s_filt[ty0 + i + kR][tx0 + kR]);
      const float4 v = *reinterpret_cast<const float4*>(
          &s_img[ty0 + i + kR + 1][tx0 + kIX]);
      const float fs[4] = {f.x, f.y, f.z, f.w};
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gx = x0 + tx0 + j;
        const bool p = rowok && gx >= margin && gx < W - margin &&
                       fs[j] > thr && vs[j] < sat;
        pass |= (unsigned)p << (4 * i + j);
      }
    }
  }
#ifdef ZUDS_STAMPS_PROBE_NO_PEAKS
  pass = 0;   // probe: the dense pass alone (not the function)
#endif
  // the ring bands the windows of this thread's passing pixels reach: the
  // kR rows above (warp 0) or below (the last warp), the kR columns left
  // (lane 0) or right (lane 31)
  const unsigned sides = pass == 0 ? 0u
                         : (warp == 0 ? 1u : 0u) |
                               (warp == kWarps - 1 ? 2u : 0u) |
                               (lane == 0 ? 4u : 0u) | (lane == 31 ? 8u : 0u);
  if (sides) atomicOr(&s_sides, sides);

  // the warp's four rows of candidate bytes; zero unless a pixel passes
  uint4 bytes = make_uint4(0, 0, 0, 0);
  if (__syncthreads_or(pass != 0))
    bytes = block_candidates(s_img, s_filt, s_sides, pass, H, W, x0, y0,
                             filt_out);

  // lane l writes 16 bytes: row 4 warp + l / 8, columns 16 (l % 8) ...
  const int gy = y0 + ty0 + (lane >> 3), gx = x0 + 16 * (lane & 7);
  if (gy < H && gx < W) {
    uint8_t* dst = cand_out + gy * W + gx;
    if (W % 16 == 0) {                     // 16 bytes on the frame, aligned
      *reinterpret_cast<uint4*>(dst) = bytes;
    } else {
      const uint32_t w4[4] = {bytes.x, bytes.y, bytes.z, bytes.w};
#pragma unroll
      for (int c = 0; c < 16; ++c)
        if (gx + c < W) dst[c] = (w4[c >> 2] >> (8 * (c & 3))) & 0xffu;
    }
  }
}

}  // namespace

// img f32 (H, W) row-major; med, sigma f32 device scalars; filt f32 (H, W),
// written at the candidates only; cand (bool bytes, (H, W), 16-byte
// aligned). 16-byte image copies need W % 4 == 0 and img 16-byte aligned;
// anything else copies one float at a time.
extern "C" int zuds_stamp_candidates(const float* img, int H, int W,
                                     const float* med, const float* sigma,
                                     float sat, int margin, float* filt,
                                     uint8_t* cand, cudaStream_t stream) {
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH);
  if (W % 4 == 0 && (reinterpret_cast<uintptr_t>(img) & 15) == 0)
    stamp_cand_kernel<true><<<grid, kThreads, 0, stream>>>(
        img, H, W, med, sigma, sat, margin, filt, cand);
  else
    stamp_cand_kernel<false><<<grid, kThreads, 0, stream>>>(
        img, H, W, med, sigma, sat, margin, filt, cand);
  return (int)cudaGetLastError();
}
