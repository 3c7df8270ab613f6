// H4: the matched filter and threshold of the detection stage.
//
// Replaces zuds_tpu/ops/detect.py:607-616 (the good-pixel mask, the 3x3
// pyramid correlation of zuds_tpu/ops/convolve.py:conv2_same with zero
// padding, and the nsigma * rms threshold), which the TPU runs as nine
// unrolled shift-FMA taps over the frame:
//   good = weight_ok & (rms > 0) & isfinite(diff)
//   img  = good ? diff : 0
//   filt = (1 2 1 / 2 4 2 / 1 2 1) / 16 correlated with img, zero padded
//   det  = good & (filt > nsigma * rms)
//
// Bound: memory, 9 B read (diff, rms, the weight byte) and 9 B written
// (img, filt, det) a pixel: 170 MB at 3080x3072, 51 us at 3.35 TB/s. The
// arithmetic is 18 operations a pixel.
//
// Design: a register-strip stencil. A thread owns V adjacent columns (V = 4,
// or 1 for a frame whose width is not a multiple of 4 or whose planes are
// not 16-byte aligned, e.g. a view into a batch) and walks down a strip of
// kRows rows (32: zuds_tpu_torch/bench_stencils.py times 16, 24 and 48 beside
// it); a warp covers 32 V columns. Per row a thread loads diff and
// rms by one 16-byte load each and its four weight bytes by one 4-byte
// load, issued a row ahead of the row it computes; it forms good and the
// masked value m = good ? d : 0 once, as the row arrives. It keeps three
// rows of m at V + 2 columns: its own and one halo column each side, which
// come from the neighbouring lanes by shuffles (lanes 0 and 31 load their
// outer column themselves). Only the two halo rows of a strip are read
// twice. The centre row's rms and good stay in registers for det; img and
// filt go out as float4 and det as uchar4.
//
// Bit-equality with the plain version (ops/detect.py:matched_filter_plain):
// - the nine taps are added in row-major order from +0 with __fmul_rn /
//   __fadd_rn, never contracted into an FMA (a subnormal product is
//   inexact, and the plain version rounds it before the add);
// - every tap is added, also those off the frame (w * +0 = +0), as the
//   plain version adds its padded taps;
// - good is wok != 0 && rms > 0 && |diff| <= FLT_MAX (NaN fails each);
// - det is good && filt > __fmul_rn(nsigma, rms), nsigma rounded to f32 as
//   PyTorch rounds a Python scalar for an f32 tensor.
#include <float.h>

#include "common.cuh"

#ifndef ZUDS_DETECT_ROWS
#define ZUDS_DETECT_ROWS 32   // rows of a warp's strip
#endif

namespace {

constexpr int kRows = ZUDS_DETECT_ROWS;
constexpr int kWarps = 4;     // a block's warps, their strips stacked in y
constexpr unsigned kFull = 0xffffffffu;

// the pyramid's weight at tap (dy, dx), dy, dx in 0..2: 1, 2 or 4 sixteenths
__device__ __forceinline__ float tap_weight(int dy, int dx) {
  return (float)((2 - (dy - 1) * (dy - 1)) * (2 - (dx - 1) * (dx - 1)))
         * 0.0625f;
}

__device__ __forceinline__ bool good_px(float d, float r, uint32_t w) {
  return w != 0 && r > 0.f && fabsf(d) <= FLT_MAX;
}

// One row's loads for a lane: its V columns, and for lanes 0 and 31 the
// outer halo column (hx < 0 or off the frame: none).
template <int V>
struct RowLoad {
  float d[V], r[V];
  uint32_t w[V];
  float hd, hr;
  uint32_t hw;
};

template <int V>
__device__ __forceinline__ void load_row(const float* __restrict__ diff,
                                         const float* __restrict__ rms,
                                         const uint8_t* __restrict__ wok,
                                         int H, int W, int y, int x, int hx,
                                         RowLoad<V>& o) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    o.d[i] = 0.f;
    o.r[i] = 0.f;
    o.w[i] = 0;
  }
  o.hd = 0.f;
  o.hr = 0.f;
  o.hw = 0;
  if (y < 0 || y >= H) return;
  const int row = y * W;
  if constexpr (V == 4) {
    if (x < W) {   // W % 4 == 0: the four columns are all on the frame
      const float4 d = __ldg(reinterpret_cast<const float4*>(diff + row + x));
      const float4 r = __ldg(reinterpret_cast<const float4*>(rms + row + x));
      const uint32_t w =
          __ldg(reinterpret_cast<const unsigned int*>(wok + row + x));
      o.d[0] = d.x;
      o.d[1] = d.y;
      o.d[2] = d.z;
      o.d[3] = d.w;
      o.r[0] = r.x;
      o.r[1] = r.y;
      o.r[2] = r.z;
      o.r[3] = r.w;
#pragma unroll
      for (int i = 0; i < V; ++i) o.w[i] = (w >> (8 * i)) & 0xffu;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (x + i < W) {
        o.d[i] = __ldg(diff + row + x + i);
        o.r[i] = __ldg(rms + row + x + i);
        o.w[i] = __ldg(wok + row + x + i);
      }
  }
  if (hx >= 0 && hx < W) {
    o.hd = __ldg(diff + row + hx);
    o.hr = __ldg(rms + row + hx);
    o.hw = __ldg(wok + row + hx);
  }
}

// The masked row m = good ? d : 0 at V + 2 columns (the halo columns from
// the neighbouring lanes), and the row's own rms and good.
template <int V>
__device__ __forceinline__ void mask_row(const RowLoad<V>& l, int lane,
                                         float (&m)[V + 2], float (&r)[V],
                                         bool (&g)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    g[i] = good_px(l.d[i], l.r[i], l.w[i]);
    m[i + 1] = g[i] ? l.d[i] : 0.f;
    r[i] = l.r[i];
  }
  const float hm = good_px(l.hd, l.hr, l.hw) ? l.hd : 0.f;
  const float left = __shfl_up_sync(kFull, m[V], 1);
  const float right = __shfl_down_sync(kFull, m[1], 1);
  m[0] = lane == 0 ? hm : left;
  m[V + 1] = lane == 31 ? hm : right;
}

template <int V>
__global__ void __launch_bounds__(32 * kWarps)
    detect_filter_kernel(const float* __restrict__ diff,
                         const float* __restrict__ rms,
                         const uint8_t* __restrict__ wok, int H, int W,
                         float nsigma, float* __restrict__ img,
                         float* __restrict__ filt,
                         uint8_t* __restrict__ det) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int y0 = (blockIdx.y * kWarps + warp) * kRows;
  if (y0 >= H) return;                     // the whole warp
  const int xw = blockIdx.x * 32 * V;      // the warp's first column
  const int x = xw + lane * V;
  const int hx = lane == 0 ? xw - 1 : (lane == 31 ? xw + 32 * V : -1);

  float up[V + 2], mid[V + 2], dn[V + 2];
  float rmid[V], rdn[V], rup[V];
  bool gmid[V], gdn[V], gup[V];
  RowLoad<V> cur;
  load_row<V>(diff, rms, wok, H, W, y0 - 1, x, hx, cur);
  mask_row<V>(cur, lane, up, rup, gup);
  load_row<V>(diff, rms, wok, H, W, y0, x, hx, cur);
  mask_row<V>(cur, lane, mid, rmid, gmid);
  load_row<V>(diff, rms, wok, H, W, y0 + 1, x, hx, cur);

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int y = y0 + i;
    if (y >= H) break;                     // uniform over the warp
    // the row after next is in flight while this row computes
    RowLoad<V> next;
    if (i + 2 <= kRows)
      load_row<V>(diff, rms, wok, H, W, y + 2, x, hx, next);
    mask_row<V>(cur, lane, dn, rdn, gdn);

    float f[V];
    bool dt[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc = __fadd_rn(acc, __fmul_rn(tap_weight(0, dx), up[c + dx]));
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc = __fadd_rn(acc, __fmul_rn(tap_weight(1, dx), mid[c + dx]));
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc = __fadd_rn(acc, __fmul_rn(tap_weight(2, dx), dn[c + dx]));
      f[c] = acc;
      dt[c] = gmid[c] && acc > __fmul_rn(nsigma, rmid[c]);
    }
    const int o = y * W + x;
    if constexpr (V == 4) {
      if (x < W) {
        *reinterpret_cast<float4*>(img + o) =
            make_float4(mid[1], mid[2], mid[3], mid[4]);
        *reinterpret_cast<float4*>(filt + o) =
            make_float4(f[0], f[1], f[2], f[3]);
        *reinterpret_cast<uchar4*>(det + o) =
            make_uchar4(dt[0], dt[1], dt[2], dt[3]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c)
        if (x + c < W) {
          img[o + c] = mid[c + 1];
          filt[o + c] = f[c];
          det[o + c] = dt[c];
        }
    }
#pragma unroll
    for (int c = 0; c < V + 2; ++c) {
      up[c] = mid[c];
      mid[c] = dn[c];
    }
#pragma unroll
    for (int c = 0; c < V; ++c) {
      rmid[c] = rdn[c];
      gmid[c] = gdn[c];
    }
    if (i + 2 <= kRows) cur = next;
  }
}

template <int V>
void launch_detect_filter(const float* diff, const float* rms,
                          const uint8_t* wok, int H, int W, float nsigma,
                          float* img, float* filt, uint8_t* det,
                          cudaStream_t stream) {
  const int strips = (H + kRows - 1) / kRows;
  const dim3 grid((W + 32 * V - 1) / (32 * V),
                  (strips + kWarps - 1) / kWarps);
  detect_filter_kernel<V><<<grid, 32 * kWarps, 0, stream>>>(
      diff, rms, wok, H, W, nsigma, img, filt, det);
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

}  // namespace

// diff, rms f32 and wok (bool bytes), each (H, W) row-major; img, filt f32
// and det (bool bytes) out, (H, W). The 4-column form needs W % 4 == 0,
// every float plane 16-byte aligned and the byte planes 4-byte aligned;
// anything else takes the 1-column form.
extern "C" int zuds_detect_filter(const float* diff, const float* rms,
                                  const uint8_t* wok, int H, int W,
                                  float nsigma, float* img, float* filt,
                                  uint8_t* det, cudaStream_t stream) {
  const bool vec = W % 4 == 0 && aligned(diff, 16) && aligned(rms, 16) &&
                   aligned(img, 16) && aligned(filt, 16) &&
                   aligned(wok, 4) && aligned(det, 4);
  if (vec)
    launch_detect_filter<4>(diff, rms, wok, H, W, nsigma, img, filt, det,
                            stream);
  else
    launch_detect_filter<1>(diff, rms, wok, H, W, nsigma, img, filt, det,
                            stream);
  return (int)cudaGetLastError();
}
