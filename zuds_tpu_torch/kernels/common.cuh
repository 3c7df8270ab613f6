// Shared helpers of the zuds_tpu_torch CUDA kernels.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// Non-negative remainder: the reference's jnp.roll wraps around.
__device__ __forceinline__ int wrap_index(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

// NaN-propagating max, as torch.max_pool2d and XLA's max: once NaN, stays
// NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(b) || b > a) ? b : a;
}

// PyTorch's NaN rules for torch.maximum/minimum (a NaN operand wins) and
// torch.clamp (a NaN input stays NaN; its bounds are never NaN here).
__device__ __forceinline__ float torch_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float torch_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// The corner of a cut x cut window about the f32 position p, as the plain
// versions form it on the card: round half to even, to int64 (a NaN or an
// out-of-range value converts as PyTorch's conversion does: the same cvt
// instruction, rounding to nearest instead of toward zero after its
// round), minus cut / 2, clamped to [0, n - cut].
// The int64 arithmetic wraps (unsigned here: signed overflow is undefined
// in C++), as PyTorch's int64 tensors wrap. ``out`` is true where the
// window about the rounded position runs off [0, n).
__device__ __forceinline__ int window_corner(float p, int n, int cut,
                                             bool* out) {
  const long long half = cut / 2;
  const long long i = __float2ll_rn(p);
  const long long lo =
      (long long)((unsigned long long)i - (unsigned long long)half);
  const long long hi =
      (long long)((unsigned long long)i + (unsigned long long)half);
  *out = lo < 0 || hi >= n;
  return (int)(lo < 0 ? 0 : (lo > n - cut ? n - cut : lo));
}

// TF32 by cvt.rna (round half away from zero on the 13 dropped bits): the
// hi part of a 3xTF32 split, x_hi = tf32(x), x_lo = tf32(x - x_hi).
__device__ __forceinline__ float tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// c += a b on the tensor cores: mma.sync m16n8k8, TF32 in, f32 accumulate.
// a: rows (g, g+8) x cols (t, t+4) of the 16 x 8 A tile; b: rows (t, t+4)
// of column g of the 8 x 8 B tile; c: rows (g, g+8) x cols (2t, 2t+1)
// (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         float b0, float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}
