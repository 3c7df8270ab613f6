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
