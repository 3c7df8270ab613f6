// Shared helpers of the zuds_tpu_torch CUDA kernels.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// Non-negative remainder: the reference's jnp.roll wraps around.
__device__ __forceinline__ int wrap_index(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}
