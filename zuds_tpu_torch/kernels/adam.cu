// H21: the fused Adam step over a flat f32 parameter buffer.
//
// Replaces optax.adam's update and optax.apply_updates in train_step
// (zuds_tpu/models/braai.py:90-105, :103-104): per element, in optax
// 0.2.6's order of operations,
//   mu = (1 - b1) g + b1 mu
//   nu = (1 - b2) (g g) + b2 nu
//   u  = (mu / c1) / (sqrt(nu / c2) + eps)
//   p  = p + u (-lr)
// with the bias corrections c1 = 1 - b1^count and c2 = 1 - b2^count
// (count already incremented) read from two device scalars that the
// caller forms once (models/adam.py:bias_corrections), so nothing is read
// back to the host. Every product, sum, quotient and root is rounded on
// its own (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: nvcc would
// contract a product and a sum into an FMA otherwise), as PyTorch's
// elementwise kernels round each operation of the plain version
// (models/adam.py:adam_update_plain), so the two are bit-equal on the card.
//
// One grid-stride pass, one thread per element; p, mu and nu are updated
// in place. Bound: bytes, 28 B per parameter (p, g, mu, nu read, p, mu,
// nu written): 67.9 MB for braai's 2,425,377 parameters, 0.0203 ms at
// 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                float* __restrict__ mu, float* __restrict__ nu,
                const float* __restrict__ bc1, const float* __restrict__ bc2,
                long long n, float b1, float omb1, float b2, float omb2,
                float eps, float neg_lr) {
  const float c1 = *bc1, c2 = *bc2;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float gi = g[i];
    const float m = __fadd_rn(__fmul_rn(omb1, gi), __fmul_rn(b1, mu[i]));
    const float v =
        __fadd_rn(__fmul_rn(omb2, __fmul_rn(gi, gi)), __fmul_rn(b2, nu[i]));
    const float u = __fdiv_rn(__fdiv_rn(m, c1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), eps));
    p[i] = __fadd_rn(p[i], __fmul_rn(u, neg_lr));
    mu[i] = m;
    nu[i] = v;
  }
}

}  // namespace

// p, g, mu, nu (n,) f32, bc1, bc2 f32 device scalars; p, mu, nu in place.
// omb1 = 1 - b1 and omb2 = 1 - b2 as the caller rounds them to f32.
extern "C" int zuds_adam_step(float* p, const float* g, float* mu, float* nu,
                              const float* bc1, const float* bc2,
                              long long n, float b1, float omb1, float b2,
                              float omb2, float eps, float neg_lr,
                              cudaStream_t stream) {
  if (n > 0) {
    const long long want = (n + kThreads - 1) / kThreads;
    const int grid = (int)(want < 4 * 132 * 8 ? want : 4 * 132 * 8);
    adam_kernel<<<grid, kThreads, 0, stream>>>(p, g, mu, nu, bc1, bc2, n, b1,
                                               omb1, b2, omb2, eps, neg_lr);
  }
  return (int)cudaGetLastError();
}
