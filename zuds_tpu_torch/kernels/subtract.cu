// H11: the difference and noise epilogue of a subtraction, one thread per
// pixel.
//
// Replaces the elementwise tail of the reference's subtract_frames
// (zuds_tpu/ops/subtract.py:663-670) and of one_frame's noise stage
// (zuds_tpu/parallel/pipeline.py:264-269): from the science frame, the
// model (H3), the science rms, the propagated reference variance (H3 at
// Nm = 1) and the bad-pixel map it writes
//   diff = bad ? 1e-30 : sci - model
//   rms  = bad ? BIG_RMS : sqrt(sci_rms^2 + ref_var)
// and, when a submask is passed, submask | 1 << bit where diff is the
// sentinel. The roundings are the reference's: sci_rms^2 is rounded before
// the add (the eager per-pair path), or the square and the add are one FMA
// (``contract``: XLA:CPU contracts them inside the jitted pipeline). The
// square root is correctly rounded.
//
// Bound: memory: 17 bytes read and 8 written per pixel, 8 more with a
// submask.
#include "common.cuh"

namespace {

template <bool SUBMASK>
__global__ void subtract_epilogue_kernel(
    const float* __restrict__ sci, const float* __restrict__ model,
    const float* __restrict__ sci_rms, const float* __restrict__ ref_var,
    const uint8_t* __restrict__ bad, const int* __restrict__ submask,
    float* __restrict__ diff, float* __restrict__ rms,
    int* __restrict__ submask_out, long long n, float sentinel,
    float big_rms, int bit, int contract) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const bool b = bad[i] != 0;
    const float s = sci_rms[i];
    const float var = contract ? fmaf(s, s, ref_var[i])
                               : __fadd_rn(__fmul_rn(s, s), ref_var[i]);
    const float d = b ? sentinel : __fsub_rn(sci[i], model[i]);
    diff[i] = d;
    rms[i] = b ? big_rms : __fsqrt_rn(var);
    if (SUBMASK) submask_out[i] = submask[i] | (d == sentinel ? 1 << bit : 0);
  }
}

}  // namespace

// submask and submask_out are both null or both set.
extern "C" int zuds_subtract_epilogue(
    const float* sci, const float* model, const float* sci_rms,
    const float* ref_var, const uint8_t* bad, const int* submask, float* diff,
    float* rms, int* submask_out, long long n, float sentinel, float big_rms,
    int bit, int contract, cudaStream_t stream) {
  if ((submask == nullptr) != (submask_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const int block = 256;
  long long want = (n + block - 1) / block;
  const int grid = (int)(want < 1 ? 1 : (want > 132 * 16 ? 132 * 16 : want));
  if (submask != nullptr)
    subtract_epilogue_kernel<true><<<grid, block, 0, stream>>>(
        sci, model, sci_rms, ref_var, bad, submask, diff, rms, submask_out, n,
        sentinel, big_rms, bit, contract);
  else
    subtract_epilogue_kernel<false><<<grid, block, 0, stream>>>(
        sci, model, sci_rms, ref_var, bad, submask, diff, rms, submask_out, n,
        sentinel, big_rms, bit, contract);
  return (int)cudaGetLastError();
}
