// Fused w8a8 dense for the V-JEPA2 backbone's query/key/value/proj, sm_90a.
//
// Replaces: algonauts2025_tpu/ops/quant.py::_fused_w8a8_kernel (the Pallas
// TPU kernel launched by int8_matmul_fused).  It quantizes the activation
// x with a calibrated static scale sx in registers (true division, round
// half to even, clamp +-127), multiplies int8 x int8 into an int32
// accumulator, and writes acc * (sx * w_scale[n]) + bias[n] in the output
// dtype; neither the int8 activations nor the int32 sums reach device
// memory.  It equals its plain PyTorch version bit for bit.
//
// What bounds it on an H100: at ViT-G with a window batch of 4 one call is
// (32768 x 1408) @ (1408 x 1408): 130 GOP of int8 work against ~190 MB of
// bf16 in, int8 weights and bf16 out, so the bound is operations (~0.066 ms
// at the 1979 TOP/s int8 tensor-core peak).  This first version runs on the
// CUDA cores with __dp4a (int8_gemm.cuh), well below that peak; tensor
// cores (mma.sync / wgmma s8) are the next step.

#include "int8_gemm.cuh"

namespace {

template <typename TA>
int dispatch_out(const i8gemm::Args& g, int out_dtype, cudaStream_t s) {
  if (out_dtype == 0) return i8gemm::launch<TA, i8gemm::StoreDequant<float>>(g, s);
  if (out_dtype == 1) return i8gemm::launch<TA, i8gemm::StoreDequant<__nv_bfloat16>>(g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out (M, N) = dequant(quant(x, sx) @ w_q) + bias.  sx: device pointer to one
// float (already validated / NaN-poisoned by the caller).  bias may be null.
// x_dtype / out_dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 on success).
int w8a8_forward(const void* x, int x_dtype, const int8_t* w_q, const float* w_scale,
                 const float* bias, const float* sx, void* out, int out_dtype, int M, int N,
                 int K, void* stream) {
  i8gemm::Args g{x, w_q, w_scale, bias, sx, out, M, N, K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return dispatch_out<float>(g, out_dtype, s);
  if (x_dtype == 1) return dispatch_out<__nv_bfloat16>(g, out_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
