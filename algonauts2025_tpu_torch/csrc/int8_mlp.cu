// Fused w8a8 ViT MLP for the V-JEPA2 backbone, sm_90a.
//
// Replaces: algonauts2025_tpu/ops/quant.py::_fused_mlp_kernel (the Pallas
// TPU kernel launched by int8_mlp_fused): quantize x by sx, fc1 as an int8
// GEMM, dequantize + b1, the Abramowitz-Stegun 7.1.26 erf-gelu
// (_gelu_erf_approx), requantize by h_scale, fc2 as an int8 GEMM, dequantize
// + b2, in the output dtype.
//
// Why the TPU design does not carry over: the TPU kept both int8 weight
// matrices (8.65 MB each at ViT-G) in VMEM next to a (256, 1408) int32
// accumulator that lived across the F chunks.  On an H100 a 64-row slice of
// that accumulator alone is 360 KB, above the 227 KB of shared memory.  So
// the MLP is two launches of the GEMM core in int8_gemm.cuh:
//   1. fc1 with an epilogue that dequantizes, adds b1, applies the gelu and
//      requantizes by h_scale, writing int8 (M, F) to a scratch buffer the
//      wrapper allocates (201 MB at M = 32768, F = 6144);
//   2. fc2 over that int8 scratch, dequantized by h_scale * w2_scale + b2.
// The int32 sums and the fp32 hidden activations never reach device memory;
// the int8 hidden state does, once written and once read (0.4 GB, ~0.12 ms
// at 3.35 TB/s, against ~0.57 ms of int8 tensor-core work at the bound).
// The gelu uses expf (not __expf) and _rn intrinsics in the order of the
// plain version; the remaining differences from PyTorch's exp can flip rare
// int8 roundings of the hidden state.
//
// What bounds it on an H100: 2 * M * (K*F + F*K) = 1.13 TOP at ViT-G with a
// window batch of 4, i.e. operations (0.57 ms at 1979 TOP/s).  This first
// version runs on the CUDA cores with __dp4a.

#include <math.h>

#include "int8_gemm.cuh"

namespace {

// _gelu_erf_approx of ops/quant.py, operation by operation
__device__ __forceinline__ float gelu_as(float x) {
  const float z = __fmul_rn(x, 0.7071067811865476f);
  const float a = fabsf(z);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(0.3275911f, a)));
  float p = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  p = __fadd_rn(1.421413741f, __fmul_rn(t, p));
  p = __fadd_rn(-0.284496736f, __fmul_rn(t, p));
  p = __fadd_rn(0.254829592f, __fmul_rn(t, p));
  p = __fmul_rn(t, p);
  const float erf_abs = __fsub_rn(1.f, __fmul_rn(p, expf(__fmul_rn(-a, a))));
  const float sign = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
  const float erf = __fmul_rn(sign, erf_abs);
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, erf));
}

// fc1 epilogue: dequant by scales[0] (sx), + b1, gelu, requant by scales[1] (sh)
struct StoreGeluQuant {
  __device__ __forceinline__ static void store(const i8gemm::Args& g, int m, int n, int acc) {
    const float h = gelu_as(i8gemm::dequant(g, acc, g.scales[0], n));
    static_cast<int8_t*>(g.out)[(long long)m * g.N + n] =
        static_cast<int8_t>(i8gemm::quantize(h, g.scales[1]));
  }
};

template <typename TA>
int fc1(const i8gemm::Args& g, cudaStream_t s) {
  return i8gemm::launch<TA, StoreGeluQuant>(g, s);
}

}  // namespace

extern "C" {

// out (M, K) = fc2(requant(gelu(fc1(quant(x, sx)))), sh).  scales: device
// pointer to {sx, sh} (validated / NaN-poisoned together by the caller).
// h: int8 (M, F) scratch.  x_dtype / out_dtype: 0 = float32, 1 = bfloat16.
// Returns the first non-zero cudaGetLastError() of the two launches.
int int8_mlp_forward(const void* x, int x_dtype, const int8_t* w1_q, const float* w1_scale,
                     const float* b1, const int8_t* w2_q, const float* w2_scale,
                     const float* b2, const float* scales, int8_t* h, void* out,
                     int out_dtype, int M, int K, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i8gemm::Args g1{x, w1_q, w1_scale, b1, scales, h, M, F, K};
  int err;
  if (x_dtype == 0) {
    err = fc1<float>(g1, s);
  } else if (x_dtype == 1) {
    err = fc1<__nv_bfloat16>(g1, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  const i8gemm::Args g2{h, w2_q, w2_scale, b2, scales, out, M, K, F};
  if (out_dtype == 0) return i8gemm::launch<int8_t, i8gemm::StoreDequant<float, 1>>(g2, s);
  if (out_dtype == 1) return i8gemm::launch<int8_t, i8gemm::StoreDequant<__nv_bfloat16, 1>>(g2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
