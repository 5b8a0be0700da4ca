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
// the MLP is three launches, two of them on the persistent, warp-specialised
// tensor-core GEMM core of int8_wgmma.cuh (wgmma s8.s8 -> s32, TMA loads
// and stores, a ring of stages on mbarriers, setmaxnreg):
//   1. quantize x by sx into an int8 (M, K) scratch (0.14 GB of traffic at
//      ViT-G, ~0.05 ms): TMA then feeds fc1 from int8 rows, half the bytes
//      of bf16 ones, and the conversion leaves fc1's consumer warps;
//   2. fc1 on the PingPongPairs schedule, with an epilogue that dequantizes,
//      adds b1, applies the gelu and requantizes by h_scale, writing int8
//      (M, F) to a second scratch (201 MB at M = 32768, F = 6144): two
//      teams of two consumer warpgroups take 128 x 128 tiles in turns, so
//      that one team's gelu runs while the other's products do;
//   3. fc2 over that int8 scratch on the Cooperative schedule (128 x 256
//      tiles: its K = 6144 makes it the GEMM that re-reads the most from
//      L2), dequantized by h_scale * w2_scale + b2.
// The weights come K-major, as (F, K) and (K, F) int8 copies of the JAX
// layout's (K, F) and (F, K): wgmma reads an 8-bit B operand only K-major.
// The int32 sums and the fp32 hidden activations never reach device memory;
// the int8 hidden state does, once written and once read (0.4 GB, ~0.12 ms
// at 3.35 TB/s).  The gelu uses expf (not __expf) and _rn intrinsics in the
// order of the plain version (its reciprocal by __frcp_rn, which rounds
// 1 / y as __fdiv_rn(1, y) does); the remaining differences from PyTorch's
// exp can flip rare int8 roundings of the hidden state.  Both scales arrive
// NaN-poisoned together from the wrapper.
//
// What bounds it on an H100: 2 * M * (K*F + F*K) = 1.13 TOP at ViT-G with a
// window batch of 4, i.e. operations (0.57 ms at 1979 TOP/s).  After them
// comes fc1's epilogue: a reciprocal, an expf and a true division among ~60
// instructions for each of the 201 M hidden values, ~0.4 ms of issue on the
// CUDA cores at one instruction a cycle a scheduler; the PingPongPairs
// schedule overlaps it with the products.

#include <math.h>

#include "int8_wgmma.cuh"

namespace {

// _gelu_erf_approx of ops/quant.py, operation by operation (its reciprocal
// by __frcp_rn, which rounds 1 / y as __fdiv_rn(1, y) does)
__device__ __forceinline__ float gelu_as(float x) {
  const float z = __fmul_rn(x, 0.7071067811865476f);
  const float a = fabsf(z);
  const float t = __frcp_rn(__fadd_rn(1.f, __fmul_rn(0.3275911f, a)));
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

// fc1 epilogue: dequant by scales[0] (sx), + b1, gelu, requant by scales[1]
// (sh), two int8 columns at a time
struct StoreGeluQuant {
  using Out = int8_t;
  using Pair = uint16_t;
  using Args = const float*;  // the device scalars
  float sx, sh;
  __device__ explicit StoreGeluQuant(const float* scales) : sx(scales[0]), sh(scales[1]) {}
  __device__ __forceinline__ uint16_t pair(int acc0, int acc1, float2 ws, float2 bias, int, int) const {
    const int q0 = i8wg::quantize(gelu_as(i8wg::dequant(acc0, sx, ws.x, bias.x)), sh);
    const int q1 = i8wg::quantize(gelu_as(i8wg::dequant(acc1, sx, ws.y, bias.y)), sh);
    return static_cast<uint16_t>((q0 & 0xff) | (q1 & 0xff) << 8);
  }
};

}  // namespace

extern "C" {

// out (M, K) = fc2(requant(gelu(fc1(quant(x, sx)))), sh).  w1_t (F, K) and
// w2_t (K, F): the int8 weights K-major.  scales: device pointer to {sx,
// sh} (validated / NaN-poisoned together by the caller).  xq: int8 (M, K)
// and h: int8 (M, F) scratch.  x_dtype / out_dtype: 0 = float32, 1 =
// bfloat16.  K and F multiples of 128.  Returns the first non-zero
// cudaGetLastError() of the three launches.
int int8_mlp_forward(const void* x, int x_dtype, const int8_t* w1_t, const float* w1_scale,
                     const float* b1, const int8_t* w2_t, const float* w2_scale,
                     const float* b2, const float* scales, int8_t* xq, int8_t* h, void* out,
                     int out_dtype, int M, int K, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)M * K;
  int err;
  if (x_dtype == 0)
    err = i8wg::quantize_rows<float>(x, xq, scales, n, s);
  else if (x_dtype == 1)
    err = i8wg::quantize_rows<__nv_bfloat16>(x, xq, scales, n, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  err = i8wg::gemm<StoreGeluQuant, i8wg::PingPongPairs>(xq, w1_t, h, w1_scale, b1, scales, M, F, K, s);
  if (err != 0) return err;
  // fc2: dequant by scales[1] (sh), + b2, in the output dtype
  if (out_dtype == 0)
    return i8wg::gemm<i8wg::StoreDequant<float, 1>, i8wg::Cooperative>(h, w2_t, out, w2_scale, b2, scales, M,
                                                                         K, F, s);
  if (out_dtype == 1)
    return i8wg::gemm<i8wg::StoreDequant<__nv_bfloat16, 1>, i8wg::Cooperative>(h, w2_t, out, w2_scale, b2,
                                                                                 scales, M, K, F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
