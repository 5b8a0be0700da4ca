// Fused w8a8 dense for the V-JEPA2 backbone's query/key/value/proj, sm_90a.
//
// Replaces: algonauts2025_tpu/ops/quant.py::_fused_w8a8_kernel (the Pallas
// TPU kernel launched by int8_matmul_fused).  It quantizes the activation
// x with a calibrated static scale sx (true division, round half to even,
// clamp +-127), multiplies int8 x int8 into an int32 accumulator, and
// writes acc * (sx * w_scale[n]) + bias[n] in the output dtype, one fused
// multiply-add with _rn intrinsics.  It equals its plain PyTorch version
// bit for bit.
//
// What bounds it on an H100: at ViT-G with a window batch of 4 one call is
// (32768 x 1408) @ (1408 x 1408): 130 GOP of int8 work against ~190 MB of
// bf16 in, int8 weights and bf16 out, so the bound is operations (~0.066 ms
// at the 1979 TOP/s int8 tensor-core peak), reached only through wgmma.
//
// Why the TPU design does not carry over: the TPU kernel quantizes each
// (bm, bk) block of x in registers, once only because its block spans the
// whole N (1408).  Here a tile's accumulator holds 128 of the 1408 columns,
// so quantizing inside the GEMM would redo each element 11 times.  The call
// is two launches on the persistent, warp-specialised tensor-core core of
// int8_wgmma.cuh instead:
//   1. quantize x by sx into an int8 (M, K) scratch (92 MB read and 46 MB
//      written at ViT-G, ~0.05 ms), which TMA then feeds to the GEMM at
//      half the bytes of bf16 rows;
//   2. the wgmma s8.s8 -> s32 GEMM over the scratch and the K-major weight
//      (N, K) (wgmma reads an 8-bit B operand only K-major) on the PingPong
//      schedule, 128 x 128 tiles of 11 stages each at K = 1408, one
//      consumer warpgroup's epilogue (StoreDequant reading sx, scales[0];
//      TMA stores) under the other's products.  Its 128 x 256 tiles on the
//      Cooperative schedule re-read a quarter fewer bytes from L2 but wait
//      for their epilogues and compute 1536 columns for 1408: slower (PERF.md).
// The two launches move ~0.28 GB at ViT-G (0.083 ms at 3.35 TB/s), just
// above the operations' bound.  K and N must be multiples of 128.
//
// The second entry, w8a8_rope_forward, is the same dense for the V-JEPA2
// attention's query and key: its epilogue (StoreDequantRope) rounds each
// dequantized pair to bf16 and applies the fp32 3D rotary to it in
// registers before the TMA store, bit for bit the bf16 dense followed by
// models/backbones/vjepa2.py _apply_rope (separate fp32 multiplies and an
// add, _rn, rounded to bf16).  The operations do not change and the tables
// add 4 MB (2 x 2 MB fp32 at ViT-G: 8192 tokens x 64 lanes) to the bytes
// from device memory, so the bound stays ~0.066 ms; but every tile reads its
// rows of the tables again through L2, 16 bytes an output pair (0.36 GB a
// call), which doubles the GEMM's time (~0.10 -> ~0.19-0.21 ms on an H100).
// Done outside, the rotary is seven elementwise passes over each (32768 x
// 1408) output in fp32, ~2.6 GB and ~1.2 ms a call.

#include "int8_wgmma.cuh"

namespace {

// xq = quantize(x, *sx) in x_dtype's reading (0 = float32, 1 = bfloat16).
int quantize_x(const void* x, int x_dtype, int8_t* xq, const float* sx, long long n, cudaStream_t s) {
  if (x_dtype == 0) return i8wg::quantize_rows<float>(x, xq, sx, n, s);
  if (x_dtype == 1) return i8wg::quantize_rows<__nv_bfloat16>(x, xq, sx, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out (M, N) = dequant(quant(x, sx) @ w_t^T) + bias.  w_t (N, K): the int8
// weight K-major.  sx: device pointer to one float (already validated /
// NaN-poisoned by the caller).  xq: int8 (M, K) scratch.  bias may be null.
// x_dtype / out_dtype: 0 = float32, 1 = bfloat16.  K and N multiples of
// 128.  Returns the first non-zero cudaGetLastError() of the two launches.
int w8a8_forward(const void* x, int x_dtype, const int8_t* w_t, const float* w_scale,
                 const float* bias, const float* sx, int8_t* xq, void* out, int out_dtype, int M,
                 int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype != 0 && out_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int err = quantize_x(x, x_dtype, xq, sx, (long long)M * K, s);
  if (err != 0) return err;
  // dequant by scales[0] (sx), + bias, in the output dtype
  if (out_dtype == 0)
    return i8wg::gemm<i8wg::StoreDequant<float, 0>, i8wg::PingPong>(xq, w_t, out, w_scale, bias, sx, M, N,
                                                                         K, s);
  return i8wg::gemm<i8wg::StoreDequant<__nv_bfloat16, 0>, i8wg::PingPong>(xq, w_t, out, w_scale, bias,
                                                                                 sx, M, N, K, s);
}

// w8a8_forward's dense with bf16 out (out_dtype must be 1), rotated in the
// epilogue: out[m, n .. n + 1] by the fp32 tables cos, sin (tokens,
// head_dim), row m % tokens, lanes n % head_dim ..  tokens divides M;
// head_dim is even and divides 128.  Returns the first non-zero
// cudaGetLastError() of the two launches.
int w8a8_rope_forward(const void* x, int x_dtype, const int8_t* w_t, const float* w_scale, const float* bias,
                      const float* sx, int8_t* xq, void* out, int out_dtype, int M, int N, int K,
                      const float* cos, const float* sin, int tokens, int head_dim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype != 1 || tokens < 1 || M % tokens || head_dim < 2 || head_dim > 128 || 128 % head_dim)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = quantize_x(x, x_dtype, xq, sx, (long long)M * K, s);
  if (err != 0) return err;
  using Epi = i8wg::StoreDequantRope<i8wg::StoreDequant<__nv_bfloat16, 0>>;
  return i8wg::gemm<Epi, i8wg::PingPong>(xq, w_t, out, w_scale, bias, Epi::Args{sx, cos, sin, tokens, head_dim}, M,
                                         N, K, s);
}

}  // extern "C"
