// __dp4a core of the w8a8 kernel (w8a8.cu, kernel row 6) on the CUDA cores,
// sm_90a.  The fused MLP (int8_mlp.cu) runs the tensor-core core of
// int8_wgmma.cuh instead.
//
// out[m, n] = epilogue(sum_k A[m, k] * W[k, n]) with A quantized to int8 on
// its way into shared memory, W int8 (K, N) row-major,
// and an int32 accumulator that never leaves registers.  int32 sums are
// exact in any order, so the result does not depend on the tiling.
//
// Quantization is the JAX package's (ops/quant.py int8_matmul): true
// division (__fdiv_rn, never a reciprocal multiply), round half to even
// (rintf), clamp to +-127, and only then the conversion to an integer.
// fmaxf/fminf turn a NaN quotient (a NaN-poisoned scale) into a bound, so
// the conversion is always defined; the poisoned scale reaches the output
// through the epilogue's multiply instead.  The epilogue is one fused
// multiply-add, fma(acc, scale * w_scale[n], bias[n]), written with the _rn
// intrinsics so that nvcc's contraction cannot change it: XLA fuses the
// JAX kernels' acc * scale + bias the same way, and the plain PyTorch
// version rounds it once too, so the kernel equals both bit for bit.
//
// Design: one 256-thread block per 128 x 128 output tile; the K loop walks
// 32-deep slices.  A and W slices are packed four k-values to a 32-bit
// word in shared memory ([k/4][row] for A, [k/4][col] for W) and each
// thread accumulates an 8 x 8 register tile with __dp4a (four int8 MACs per
// instruction on the CUDA cores).  Rows and columns are strided by 16
// between a thread's tiles so that a warp's shared-memory reads are
// conflict free.  Ragged M, N and K are masked with zero-filled loads and
// skipped stores, so any shape works.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace i8gemm {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;           // int8 depth of a K slice
constexpr int kKP = kBK / 4;      // packed words per row of a slice
constexpr int kPad = 4;           // shared-memory row padding, in words
constexpr int kThreads = 256;     // 16 x 16 threads, 8 x 8 outputs each

struct Args {
  const void* a;         // (M, K) float32 or bfloat16, row-major
  const int8_t* w;       // (K, N) int8, row-major
  const float* w_scale;  // (N,)
  const float* bias;     // (N,) or null
  const float* scales;   // device scalar: the scale of A
  void* out;             // (M, N) row-major
  int M, N, K;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ int quantize(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<int>(q);
}

template <typename TO>
__device__ __forceinline__ TO from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A element (m, k) quantized by scales[0], as int8 in an int
template <typename TA>
__device__ __forceinline__ int load_a(const Args& g, int m, int k, float sa) {
  return quantize(to_f32(static_cast<const TA*>(g.a)[(long long)m * g.K + k]), sa);
}

__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (b0 & 0xff) | ((b1 & 0xff) << 8) | ((b2 & 0xff) << 16) | ((b3 & 0xff) << 24);
}

// fma(acc, scale * w_scale[n], bias[n]) in fp32
__device__ __forceinline__ float dequant(const Args& g, int acc, float scale, int n) {
  return __fmaf_rn(__int2float_rn(acc), __fmul_rn(scale, g.w_scale[n]), g.bias ? g.bias[n] : 0.f);
}

// Epilogue: dequantize by scales[0] and store in TO.
template <typename TO>
struct StoreDequant {
  __device__ __forceinline__ static void store(const Args& g, int m, int n, int acc) {
    static_cast<TO*>(g.out)[(long long)m * g.N + n] = from_f32<TO>(dequant(g, acc, g.scales[0], n));
  }
};

template <typename TA, typename Epi>
__global__ void __launch_bounds__(kThreads) gemm_kernel(Args g) {
  __shared__ int as[kKP][kBM + kPad];
  __shared__ int ws[kKP][kBN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const float sa = g.scales[0];

  int acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < g.K; k0 += kBK) {
    // A slice: 128 rows x 8 words; 8 neighbouring threads read one row's 32 values
#pragma unroll
    for (int it = 0; it < kBM * kKP / kThreads; ++it) {
      const int p = tid + it * kThreads;
      const int r = p / kKP, kp = p % kKP;
      const int m = m0 + r;
      int b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + 4 * kp + e;
        b[e] = (m < g.M && k < g.K) ? load_a<TA>(g, m, k, sa) : 0;
      }
      as[kp][r] = pack4(b[0], b[1], b[2], b[3]);
    }
    // W slice: 8 words x 128 columns; neighbouring threads read neighbouring columns
#pragma unroll
    for (int it = 0; it < kBN * kKP / kThreads; ++it) {
      const int p = tid + it * kThreads;
      const int c = p % kBN, kp = p / kBN;
      const int n = n0 + c;
      int b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + 4 * kp + e;
        b[e] = (n < g.N && k < g.K) ? g.w[(long long)k * g.N + n] : 0;
      }
      ws[kp][c] = pack4(b[0], b[1], b[2], b[3]);
    }
    __syncthreads();
#pragma unroll
    for (int kp = 0; kp < kKP; ++kp) {
      int a[8], w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = as[kp][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = ws[kp][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < g.N) Epi::store(g, m, n, acc[i][j]);
    }
  }
}

template <typename TA, typename Epi>
int launch(const Args& g, cudaStream_t stream) {
  const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM);
  gemm_kernel<TA, Epi><<<grid, kThreads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace i8gemm
