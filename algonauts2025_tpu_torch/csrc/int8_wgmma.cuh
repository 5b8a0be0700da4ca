// int8 GEMM core on Hopper's tensor cores, sm_90a: out = Epi(A B) with A
// (M, K) int8 and B given K-major as Bt (N, K) int8, both row-major, and an
// int32 accumulator that never leaves registers.  Included by both int8
// kernels: w8a8.cu (kernel row 6, one GEMM) and int8_mlp.cu (row 7, two),
// which share the quantize pass and the StoreDequant epilogue below.
// flash_attention.cu does not include it: its helpers below (mbarriers,
// TMA, wgmma descriptors and fences, the cuTensorMapEncodeTiled lookup) are
// copies of that file's.
//
// What bounds an int8 GEMM on an H100: at the ViT-G MLP's shapes (M =
// 32768, K = 1408, N = 6144 and back) 2 M K N = 0.567 TOP a GEMM against
// ~0.1 GB, so operations: 0.29 ms at 1979 TOP/s, reached only by
// wgmma.mma_async ... .s32.s8.s8 (SASS IGMMA).
//
// Design.  One block per 128 x 128 output tile: one producer warp whose
// elected lane streams 128-deep K stages of A (128 x 128 B) and Bt (128 x
// 128 B) with TMA (2-d tensor maps, 128-byte swizzle: one swizzle row is
// one stage's 128 int8 values, so a k32 step moves the descriptor 32 bytes
// along it) into a ring of kStages stages on mbarriers (full: bytes
// arrived; empty: all 256 consumer threads done), and two consumer
// warpgroups, each issuing wgmma m64n128k32 from shared memory for its 64
// rows and keeping one stage's products in flight while it waits for the
// next.  wgmma reads an 8-bit B operand only K-major (the transpose bits of
// its descriptor exist for 16-bit types only), hence Bt.  Ragged M is zero
// filled by TMA and masked at the stores; K and N must be multiples of 128.
// Three stages (96 KB) and at most 112 registers a thread let two blocks
// share an SM, so one block's epilogue overlaps the other's products.
// Epi sees each thread's accumulator fragment, whose (row, column) layout
// is the fp32 one of flash_attention.cu: rows r0 = 16 warp + lane / 4 and
// r0 + 8 of the warpgroup's 64, column pairs 8 j + 2 (lane % 4) + {0, 1}.
//
// Quantization is the JAX package's (ops/quant.py int8_matmul): true
// division (__fdiv_rn), round half to even (rintf),
// clamp to +-127, and only then the conversion to an integer; fmaxf/fminf
// turn a NaN quotient (a NaN-poisoned scale) into a bound, so the
// conversion is always defined.  The dequantization is one fused
// multiply-add, fma(acc, scale * w_scale[n], bias[n]), with _rn intrinsics.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace i8wg {

constexpr int kBM = 128;                   // rows of a block tile: two warpgroups of 64
constexpr int kBN = 128;                   // columns of a block tile
constexpr int kBK = 128;                   // int8 depth of a stage: one 128-byte swizzle row
constexpr int kStages = 3;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kTileBytes = kBM * kBK;      // one A or Bt stage (kBN == kBM)
constexpr int kStageBytes = 2 * kTileBytes;
// the ring, then full[kStages] and empty[kStages], + the alignment slack
constexpr int kSmemBytes = kStages * kStageBytes + 16 * kStages + 1024;
static_assert(kBN == kBM, "A and Bt stages share one size");

struct Params {
  CUtensorMap a;         // A (M, K) int8 row-major
  CUtensorMap b;         // Bt (N, K) int8 row-major
  void* out;             // (M, N) row-major
  const float* w_scale;  // (N,)
  const float* bias;     // (N,) or null
  int M, N, K;
};

__device__ __forceinline__ int quantize(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<int>(q);
}

// fma(acc, scale * w_scale, bias) in fp32
__device__ __forceinline__ float dequant(int acc, float scale, float w_scale, float bias) {
  return __fmaf_rn(__int2float_rn(acc), __fmul_rn(scale, w_scale), bias);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Block until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA tile of a 2-d tensor map into shared memory, counted on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (>> 4), layout type 1 (B128).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin an accumulator's registers here, so that no read of them moves above
// the wgmma wait that completes them.
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A B for one k32 step, A (64 x 32) and B (32 x 128) in shared memory,
// both K-major (128-byte swizzle).
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "n"(1));
}

// Epi: constructed in each consumer thread from the device scalars, then
// store(out, N, m, n, acc0, acc1, w_scale[n .. n + 1], bias[n .. n + 1])
// writes out[m, n] and out[m, n + 1].
template <typename Epi>
__global__ void __launch_bounds__(kThreads, 2) gemm_kernel(const __grid_constant__ Params g, const float* scales) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t a_s = base, b_s = base + kStages * kTileBytes;
  const uint32_t full_bar = base + kStages * kStageBytes, empty_bar = full_bar + 8 * kStages;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int n_k = g.K / kBK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer: the ring of A and Bt stages ----
    if (lane == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty_bar + 8 * s, (kt / kStages - 1) & 1);
        mbar_expect_tx(full_bar + 8 * s, kStageBytes);
        tma_load(a_s + s * kTileBytes, &g.a, full_bar + 8 * s, kt * kBK, m0);
        tma_load(b_s + s * kTileBytes, &g.b, full_bar + 8 * s, kt * kBK, n0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
  const int wg = warp / 4;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
#pragma unroll 1
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full_bar + 8 * s, (kt / kStages) & 1);
    const uint32_t a_t = a_s + s * kTileBytes + 64 * wg * kBK, b_t = b_s + s * kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_s8_n128(acc, smem_desc(a_t + 32 * kk, 16, 1024), smem_desc(b_t + 32 * kk, 16, 1024));
    wgmma_commit();
    // the previous stage's products are done: hand its slot back
    wgmma_wait<1>();
    if (kt > 0) mbar_arrive(empty_bar + 8 * ((kt - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // ---- epilogue on the fragment: element i is row r0 + 8 ((i >> 1) & 1),
  // column n0 + 8 (i >> 2) + c2 + (i & 1) ----
  const Epi epi(scales);
  const int r0 = m0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int c2 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int n = n0 + 8 * j + c2;
    if (n >= g.N) continue;
    const float2 ws = make_float2(__ldg(g.w_scale + n), __ldg(g.w_scale + n + 1));
    const float2 bias = g.bias ? make_float2(__ldg(g.bias + n), __ldg(g.bias + n + 1)) : make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = r0 + 8 * r;
      if (m < g.M) epi.store(g.out, g.N, m, n, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1], ws, bias);
    }
  }
}

// The dequantizing epilogue: fma(acc, scales[kScale] * w_scale[n], bias[n])
// written in TO (float or __nv_bfloat16, two adjacent columns at a time).
// kScale picks the device scalar of the GEMM's int8 A: sx for w8a8.cu (0),
// the hidden state's sh for int8_mlp.cu's fc2 (1).
template <typename TO, int kScale>
struct StoreDequant {
  float s;
  __device__ explicit StoreDequant(const float* scales) : s(scales[kScale]) {}
  __device__ __forceinline__ void store(void* out, int N, int m, int n, int acc0, int acc1, float2 ws,
                                        float2 bias) const {
    const float y0 = dequant(acc0, s, ws.x, bias.x);
    const float y1 = dequant(acc1, s, ws.y, bias.y);
    TO* dst = static_cast<TO*>(out) + (long long)m * N + n;
    if constexpr (sizeof(TO) == 4)
      *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
    else
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Quantize n float values of x to int8 by the device scalar *scale, kW
// at a time (kW = 8: 16- or 32-byte loads and an 8-byte store a thread).
template <typename TA, int kW>
__global__ void quantize_kernel(const TA* x, int8_t* xq, const float* scale, long long n) {
  const float s = *scale;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n / kW; i += step) {
    float v[kW];
    if constexpr (kW == 1) {
      v[0] = to_f32(x[i]);
    } else if constexpr (sizeof(TA) == 4) {
      const float4 a = reinterpret_cast<const float4*>(x)[2 * i], b = reinterpret_cast<const float4*>(x)[2 * i + 1];
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
      const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        v[2 * e] = f.x, v[2 * e + 1] = f.y;
      }
    }
    uint32_t packed[kW == 1 ? 1 : 2] = {};
#pragma unroll
    for (int e = 0; e < kW; ++e) packed[e / 4] |= (static_cast<uint32_t>(quantize(v[e], s)) & 0xffu) << (8 * (e % 4));
    if constexpr (kW == 1)
      xq[i] = static_cast<int8_t>(packed[0]);
    else
      reinterpret_cast<uint2*>(xq)[i] = make_uint2(packed[0], packed[1]);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    // the 12.0 ABI of the symbol (CUDA 12.5+ runtime)
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// An int8 tensor map over a row-major (rows, K) matrix, read in boxes of
// kBK columns x 128 rows with the 128-byte swizzle; rows past ``rows`` are
// zero.
inline int make_map(CUtensorMap* map, const void* ptr, int rows, int K) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {kBK, 128};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// out (M, N) = Epi(a (M, K) . bt (N, K)^T); K and N multiples of 128.
// Returns cudaGetLastError() after the launch (0 on success).
template <typename Epi>
int gemm(const int8_t* a, const int8_t* bt, void* out, const float* w_scale, const float* bias,
         const float* scales, int M, int N, int K, cudaStream_t stream) {
  if (M < 1 || K < kBK || N < kBN || K % kBK || N % kBN || (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  Params g;
  int err = make_map(&g.a, a, M, K);
  if (err == 0) err = make_map(&g.b, bt, N, K);
  if (err != 0) return err;
  g.out = out;
  g.w_scale = w_scale;
  g.bias = bias;
  g.M = M;
  g.N = N;
  g.K = K;
  const cudaError_t e =
      cudaFuncSetAttribute(gemm_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<Epi><<<grid, kThreads, kSmemBytes, stream>>>(g, scales);
  return (int)cudaGetLastError();
}

// xq (M, K) int8 = quantize(x, *scale) for float32 or bfloat16 x: eight
// values a thread where x is 16-byte aligned and n a multiple of 8 (a
// layout decided here, before the launch), else one.
template <typename TA>
int quantize_rows(const void* x, int8_t* xq, const float* scale, long long n, cudaStream_t stream) {
  const bool wide = n % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(xq) % 8 == 0;
  const long long items = wide ? n / 8 : n;
  const int blocks = (int)((items + 255) / 256 < 132 * 8 ? (items + 255) / 256 : 132 * 8);
  if (wide)
    quantize_kernel<TA, 8><<<blocks, 256, 0, stream>>>(static_cast<const TA*>(x), xq, scale, n);
  else
    quantize_kernel<TA, 1><<<blocks, 256, 0, stream>>>(static_cast<const TA*>(x), xq, scale, n);
  return (int)cudaGetLastError();
}

}  // namespace i8wg
