// Fused non-causal attention for the FmriEncoder trunk, sm_90a.
//
// Replaces: algonauts2025_tpu/ops/attention.py::_attn_kernel (the Pallas TPU
// kernel launched by _fused_attention_tpu), which computes
// softmax(q k^T * dh^-1/2) v per (batch, head) over all T keys with fp32
// scores and never writes the (T, T) score block to device memory.
//
// What bounds it on an H100: at the flagship shape (B=16, H=8, T=298,
// dh=384, fp32) one launch does 4*B*H*T^2*dh = 17.5 GFLOP against 234 MB of
// q, k, v and o, about 75 FLOP per byte.  Without tensor cores (fp32 is the
// contract) that is above the fp32 CUDA-core ridge of ~20 FLOP/B, so the
// bound is operations: ~0.26 ms at 67 TFLOP/s.  In bf16 the same work is
// byte-bound (117 MB).
//
// Design.  One block of 256 threads per (b*h, 64-row query tile).  The TPU
// kept the whole padded (T, T) score row in VMEM; 227 KB of shared memory
// cannot hold K for one head (298 x 384 x 4 B = 458 KB), and the port must
// take any T, so the kernel streams 64-key tiles of K and V through shared
// memory with an online (running max) softmax.  The 64 x dh fp32 output
// accumulator lives in shared memory (96 KB at dh=384) so that dh=384, above
// the 256 that stock flash kernels take, needs no special case: the score
// product walks dh in 32-wide chunks and the P.V product walks the output in
// 64-wide column chunks.  Each thread owns a 4x4 register tile of every
// 64x64 product.  Scores never leave the chip.  All arithmetic is fp32 on
// CUDA cores (no wgmma, no TMA); the output is written in the input dtype.
// The ragged edges are masked in the kernel (zero-filled loads, -inf scores
// for keys >= T, no stores for rows >= T), so no padded copies are needed.
//
// Layout.  q, k, v and o are (B, H, T, dh) with unit stride on dh and any
// strides on B, H and T (passed in elements), so the trunk hands over the
// head-split views of its fused qkv projection without .contiguous() copies
// and receives the output already in (B, T, H, dh) order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 64;    // query rows per block
constexpr int kBN = 64;    // keys per streamed tile
constexpr int kBD = 32;    // head-dim chunk of the score product
constexpr int kDC = 64;    // output-column chunk of the P.V product
constexpr int kThreads = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq[3], sk[3], sv[3], so[3];  // strides of b, h, t in elements
  int H, T, D;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// shared memory in floats: o_acc (kBM*D), s_tile (kBM*(kBN+1)),
// q chunk (kBM*(kBD+1)), k chunk (kBN*(kBD+1)), row max / sum / rescale (3*kBM).
// The V chunk (kBN*kDC) reuses the q and k chunk space.
__host__ __device__ constexpr long long smem_floats(int D) {
  return (long long)kBM * D + kBM * (kBN + 1) + (kBM + kBN) * (kBD + 1) + 3 * kBM;
}
static_assert((kBM + kBN) * (kBD + 1) >= kBN * kDC, "V chunk must fit the q/k chunk space");

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int Tn = p.T;
  float* o_acc = smem;
  float* s_tile = o_acc + kBM * D;
  float* q_chunk = s_tile + kBM * (kBN + 1);
  float* k_chunk = q_chunk + kBM * (kBD + 1);
  float* row_max = k_chunk + kBN * (kBD + 1);
  float* row_sum = row_max + kBM;
  float* row_alpha = row_sum + kBM;
  float* v_chunk = q_chunk;

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * kBM;
  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[1];
  T* og = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns columns tx + 16*j
  const int ty = tid / 16;  // owns rows ty + 16*i
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < kBM * D; i += kThreads) o_acc[i] = 0.f;
  if (tid < kBM) {
    row_max[tid] = -INFINITY;
    row_sum[tid] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < Tn; k0 += kBN) {
    // ---- scores: S = q k^T over dh in kBD-wide chunks ----
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kBD) {
      for (int i = tid; i < kBM * kBD; i += kThreads) {
        const int r = i / kBD, c = i % kBD, d = d0 + c;
        const int tq = q0 + r, tk = k0 + r;
        q_chunk[r * (kBD + 1) + c] = (tq < Tn && d < D) ? to_float(qg[tq * p.sq[2] + d]) : 0.f;
        k_chunk[r * (kBD + 1) + c] = (tk < Tn && d < D) ? to_float(kg[tk * p.sk[2] + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kBD; ++c) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = q_chunk[(ty + 16 * i) * (kBD + 1) + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = k_chunk[(tx + 16 * j) * (kBD + 1) + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bk[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        s_tile[(ty + 16 * i) * (kBN + 1) + col] =
            (k0 + col < Tn) ? acc[i][j] * p.scale : -INFINITY;
      }
    __syncthreads();

    // ---- online softmax: each warp updates kBM/8 rows ----
    for (int rr = 0; rr < kBM / 8; ++rr) {
      const int r = warp * (kBM / 8) + rr;
      float* srow = s_tile + r * (kBN + 1);
      const float s0 = srow[lane];
      const float s1 = srow[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_max[r];
      const float m_new = fmaxf(m_old, mx);  // finite: key k0 < T is always valid
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      srow[lane] = p0;
      srow[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        row_alpha[r] = alpha;
        row_sum[r] = row_sum[r] * alpha + sum;
        row_max[r] = m_new;
      }
    }
    __syncthreads();

    // ---- o_acc = o_acc * alpha + P v over kDC-wide output chunks ----
    for (int c0 = 0; c0 < D; c0 += kDC) {
      for (int i = tid; i < kBN * kDC; i += kThreads) {
        const int r = i / kDC, c = i % kDC, d = c0 + c;
        const int tk = k0 + r;
        v_chunk[r * kDC + c] = (tk < Tn && d < D) ? to_float(vg[tk * p.sv[2] + d]) : 0.f;
      }
      __syncthreads();
      float o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tx + 16 * j;
          o[i][j] = (c < D) ? o_acc[r * D + c] * row_alpha[r] : 0.f;
        }
      }
#pragma unroll 8
      for (int kk = 0; kk < kBN; ++kk) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_tile[(ty + 16 * i) * (kBN + 1) + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = v_chunk[kk * kDC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = fmaf(a[i], bv[j], o[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tx + 16 * j;
          if (c < D) o_acc[r * D + c] = o[i][j];
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < kBM * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int t = q0 + r;
    if (t < Tn) og[t * p.so[2] + c] = from_float<T>(o_acc[i] / row_sum[r]);
  }
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.D);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.T + kBM - 1) / kBM, B * p.H);
  attn_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for head dim D.
long long attn_smem_bytes(int D) { return (long long)sizeof(float) * smem_floats(D); }

// o = softmax(q k^T * scale) v.  strides: 12 int64, the (b, h, t) strides of
// q, k, v and o in elements.  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 on success).
int attn_forward(const void* q, const void* k, const void* v, void* o, const long long* strides,
                 int B, int H, int T, int D, int dtype, float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
  }
  p.H = H;
  p.T = T;
  p.D = D;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
