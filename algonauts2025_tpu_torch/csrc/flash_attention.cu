// Flash attention for the V-JEPA2 and Llama backbones and the attention
// bench, sm_90a: one tile loop, two numerics, four C entry points.
//
// flash_forward (the video backbone's long non-causal attention).
// Replaces: algonauts2025_tpu/ops/flash_attention.py::_bounded_kernel (the
// Pallas TPU kernel launched by _bounded_flash), which computes exact
// softmax(q k^T / sqrt(d)) v over all T keys with the scale folded into q
// (rounded to q's dtype), p rounded to v's dtype before the P.V product and
// the row sum taken over that rounded p.  The TPU kernel shifts the scores
// by an a-priori per-row bound min(|q_i| max_j |k_j|, q_i . mean(k[:512]) +
// 55); when the scores of one row spread over more than ~143 nats that
// shift overflows exp and the whole output is NaN.  This kernel uses the
// running (online) maximum instead, which gives the same exact softmax and
// cannot overflow.
//
// What bounds it on an H100: at ViT-G (B=4 windows, H=22, T=8192, d=64,
// bf16) one call is 4*B*H*T^2*d = 1.51 TFLOP against 0.18 GB of q, k, v
// and o, so the bound is operations: 1.53 ms at the 989 TFLOP/s bf16
// tensor-core peak.  This first version does its arithmetic in fp32 on the
// CUDA cores (no mma/wgmma), far from that bound.
//
// flash_forward_masked (the Llama backbone's decoder attention).
// Replaces: algonauts2025_tpu/ops/flash_attention.py::_flash_kernel (launched
// by flash_attention with causal=True and/or right-padded key lengths):
// scores q.k in fp32 times the scale in fp32 (not folded into q), masked
// scores dropped (keep col <= row if causal, col < lengths[b] if lengths),
// running-max softmax, the row sum over fp32 p, P.V over p rounded to v's
// dtype, out = acc / max(l, 1e-30); a row whose length is 0 is zero.  Like
// the TPU kernel it skips key tiles past the diagonal, past lengths[b] and
// past T, so causal work is about half of the full product.  GQA: query
// head h reads kv head h / (H / kv_heads), the order jnp.repeat gives,
// without materialising the repeat.  At Llama-3.2-3B's (8, 24, 1024, 128)
// bf16 causal with 8 kv heads, one call is 51.5 GFLOP against 134 MB of q,
// k, v and o: the bound is operations, 0.052 ms at the bf16 tensor-core
// peak; this version runs fp32 FMAs on the CUDA cores.  The query tiles of
// a head are launched heaviest first (the last causal tile streams every
// key), so the longest blocks do not start last.
//
// flash_forward_fast (the attention bench's online-max baseline).
// Replaces: algonauts2025_tpu/ops/flash_attention.py::_fast_kernel (launched by
// _fast_flash, called only by scripts/bench_attn.py): flash_forward's
// numerics (scale folded into a rounded q, running max, the row sum over p
// rounded to v's dtype, which the TPU kernel takes through a ones-lane in
// v's padding), with an optional rounding of every score to bf16 before the
// running max and exp.  The same kernel as flash_forward under a third
// template flag; at the bench's (4, 22, 8192, 64) bf16 the bound is
// flash_forward's, 1.53 ms of operations.
//
// flash_forward_packed (the attention bench's head-pair packed variant).
// Replaces: algonauts2025_tpu/ops/flash_attention.py::_flash_kernel_packed
// (launched by _packed_call, called only by scripts/bench_attn.py), which
// packs two heads of d = 64 block-diagonally into the TPU's 128 lanes: a
// layout trick with no counterpart here, so each head runs on its own.
// Its numerics are _flash_kernel's with no mask (fp32 scale on the fp32
// scores, the row sum over fp32 p, p rounded to v's dtype for P.V): this
// is flash_forward_masked's loop with causal 0, no lengths and one query
// head per kv head.  Same bound as flash_forward_fast.
//
// Design.  One 256-thread block per (b*h, 64-query tile).  One head's K is
// 1 MB at T=8192, far above shared memory, so K and V stream through it in
// 64-key tiles with an online softmax; the scores never leave the chip.
// The 64 x d query tile is scaled, rounded and kept in shared memory for
// the whole key loop; each thread owns a 4 x 4 tile of every 64 x 64 score
// block and a 4 x (d/16) tile of the output accumulator in registers.
// Head dims up to 128 are taken.  Ragged T is masked in the kernel
// (zero-filled loads, -inf scores for keys >= T, no stores past T).
//
// Layout.  q, k, v and o are (B, H, T, d) with unit stride on d and any
// strides on B, H and T (in elements), so the backbone hands over the
// head-split views of its (B, T, H*d) projections without copies and gets
// the output back in (B, T, H, d) order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 64;  // query rows per block
constexpr int kBN = 64;  // keys per streamed tile
constexpr int kThreads = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq[3], sk[3], sv[3], so[3];  // strides of b, h, t in elements
  const int* lengths;                     // (B,) right-pad key lengths, or null
  int H, T, D;
  int rep;     // query heads per kv head
  int causal;  // keep keys col <= row only
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T and back (identity for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// shared memory in floats for head dim D and DC output columns per thread:
// q and k tiles (kBM/kBN x (D+1)), v tile (kBN x 16*DC), score tile
// (kBM x (kBN+1)), row max / sum / rescale (3*kBM)
__host__ __device__ constexpr long long smem_floats(int D, int DC) {
  return (long long)(kBM + kBN) * (D + 1) + kBN * 16 * DC + kBM * (kBN + 1) + 3 * kBM;
}

// kMasked selects the numerics and the masks: false is flash_forward's
// (scale folded into a rounded q, row sum over rounded p, every key), true
// is flash_forward_masked's (fp32 scale on the scores, row sum over fp32 p,
// causal / length masks with the empty key tiles skipped).  kBf16Scores
// (unmasked only) rounds each score to bf16 before the running max and exp.
template <typename T, int DC, bool kMasked, bool kBf16Scores>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int Tn = p.T;
  const int DV = 16 * DC;  // padded width of the v tile
  float* qs = smem;
  float* ks = qs + kBM * (D + 1);
  float* vs = ks + kBN * (D + 1);
  float* st = vs + kBN * DV;
  float* row_max = st + kBM * (kBN + 1);
  float* row_sum = row_max + kBM;
  float* row_alpha = row_sum + kBM;

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int hk = h / p.rep;
  const int q0 = (kMasked ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kBM;
  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + hk * p.sk[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + hk * p.sv[1];
  // keys col < valid are kept; tiles from kv_end on hold no kept key
  int valid = Tn, kv_end = Tn;
  if (kMasked) {
    if (p.lengths != nullptr) valid = max(0, min(p.lengths[b], Tn));
    kv_end = p.causal ? min(valid, q0 + kBM) : valid;
  }
  T* og = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns columns tx + 16*j
  const int ty = tid / 16;  // owns rows ty + 16*i
  const int warp = tid / 32;
  const int lane = tid % 32;

  // q tile; unmasked: scale folded in and rounded to q's dtype,
  // (q * d^-1/2).astype(q.dtype)
  for (int i = tid; i < kBM * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    const float x = t < Tn ? to_float(qg[t * p.sq[2] + d]) : 0.f;
    qs[r * (D + 1) + d] = kMasked ? x : round_to<T>(__fmul_rn(x, p.scale));
  }
  if (tid < kBM) {
    row_max[tid] = -INFINITY;
    row_sum[tid] = 0.f;
  }
  float o[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) o[i][j] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kBN) {
    // ---- stream the k and v tiles ----
    for (int i = tid; i < kBN * D; i += kThreads) {
      const int r = i / D, d = i % D, t = k0 + r;
      ks[r * (D + 1) + d] = t < Tn ? to_float(kg[t * p.sk[2] + d]) : 0.f;
    }
    for (int i = tid; i < kBN * DV; i += kThreads) {
      const int r = i / DV, d = i % DV, t = k0 + r;
      vs[i] = (t < Tn && d < D) ? to_float(vg[t * p.sv[2] + d]) : 0.f;
    }
    __syncthreads();

    // ---- scores s = q k^T (unmasked: the scale is already in q) ----
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bk[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty + 16 * i, col = tx + 16 * j;
        const bool keep = k0 + col < valid && !(kMasked && p.causal && k0 + col > q0 + row);
        float s = kMasked ? __fmul_rn(acc[i][j], p.scale) : acc[i][j];
        if (kBf16Scores) s = round_to<__nv_bfloat16>(s);
        st[row * (kBN + 1) + col] = keep ? s : -INFINITY;
      }
    __syncthreads();

    // ---- online softmax, p rounded to v's dtype for P.V; the row sum is
    // over that rounded p (unmasked) or over fp32 p (masked); each warp
    // owns kBM/8 rows.  m_new is finite: tile 0 keeps key 0 in every row
    // (causal: 0 <= row; lengths: the loop runs only when valid > 0) ----
    for (int rr = 0; rr < kBM / 8; ++rr) {
      const int r = warp * (kBM / 8) + rr;
      float* srow = st + r * (kBN + 1);
      const float s0 = srow[lane];
      const float s1 = srow[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_max[r];
      const float m_new = fmaxf(m_old, mx);
      const float e0 = expf(s0 - m_new);
      const float e1 = expf(s1 - m_new);
      const float p0 = round_to<T>(e0);
      const float p1 = round_to<T>(e1);
      srow[lane] = p0;
      srow[lane + 32] = p1;
      float sum = kMasked ? e0 + e1 : p0 + p1;
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

    // ---- o = o * alpha + p v ----
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = row_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DC; ++j) o[i][j] *= alpha;
    }
#pragma unroll 8
    for (int kk = 0; kk < kBN; ++kk) {
      float a[4], bv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = st[(ty + 16 * i) * (kBN + 1) + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) bv[j] = vs[kk * DV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) o[i][j] = fmaf(a[i], bv[j], o[i][j]);
    }
    __syncthreads();
  }
  __syncthreads();  // row_sum's initial zeros when no key tile ran (length 0)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int t = q0 + r;
    if (t >= Tn) continue;
    const float l = fmaxf(row_sum[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < D) og[t * p.so[2] + c] = from_float<T>(o[i][j] / l);
    }
  }
}

template <typename T, int DC, bool kMasked, bool kBf16Scores>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.D, DC);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DC, kMasked, kBf16Scores>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.T + kBM - 1) / kBM, B * p.H);
  flash_fwd_kernel<T, DC, kMasked, kBf16Scores><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool kMasked, bool kBf16Scores = false>
int launch_typed(const Params& p, int B, int dtype, cudaStream_t s) {
  if (p.D < 1 || p.D > 128) return (int)cudaErrorInvalidValue;
  const bool narrow = p.D <= 64;
  if (dtype == 0)
    return narrow ? launch<float, 4, kMasked, kBf16Scores>(p, B, s)
                  : launch<float, 8, kMasked, kBf16Scores>(p, B, s);
  if (dtype == 1)
    return narrow ? launch<__nv_bfloat16, 4, kMasked, kBf16Scores>(p, B, s)
                  : launch<__nv_bfloat16, 8, kMasked, kBf16Scores>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v, void* o, const long long* strides,
                   int H, int T, int D, float scale) {
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
  p.lengths = nullptr;
  p.H = H;
  p.T = T;
  p.D = D;
  p.rep = 1;
  p.causal = 0;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// Largest head dim the kernel takes.
int flash_max_head_dim() { return 128; }

// o = softmax(round(q * scale) k^T) v with p rounded to the input dtype.
// strides: 12 int64, the (b, h, t) strides of q, k, v and o in elements.
// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).
int flash_forward(const void* q, const void* k, const void* v, void* o, const long long* strides,
                  int B, int H, int T, int D, int dtype, float scale, void* stream) {
  const Params p = make_params(q, k, v, o, strides, H, T, D, scale);
  return launch_typed<false>(p, B, dtype, static_cast<cudaStream_t>(stream));
}

// flash_forward with, when score_bf16 is not 0, every score rounded to
// bf16 before the running max and exp (_fast_kernel's score_dtype).
int flash_forward_fast(const void* q, const void* k, const void* v, void* o, const long long* strides,
                       int B, int H, int T, int D, int dtype, int score_bf16, float scale, void* stream) {
  const Params p = make_params(q, k, v, o, strides, H, T, D, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return score_bf16 ? launch_typed<false, true>(p, B, dtype, s) : launch_typed<false>(p, B, dtype, s);
}

// o = softmax(q k^T * scale) v over every key, with _flash_kernel's
// numerics (_flash_kernel_packed's): flash_forward_masked with causal 0,
// no lengths and kv heads = H.  Returns cudaGetLastError() after the launch.
int flash_forward_packed(const void* q, const void* k, const void* v, void* o, const long long* strides,
                         int B, int H, int T, int D, int dtype, float scale, void* stream) {
  const Params p = make_params(q, k, v, o, strides, H, T, D, scale);
  return launch_typed<true>(p, B, dtype, static_cast<cudaStream_t>(stream));
}

// o = softmax(mask(q k^T * scale)) v, _flash_kernel's numerics.  q and o
// are (B, H, T, D), k and v (B, KVH, T, D) with H a multiple of KVH;
// strides as for flash_forward (k's and v's h stride is per kv head).
// lengths: (B,) int32 in device memory, or null for no length mask;
// causal: 0 or 1.  Returns cudaGetLastError() after the launch.
int flash_forward_masked(const void* q, const void* k, const void* v, void* o,
                         const long long* strides, const int* lengths, int B, int H, int KVH,
                         int T, int D, int dtype, int causal, float scale, void* stream) {
  if (KVH < 1 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, o, strides, H, T, D, scale);
  p.lengths = lengths;
  p.rep = H / KVH;
  p.causal = causal != 0;
  return launch_typed<true>(p, B, dtype, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
