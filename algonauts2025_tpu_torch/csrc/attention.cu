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
// contract: fp32 FMAs, no TF32) that is above the fp32 CUDA-core ridge of
// ~20 FLOP/B, so the bound is operations: ~0.26 ms at 67 TFLOP/s.  In bf16
// the same work is byte-bound (117 MB), but the arithmetic stays fp32.
//
// Design.  A block of 8 warps owns BM = 8 R query rows of one (b, h); K and
// V stream through shared memory in tiles of BN keys with an online
// (running max) softmax, since one head's K (298 x 384 x 4 B = 458 KB) is
// twice the 227 KB of shared memory.
//   - q is staged in shared memory once per block, not once per key tile.
//   - Scores S = q K^T.  A 128-bit shared load is served a quarter-warp at
//     a time, four shared-memory cycles even where lanes share an address,
//     so a warp's load count has to be small beside its FMAs.  With 8 warps
//     on a 64 x 32 tile a warp has only 256 scores, so the head dim is
//     split instead: warp w computes
//     the partial scores of head-dim slice w % 4 (96 of 384) for 32 rows,
//     each lane an 8 x 4 register tile walked four values at a time (12
//     loads for 128 FMAs; lanes 8 rg .. 8 rg + 7 share rows, lane kg owns
//     keys kg + 8 j; rows padded by 4 floats so a quarter-warp's loads hit
//     32 distinct banks), and writes them to shared memory (rows of BN + 1,
//     conflict-free).
//   - Softmax and P V: warp w owns rows 8 w .. 8 w + 7.  It sums their four
//     partial scores, runs the online softmax (the row max and sum meet in
//     three shuffles) and writes the probabilities over slice 0's copy of
//     its own rows (the scores never leave the chip).  The output
//     accumulator stays in registers: each lane owns R rows x 4 NJ columns,
//     columns 4 lane + 128 j (96 floats at dh = 384), fed by 128-bit loads
//     of V (contiguous across the warp) and broadcast loads of P (5 loads
//     for 96 FMAs).
//   - K and V have one buffer each and are copied with cp.async: the next
//     K tile arrives while this tile's softmax and P V run, the next V tile
//     while the next scores run.
// Query tile and grid.  R = 8 gives BM = 64: at T = 298, 5 query tiles x
// B H = 128 heads = 640 blocks, 4.85 waves of one block per SM (all 227 KB
// of shared memory a block at dh = 384); the last wave is 85 % full.  The
// last query tile holds 42 of its 64 rows; warps whose rows all lie past T
// skip the softmax and P V (two of eight) and the score warps of a half
// past T skip theirs.  A 32-row tile would make no fewer waves and halve
// the reuse of each K and V load.  Head dims up to 384 run with R = 8, BN
// = 32, NJ = dh / 128 rounded up and four slices; larger ones (up to 892)
// with R = 4, BN = 16, NJ = 7 and no split, to fit shared memory.
// Layout routing.  q, k, v and o are (B, H, T, dh) with unit stride on dh
// and any strides on B, H and T (in elements), so the trunk hands over the
// head-split views of its fused qkv projection and receives the output in
// (B, T, H, dh) order.  The wrapper decides from the layout, before the
// launch, whether every row may be read and written four elements at a
// time (dh, the b, h and t strides multiples of 4 elements, 4-element
// aligned bases): then fp32 tiles arrive by 16-byte cp.async and bf16 ones
// by 8-byte loads; otherwise the same kernel reads one element at a time.
// bf16 is converted to fp32 on its way into shared memory, so its copies do
// not overlap the arithmetic (no main path runs bf16 here).  The ragged
// edges are masked in the kernel (zero-filled loads, -inf scores for keys
// >= T, no stores for rows >= T), so no padded copies are needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq[3], sk[3], sv[3], so[3];  // strides of b, h, t in elements
  int H, T, D;
  float scale;
};

// Shared memory in floats for head dim D padded to Dp (a multiple of 4): q
// (BM rows) and K (BN rows) with rows of Dp + 4, V (BN rows of Dp), the
// partial scores of the kSplit head-dim slices (BM rows of BN + 1 each;
// slice 0's rows then hold the probabilities), the row rescales and the row
// sums (BM).
__host__ __device__ constexpr long long smem_floats(int R, int BN, int Dp, int kSplit) {
  return (long long)(kWarps * R + BN) * (Dp + 4) + (long long)BN * Dp + kSplit * kWarps * R * (BN + 1) +
         2 * kWarps * R;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [t0, t0 + rows) of one (b, h) slice of a (.., T, D) tensor with row
// stride st into shared memory rows of ld floats, columns [0, Dp); rows
// past T and columns past D are zero.
template <typename T, bool kVec>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, long long st, int t0, int rows,
                                          int Tn, int D, int Dp) {
  constexpr int kW = kVec ? 4 : 1;  // elements a copy
  const int per_row = Dp / kW;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, d = (i % per_row) * kW, t = t0 + r;
    const bool in = t < Tn && d < D;
    const T* g = src + (in ? t * st + d : 0);
    float* s = dst + r * ld + d;
    if constexpr (sizeof(T) == 4) {
      if constexpr (kVec) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(s)), "l"(g),
                     "r"(in ? 16 : 0)
                     : "memory");
      } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(s)), "l"(g),
                     "r"(in ? 4 : 0)
                     : "memory");
      }
    } else if constexpr (kVec) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in) {
        const uint2 raw = *reinterpret_cast<const uint2*>(g);
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        f = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      *reinterpret_cast<float4*>(s) = f;
    } else {
      *s = in ? __bfloat162float(*g) : 0.f;
    }
  }
}

__device__ __forceinline__ void store4(float* g, float4 x) { *reinterpret_cast<float4*>(g) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* g, float4 x) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(x.x, x.y);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(g) = raw;
}
__device__ __forceinline__ void store1(float* g, float x) { *g = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* g, float x) { *g = __float2bfloat16(x); }

template <typename T, bool kVec, int R, int BN, int NJ, int kSplit>
__global__ void __launch_bounds__(kThreads, 1) attn_fwd_kernel(Params p) {
  constexpr int BM = kWarps * R;
  constexpr int RW = BM * kSplit / kWarps;  // rows of a warp's partial scores
  constexpr int PR = RW / 4;                // partial-score rows a lane
  constexpr int SR = R / 4;                 // softmax rows a lane
  constexpr int SK = BN / 8;                // score keys a lane
  constexpr int NC = 4 * NJ;                // output columns a lane
  constexpr int LDR = BN + 1;               // row stride of the partial scores
  static_assert(R % 4 == 0 && BN % 8 == 0 && kWarps % kSplit == 0, "a warp's score tile is 4 x 8 lanes");

  extern __shared__ __align__(16) float smem[];
  const int D = p.D, Tn = p.T;
  const int Dp = (D + 3) & ~3;
  const int ld = Dp + 4;
  float* q_s = smem;
  float* k_s = q_s + BM * ld;
  float* v_s = k_s + BN * ld;
  float* red = v_s + BN * Dp;          // partial scores, [slice][row][key]
  float* a_s = red + kSplit * BM * LDR;  // row rescales
  float* l_s = a_s + BM;                 // row sums

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * BM;
  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const T* kptr = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[1];
  T* og = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[1];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 8, kg = lane % 8;
  const int row0 = R * warp;              // the warp's first softmax and output row
  const bool active = q0 + row0 < Tn;     // a warp whose rows all lie past T only loads
  // the warp's probabilities, [key][row], over slice 0's partial scores of
  // its own rows (R LDR >= BN R floats)
  float* p_w = red + row0 * LDR;
  // the warp's share of the scores: head-dim slice sl of rows srow ..
  // srow + RW - 1
  const int sl = warp % kSplit, srow = RW * (warp / kSplit);
  const int chunk = (Dp / 4 + kSplit - 1) / kSplit * 4;
  const int d0 = min(Dp, sl * chunk), d1 = min(Dp, d0 + chunk);

  // output columns of this lane; a column past Dp reads column 0 and is
  // never stored
  int col[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) col[j] = 4 * lane + 128 * j < Dp ? 4 * lane + 128 * j : 0;

  load_tile<T, kVec>(q_s, ld, qg, p.sq[2], q0, BM, Tn, D, Dp);
  load_tile<T, kVec>(k_s, ld, kptr, p.sk[2], 0, BN, Tn, D, Dp);
  cp_async_commit();
  load_tile<T, kVec>(v_s, Dp, vg, p.sv[2], 0, BN, Tn, D, Dp);
  cp_async_commit();

  float o[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
  float m[SR], l[SR];  // running max, and this lane's share of the row sum
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int k0 = 0; k0 < Tn; k0 += BN) {
    const bool more = k0 + BN < Tn;
    cp_async_wait<1>();  // this K tile (the V tile may still be in flight)
    __syncthreads();

    // ---- partial scores: q K^T over the warp's head-dim slice, four
    // values a step, into shared memory ----
    if (q0 + srow < Tn) {
      float s[PR][SK];
#pragma unroll
      for (int i = 0; i < PR; ++i)
#pragma unroll
        for (int j = 0; j < SK; ++j) s[i][j] = 0.f;
      const float* qr = q_s + (srow + PR * rg) * ld;
      const float* kr = k_s + kg * ld;
#pragma unroll 2
      for (int d = d0; d < d1; d += 4) {
        float4 a[PR], bk[SK];
#pragma unroll
        for (int i = 0; i < PR; ++i) a[i] = *reinterpret_cast<const float4*>(qr + i * ld + d);
#pragma unroll
        for (int j = 0; j < SK; ++j) bk[j] = *reinterpret_cast<const float4*>(kr + 8 * j * ld + d);
#pragma unroll
        for (int i = 0; i < PR; ++i)
#pragma unroll
          for (int j = 0; j < SK; ++j) {
            s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
          }
      }
      float* dst = red + (sl * BM + srow + PR * rg) * LDR + kg;
#pragma unroll
      for (int i = 0; i < PR; ++i)
#pragma unroll
        for (int j = 0; j < SK; ++j) dst[i * LDR + 8 * j] = s[i][j];
    }
    __syncthreads();  // every warp is done with this K tile, every partial score is in
    if (more) load_tile<T, kVec>(k_s, ld, kptr, p.sk[2], k0 + BN, BN, Tn, D, Dp);
    cp_async_commit();

    // ---- online softmax on the lane's rows; the 8 lanes of a row meet in
    // three shuffles.  m_new is finite: key k0 < T is kept in every row ----
    if (active) {
      float s[SR][SK];
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SK; ++j) {
          const float* src = red + (row0 + SR * rg + i) * LDR + kg + 8 * j;
          float x = src[0];
#pragma unroll
          for (int t = 1; t < kSplit; ++t) x += src[t * BM * LDR];
          s[i][j] = x;
        }
      __syncwarp();  // slice 0's rows are read before the probabilities overwrite them
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < SK; ++j) {
          s[i][j] = k0 + kg + 8 * j < Tn ? s[i][j] * p.scale : -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);  // 0 on the first tile
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < SK; ++j) {
          const float e = expf(s[i][j] - m_new);
          p_w[(kg + 8 * j) * R + SR * rg + i] = e;
          sum += e;
        }
        l[i] = l[i] * alpha + sum;
        if (kg == 0) a_s[row0 + SR * rg + i] = alpha;
      }
    }
    cp_async_wait<1>();  // this V tile (the next K tile may still be in flight)
    __syncthreads();

    // ---- o = o * alpha + P V ----
    if (active) {
#pragma unroll
      for (int r4 = 0; r4 < R; r4 += 4) {
        const float4 al = *reinterpret_cast<const float4*>(a_s + row0 + r4);
        const float alr[4] = {al.x, al.y, al.z, al.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) o[r4 + r][c] *= alr[r];
      }
#pragma unroll 4
      for (int kk = 0; kk < BN; ++kk) {
        float pr[R];
#pragma unroll
        for (int r4 = 0; r4 < R; r4 += 4) {
          const float4 x = *reinterpret_cast<const float4*>(p_w + kk * R + r4);
          pr[r4] = x.x;
          pr[r4 + 1] = x.y;
          pr[r4 + 2] = x.z;
          pr[r4 + 3] = x.w;
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(v_s + kk * Dp + col[j]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            o[r][4 * j] = fmaf(pr[r], vv.x, o[r][4 * j]);
            o[r][4 * j + 1] = fmaf(pr[r], vv.y, o[r][4 * j + 1]);
            o[r][4 * j + 2] = fmaf(pr[r], vv.z, o[r][4 * j + 2]);
            o[r][4 * j + 3] = fmaf(pr[r], vv.w, o[r][4 * j + 3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this V tile and its probabilities
    if (more) load_tile<T, kVec>(v_s, Dp, vg, p.sv[2], k0 + BN, BN, Tn, D, Dp);
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (!active) return;

  // ---- out = o / l ----
#pragma unroll
  for (int i = 0; i < SR; ++i) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    if (kg == 0) l_s[row0 + SR * rg + i] = l[i];
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = q0 + row0 + r;
    if (t >= Tn) continue;
    const float lr = l_s[row0 + r];
    T* orow = og + t * p.so[2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = 4 * lane + 128 * j;
      if (c >= D) continue;
      const float4 x = make_float4(o[r][4 * j] / lr, o[r][4 * j + 1] / lr, o[r][4 * j + 2] / lr,
                                   o[r][4 * j + 3] / lr);
      if (kVec) {
        store4(orow + c, x);
      } else {
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < D) store1(orow + c + e, xs[e]);
      }
    }
  }
}

template <typename T, bool kVec, int R, int BN, int NJ, int kSplit>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int Dp = (p.D + 3) & ~3;
  const long long smem = sizeof(float) * smem_floats(R, BN, Dp, kSplit);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T, kVec, R, BN, NJ, kSplit>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.T + kWarps * R - 1) / (kWarps * R), B * p.H);
  attn_fwd_kernel<T, kVec, R, BN, NJ, kSplit><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Head dims up to 384: 64-row query tiles, 32-key tiles, NJ = Dp / 128
// rounded up, scores split over 4 head-dim slices; up to 892: 32-row query
// tiles, 16-key tiles, NJ = 7 and no split, to fit shared memory.
template <typename T, bool kVec>
int launch_dims(const Params& p, int B, cudaStream_t s) {
  const int Dp = (p.D + 3) & ~3;
  if (Dp <= 128) return launch<T, kVec, 8, 32, 1, 4>(p, B, s);
  if (Dp <= 256) return launch<T, kVec, 8, 32, 2, 4>(p, B, s);
  if (Dp <= 384) return launch<T, kVec, 8, 32, 3, 4>(p, B, s);
  if (Dp <= 892) return launch<T, kVec, 4, 16, 7, 1>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for head dim D.
long long attn_smem_bytes(int D) {
  const int Dp = (D + 3) & ~3;
  return (long long)sizeof(float) * (Dp <= 384 ? smem_floats(8, 32, Dp, 4) : smem_floats(4, 16, Dp, 1));
}

// o = softmax(q k^T * scale) v.  strides: 12 int64, the (b, h, t) strides of
// q, k, v and o in elements.  dtype: 0 = float32, 1 = bfloat16.  vec: 1 when
// D and every b, h, t stride are multiples of 4 elements and every base is
// aligned to 4 elements (then rows move four elements at a time), else 0.
// Returns cudaGetLastError() after the launch (0 on success).
int attn_forward(const void* q, const void* k, const void* v, void* o, const long long* strides,
                 int B, int H, int T, int D, int dtype, int vec, float scale, void* stream) {
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
  if (dtype == 0) return vec ? launch_dims<float, true>(p, B, s) : launch_dims<float, false>(p, B, s);
  if (dtype == 1)
    return vec ? launch_dims<__nv_bfloat16, true>(p, B, s) : launch_dims<__nv_bfloat16, false>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
