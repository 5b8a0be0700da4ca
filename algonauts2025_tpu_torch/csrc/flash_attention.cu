// Flash attention for the V-JEPA2 and Llama backbones and the attention
// bench, sm_90a: four C entry points over two tile loops, one for each
// dtype.  bf16 runs on the tensor cores (wgmma, TMA); fp32 stays on the
// CUDA cores, since the port's fp32 contract (TF32 off) rules the tensor
// cores out for fp32 and no main path runs fp32 attention.
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
// without materialising the repeat.  The query tiles of a head are
// launched heaviest first (the last causal tile streams every key), so the
// longest blocks do not start last.
//
// flash_forward_fast (the attention bench's online-max baseline).
// Replaces: algonauts2025_tpu/ops/flash_attention.py::_fast_kernel (launched by
// _fast_flash, called only by scripts/bench_attn.py): flash_forward's
// numerics (scale folded into a rounded q, running max, the row sum over p
// rounded to v's dtype, which the TPU kernel takes through a ones-lane in
// v's padding), with an optional rounding of every score to bf16 before the
// running max and exp: flash_forward's loop under a third template flag.
//
// flash_forward_packed (the attention bench's head-pair packed variant).
// Replaces: algonauts2025_tpu/ops/flash_attention.py::_flash_kernel_packed
// (launched by _packed_call, called only by scripts/bench_attn.py), which
// packs two heads of d = 64 block-diagonally into the TPU's 128 lanes: a
// layout trick with no counterpart here, so each head runs on its own.
// Its numerics are _flash_kernel's with no mask (fp32 scale on the fp32
// scores, the row sum over fp32 p, p rounded to v's dtype for P.V): this
// is flash_forward_masked's loop with causal 0, no lengths and one query
// head per kv head.
//
// What bounds it on an H100: at ViT-G and the bench (B=4, H=22, T=8192,
// d=64, bf16) one call is 4*B*H*T^2*d = 1.51 TFLOP against 0.18 GB of q,
// k, v and o; at Llama-3.2-3B's (8, 24, 1024, 128) bf16 causal with 8 kv
// heads, 51.6 GFLOP against 134 MB.  Both are bound by operations (1.53 and
// 0.052 ms at the 989 TFLOP/s bf16 tensor-core peak), so the bf16 loop has
// to run its two products on the tensor cores and keep the softmax, which
// at d = 64 takes one exp for every 256 tensor-core operations, off their
// path: at ViT-G's shape the 5.9e9 exponentials alone take 1.41 ms on the
// MUFU at 1,980 MHz, against 1.53 ms of products.
//
// bf16 design (flash_tc_kernel).  Persistent and warp specialised: one
// block an SM walks a list of (query tile, head) items; a block holds
// consumer warpgroups of 64 query rows each (three at d = 64, 192 rows an
// item; two at d = 128) and one producer warpgroup, whose elected thread
// loads each item's q tile and streams 128-key tiles of K and V through a
// ring in shared memory with TMA (3 stages at d = 64, 2 at d = 128; one 4-d
// tensor map per operand over (d, t, h, b) with the caller's strides, so
// strided head views need no copy; 128-byte swizzle; the out-of-bounds zero
// fill covers the ragged T edge and the head-dim columns past D).  K and V
// of a stage have their own full and empty mbarriers, so S = Q K^T starts
// when K has landed and K's stage frees before V's; the ring runs on across
// items and q has two slots, so the next item's loads overlap this one.
// The blocks take the items in rounds, every other round in reverse
// (block_item), which evens out the causal items' lengths.  The output
// leaves through the item's q slot: each warpgroup writes its normalised
// rows there in TMA's swizzled layout and one thread stores them with TMA,
// so no consumer waits on global stores (where o's layout is not one TMA
// can write, the threads store it).
// The producer gives its registers up (setmaxnreg.dec) and the consumers
// take them (setmaxnreg.inc: 160 a thread at d = 64, 240 at d = 128).  Each
// consumer warpgroup computes S = Q K^T with wgmma m64n128k16 from shared
// memory (K row-major is K-major for this product), runs the online
// softmax on its fragment with the scale, the optional bf16 score rounding
// and the masks (each thread holds two rows; the row max and sum need two
// shuffles), converts p to bf16 pairs -- the accumulator layout of S is the
// register A-operand layout of P -- and accumulates O += P V with wgmma
// from registers, V being the transposed (MN-major) shared-memory operand.
// Scores never touch shared memory.  At d = 64 the exponentials (one MUFU
// ex2 per score, 16 a clock per SM) take about as long as the two products
// on the tensor cores, so the loop keeps the softmax off the tensor cores'
// path: the warpgroups issue S_j and P_{j-1} V_{j-1} together, in turns
// round a ring of named barriers, so that one's softmax runs while the
// others' products do.  With the unmasked
// numerics at d = 64 the row sums over the rounded p ride P V: it runs 8
// columns wider, over a panel of ones beside each V tile, so the CUDA
// cores do not sum.  Head dims up to 64 run at 64 and up to 128 at 128
// (zero columns leave the dot products as they are).  The layout contract
// that TMA needs (16-byte aligned bases, b, h and t strides in multiples of
// 8 elements) is checked by the wrapper.
//
// fp32 design (flash_fwd_kernel).  One 256-thread block per (b*h, 64-query
// tile); K and V stream through shared memory in 64-key tiles with the
// same online softmax; each thread owns a 4 x 4 tile of every 64 x 64
// score block and a 4 x (d/16) tile of the output accumulator in
// registers, with fp32 FMAs.
//
// Layout.  q, k, v and o are (B, H, T, d) with unit stride on d and any
// strides on B, H and T (in elements; for bf16 within the TMA contract),
// so the backbone hands over the head-split views of its (B, T, H*d)
// projections without copies and gets the output back in (B, T, H, d)
// order.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// ---------------------------------------------------------------------------
// fp32: the CUDA-core loop

constexpr int kBM = 64;  // query rows per block
constexpr int kBN = 64;  // keys per streamed tile
constexpr int kThreads = 256;

// shared memory in floats for head dim D and DC output columns per thread:
// q and k tiles (kBM/kBN x (D+1)), v tile (kBN x 16*DC), score tile
// (kBM x (kBN+1)), row max / sum / rescale (3*kBM)
__host__ __device__ constexpr long long smem_floats(int D, int DC) {
  return (long long)(kBM + kBN) * (D + 1) + kBN * 16 * DC + kBM * (kBN + 1) + 3 * kBM;
}

// kMasked selects the numerics and the masks: false is flash_forward's
// (scale folded into q, row sum over p, every key), true is
// flash_forward_masked's (scale on the scores, causal / length masks with
// the empty key tiles skipped).  In fp32 the roundings to the input dtype
// are the identity.  kBf16Scores (unmasked only) rounds each score to bf16
// before the running max and exp.
template <int DC, bool kMasked, bool kBf16Scores>
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
  const float* qg = static_cast<const float*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const float* kg = static_cast<const float*>(p.k) + b * p.sk[0] + hk * p.sk[1];
  const float* vg = static_cast<const float*>(p.v) + b * p.sv[0] + hk * p.sv[1];
  // keys col < valid are kept; tiles from kv_end on hold no kept key
  int valid = Tn, kv_end = Tn;
  if (kMasked) {
    if (p.lengths != nullptr) valid = max(0, min(p.lengths[b], Tn));
    kv_end = p.causal ? min(valid, q0 + kBM) : valid;
  }
  float* og = static_cast<float*>(p.o) + b * p.so[0] + h * p.so[1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns columns tx + 16*j
  const int ty = tid / 16;  // owns rows ty + 16*i
  const int warp = tid / 32;
  const int lane = tid % 32;

  // q tile; unmasked: scale folded in
  for (int i = tid; i < kBM * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    const float x = t < Tn ? qg[t * p.sq[2] + d] : 0.f;
    qs[r * (D + 1) + d] = kMasked ? x : __fmul_rn(x, p.scale);
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
      ks[r * (D + 1) + d] = t < Tn ? kg[t * p.sk[2] + d] : 0.f;
    }
    for (int i = tid; i < kBN * DV; i += kThreads) {
      const int r = i / DV, d = i % DV, t = k0 + r;
      vs[i] = (t < Tn && d < D) ? vg[t * p.sv[2] + d] : 0.f;
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
        if (kBf16Scores) s = round_bf16(s);
        st[row * (kBN + 1) + col] = keep ? s : -INFINITY;
      }
    __syncthreads();

    // ---- online softmax; each warp owns kBM/8 rows.  m_new is finite:
    // tile 0 keeps key 0 in every row (causal: 0 <= row; lengths: the loop
    // runs only when valid > 0) ----
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
      srow[lane] = e0;
      srow[lane + 32] = e1;
      float sum = e0 + e1;
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
      if (c < D) og[t * p.so[2] + c] = o[i][j] / l;
    }
  }
}

template <int DC, bool kMasked, bool kBf16Scores>
int launch_fp32(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.D, DC);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DC, kMasked, kBf16Scores>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.T + kBM - 1) / kBM, B * p.H);
  flash_fwd_kernel<DC, kMasked, kBf16Scores><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core loop

namespace tc {

constexpr int kKeys = 128;                 // keys per streamed tile
constexpr int kPanelBytes = 128;           // one swizzle row: 64 bf16 columns
constexpr int kMaxSmem = 232448;           // the dynamic shared memory a block may use
constexpr float kLog2e = 1.4426950408889634f;

// The block for head dim kD: kWarpgroups consumer warpgroups of 64 query
// rows and one producer warpgroup, kQSlots q tiles (the next item's q loads
// while this one runs), a ring of kStages K and V tiles, and the
// registers setmaxnreg gives each consumer and producer thread.  kOnes: a
// 64-column panel of ones follows each V tile, and P V runs 8 columns
// wider over it, so that the tensor cores sum each row of the rounded p
// (unmasked numerics at d = 64, where the CUDA cores are the scarcer).  The
// register file (65,536) holds kConsumers * kConsumerRegs + 128 *
// kProducerRegs, which is what the block holds at launch (kThreads *
// kLaunchRegs, the most __launch_bounds__(kThreads, 1) allows).  Shared
// memory in bytes from a 1024-aligned base: each tile is kD / 64 column
// panels of (rows x 128 B), as TMA writes them with the 128-byte swizzle.
template <int kD, bool kOnesPanel>
struct Block {
  static constexpr bool kOnes = kOnesPanel;
  static constexpr int kWarpgroups = kD == 64 ? 3 : 2;
  static constexpr int kQSlots = 2;
  static constexpr int kStages = kD == 64 ? 3 : 2;
  static constexpr int kConsumerRegs = kD == 64 ? 160 : 240;
  static constexpr int kProducerRegs = kD == 64 ? 32 : 24;
  static constexpr int kRows = 64 * kWarpgroups;  // query rows per block
  static constexpr int kConsumers = 128 * kWarpgroups;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kLaunchRegs = (65536 / kThreads < 255 ? 65536 / kThreads : 255) / 8 * 8;
  static constexpr int kPanels = kD / 64;
  static constexpr int kQBytes = kRows * kD * 2;
  static constexpr int kTileBytes = kKeys * kD * 2;  // one K or V tile
  static constexpr int kVStage = kTileBytes + (kOnes ? kKeys * kPanelBytes : 0);
  static constexpr int kK = kQSlots * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  // q full and empty for each slot, then full and empty barriers of K and
  // of V for each stage
  static constexpr int kBar = kV + kStages * kVStage;
  static constexpr int kBytes = kBar + 8 * (2 * kQSlots + 4 * kStages) + 1024;  // + the alignment slack
  static_assert(kBytes <= kMaxSmem, "the block's shared memory");
  static_assert(kQSlots >= 2, "an item's O leaves through its q slot while the next item's q loads");
  static_assert(kConsumers * kConsumerRegs + 128 * kProducerRegs <= kThreads * kLaunchRegs,
                "setmaxnreg must stay within the registers the block holds");
};

// The block of an instantiation: the unmasked numerics sum the rounded p,
// and at d = 64 the tensor cores do it.
template <int kD, bool kMasked>
using BlockOf = Block<kD, !kMasked && kD == 64>;

struct TcParams {
  CUtensorMap q, k, v;  // over (d, t, h, b); k and v at the kv heads
  CUtensorMap o_map;    // o over (d, t, h, b) in 64-row boxes, where o_tma
  void* o;
  long long so[3];  // strides of o's b, h, t in elements
  const int* lengths;
  int BH, H, T, D, rep, causal, o_pairs, o_tma;
  float scale;
};

// One work item of a block: a query tile of one head, and the key tiles it
// streams.
struct Item {
  int b, h, q0, valid, n_tiles;
};

// Item k of the (query tile, head) list: causal, all heads' tiles with the
// most keys first (the blocks walk the list in step, so the longest items
// do not come last); else head by head, so that the blocks at work at once
// share K and V in L2.  Keys col < valid are kept; tiles from kv_end on
// hold no kept key.
template <int kRows, bool kMasked>
__device__ __forceinline__ Item item_at(const TcParams& p, int k) {
  const int n_q = (p.T + kRows - 1) / kRows;
  const bool causal = kMasked && p.causal;
  const int bh = causal ? k % p.BH : k / n_q;
  const int qt = causal ? n_q - 1 - k / p.BH : k % n_q;
  Item it;
  it.b = bh / p.H;
  it.h = bh % p.H;
  it.q0 = qt * kRows;
  it.valid = p.T;
  int kv_end = p.T;
  if (kMasked) {
    if (p.lengths != nullptr) it.valid = max(0, min(p.lengths[it.b], p.T));
    kv_end = causal ? min(it.valid, it.q0 + kRows) : it.valid;
  }
  it.n_tiles = (kv_end + kKeys - 1) / kKeys;
  return it;
}

// The list index of this block's item t, or -1 past the list: the blocks
// take the list in rounds of gridDim.x items, block i item i of an even
// round and item gridDim.x - 1 - i of an odd one, so that with the
// heaviest items first each block's total keys come out even.
__device__ __forceinline__ int block_item(int t, int n_items) {
  const int k = t * gridDim.x + (t & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  return k < n_items ? k : -1;
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

// One TMA tile of a 4-d tensor map into shared memory, counted on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One TMA tile of shared memory into a 4-d tensor map, in this thread's
// bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Until this thread's bulk groups have read their shared memory (kRead) or
// are complete.
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Named barriers 1.. (0 is __syncthreads): n threads in all sync or arrive.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// This warpgroup's registers per thread, from here on.
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// wgmma's shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (>> 4), layout type 1 (B128).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Pin an accumulator's registers here, so that no read of them moves above
// the wgmma wait that completes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (+)= A B for one k16 step, A (64 x 16) and B (16 x 128) in shared
// memory, both K-major (128-byte swizzle); kAcc = false overwrites d.
template <bool kAcc>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b) {
  if constexpr (kAcc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "n"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
          "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
          "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
          "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
          "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
          "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
        : "l"(a), "l"(b), "n"(0));
  }
}

// d += A B for one k16 step: A (64 x 16) the bf16 pairs in a[4] (the
// accumulator fragment layout), B (16 x 64) in shared memory, MN-major
// (transposed, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// d += A B for one k16 step: A (64 x 16) the bf16 pairs in a[4] (the
// accumulator fragment layout), B (16 x 72) in shared memory, MN-major
// (transposed, 128-byte swizzle): V's 64 columns and 8 of the ones panel.
__device__ __forceinline__ void wgmma_rs_n72(float (&d)[36], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// d += A B for one k16 step: A (64 x 16) the bf16 pairs in a[4] (the
// accumulator fragment layout), B (16 x 128) in shared memory, MN-major
// (transposed, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// Issue S = Q K^T for one warpgroup (64 query rows x 128 keys) as one
// group: k16 steps walk 32 bytes along a swizzle row, then the next
// 64-column panel, whose rows are kRows (Q) or kKeys (K) x 128 bytes.
template <int kD, int kRows>
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint32_t q_wg, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint64_t qd = smem_desc(q_wg + (kk / 4) * kRows * kPanelBytes + (kk % 4) * 32, 16, 1024);
    const uint64_t kd = smem_desc(k_tile + (kk / 4) * kKeys * kPanelBytes + (kk % 4) * 32, 16, 1024);
    if (kk == 0)
      wgmma_ss_n128<false>(sc, qd, kd);
    else
      wgmma_ss_n128<true>(sc, qd, kd);
  }
  wgmma_commit();
}

// Issue O += P V as one group, P in registers; N (2 x the accumulator's
// registers) is the head dim, + 8 columns of ones for the row sums.  Step
// kk takes keys 16 kk .. 16 kk + 15, 16 rows of the V tile (two 8-row
// swizzle atoms); the 64-column panels are LBO apart.
template <int N>
__device__ __forceinline__ void issue_pv(float (&o)[N / 2], const uint32_t (&pa)[32], uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint64_t vd = smem_desc(v_tile + kk * 16 * kPanelBytes, kKeys * kPanelBytes, 1024);
    if constexpr (N == 64)
      wgmma_rs_n64(o, &pa[4 * kk], vd);
    else if constexpr (N == 72)
      wgmma_rs_n72(o, &pa[4 * kk], vd);
    else
      wgmma_rs_n128(o, &pa[4 * kk], vd);
  }
  wgmma_commit();
}

// The online softmax of one score tile sc: scale (kMasked) and bf16
// rounding (kBf16Scores), then, where ``masked``, the masks (a masked
// score takes no part in the maximum and gives p = +0, as exp(-inf) does);
// the running maxima m, the factor alpha by which the output so far is
// rescaled, p = exp(s - m) as bf16 pairs pn in the A-operand layout of P V
// (the accumulator layout of S is that layout), and this thread's share of
// the two row sums, over fp32 p (kMasked) or over the rounded p (kOnes:
// the tensor cores take those).  The 4 threads of a row (lanes 4r .. 4r +
// 3) meet in two shuffles.
template <bool kMasked, bool kBf16Scores, bool kOnes>
__device__ __forceinline__ void softmax_tile(const float (&sc)[64], uint32_t (&pn)[32], float (&m)[2],
                                             float (&alpha)[2], float (&sum)[2], const TcParams& p, bool masked,
                                             int k0, int valid, int r0, int c2) {
  // x(i): score i, scaled once into a copy (kMasked), else sc itself.
  // kBf16Scores rounds the scores where the exponentials read them, and
  // the row maximum once: rounding is monotone, so the maximum of the
  // rounded scores is the rounded maximum (a rounded copy would not fit
  // the registers)
  static_assert(!(kMasked && kBf16Scores), "bf16 scores are an unmasked option");
  float scaled[kMasked ? 64 : 1];
  if constexpr (kMasked) {
#pragma unroll
    for (int i = 0; i < 64; ++i) scaled[i] = __fmul_rn(sc[i], p.scale);
  }
  const auto x = [&](int i) {
    if constexpr (kMasked)
      return scaled[i];
    else
      return sc[i];
  };
  const bool causal = kMasked && p.causal;
  const auto dropped = [&](int i) {  // without branches
    const int col = k0 + 8 * (i >> 2) + c2 + (i & 1);
    return (col >= valid) | (causal & (col > r0 + 8 * ((i >> 1) & 1)));
  };
  // a masked score is left out of the maximum, then of the exponentials
  // (only tiles that reach past valid or the diagonal take the masks)
  float mx[2] = {-INFINITY, -INFINITY};
  if (masked) {
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], dropped(i) ? -INFINITY : x(i));
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x(i));
  }
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if (kBf16Scores) mx[r] = round_bf16(mx[r]);
    const float m_new = fmaxf(m[r], mx[r]);
    // a row with no kept key yet keeps its zeros (exp(-inf) = 0)
    shift[r] = m_new == -INFINITY ? 0.f : m_new * kLog2e;
    alpha[r] = ex2(fmaf(m[r], kLog2e, -shift[r]));  // 0 on the first tile
    m[r] = m_new;
  }
  // p and the row sums
  const auto exps = [&](auto with_mask) {
    sum[0] = sum[1] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      float e[2];
      if constexpr (kBf16Scores) {
        const uint32_t pair = pack_bf16(x(i), x(i + 1));
        const float2 xs = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pair));
        e[0] = decltype(with_mask)::value && dropped(i) ? 0.f : ex2(fmaf(xs.x, kLog2e, -shift[(i >> 1) & 1]));
        e[1] = decltype(with_mask)::value && dropped(i + 1) ? 0.f : ex2(fmaf(xs.y, kLog2e, -shift[(i >> 1) & 1]));
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = ex2(fmaf(x(i + h), kLog2e, -shift[(i >> 1) & 1]));
          e[h] = decltype(with_mask)::value && dropped(i + h) ? 0.f : v;
        }
      }
      pn[i / 2] = pack_bf16(e[0], e[1]);
      if (kOnes) continue;
      if (kMasked) {
        sum[(i >> 1) & 1] += e[0] + e[1];
      } else {
        const float2 pr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pn[i / 2]));
        sum[(i >> 1) & 1] += pr.x + pr.y;
      }
    }
  };
  if (masked)
    exps(std::true_type{});
  else
    exps(std::false_type{});
}

// kMasked and kBf16Scores as for flash_fwd_kernel.  Persistent: each block
// works its items (block_item) of the (query tile, head) list.  Each
// consumer thread holds rows r0 = 16 * warp + lane / 4 and r0 + 8 of its
// warpgroup's 64; element i of a 64 x N accumulator fragment is row r0 + 8
// * ((i >> 1) & 1), column 8 * (i >> 2) + 2 * (lane % 4) + (i & 1).
//
// A consumer warpgroup's tile j (j >= 1) runs: wait for K_j and V_{j-1};
// take its turn (named barrier); issue S_j = Q K_j^T and O += P_{j-1}
// V_{j-1}; pass the turn on; wait for both and release K_j and V_{j-1};
// run the softmax of S_j into P_j and rescale O.  The turns go round the
// consumer warpgroups in order, so one's softmax runs while the others'
// products do.  (Its softmax under its own P_{j-1} V_{j-1}, waiting for
// S_j alone, was measured: no faster at d = 128, slower at d = 64, whose
// 160 registers do not hold a second P.)  The K/V ring and the turns run
// on across items; item t's q tile lives in slot t % kQSlots, so the
// producer loads the next item's q and K/V while the consumers work this
// one.  The slot is released once the item's O, staged in it, has been
// read by its TMA store (or, where the threads store o, once the item's
// last S is done).
template <int kD, bool kMasked, bool kBf16Scores>
__global__ void __launch_bounds__(BlockOf<kD, kMasked>::kThreads, 1)
    flash_tc_kernel(const __grid_constant__ TcParams p) {
  using L = BlockOf<kD, kMasked>;
  constexpr bool kOnes = L::kOnes;
  constexpr int kAcc = kD / 2 + (kOnes ? 4 : 0);  // registers of O (and the sums)
  constexpr int kStages = L::kStages, kRows = L::kRows, kWarpgroups = L::kWarpgroups;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_s = base, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8 * L::kQSlots;
  const uint32_t full_k = q_empty + 8 * L::kQSlots, full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages, empty_v = empty_k + 8 * kStages;
  const int n_items = (p.T + kRows - 1) / kRows * p.BH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (kOnes) {
    // bf16 1.0 over every ones panel, for wgmma's async proxy
    for (int i = tid; i < kStages * kKeys * kPanelBytes / 16; i += L::kThreads) {
      const int s = i / (kKeys * kPanelBytes / 16), e = i % (kKeys * kPanelBytes / 16);
      reinterpret_cast<uint4*>(smem + L::kV + s * L::kVStage + L::kTileBytes)[e] =
          make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (tid == 0) {
    for (int s = 0; s < L::kQSlots; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, L::kConsumers / 32);  // one arrival per consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, L::kConsumers / 32);
      mbar_init(empty_v + 8 * s, L::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= L::kConsumers / 32) {
    // ---- producer warpgroup: one thread loads each item's q tile once its
    // slot is released, and K and V of each key tile as soon as its stage
    // is free ----
    setmaxnreg_dec<L::kProducerRegs>();
    if (tid == L::kConsumers) {
      int g = 0;  // key tiles loaded by this block
      for (int t = 0, k; (k = block_item(t, n_items)) >= 0; ++t) {
        const Item it = item_at<kRows, kMasked>(p, k);
        const int hk = it.h / p.rep, slot = t % L::kQSlots;
        const uint32_t full = q_full + 8 * slot;
        if (t >= L::kQSlots) mbar_wait(q_empty + 8 * slot, (t / L::kQSlots - 1) & 1);
        mbar_expect_tx(full, L::kQBytes);
        for (int c = 0; c < L::kPanels; ++c)
          tma_load(q_s + slot * L::kQBytes + c * kRows * kPanelBytes, &p.q, full, 64 * c, it.q0, it.h, it.b);
        for (int j = 0; j < it.n_tiles; ++j, ++g) {
          const int s = g % kStages;
          const uint32_t parity = (g / kStages - 1) & 1;
          if (g >= kStages) mbar_wait(empty_k + 8 * s, parity);
          mbar_expect_tx(full_k + 8 * s, L::kTileBytes);
          for (int c = 0; c < L::kPanels; ++c)
            tma_load(k_s + s * L::kTileBytes + c * kKeys * kPanelBytes, &p.k, full_k + 8 * s, 64 * c, j * kKeys,
                     hk, it.b);
          if (g >= kStages) mbar_wait(empty_v + 8 * s, parity);
          mbar_expect_tx(full_v + 8 * s, L::kTileBytes);
          for (int c = 0; c < L::kPanels; ++c)
            tma_load(v_s + s * L::kVStage + c * kKeys * kPanelBytes, &p.v, full_v + 8 * s, 64 * c, j * kKeys,
                     hk, it.b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups ----
    setmaxnreg_inc<L::kConsumerRegs>();
    const int wg = warp / 4;
    const int c2 = 2 * (lane % 4);
    // named barriers: 1 + wg for the q scaling, kTurn + wg for the turns
    constexpr int kTurn = 1 + kWarpgroups;
    const int next_turn = kTurn + (wg + 1) % kWarpgroups;
    // one turn a key tile; the last warpgroup hands the first to warpgroup
    // 0 (its last arrival is left pending when the block ends, and the
    // named barriers start afresh with each block)
    if (wg == kWarpgroups - 1) bar_arrive(kTurn, 256);
    int g = 0;  // key tiles consumed
    // with o_tma, an item's q slot takes its O for the store and is
    // released once the store has read it: by three warps of a warpgroup
    // after the epilogue, by the first (whose thread 0 issued the store)
    // during the next item
    int pending = -1;  // the slot of thread 0's store not yet seen read
    const auto release = [&]() {
      if (pending >= 0) {
        bulk_wait<true>();
        mbar_arrive(q_empty + 8 * pending);
        pending = -1;
      }
    };

    for (int t = 0, k; (k = block_item(t, n_items)) >= 0; ++t) {
      const Item it = item_at<kRows, kMasked>(p, k);
      const int r0 = it.q0 + 64 * wg + 16 * (warp % 4) + lane / 4;  // this thread's rows r0, r0 + 8
      const int n = it.n_tiles, valid = it.valid, slot = t % L::kQSlots;
      const uint32_t q_wg = q_s + slot * L::kQBytes + 64 * wg * kPanelBytes, q_done = q_empty + 8 * slot;
      mbar_wait(q_full + 8 * slot, (t / L::kQSlots) & 1);
      if (!kMasked) {
        // (q * d^-1/2).astype(q.dtype), in place on this warpgroup's rows
#pragma unroll
        for (int c = 0; c < L::kPanels; ++c) {
          uint4* rows = reinterpret_cast<uint4*>(smem + slot * L::kQBytes + c * kRows * kPanelBytes +
                                                 64 * wg * kPanelBytes);
#pragma unroll
          for (int i = tid % 128; i < 64 * kPanelBytes / 16; i += 128) {
            uint4 x = rows[i];
            uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
              w[e] = pack_bf16(__fmul_rn(f.x, p.scale), __fmul_rn(f.y, p.scale));
            }
            rows[i] = x;
          }
        }
        // the generic-proxy writes must be visible to wgmma's async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_sync(1 + wg, 128);
      }

      float o[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sum
      // a tile needs the masks if it reaches past valid or, causal, past
      // this warpgroup's first row
      const int causal_from = kMasked && p.causal ? it.q0 + 64 * wg : INT_MAX;
      if (n > 0) {
        float sc[64], alpha[2], sum[2];
        uint32_t pa[32];  // P of the last tile
        // l and O through the last tile to the new maxima, plus this tile's
        // sums; no product is in flight (ptxas serialises every wgmma if a
        // register of one is written while any is)
        const auto rescale = [&]() {
          if (!kOnes) {
#pragma unroll
            for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
          }
#pragma unroll
          for (int i = 0; i < kAcc; ++i) o[i] *= alpha[(i >> 1) & 1];
        };
        mbar_wait(full_k + 8 * (g % kStages), (g / kStages) & 1);
        bar_sync(kTurn + wg, 256);
        wgmma_fence();
        issue_scores<kD, kRows>(sc, q_wg, k_s + (g % kStages) * L::kTileBytes);
        bar_arrive(next_turn, 256);
        release();
        wgmma_wait();
        fence_regs(sc);
        if (lane == 0) {
          mbar_arrive(empty_k + 8 * (g % kStages));
          if (n == 1 && !p.o_tma) mbar_arrive(q_done);
        }
        softmax_tile<kMasked, kBf16Scores, kOnes>(sc, pa, m, alpha, sum, p,
                                                  kKeys > valid || kKeys - 1 > causal_from, 0, valid, r0, c2);
        rescale();

#pragma unroll 1
        for (int j = 1; j < n; ++j) {
          const int s = (g + j) % kStages, sp = (g + j - 1) % kStages;
          const int k0 = j * kKeys;
          mbar_wait(full_k + 8 * s, ((g + j) / kStages) & 1);
          mbar_wait(full_v + 8 * sp, ((g + j - 1) / kStages) & 1);
          bar_sync(kTurn + wg, 256);
          wgmma_fence();
          issue_scores<kD, kRows>(sc, q_wg, k_s + s * L::kTileBytes);
          issue_pv<2 * kAcc>(o, pa, v_s + sp * L::kVStage);
          bar_arrive(next_turn, 256);
          wgmma_wait();
          fence_regs(sc);
          fence_regs(o);
          if (lane == 0) {
            mbar_arrive(empty_k + 8 * s);
            mbar_arrive(empty_v + 8 * sp);
            if (j == n - 1 && !p.o_tma) mbar_arrive(q_done);
          }
          softmax_tile<kMasked, kBf16Scores, kOnes>(sc, pa, m, alpha, sum, p,
                                                    k0 + kKeys > valid || k0 + kKeys - 1 > causal_from, k0, valid,
                                                    r0, c2);
          rescale();
        }

        // the last tile's P V
        const int sl = (g + n - 1) % kStages;
        mbar_wait(full_v + 8 * sl, ((g + n - 1) / kStages) & 1);
        wgmma_fence();
        issue_pv<2 * kAcc>(o, pa, v_s + sl * L::kVStage);
        wgmma_wait();
        fence_regs(o);
        if (lane == 0) mbar_arrive(empty_v + 8 * sl);
        g += n;
      } else {
        release();
        if (lane == 0 && !p.o_tma) mbar_arrive(q_done);  // no key: q was not read
      }

      // ---- out = o / max(l, 1e-30); a row with no key is 0 ----
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (kOnes) {
          l[r] = o[kD / 2 + 2 * r];  // the whole row's sum, in each of its 4 threads
        } else {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        }
        inv[r] = 1.f / fmaxf(l[r], 1e-30f);
      }
      if (p.o_tma) {
        // into this warpgroup's rows of the q slot, as TMA's 128-byte
        // swizzle lays them out (16-byte chunk j of row i at j ^ (i % 8));
        // then one thread stores them with TMA, which leaves out the rows
        // past T and the columns past D
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * (warp % 4) + lane / 4 + 8 * r;
#pragma unroll
          for (int c = 0; c < kD / 8; ++c) {
            const uint32_t at = q_wg + (c / 8) * kRows * kPanelBytes + row * kPanelBytes +
                                (((c % 8) ^ (row % 8)) * 16) + 2 * c2;
            const uint32_t pair = pack_bf16(o[4 * c + 2 * r] * inv[r], o[4 * c + 2 * r + 1] * inv[r]);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(pair) : "memory");
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_sync(1 + wg, 128);
        if (tid % 128 == 0) {
#pragma unroll
          for (int c = 0; c < L::kPanels; ++c)
            tma_store(&p.o_map, q_wg + c * kRows * kPanelBytes, 64 * c, it.q0 + 64 * wg, it.h, it.b);
          bulk_commit();
          pending = slot;
        } else if (lane == 0) {
          mbar_arrive(q_done);
        }
        continue;
      }
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + it.b * p.so[0] + it.h * p.so[1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row >= p.T) continue;
        __nv_bfloat16* orow = og + row * p.so[2];
#pragma unroll
        for (int c = 0; c < kD / 8; ++c) {
          const int col = 8 * c + c2;
          const float x0 = o[4 * c + 2 * r] * inv[r], x1 = o[4 * c + 2 * r + 1] * inv[r];
          if (p.o_pairs && col + 1 < p.D) {
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
          } else {
            if (col < p.D) orow[col] = __float2bfloat16_rn(x0);
            if (col + 1 < p.D) orow[col + 1] = __float2bfloat16_rn(x1);
          }
        }
      }
    }
    if (tid % 128 == 0) bulk_wait<false>();  // the last stores, before the block's shared memory goes
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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

// A bf16 tensor map over (d, t, h, b) of ``ptr`` with (b, h, t) element
// strides ``st``, read in boxes of 64 columns x ``rows`` with the 128-byte
// swizzle; reads past D or T give zeros.  A stride of a dim of size 1 is
// never used and may be anything, so it is replaced by a legal one.
int make_map(CUtensorMap* map, const void* ptr, const long long* st, int D, int T, int heads, int B,
             int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)heads, (cuuint64_t)B};
  const long long elems[3] = {st[2], st[1], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) strides[i] = dims[i + 1] == 1 ? 16 : (cuuint64_t)elems[i] * 2;
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int kD, bool kMasked, bool kBf16Scores>
int launch(const Params& p, int B, cudaStream_t stream) {
  using L = BlockOf<kD, kMasked>;
  TcParams t;
  const int kv_heads = p.H / p.rep;
  int err = make_map(&t.q, p.q, p.sq, p.D, p.T, p.H, B, L::kRows);
  if (err == 0) err = make_map(&t.k, p.k, p.sk, p.D, p.T, kv_heads, B, kKeys);
  if (err == 0) err = make_map(&t.v, p.v, p.sv, p.D, p.T, kv_heads, B, kKeys);
  if (err != 0) return err;
  t.o = p.o;
  for (int i = 0; i < 3; ++i) t.so[i] = p.so[i];
  t.lengths = p.lengths;
  t.BH = B * p.H;
  t.H = p.H;
  t.T = p.T;
  t.D = p.D;
  t.rep = p.rep;
  t.causal = p.causal;
  t.o_pairs = p.D % 2 == 0 && p.so[0] % 2 == 0 && p.so[1] % 2 == 0 && p.so[2] % 2 == 0 &&
              reinterpret_cast<uintptr_t>(p.o) % 4 == 0;
  t.scale = p.scale;
  // TMA stores o where its base and strides allow, else the threads do
  const int sizes[3] = {B, p.H, p.T};
  bool o_tma = reinterpret_cast<uintptr_t>(p.o) % 16 == 0;
  for (int i = 0; i < 3; ++i) o_tma = o_tma && (sizes[i] == 1 || p.so[i] * 2 % 16 == 0);
  t.o_tma = o_tma && make_map(&t.o_map, p.o, p.so, p.D, p.T, p.H, B, 64) == 0;
  const int smem = L::kBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_tc_kernel<kD, kMasked, kBf16Scores>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // persistent: one block an SM, or one an item where there are fewer
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)(p.T + L::kRows - 1) / L::kRows * B * p.H;
  const int blocks = items < sms ? (int)items : sms;
  flash_tc_kernel<kD, kMasked, kBf16Scores><<<blocks, L::kThreads, smem, stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <bool kMasked, bool kBf16Scores = false>
int launch_typed(const Params& p, int B, int dtype, cudaStream_t s) {
  if (p.D < 1 || p.D > 128) return (int)cudaErrorInvalidValue;
  const bool narrow = p.D <= 64;
  if (dtype == 0)
    return narrow ? launch_fp32<4, kMasked, kBf16Scores>(p, B, s) : launch_fp32<8, kMasked, kBf16Scores>(p, B, s);
  if (dtype == 1)
    return narrow ? tc::launch<64, kMasked, kBf16Scores>(p, B, s) : tc::launch<128, kMasked, kBf16Scores>(p, B, s);
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
