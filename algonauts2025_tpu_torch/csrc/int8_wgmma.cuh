// int8 GEMM core on Hopper's tensor cores, sm_90a: out = Epi(A B) with A
// (M, K) int8 and B given K-major as Bt (N, K) int8, both row-major, and an
// int32 accumulator that never leaves registers.  Included by both int8
// kernels: w8a8.cu (kernel row 6, one GEMM) and int8_mlp.cu (row 7, two),
// which share the quantize pass and the StoreDequant epilogue below; row
// 6's query and key take StoreDequantRope, which rotates them as well.
// flash_attention.cu does not include it: its helpers below (mbarriers,
// TMA, named barriers, setmaxnreg, wgmma descriptors and fences, the
// cuTensorMapEncodeTiled lookup) are copies of that file's.
//
// What bounds an int8 GEMM on an H100: at the ViT-G MLP's shapes (M =
// 32768, K = 1408, N = 6144 and back) 2 M K N = 0.567 TOP a GEMM against
// ~0.1 GB of device memory, so operations: 0.29 ms at 1979 TOP/s, reached
// only by wgmma.mma_async ... .s32.s8.s8 (SASS IGMMA).  Next come the
// operands' re-reads from L2: a tile of BM x BN reads A's bytes N / BN
// times and B's M / BM times (4.43 GB a ViT-G MLP GEMM in 128 x 128 tiles),
// and fc1's epilogue, a gelu and a requantization for each of its 201 M
// hidden values, which has the CUDA cores' work of the same order as the
// tensor cores'.
//
// Design.  Persistent: one block an SM (gridDim.x <= the SMs) walks the
// output tiles t = blockIdx.x, blockIdx.x + gridDim.x, ... in row order, so
// that the blocks at work at once share their A row panels in L2 (B, at
// most 8.65 MB here, stays there).  Warp specialised: one producer
// warpgroup, whose elected thread streams 128-deep K stages of A (128 x
// 128 B) and Bt (BN x 128 B) with TMA (2-d tensor maps, 128-byte swizzle:
// one swizzle row is one stage's 128 int8 values, so a k32 step moves the
// descriptor 32 bytes along it) into a ring of kStages stages on mbarriers
// (full: bytes arrived; empty: the stage's consumers are done), tile after
// tile without a pause, so that the next tile's stages load while the
// consumers finish this one; and consumer warpgroups that issue the wgmma
// from shared memory and keep one stage's products in flight while they
// wait for the next.  The producer gives its registers up (setmaxnreg.dec
// to kProducerRegs) and the consumers take them (setmaxnreg.inc to the
// schedule's kConsumerRegs, room for their accumulators and the epilogue).
// wgmma reads an 8-bit B operand only K-major (the transpose bits of its
// descriptor exist for 16-bit types only), hence Bt.  Three schedules
// (Schedule: consumer warpgroups in teams, a team to a tile), fixed at
// compile time for each GEMM:
//   Cooperative: one team of two warpgroups on a 128 x 256 tile, 64 rows
//     each (wgmma m64n256k32): a quarter fewer L2 re-reads than 128 x 128,
//     where a tile's 48 stages (fc2) make its epilogue a small share;
//   PingPong: two teams of one warpgroup, each on its own 128 x 128 tile
//     (two m64n128k32 a k32 step), in turns round a pair of named barriers,
//     so that one's epilogue runs while the other's products do (row 6,
//     whose tiles have 11 stages);
//   PingPongPairs: two teams of two warpgroups (64 rows each, m64n128k32),
//     in turns: twice the warps for an epilogue that the CUDA cores bound
//     (fc1's gelu), at 112 registers a consumer thread.
// The epilogue goes out through shared memory: each consumer warpgroup
// writes its fragment 64 rows x 128 bytes at a time (kChunkBytes, two
// buffers) in the 128-byte swizzle, and one of its threads stores each
// piece with TMA (cp.async.bulk.tensor), which leaves out the rows past M
// and the columns past N.  Ragged M is zero filled by TMA on the way in;
// K and N must be multiples of 128 (a 256-wide tile past N reads zeros
// for its last 128 columns and stores none of them).
// Epi sees each thread's accumulator fragment, whose (row, column) layout
// is the fp32 one of flash_attention.cu: rows r0 = 16 warp + lane / 4 and
// r0 + 8 of a 64-row wgmma, column pairs 8 j + 2 (lane % 4) + {0, 1}.
//
// Quantization is the JAX package's (ops/quant.py int8_matmul): true
// division (__fdiv_rn), round half to even, clamp to +-127; fmaxf/fminf
// turn a NaN quotient (a NaN-poisoned scale) into a bound.  The clamp
// comes before the rounding (rint and a clamp to integers commute), and
// the rounding is one float addition of 1.5 * 2^23, whose sum has a unit
// last place over [-127, 127]: bit for bit rintf and the conversion, on
// the FMA pipe instead of the conversion unit.  The dequantization is one
// fused multiply-add, fma(acc, scale * w_scale[n], bias[n]), with _rn
// intrinsics.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace i8wg {

constexpr int kBM = 128;                // rows of a tile
constexpr int kBK = 128;                // int8 depth of a stage: one 128-byte swizzle row
constexpr int kProducerRegs = 24;       // the registers setmaxnreg leaves a producer thread
constexpr int kChunkBytes = 64 * 128;   // one staged piece of the output: 64 rows x 128 bytes
constexpr int kGroupPairs = 4;          // column pairs a thread's epilogue takes together
constexpr int kMaxSmem = 232448;        // the dynamic shared memory a block may use

// A schedule: kWarpgroups consumer warpgroups in teams of kTeam, each team
// on its own kBM x kBN tile (kRows = kBM / kTeam rows a warpgroup), the
// block's tiles dealt to the teams in turn; kStages ring stages; the
// registers setmaxnreg gives a consumer thread (the block holds kThreads x
// kLaunchRegs at launch, the most __launch_bounds__(kThreads, 1) allows).
template <int kWarpgroups_, int kTeam_, int kBN_, int kStages_, int kConsumerRegs_>
struct Schedule {
  static constexpr int kWarpgroups = kWarpgroups_;
  static constexpr int kTeam = kTeam_;
  static constexpr int kTeams = kWarpgroups / kTeam;
  static constexpr int kBN = kBN_;
  static constexpr int kStages = kStages_;
  static constexpr int kConsumerRegs = kConsumerRegs_;
  static constexpr int kRows = kBM / kTeam;
  static constexpr int kHalves = kRows / 64;      // its 64-row wgmmas a k32 step
  static constexpr int kAcc = kHalves * kBN / 2;  // its int32 accumulators a thread
  static constexpr int kConsumers = 128 * kWarpgroups;
  static constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
  static constexpr int kLaunchRegs = (65536 / kThreads < 255 ? 65536 / kThreads : 255) / 8 * 8;
  static_assert(kConsumers * kConsumerRegs + 128 * kProducerRegs <= kThreads * kLaunchRegs,
                "setmaxnreg must stay within the registers the block holds");
  static_assert(kTeams <= 2 && kHalves >= 1 && (kBN == 128 || kHalves == 1), "a schedule the kernel runs");
};

// both consumer warpgroups on one 128 x 256 tile, 64 rows each (m64n256k32)
struct Cooperative : Schedule<2, 2, 256, 4, 240> {};
// each consumer warpgroup on its own 128 x 128 tile (two m64n128k32), in turns
struct PingPong : Schedule<2, 1, 128, 6, 240> {};
// two teams of two consumer warpgroups, each team on its own 128 x 128 tile
// (a warpgroup's 64 rows: m64n128k32), the teams in turns
struct PingPongPairs : Schedule<4, 2, 128, 5, 112> {};

// Shared memory of a schedule, in bytes from a 1024-aligned base: the A
// ring, the Bt ring, two output pieces a consumer warpgroup, the full and
// empty mbarriers; + the alignment slack.
template <class S>
struct Layout {
  static constexpr int kABytes = kBM * kBK;
  static constexpr int kBBytes = S::kBN * kBK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kB = S::kStages * kABytes;
  static constexpr int kOut = kB + S::kStages * kBBytes;
  static constexpr int kBar = kOut + S::kWarpgroups * 2 * kChunkBytes;
  static constexpr int kBytes = kBar + 16 * S::kStages + 1024;
  static_assert(kBytes <= kMaxSmem, "the block's shared memory");
};

struct Params {
  CUtensorMap a;         // A (M, K) int8 row-major, 128 x 128 boxes
  CUtensorMap b;         // Bt (N, K) int8 row-major, BN x 128 boxes
  CUtensorMap out;       // (M, N) row-major, 64-row x 128-byte boxes
  const float* w_scale;  // (N,)
  const float* bias;     // (N,) or null
  int M, N, K;
};

__device__ __forceinline__ int quantize(float v, float s) {
  const float c = fminf(fmaxf(__fdiv_rn(v, s), -127.f), 127.f);
  return __float_as_int(__fadd_rn(c, 12582912.f)) - 0x4B400000;
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

// One TMA tile of shared memory into a 2-d tensor map, in this thread's
// bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Until all but the newest of this thread's bulk groups have read their
// shared memory.
__device__ __forceinline__ void bulk_wait_read_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}
// Until all of this thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

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

// d[kOff ..) += A B for one k32 step, A (64 x 32) and B (32 x 128) in
// shared memory, both K-major (128-byte swizzle): 64 accumulators.
template <int kOff, int N>
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[N], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[kOff + 0]), "+r"(d[kOff + 1]), "+r"(d[kOff + 2]), "+r"(d[kOff + 3]), "+r"(d[kOff + 4]), "+r"(d[kOff + 5]), "+r"(d[kOff + 6]), "+r"(d[kOff + 7]),
        "+r"(d[kOff + 8]), "+r"(d[kOff + 9]), "+r"(d[kOff + 10]), "+r"(d[kOff + 11]), "+r"(d[kOff + 12]), "+r"(d[kOff + 13]), "+r"(d[kOff + 14]), "+r"(d[kOff + 15]),
        "+r"(d[kOff + 16]), "+r"(d[kOff + 17]), "+r"(d[kOff + 18]), "+r"(d[kOff + 19]), "+r"(d[kOff + 20]), "+r"(d[kOff + 21]), "+r"(d[kOff + 22]), "+r"(d[kOff + 23]),
        "+r"(d[kOff + 24]), "+r"(d[kOff + 25]), "+r"(d[kOff + 26]), "+r"(d[kOff + 27]), "+r"(d[kOff + 28]), "+r"(d[kOff + 29]), "+r"(d[kOff + 30]), "+r"(d[kOff + 31]),
        "+r"(d[kOff + 32]), "+r"(d[kOff + 33]), "+r"(d[kOff + 34]), "+r"(d[kOff + 35]), "+r"(d[kOff + 36]), "+r"(d[kOff + 37]), "+r"(d[kOff + 38]), "+r"(d[kOff + 39]),
        "+r"(d[kOff + 40]), "+r"(d[kOff + 41]), "+r"(d[kOff + 42]), "+r"(d[kOff + 43]), "+r"(d[kOff + 44]), "+r"(d[kOff + 45]), "+r"(d[kOff + 46]), "+r"(d[kOff + 47]),
        "+r"(d[kOff + 48]), "+r"(d[kOff + 49]), "+r"(d[kOff + 50]), "+r"(d[kOff + 51]), "+r"(d[kOff + 52]), "+r"(d[kOff + 53]), "+r"(d[kOff + 54]), "+r"(d[kOff + 55]),
        "+r"(d[kOff + 56]), "+r"(d[kOff + 57]), "+r"(d[kOff + 58]), "+r"(d[kOff + 59]), "+r"(d[kOff + 60]), "+r"(d[kOff + 61]), "+r"(d[kOff + 62]), "+r"(d[kOff + 63])
      : "l"(a), "l"(b), "n"(1));
}

// d += A B for one k32 step, A (64 x 32) and B (32 x 256): 128 accumulators.
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "n"(1));
}

// A Pair of output bits into shared memory.  No "memory" clobber: the
// compiler may move the loads of later columns' scales above it; the
// fence.proxy.async that follows a piece orders the stores.
__device__ __forceinline__ void st_shared(uint32_t at, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(at), "h"(v));
}
__device__ __forceinline__ void st_shared(uint32_t at, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(v));
}
__device__ __forceinline__ void st_shared(uint32_t at, uint2 v) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(at), "r"(v.x), "r"(v.y));
}

// kGroupPairs column pairs of this thread's fragment, accumulators acc[off
// .. off + 4 kGroupPairs) (pair e, row r: acc[off + 4 e + 2 r], + 1), into
// a piece's shared memory at dst, by Epi::pair, in TMA's 128-byte
// swizzle (the 16-byte chunk u of row i at u ^ (i % 8)): the pairs' columns
// are ncol + 8 e + 2 (lane % 4) + {0, 1}, col .. of the piece, their rows
// row + r0 and row + r0 + 8 of the output.  Their scales are loaded first
// and their values computed side by side.
template <int kGroupPairs, class Epi, int N>
__device__ __forceinline__ void write_group(const Params& g, const Epi& epi, const int (&acc)[N], int off,
                                            uint32_t dst, int row, int ncol, int col) {
  const int lane = threadIdx.x % 32, rq = lane / 4, c2 = 2 * (lane % 4);
  const int r0 = 16 * (threadIdx.x / 32 % 4) + rq;
  float2 ws[kGroupPairs], bias[kGroupPairs];
#pragma unroll
  for (int e = 0; e < kGroupPairs; ++e) {
    const int n = ncol + 8 * e + c2;
    ws[e] = make_float2(__ldg(g.w_scale + n), __ldg(g.w_scale + n + 1));
    bias[e] = g.bias ? make_float2(__ldg(g.bias + n), __ldg(g.bias + n + 1)) : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int e = 0; e < kGroupPairs; ++e) {
    const int byte = (col + 8 * e + c2) * static_cast<int>(sizeof(typename Epi::Out));
#pragma unroll
    for (int r = 0; r < 2; ++r)
      st_shared(dst + (r0 + 8 * r) * 128 + (((byte >> 4) ^ rq) << 4) + (byte & 15),
                epi.pair(acc[off + 4 * e + 2 * r], acc[off + 4 * e + 2 * r + 1], ws[e], bias[e], row + r0 + 8 * r,
                         ncol + 8 * e + c2));
  }
}

// The buffer of this warpgroup's next piece, once the piece stored from it
// two pieces earlier has been read.
__device__ __forceinline__ uint32_t piece_begin(uint32_t out_u32, int pieces, int wg) {
  if (threadIdx.x % 128 == 0 && pieces >= 2) bulk_wait_read_all_but_one();
  bar_sync(1 + wg, 128);
  return out_u32 + (pieces & 1) * kChunkBytes;
}

// The piece written at buf stored by the warpgroup's first thread at
// (column nc, row), and counted.
__device__ __forceinline__ void piece_end(const Params& g, uint32_t buf, int nc, int row, int wg, int& pieces) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bar_sync(1 + wg, 128);
  if (threadIdx.x % 128 == 0) {
    if (row < g.M) tma_store(&g.out, buf, nc, row);
    bulk_commit();
  }
  ++pieces;
}

// Epi of this consumer warpgroup's fragment of a tile, out through its two
// pieces of shared memory (at out_u32; ``pieces``: how many it has stored
// so far).  The fragment is kHalves x 64 rows from row0 by BN columns from
// n0, in pieces of 64 rows x 128 bytes of columns, each written once the
// piece stored from the same buffer two pieces earlier has been read, and
// stored by the warpgroup's first thread; a piece is groups of kGroupPairs
// column pairs (write_group).
template <class Epi, class S>
__device__ __forceinline__ void store_tile(const Params& g, const Epi& epi, const int (&acc)[S::kAcc],
                                           uint32_t out_u32, int row0, int n0, int wg, int& pieces) {
  constexpr int kCols = 128 / sizeof(typename Epi::Out);  // columns of a piece
  constexpr int kPairs = kGroupPairs < kCols / 8 ? kGroupPairs : kCols / 8;  // column pairs of a group
  constexpr int kGroups = kCols / (8 * kPairs);           // groups of a piece
  constexpr int kPerHalf = S::kBN / kCols;                // pieces of a 64-row half
#pragma unroll
  for (int p = 0; p < S::kHalves * kPerHalf; ++p) {
    const int nc = n0 + p % kPerHalf * kCols;
    if (nc >= g.N) break;  // the last 128 columns of a 256-wide tile past N
    const uint32_t buf = piece_begin(out_u32, pieces, wg);
    const int row = row0 + 64 * (p / kPerHalf);
#pragma unroll
    for (int q = 0; q < kGroups; ++q)
      write_group<kPairs>(g, epi, acc, 4 * kPairs * (p * kGroups + q), buf, row, nc + 8 * kPairs * q,
                          8 * kPairs * q);
    piece_end(g, buf, nc, row, wg, pieces);
  }
}

// Epi: constructed in each consumer thread from its Args (the device
// scalars, and what else it reads); Out is the output's element type and
// pair(acc0, acc1, w_scale[n .. n + 1], bias[n .. n + 1], m, n) the Pair of
// bits of out[m, n] and out[m, n + 1].
template <class Epi, class S>
__global__ void __launch_bounds__(S::kThreads, 1)
    gemm_kernel(const __grid_constant__ Params g, const typename Epi::Args args) {
  using L = Layout<S>;
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full_bar = base + L::kBar, empty_bar = full_bar + 8 * kStages;
  const int n_m = (g.M + kBM - 1) / kBM, n_n = (g.N + S::kBN - 1) / S::kBN, n_k = g.K / kBK;
  const int n_tiles = n_m * n_n;
  const int tid = threadIdx.x, warp = tid / 32;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 128 * S::kTeam);  // every thread of the team that takes the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= S::kConsumers / 32) {
    // ---- producer warpgroup: one thread streams the stages of the
    // block's tiles, one after the other, into the ring ----
    setmaxnreg_dec<kProducerRegs>();
    if (tid == S::kConsumers) {
      int gs = 0;  // stages loaded by this block
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int mt = t / n_n, nt = t % n_n;
        for (int kt = 0; kt < n_k; ++kt, ++gs) {
          const int s = gs % kStages;
          if (gs >= kStages) mbar_wait(empty_bar + 8 * s, (gs / kStages - 1) & 1);
          mbar_expect_tx(full_bar + 8 * s, L::kStageBytes);
          tma_load(base + s * L::kABytes, &g.a, full_bar + 8 * s, kt * kBK, mt * kBM);
          tma_load(base + L::kB + s * L::kBBytes, &g.b, full_bar + 8 * s, kt * kBK, nt * S::kBN);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: warpgroup wg is member wg % kTeam of team
    // wg / kTeam and owns rows kRows * member .. of its team's tiles; the
    // block's tile i goes to team i % kTeams, whose stages are i n_k .. i
    // n_k + n_k - 1 of the ring ----
    setmaxnreg_inc<S::kConsumerRegs>();
    const int wg = warp / 4, team = wg / S::kTeam, member = wg % S::kTeam;
    // named barriers: 1 + wg for the warpgroup's output pieces; with two
    // teams their turns, kTurn + team: a team issues a tile's products only
    // after the other has issued those of the tile before, so that every
    // earlier fill of the ring's stages has landed before it waits on one
    // (an mbarrier wait by parity cannot tell a fill from the one two before
    // it); the second team hands the first its first turn (its last arrival
    // is left pending when the block ends, and the named barriers start
    // afresh with each block)
    constexpr int kTurn = 1 + S::kWarpgroups, kTurnThreads = 2 * 128 * S::kTeam;
    if (S::kTeams == 2 && team == 1) bar_arrive(kTurn, kTurnThreads);
    const Epi epi(args);
    const uint32_t out_u32 = base + L::kOut + wg * 2 * kChunkBytes;
    int pieces = 0;
    int acc[S::kAcc];
    int i = 0;  // the block's tiles so far
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
      if (S::kTeams == 2 && (i & 1) != team) continue;
      const int mt = t / n_n, nt = t % n_n;
#pragma unroll
      for (int e = 0; e < S::kAcc; ++e) acc[e] = 0;
      int gs = i * n_k;
      if constexpr (S::kTeams == 2) bar_sync(kTurn + team, kTurnThreads);
#pragma unroll 1
      for (int kt = 0; kt < n_k; ++kt, ++gs) {
        const int s = gs % kStages;
        mbar_wait(full_bar + 8 * s, (gs / kStages) & 1);
        const uint32_t a_t = base + s * L::kABytes + S::kRows * member * kBK, b_t = base + L::kB + s * L::kBBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {
          const uint64_t b = smem_desc(b_t + 32 * kk, 16, 1024);
          if constexpr (S::kBN == 256) {
            wgmma_s8_n256(acc, smem_desc(a_t + 32 * kk, 16, 1024), b);
          } else {
            wgmma_s8_n128<0>(acc, smem_desc(a_t + 32 * kk, 16, 1024), b);
            if constexpr (S::kHalves == 2) wgmma_s8_n128<64>(acc, smem_desc(a_t + 64 * kBK + 32 * kk, 16, 1024), b);
          }
        }
        wgmma_commit();
        // the previous stage's products are done: hand its slot back
        wgmma_wait<1>();
        if (kt > 0) mbar_arrive(empty_bar + 8 * ((gs - 1) % kStages));
      }
      if constexpr (S::kTeams == 2) bar_arrive(kTurn + 1 - team, kTurnThreads);
      wgmma_wait<0>();
      mbar_arrive(empty_bar + 8 * ((gs - 1) % kStages));
      fence_regs(acc);
      store_tile<Epi, S>(g, epi, acc, out_u32, mt * kBM + S::kRows * member, nt * S::kBN, wg, pieces);
    }
    if (tid % 128 == 0) bulk_wait_all();  // the stores have read shared memory and landed
  }
}

// The dequantizing epilogue: fma(acc, scales[kScale] * w_scale[n], bias[n])
// in TO (float or __nv_bfloat16).  kScale picks the device scalar of the
// GEMM's int8 A: sx for w8a8.cu (0), the hidden state's sh for
// int8_mlp.cu's fc2 (1).
template <typename TO, int kScale>
struct StoreDequant {
  using Out = TO;
  using Pair = std::conditional_t<sizeof(TO) == 4, uint2, uint32_t>;
  using Args = const float*;  // the device scalars
  float s;
  __device__ explicit StoreDequant(const float* scales) : s(scales[kScale]) {}
  __device__ __forceinline__ Pair pair(int acc0, int acc1, float2 ws, float2 bias, int, int) const {
    const float y0 = dequant(acc0, s, ws.x, bias.x);
    const float y1 = dequant(acc1, s, ws.y, bias.y);
    if constexpr (sizeof(TO) == 4) {
      return make_uint2(__float_as_uint(y0), __float_as_uint(y1));
    } else {
      const __nv_bfloat162 p = __floats2bfloat162_rn(y0, y1);
      return *reinterpret_cast<const uint32_t*>(&p);
    }
  }
};

// Row 6's epilogue for the query and key of the V-JEPA2 attention: the
// bf16 Pair of Dequant (StoreDequant<__nv_bfloat16, 0>), then the fp32
// rotary of that interleaved pair, columns n, n + 1 = lanes j, j + 1 of a
// head (j = n % head_dim) of token t = m % tokens (the rows are (window,
// token) and the tables' rows are the tokens):
//   out[m, n]     = x[n] cos[t, j]         + (-x[n + 1]) sin[t, j]
//   out[m, n + 1] = x[n + 1] cos[t, j + 1] + x[n] sin[t, j + 1]
// with x the dequantized pair rounded to bf16 and widened back, each
// product and the sum rounded (_rn, no contraction), and the result rounded
// to bf16: bit for bit the plain dense's bf16 output rotated by separate
// fp32 multiplies and an add, as models/backbones/vjepa2.py _apply_rope
// does.  head_dim is even and divides 128 (a power of two), so no pair or
// head straddles a tile.  Each pair reads its 16 bytes of the two
// (tokens, head_dim) fp32 tables through L2 (0.36 GB at ViT-G, where the
// tables are 4 MB): that traffic, not the arithmetic, is what the rotation
// adds to the GEMM.
template <class Dequant>
struct StoreDequantRope {
  static_assert(std::is_same_v<typename Dequant::Out, __nv_bfloat16>, "the rotary's output is bf16");
  using Out = __nv_bfloat16;
  using Pair = uint32_t;
  struct Args {
    const float* scales;
    const float* cos;  // (tokens, head_dim) fp32
    const float* sin;
    int tokens, head_dim;
  };
  Dequant dequant;
  const float* cos;
  const float* sin;
  int tokens, lanes;
  __device__ explicit StoreDequantRope(const Args& a)
      : dequant(a.scales), cos(a.cos), sin(a.sin), tokens(a.tokens), lanes(a.head_dim - 1) {}
  __device__ __forceinline__ Pair pair(int acc0, int acc1, float2 ws, float2 bias, int m, int n) const {
    const Pair bits = dequant.pair(acc0, acc1, ws, bias, m, n);
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bits));
    const int at = (m % tokens) * (lanes + 1) + (n & lanes);
    const float2 c = __ldg(reinterpret_cast<const float2*>(cos + at));
    const float2 s = __ldg(reinterpret_cast<const float2*>(sin + at));
    const float o0 = __fadd_rn(__fmul_rn(x.x, c.x), __fmul_rn(-x.y, s.x));
    const float o1 = __fadd_rn(__fmul_rn(x.y, c.y), __fmul_rn(x.x, s.y));
    const __nv_bfloat162 p = __floats2bfloat162_rn(o0, o1);
    return *reinterpret_cast<const uint32_t*>(&p);
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

// A 2-d tensor map over a row-major (rows, cols) matrix of ``bytes``-byte
// elements, in boxes of box_cols x box_rows with the 128-byte swizzle (one
// box row is 128 bytes); a load reads zeros past the edges, a store leaves
// them out.
inline int make_map(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* ptr, int rows, int cols,
                    int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / bytes), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  if constexpr (sizeof(T) == 4)
    return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  else if constexpr (sizeof(T) == 2)
    return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  else
    return CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// out (M, N) = Epi(a (M, K) . bt (N, K)^T) on schedule S; K and N multiples
// of 128.  One block an SM, or one a tile where there are fewer tiles.
// Returns cudaGetLastError() after the launch (0 on success).
template <class Epi, class S>
int gemm(const int8_t* a, const int8_t* bt, void* out, const float* w_scale, const float* bias,
         const typename Epi::Args& args, int M, int N, int K, cudaStream_t stream) {
  using Out = typename Epi::Out;
  if (M < 1 || K < kBK || N < 128 || K % kBK || N % 128) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((M + kBM - 1) / kBM) * ((N + S::kBN - 1) / S::kBN);
  if (tiles > (1ll << 30)) return (int)cudaErrorInvalidValue;
  Params g;
  int err = make_map(&g.a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a, M, K, kBM);
  if (err == 0) err = make_map(&g.b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, bt, N, K, S::kBN);
  if (err == 0) err = make_map(&g.out, tma_type<Out>(), sizeof(Out), out, M, N, 64);
  if (err != 0) return err;
  g.w_scale = w_scale;
  g.bias = bias;
  g.M = M;
  g.N = N;
  g.K = K;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gemm_kernel<Epi, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<S>::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)(tiles < sms ? tiles : sms);
  gemm_kernel<Epi, S><<<grid, S::kThreads, Layout<S>::kBytes, stream>>>(g, args);
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
