// The Hopper attention body for bf16 storage at head dim 64 without a bias:
// every K1 (tiny_attention.cu) and K2 (mh_flash.cu) launch of the denoise
// loop, the SR refiners and entry(), and every K5a (flash_lse.cu) and K6a
// (flash_t.cu) launch of the training step and the opt-in loop at the pano's
// spatial self-attention (kernels.wgmma_route). It replaces, for those
// launches, the `mma.sync` body of attn_mma.cuh, and with it the TPU kernels
// imagine360_tpu/ops/pallas_attention.py: _mh_flash_kernel (K2),
// _tiny_packed_kernel (K1), _flash_kernel (K5a) and _flash_kernel_t (K6a).
//
// What it computes is what i360::flash_tile_mma computes for a problem
// without a bias: softmax(q·kᵀ·scale)·v per (batch, head), keys at or beyond
// Sk given the finite kNegInf, a running max and sum in log2 units, P = 2^(s
// - m) while the row sum is taken over the unrounded P, the output divided
// by the sum at the end (a zero sum replaced by 1). Three compile options
// (attn_wgmma_tile's template arguments) cover the four kernels:
// - SPLIT_P (K5a, K6a): P·V on the exact split hi = bf16(p), lo = bf16(p -
//   hi), two products a k-step, since the kernels they replace keep P in
//   float32 through P·V; without it (K1, K2) P is rounded once to bf16.
// - LSE (K5a): the row's log-sum-exp (m + log2 l)·ln 2 in float32 [B, H, Sq],
//   for rows below Sq, the residual of K5b and K5c.
// - SEQ_MINOR (K6a): q, k, v [B, H, 64, S], the sequence contiguous, read
//   as they lie (no transposed copy) and the output [B, H, Sq, 64]; without
//   it the natural [B, S, H·64] layout of K1, K2 and K5a.
//
// What bounds it on the H100: at its sites (Sq, Sk of 1024 to 33792 at
// D = 64) a (batch, head) problem does 4·Sq·Sk·64 operations on
// (2·Sq + 2·Sk)·64·2 bytes, far above the card's ~295 bf16 operations a
// byte: it is bound by operations, 989 TFLOP/s bf16 on the tensor cores.
// At D = 64 the softmax is a large share of that work: each key tile's
// 2^x is one MUFU op a logit, and with the scale, max, sum and bf16 packing
// the softmax takes about as many cycles of the SM as the tile's two
// products take on the tensor cores, so it has to run under them. The split
// adds a third product and the lo arithmetic (an unpack, two subtractions
// and a pack a pair of logits).
//
// What held the `mma.sync` body back, and what this design does about it:
// - The instruction. `mma.sync.m16n8k16` is a warp's 16×8×16 with both
//   operands reloaded from shared memory by ldmatrix every k-step. Here
//   both products are `wgmma.mma_async` of a warpgroup (4 warps, 64 query
//   rows): S = Q·Kᵀ is m64n128k16 with Q and the K tile read from shared
//   memory through descriptors (4 k-steps at D = 64); O += P·V is
//   m64n64k16 with P taken from registers (the S accumulator's layout,
//   packed to bf16 pairs, is the A-register fragment, as FlashAttention-3
//   does it) and the V tile read from shared memory through a descriptor.
// - The copies. A block is three warpgroups: one producer and two
//   consumers of 64 query rows each (BQ = 128). One producer thread issues
//   TMA copies (cp.async.bulk.tensor) of the Q tile once and of the K and V
//   tiles into a ring of stages; "full" mbarriers (K and V apart, so Q·Kᵀ
//   starts while V lands) carry the bytes, "empty" mbarriers return a stage
//   when both consumers are done with it. No thread computes an address or
//   issues a copy of its own, and there is no block-wide barrier in the key
//   loop: each consumer waits only for its own tiles. `setmaxnreg` moves
//   registers from the producer (40) to the consumers (232).
// - The key tiles. 128 keys a tile (kMmaBK is 64), so the max/rescale round
//   trip of the online softmax is paid half as often.
// - The softmax under the products. Inside a warpgroup, tile t's
//   Q·Kᵀ and tile t-1's P·V are issued back to back, and tile t's softmax
//   runs while P·V is on the tensor cores (FlashAttention-3's
//   intra-warpgroup overlap; the arithmetic is the one-tile-at-a-time
//   order's). P of tiles t-1 and t live in two register sets that swap
//   roles, the loop unrolled by two: a copy between them let ptxas coalesce
//   the two and serialise the products (C7513). Three stages keep the next
//   tile's copies in flight while two tiles are in use. 2^x is
//   ex2.approx.ftz (exp2f adds three instructions a logit to keep results
//   below 2^-126 subnormal; those add nothing to a sum that holds a 1).
//   Measured against each other on an H100 (scripts/torch_wgmma_check.py
//   times this body against flash_tile_mma; the variants are in PERF.md §6,
//   scripts/torch_wgmma_variants.py): one tile at a time with two stages,
//   7.0 ms at the K2 pano site; the overlap, 6.6 ms; with ex2.approx.ftz,
//   5.8-5.9 ms; two stages or four, slower or even.
// - The split's registers. With 128-key tiles and the overlap a consumer
//   thread holds S (64 floats), O (32) and P hi + lo of two tiles (128):
//   224 of its 232 registers before the row statistics. ptxas fits that
//   without a spill, so K5a and K6a take K1's and K2's form: on an H100 it
//   measured 1-10% faster at their sites than 64-key tiles with the overlap
//   (S 32 floats, P of two tiles 64 registers) or 128-key tiles one at a
//   time (no P of a previous tile live), two forms that
//   scripts/torch_wgmma_variants.py builds by editing a copy of this header
//   (PERF.md §6).
// The two consumers also interleave on the SM (one's softmax under the
// other's products); FlashAttention-3's ping-pong (named barriers forcing
// that interleave) is left out, as is a persistent grid. The query tile is
// the fastest grid axis, so the blocks that run together share one (batch,
// head)'s K and V in L2.
//
// Operands in shared memory, all 128-byte swizzled as TMA writes them:
// - natural layout: each operand has a 4-D tensor map, dims {64, H, S, B},
//   strides {128, 128·H, 128·H·S} bytes. A tile is one box of rows of 128
//   bytes (one position's 64 head-dim elements): Q and K are K-major, V is
//   MN-major (the descriptor's transpose bit for B), so no transposed copy of
//   V is made.
// - sequence-minor layout (K6a): 3-D maps {S, 64, B·H}, boxes of 64
//   positions × 64 head-dim rows (rows of 128 bytes, one head-dim element's
//   64 positions); a 128-position tile is two boxes. Q is wgmma's A operand
//   MN-major (the transpose bit for A), K in S = Q·Kᵀ is B MN-major (its two
//   boxes one descriptor's LBO apart), and V in O = P·V is B K-major with no
//   transpose bit. TMA needs the row stride S·2 bytes to be a multiple of
//   16: Sq and Sk multiples of 8 (the launcher refuses the rest).
// A key or query past S is zero-filled by the copy inside its own (batch,
// head) slab and never reads the next one's; zero keys still give logit 0,
// so keys at or beyond Sk are masked in registers. The output tile is staged
// in the consumer's own Q rows (128-byte swizzled, as its map reads them)
// and written by a TMA store, which clips the rows past Sq; the output map
// is {64, H, S, B} (natural) or {64, Sq, B·H} (sequence-minor).
//
// Budget: shared memory 16 KB of Q (128 × 64 bf16) and, per stage, 32 KB
// of K and V (2 × 128 × 64 bf16): 112 KB at three stages, plus the
// barriers and 1 KB to align the tiles to the 1024 bytes of the swizzle
// pattern (the block may have 227 KB). A block takes 384 threads;
// the registers (168 a thread at launch, __launch_bounds__(384, 1)) allow
// one block an SM. The ptxas report that build_library() keeps beside the
// library gives the registers and spills.
//
// The tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// fetched from the driver with cudaGetDriverEntryPointByVersion, so the
// library links nothing new) and passed as __grid_constant__ parameters.
// Raw PTX (cp.async.bulk.tensor, mbarrier, wgmma, setmaxnreg), no CUTLASS
// or CuTe header. These primitives also serve wgmma_ops.cuh (K6b, K7).
#pragma once

#include <cuda.h>   // CUtensorMap and the types of cuTensorMapEncodeTiled (no link)

#include "attn_mma.cuh"

namespace i360 {

constexpr int kWgD = 64;            // the head dim this body takes
constexpr int kWgBQ = 128;          // query rows a block: two consumers of 64
constexpr int kWgBK = 128;          // keys a tile
constexpr int kWgStages = 3;        // stages of the K/V ring
constexpr int kWgThreads = 384;     // producer warpgroup + two consumer warpgroups
constexpr int kWgQBytes = kWgBQ * kWgD * 2;    // the Q tile
constexpr int kWgKVBytes = kWgBK * kWgD * 2;   // one K or V tile
constexpr int kWgBoxBytes = 64 * kWgD * 2;     // one box of a sequence-minor tile
constexpr int kWgProducerRegs = 40;
constexpr int kWgConsumerRegs = 232;
// what the register moves need from the block's pool at launch (168 a thread)
constexpr int kWgLaunchRegs = (kWgProducerRegs * 128 + kWgConsumerRegs * 256) / kWgThreads;

// Q, K and V tiles, then the barriers: Q's, and per stage K full, V full
// and empty; plus 1 KB to align the tiles
constexpr size_t kWgSmemBytes = 1024 + (size_t)kWgQBytes + (size_t)kWgKVBytes * 2 * kWgStages +
                                8 * (1 + 3 * kWgStages);

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 5-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// One box from shared memory to a 4-D tensor map; rows outside it are
// clipped. Waits until the shared memory has been read.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"((uint64_t)map), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The same to a 3-D tensor map.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      ::"l"((uint64_t)map), "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)map) : "memory");
}

// Descriptor of a 128-byte-swizzled tile of 128-byte rows at shared
// address `addr` (1024-byte aligned for the pattern, or advanced within a
// row by a k-step): 8-row groups 1024 bytes apart (SBO), LBO unused (1).
// The same layout serves a K-major operand (Q and K natural, V
// sequence-minor: 32 bytes a k-step) and an MN-major one of 64 columns (V
// natural, Q sequence-minor: 16 rows a k-step, 2048 bytes on).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// The same for an MN-major operand wider than one 128-byte row (K
// sequence-minor at 128 keys): its 64-column boxes `lbo` bytes apart (LBO).
__device__ __forceinline__ uint64_t wg_desc_lbo(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Descriptor of a no-swizzle tile of 16-byte core matrices at shared
// address `addr`: `lbo` bytes between core matrices along K, `sbo` along M
// or N (layout type 0).
__device__ __forceinline__ uint64_t wg_desc_noswz(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are still running.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads and writes of accumulator registers
// across the asynchronous products.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= a·b for one m64n128k16 step, a and b from shared memory, K-major
// (TA, TB 0) or MN-major (1: the transpose bit); scale_d 0: d = a·b.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d += a·b for one m64n64k16 step: a the bf16 A fragment in registers, b
// from shared memory MN-major (TB 1: the transpose bit) or K-major (0).
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// 2^x on the MUFU alone, results below 2^-126 flushed to 0 (exp2f adds
// three instructions to keep them subnormal; they add nothing to a sum
// that holds a 1).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// P of one key tile as the A fragments of its kWgBK/16 k-steps of P·V,
// bf16 pairs: hi = bf16(p) and, with SPLIT_P, lo = bf16(p - hi).
template <bool SPLIT_P> struct WgP {
  uint32_t hi[kWgBK / 16][4];
  uint32_t lo[SPLIT_P ? kWgBK / 16 : 1][4];
};

// Scale one key tile's logits to log2 units and take its row max: s[4i + j]
// is key 8i + 2tg + (j & 1) of row g (j < 2) or g + 8; keys at or beyond nk
// (MASK: the tile is the last, partial one) become kNegInf.
template <bool MASK>
__device__ __forceinline__ void wg_scale_max(float (&s)[kWgBK / 2], float sl2, int nk, int tg,
                                             float& mx0, float& mx1) {
#pragma unroll
  for (int i = 0; i < kWgBK / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = s[4 * i + j] * sl2;
      if (MASK && 8 * i + 2 * tg + (j & 1) >= nk) x = kNegInf;
      s[4 * i + j] = x;
      if (j < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
  }
}

// The online softmax of one key tile's S (nk of its 128 keys in range):
// log2 units, the key mask, the row max over the quad, α = 2^(m_old -
// m_new), the sums rescaled by α and added the unrounded P = 2^(S - m),
// and P packed to bf16 (with SPLIT_P also its rest) as the A fragments of
// the 8 k-steps of P·V (16 keys each: the 8-key column tiles 2kk, 2kk + 1).
template <bool SPLIT_P>
__device__ __forceinline__ void wg_softmax(float (&sc)[kWgBK / 2], float sl2, int nk, int tg,
                                           float& m0, float& m1, float& l0, float& l1,
                                           float& alpha0, float& alpha1, WgP<SPLIT_P>& pa) {
  float mx0 = m0, mx1 = m1;
  if (nk < kWgBK) wg_scale_max<true>(sc, sl2, nk, tg, mx0, mx1);
  else wg_scale_max<false>(sc, sl2, nk, tg, mx0, mx1);
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  alpha0 = ex2_ftz(m0 - mx0);
  alpha1 = ex2_ftz(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  l0 *= alpha0;
  l1 *= alpha1;
#pragma unroll
  for (int kk = 0; kk < kWgBK / 16; ++kk) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = 2 * kk + hf;
      const float p0 = ex2_ftz(sc[4 * i] - m0), p1 = ex2_ftz(sc[4 * i + 1] - m0);
      const float p2 = ex2_ftz(sc[4 * i + 2] - m1), p3 = ex2_ftz(sc[4 * i + 3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa.hi[kk][2 * hf] = pack_bf16(p0, p1);
      pa.hi[kk][2 * hf + 1] = pack_bf16(p2, p3);
      if constexpr (SPLIT_P) {
        pa.lo[kk][2 * hf] = pack_bf16_rest(p0, p1, pa.hi[kk][2 * hf]);
        pa.lo[kk][2 * hf + 1] = pack_bf16_rest(p2, p3, pa.hi[kk][2 * hf + 1]);
      }
    }
  }
}

// O's rows g (α0) and g + 8 (α1) rescaled.
__device__ __forceinline__ void wg_rescale(float (&o)[32], float alpha0, float alpha1) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o[4 * i] *= alpha0;
    o[4 * i + 1] *= alpha0;
    o[4 * i + 2] *= alpha1;
    o[4 * i + 3] *= alpha1;
  }
}

// One query tile (128 rows) of one (batch, head) problem; blockIdx.x is
// (batch × head) × query tiles + query tile. The maps are those of
// launch_attn_wgmma<SEQ_MINOR>. `lse` (LSE) points at the float [B, H, Sq]
// rows. `sl2` is scale·log2(e). `smem` has kWgSmemBytes bytes. K1 and K2
// take the defaults: no lse, P rounded once, the natural layout.
template <bool LSE = false, bool SPLIT_P = false, bool SEQ_MINOR = false>
__device__ __forceinline__ void attn_wgmma_tile(const CUtensorMap* mq, const CUtensorMap* mk,
                                                const CUtensorMap* mv, const CUtensorMap* mo,
                                                float* lse, int Sq, int Sk, int H, int nqt,
                                                float sl2, unsigned char* smem) {
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + kWgQBytes;
  const uint32_t sV = sK + kWgStages * kWgKVBytes;
  const uint32_t barQ = sV + kWgStages * kWgKVBytes;
  auto full_k = [&](int s) { return barQ + 8 + 8 * s; };
  auto full_v = [&](int s) { return barQ + 8 + 8 * (kWgStages + s); };
  auto empty = [&](int s) { return barQ + 8 + 8 * (2 * kWgStages + s); };

  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * kWgBQ;
  const int b = bh / H, h = bh - b * H;
  const int ntiles = (Sk + kWgBK - 1) / kWgBK;
  const int ncons = q0 + 64 < Sq ? 2 : 1;   // consumers with query rows in range
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 4 * ncons);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgProducerRegs));
    if (threadIdx.x == 0) {
      tma_prefetch(mq);
      tma_prefetch(mk);
      tma_prefetch(mv);
      tma_prefetch(mo);
      mbar_expect_tx(barQ, kWgQBytes);
      if constexpr (SEQ_MINOR) {   // the two consumers' boxes of 64 queries
        tma_load_3d(sQ, mq, barQ, q0, 0, bh);
        tma_load_3d(sQ + kWgBoxBytes, mq, barQ, q0 + 64, 0, bh);
      } else {
        tma_load_4d(sQ, mq, barQ, 0, h, q0, b);
      }
      // the K or V tile of keys k0 .. k0 + kWgBK - 1 into dst
      auto load_kv = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int k0) {
        if constexpr (SEQ_MINOR) {
#pragma unroll
          for (int j = 0; j < kWgBK / 64; ++j)
            tma_load_3d(dst + j * kWgBoxBytes, map, bar, k0 + 64 * j, 0, bh);
        } else {
          tma_load_4d(dst, map, bar, 0, h, k0, b);
        }
      };
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kWgStages;
        if (t >= kWgStages) mbar_wait(empty(s), ((t / kWgStages) - 1) & 1);
        mbar_expect_tx(full_k(s), kWgKVBytes);
        load_kv(sK + s * kWgKVBytes, mk, full_k(s), t * kWgBK);
        mbar_expect_tx(full_v(s), kWgKVBytes);
        load_kv(sV + s * kWgKVBytes, mv, full_v(s), t * kWgBK);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
    const int cw = wg - 1;               // this consumer's 64 rows of the tile
    if (cw >= ncons) return;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tg = lane & 3;
    const uint32_t sQc = sQ + cw * (kWgQBytes / 2);
    const uint64_t dq = wg_desc(sQc);
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;   // running max of rows g and g + 8, log2 units
    float l0 = 0.f, l1 = 0.f;           // this thread's part of their running sums
    float sc[kWgBK / 2];                // S of the tile in flight
    WgP<SPLIT_P> pa;                    // P of the tile whose P·V is next
    mbar_wait(barQ, 0);

    // S = Q·K_sᵀ issued (4 k-steps at D = 64): natural, Q and K K-major (32
    // bytes a k-step); sequence-minor, both MN-major (16 head-dim rows,
    // 2048 bytes, a k-step; K's two 64-key boxes kWgBoxBytes apart)
    auto qk = [&](int s) {
#pragma unroll
      for (int ks = 0; ks < kWgD / 16; ++ks) {
        if constexpr (SEQ_MINOR)
          wgmma_qk<1, 1>(sc, dq + 128 * ks,
                         wg_desc_lbo(sK + s * kWgKVBytes, kWgBoxBytes) + 128 * ks, ks);
        else
          wgmma_qk<0, 0>(sc, dq + 2 * ks, wg_desc(sK + s * kWgKVBytes) + 2 * ks, ks);
      }
    };
    // O += P·V issued from the descriptor dv of stage s's V tile, with
    // SPLIT_P the lo product before the hi one at each k-step of 16 keys:
    // natural, V MN-major (16 key rows, 2048 bytes, a k-step);
    // sequence-minor, V K-major (32 bytes a k-step in a box of 64 keys)
    auto pv = [&](uint64_t dv, WgP<SPLIT_P>& p) {
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        const uint64_t d = SEQ_MINOR ? dv + (kk / 4) * (kWgBoxBytes >> 4) + 2 * (kk % 4)
                                     : dv + 128 * kk;
        if constexpr (SPLIT_P) wgmma_m64n64k16_rs<!SEQ_MINOR>(o, p.lo[kk], d);
        wgmma_m64n64k16_rs<!SEQ_MINOR>(o, p.hi[kk], d);
      }
    };

    // tile 0: S, then its softmax (O is 0: its rescale is a no-op)
    mbar_wait(full_k(0), 0);
    wgmma_fence();
    qk(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    float alpha0, alpha1;
    wg_softmax(sc, sl2, min(kWgBK, Sk), tg, m0, m1, l0, l1, alpha0, alpha1, pa);

    // tile t: S_t = Q·K_tᵀ and O += P_{t-1}·V_{t-1} issued back to back; the
    // softmax of S_t runs while P·V is on the tensor cores; then O is
    // rescaled by α_t before P_t·V_t is issued with the next tile. The
    // arithmetic is the one-tile-at-a-time order's: O_t = O_{t-1}·α_t + P_t·V_t.
    // P_{t-1} and P_t live in two register sets that swap roles from tile to
    // tile (the loop is unrolled by two), so no register a running product
    // reads is written before it completes.
    auto step = [&](int t, WgP<SPLIT_P>& pin, WgP<SPLIT_P>& pout) {
      const int s = t % kWgStages, sp = (t - 1) % kWgStages;
      mbar_wait(full_k(s), (t / kWgStages) & 1);
      wgmma_fence();
      qk(s);
      wgmma_commit();
      mbar_wait(full_v(sp), ((t - 1) / kWgStages) & 1);
      const uint64_t dv = wg_desc(sV + sp * kWgKVBytes);
      pv(dv, pin);
      wgmma_commit();
      wgmma_wait<1>();                  // S_t has landed; P_{t-1}·V_{t-1} may still run
      fence_regs(sc);
      wg_softmax(sc, sl2, min(kWgBK, Sk - t * kWgBK), tg, m0, m1, l0, l1, alpha0, alpha1, pout);
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(sp));   // this warp is done with stage sp
      wg_rescale(o, alpha0, alpha1);
    };
    // the last tile's P·V
    auto last = [&](WgP<SPLIT_P>& pin) {
      const int sl = (ntiles - 1) % kWgStages;
      mbar_wait(full_v(sl), ((ntiles - 1) / kWgStages) & 1);
      const uint64_t dv = wg_desc(sV + sl * kWgKVBytes);
      fence_regs(o);
      wgmma_fence();
      pv(dv, pin);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(sl));
    };
    WgP<SPLIT_P> pn;
    int t = 1;
    for (; t + 1 < ntiles; t += 2) {
      step(t, pa, pn);
      step(t + 1, pn, pa);
    }
    if (t < ntiles) {
      step(t, pa, pn);
      last(pn);
    } else {
      last(pa);
    }

    // epilogue: the sums over the quad; with LSE the rows' (m + log2 l)·ln 2
    // (a zero sum replaced by 1, as before the divide); divide by the sum,
    // bf16 into this consumer's own Q rows (its last Q·Kᵀ has completed)
    // 128-byte swizzled as the output map reads them, then one TMA store
    // that clips the rows past Sq
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    if constexpr (LSE) {
      l0 = l0 == 0.f ? 1.f : l0;
      l1 = l1 == 0.f ? 1.f : l1;
      const int r = q0 + 64 * cw + warp * 16 + g;
      float* lrow = lse + (long)bh * Sq;
      if (tg == 0 && r < Sq) lrow[r] = m0 == kNegInf ? kNegInf : (m0 + log2f(l0)) * kLn2;
      if (tg == 0 && r + 8 < Sq) lrow[r + 8] = m1 == kNegInf ? kNegInf : (m1 + log2f(l1)) * kLn2;
    }
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    const uint32_t row = sQc + (warp * 16 + g) * 128 + tg * 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t chunk = (uint32_t)((i ^ g) << 4);   // rows g and g + 8: the same pattern
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(row + chunk),
                   "r"(pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0)) : "memory");
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(row + 8 * 128 + chunk),
                   "r"(pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1)) : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    if ((threadIdx.x & 127) == 0) {
      if constexpr (SEQ_MINOR) tma_store_3d(mo, sQc, 0, q0 + 64 * cw, bh);
      else tma_store_4d(mo, sQc, 0, h, q0 + 64 * cw, b);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, fetched once (null if the driver
// has none).
typedef CUresult (*wg_encode_fn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline wg_encode_fn wg_encoder() {
  static wg_encode_fn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &res) != cudaSuccess)
      return (wg_encode_fn) nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) !=
        cudaSuccess)
      return (wg_encode_fn) nullptr;
#endif
    return res == cudaDriverEntryPointSuccess ? (wg_encode_fn)p : (wg_encode_fn) nullptr;
  }();
  return fn;
}

// A map of `rank` dims (innermost first) of `type` with the given byte
// strides of dims 1.., boxes `box`, the given swizzle, zero fill outside.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                       cuuint32_t rank, const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  wg_encode_fn encode = wg_encoder();
  if (encode == nullptr) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same for a bf16 map under the 128-byte swizzle.
inline bool encode_wg_map(CUtensorMap* map, const void* ptr, cuuint32_t rank,
                          const cuuint64_t* dims, const cuuint64_t* strides,
                          const cuuint32_t* box) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, rank, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// The map of one [B, S, H·64] bf16 operand: dims {64, H, S, B}, boxes of
// `rows` rows of one head.
inline bool make_wg_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)kWgD, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)kWgD * 2, (cuuint64_t)kWgD * 2 * H,
                                 (cuuint64_t)kWgD * 2 * H * S};
  const cuuint32_t box[4] = {(cuuint32_t)kWgD, 1, (cuuint32_t)rows, 1};
  return encode_wg_map(map, ptr, 4, dims, strides, box);
}

// The map of one [BH, n1, n0] bf16 operand: dims {n0, n1, BH}, boxes of
// b0 × b1 elements of one slab (sequence-minor q/k/v: {S, 64, BH}, boxes
// of 64 positions × 64 head-dim rows; its output: {64, Sq, BH}, boxes of
// 64 rows).
inline bool make_wg_map_3d(CUtensorMap* map, const void* ptr, int BH, int n1, int n0, int b1,
                           int b0) {
  const cuuint64_t dims[3] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)n0 * 2, (cuuint64_t)n0 * 2 * n1};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  return encode_wg_map(map, ptr, 3, dims, strides, box);
}

// Launch `kern` (a __global__ taking the four maps, then `extra` (K5a: the
// lse pointer), Sq, Sk, H, the query tiles a (batch, head) and
// scale·log2(e)) for attn_wgmma_tile<..., SEQ_MINOR> on bf16 q/k/v/out
// [B, S, H·64], or with SEQ_MINOR q/k/v [B, H, 64, S] and out
// [B, H, Sq, 64]. Refuses (cudaErrorInvalidValue) a pointer that is not
// 16-byte aligned, with SEQ_MINOR an Sq or Sk that is no multiple of 8 (the
// maps' row strides), a map the driver does not encode, and a build whose
// launch registers would not cover the consumers' setmaxnreg (the launch
// would wait forever).
template <bool SEQ_MINOR = false, typename Kern, typename... Extra>
int launch_attn_wgmma(Kern kern, const void* q, const void* k, const void* v, void* out, int B,
                      int Sq, int Sk, int H, float scale, cudaStream_t stream, Extra... extra) {
  if ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15) != 0 || B < 1 ||
      Sq < 1 || Sk < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  if constexpr (SEQ_MINOR) {
    const int BH = B * H;
    if (Sq % 8 != 0 || Sk % 8 != 0 || !make_wg_map_3d(&mq, q, BH, kWgD, Sq, kWgD, 64) ||
        !make_wg_map_3d(&mk, k, BH, kWgD, Sk, kWgD, 64) ||
        !make_wg_map_3d(&mv, v, BH, kWgD, Sk, kWgD, 64) ||
        !make_wg_map_3d(&mo, out, BH, Sq, kWgD, 64, kWgD))
      return (int)cudaErrorInvalidValue;
  } else {
    if (!make_wg_map(&mq, q, B, Sq, H, kWgBQ) || !make_wg_map(&mk, k, B, Sk, H, kWgBK) ||
        !make_wg_map(&mv, v, B, Sk, H, kWgBK) || !make_wg_map(&mo, out, B, Sq, H, kWgBQ / 2))
      return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs < kWgLaunchRegs) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kWgSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int nqt = (Sq + kWgBQ - 1) / kWgBQ;
  const unsigned blocks = (unsigned)((long)B * H * nqt);
  kern<<<blocks, kWgThreads, kWgSmemBytes, stream>>>(mq, mk, mv, mo, extra..., Sq, Sk, H,
                                                     nqt, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace i360
