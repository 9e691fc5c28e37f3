// The Hopper attention body at head dim 32 under one shared [Sq, Sk] bias,
// in three row layouts (attn_wgmma_bias_tile's LAYOUT):
// - kFbFolded: every bf16 launch of K6b (shared_bias_folded.cu,
//   shared_bias_folded_wgmma_kernel, one per bias dtype) whose bias rows and
//   pointers TMA can take (kernels.folded_wgmma_route); q [BH, Sq, 32], k, v
//   [BH, Sk, 32];
// - kFbNatural: every bf16 D = 32 launch of K3 (shared_bias.cu,
//   shared_bias_wgmma_kernel; kernels.shared_bias_wgmma_route: the WarpAttn
//   sites); q [B, Sq, H, 32], k, v [B, Sk, H, 32], row slot g = b·H + h;
// - kFbSeqMinor: every bf16 D = 32 launch of K6a under a bias shared by all
//   batch rows and heads (flash_t.cu, flash_t_bias_wgmma_kernel;
//   kernels.flash_t_bias_wgmma_route: its WarpAttn sites); q [B, H, 32, Sq],
//   k, v [B, H, 32, Sk], the sequence contiguous, read as they lie.
// It replaces, for those launches, the `mma.sync` body of attn_mma.cuh
// (i360::flash_tile_mma under a staged bias tile, at most two rows a block),
// and with it the TPU kernels imagine360_tpu/ops/pallas_attention.py:
// _shared_bias_kernel (K6b), _shared_bias_kernel_t (K3) and _flash_kernel_t
// (K6a).
//
// What it computes is what flash_tile_mma computes there: softmax(q·kᵀ·scale
// + bias)·v for each row (a folded row, or a (batch, head) pair) of q
// against k, v, one bias [Sq, Sk] (float32 or bfloat16) for all BH rows;
// keys at or beyond Sk masked; the row sum over the unrounded P; P·V on the
// exact split hi = bf16(p), lo = bf16(p - hi) (SPLIT_P: K6a and K6b, whose
// TPU kernels keep P in float32), or on hi alone (K3, whose TPU kernel
// rounds P to the inputs' bf16 before P·V); the output divided by the sum
// (a zero sum replaced by 1) and rounded to bf16 once, [BH, Sq, 32]
// (folded and sequence-minor: K6a's [B, H, Sq, 32]) or [B, Sq, H, 32]
// (natural); with an lse pointer, lse = m + ln(l) in float32 [BH, Sq]
// (K3's [B, H, Sq]).
// The logit and the bias meet in one FFMA, x = s·scale + bias (natural
// units, the max taken there), and 2^x takes a second, p = 2^(x·log2 e -
// m·log2 e) (ex2.approx.ftz); a masked key's x is -inf, so its p is 0.
//
// What bounds it on the H100: at D = 32 a logit carries 64 tensor-core
// operations of S and 128 of the split P·V, but its softmax costs some eight
// instructions of a thread (the FFMAs, the max, the exponent on the MUFU,
// the sum, the hi + lo packing) and one bias read: the instruction issue,
// not the tensor cores (989 TFLOP/s) nor the MUFU (16 ex2 a clock an SM),
// is the floor. And the bias is as many bytes as the logits: read once for
// T folded rows, and K and V once for 128 query rows, or the L2 traffic
// becomes the bound.
//
// The design:
// - A block is three warpgroups: one producer and two consumers of 64 query
//   rows each (kFbBQ = 128), one block an SM (setmaxnreg 40 / 232 as in
//   attn_wgmma.cuh). It owns one 128-row query tile of kFbT folded rows
//   (a caller that asks for fewer a block keeps the mma.sync body) and
//   computes its kFbT row slots in one fixed order, the ragged last group's
//   slots past BH repeating its last row (computed, not stored), so no
//   product depends on a run-time row count; the folded rows are the
//   fastest grid axis, so the blocks in flight read the same bias rows.
// - One producer thread issues TMA copies: the Q tiles of the block's rows
//   once, then for each key tile of kFbBK keys one stage of a ring: the
//   [128, kFbBK] bias tile once, in its own dtype, and under it the K and V
//   tiles of every folded row of the block. "Full" and "empty" mbarriers
//   carry the stages; the consumers return a stage after their last P·V on
//   it.
// - A consumer walks the key tiles and, under each, its folded rows in turn:
//   S = Q·Kᵀ (wgmma m64nBKk16, Q and K K-major, two k-steps at D = 32), the
//   bias (read from shared memory into registers in S's fragment layout
//   once a tile, for all kFbT rows), the online softmax, O rescaled, then
//   O += P·V (m64n32k16, P from registers, V MN-major: the transpose bit),
//   two products a k-step for the split. Each row keeps its O (16 floats a
//   thread), max and sum in registers. A row's S is issued with the
//   previous row's P·V, and its softmax runs while that P·V is on the
//   tensor cores (P of the two rows in two register sets); the two
//   consumers also interleave on the SM. One row at a time (S, wait,
//   softmax, P·V left in flight into the next row) is the variants
//   script's `fb_serial` (PERF.md §6).
// - Shared memory: folded and natural, q, k, v and the output have 64-byte
//   rows (64-byte swizzle; wg_desc64: 8-row groups 512 bytes apart, V's
//   k-step 1024 bytes); the bias tile lies as boxes of 128-byte rows under
//   the 128-byte swizzle (32 float32 or 64 bf16 keys a box), so the 8 rows
//   a warp reads fall on different banks: a thread reads its pair of keys
//   (8i + 2tg, +1) of row r at 16-byte chunk c ^ (r & 7). Read again for
//   each row instead of once a tile, the body is slower (the variants
//   script's `fb_smem_bias`, PERF.md §6).
// - The output of a row is staged, bf16, in the consumer's own rows of that
//   row's Q tile (its last Q·Kᵀ has completed) and leaves by TMA stores that
//   clip the rows past Sq; the lse by scalar stores.
// - The layouts differ only in their tensor maps (launch_attn_wgmma_bias)
//   and, sequence-minor, in the operands' majorness. Natural: 4-D maps
//   {32, H, S, B}, row stride H·64 bytes, boxes {32, 1, rows, 1}: the tiles
//   land as the folded ones do. Sequence-minor: 3-D maps {S, 32, BH}, boxes
//   of 64 positions × 32 head-dim rows of 128 bytes under the 128-byte
//   swizzle (a box's inner extent fits the swizzle span, so a 128-query Q
//   tile is two boxes, one a consumer); in S = Q·Kᵀ, Q (A) and K (B) are
//   MN-major (the transpose bits; wg_desc, a k-step 16 rows, 2048 bytes);
//   in P·V, V is B K-major (32 bytes a k-step); TMA's row stride S·2 bytes
//   asks Sq and Sk to be multiples of 8. The output [BH, Sq, 32] is
//   staged and stored as the folded one. The bias tile, the ring, the
//   softmax and the register plan are the same in all three; K3 (natural)
//   leaves the lo product out (SPLIT_P off: its P·V is half K6b's).
// Budget, per stage: the bias tile (128 × 64 keys: 32 KB float32, 16 KB
// bf16) and 8 KB of K and V a folded row at 64 keys; Q 8 KB a folded row:
// at kFbT = 4 three stages (float32) or four (bf16) fit the 227 KB. A
// consumer thread holds O of the 4 rows (64 floats), S (32), P of two rows
// (64), a tile's bias pairs (32) and the row statistics (16), within the
// 232 registers of setmaxnreg; the ptxas report gives spills.
// scripts/torch_wgmma_variants.py builds other forms (kFbT, kFbBK) by text
// edits of a copy of this header and times them against this one.
#pragma once

#include "wgmma_ops.cuh"

namespace i360 {

constexpr int kFbD = 32;          // the head dim this body takes
constexpr int kFbBQ = 128;        // query rows a block: two consumers of 64
constexpr int kFbBK = 64;         // keys a tile
constexpr int kFbT = 4;           // folded rows a block computes under one bias tile (even)
constexpr int kFbMaxStages = 4;
constexpr int kFbRowBytes = kFbD * 2;               // one position's 32 bf16
constexpr int kFbQBytes = kFbBQ * kFbRowBytes;      // one folded row's Q tile
constexpr int kFbKVBytes = kFbBK * kFbRowBytes;     // one folded row's K or V tile

// The row layouts of q, k, v (attn_wgmma_bias_tile's LAYOUT)
constexpr int kFbFolded = 0;     // [BH, S, 32] (K6b)
constexpr int kFbNatural = 1;    // [B, S, H, 32], row slot b·H + h (K3)
constexpr int kFbSeqMinor = 2;   // [BH, 32, S] (K6a)

// The bias tile and the stages for a bias of type TB.
static_assert(kFbT % 2 == 0, "the two P register sets alternate row by row");

template <typename TB> struct FbBias {
  static constexpr int kBoxCols = 128 / (int)sizeof(TB);   // keys of a 128-byte box row
  static constexpr int kBoxes = kFbBK / kBoxCols;
  static constexpr int kBoxBytes = kFbBQ * 128;
  static constexpr int kBytes = kBoxes * kBoxBytes;         // the [128, kFbBK] tile
  static constexpr int kStage = kBytes + 2 * kFbT * kFbKVBytes;
  static constexpr int kFit = (kWgSmemLimit - 1024 - 256 - kFbT * kFbQBytes) / kStage;
  static constexpr int kStages = kFit < kFbMaxStages ? kFit : kFbMaxStages;
  static constexpr size_t kSmem =
      1024 + (size_t)kFbT * kFbQBytes + (size_t)kStages * kStage + 8 * (1 + 2 * kStages);
};

// P of one key tile as the A fragments of its kFbBK/16 k-steps of P·V,
// bf16 pairs: hi = bf16(p), lo = bf16(p - hi).
struct FbP {
  uint32_t hi[kFbBK / 16][4];
  uint32_t lo[kFbBK / 16][4];
};

template <int N> __device__ __forceinline__ void fence_regs_u(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// This thread's bias pair, keys 8i + 2tg and + 1 of row r of the staged
// tile at `sb` (generic address of its first box).
template <typename TB>
__device__ __forceinline__ float2 fb_bias(const unsigned char* sb, int r, int i, int tg) {
  using B = FbBias<TB>;
  if constexpr (sizeof(TB) == 4) {
    const int chunk = 2 * (i % 4) + (tg >> 1);
    return *reinterpret_cast<const float2*>(sb + (i / 4) * B::kBoxBytes + r * 128 +
                                            ((chunk ^ (r & 7)) << 4) + (tg & 1) * 8);
  } else {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(
        sb + (i / 8) * B::kBoxBytes + r * 128 + (((i % 8) ^ (r & 7)) << 4) + tg * 4);
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
  }
}

// The online softmax of one key tile of one folded row, this thread's rows
// g (m[0], l[0], α0) and g + 8 under their bias pairs bq[i][0], bq[i][1]:
// x = s·scale + bias, keys at or beyond nk (MASK: the last, partial tile)
// -inf, the row max over the quad, α = 2^((m_old - m_new)·log2 e), the sums
// rescaled by α and added the unrounded P = 2^(x·log2 e - m_new·log2 e), P
// packed as hi + lo (the A fragments of the kFbBK/16 k-steps of P·V).
template <bool MASK>
__device__ __forceinline__ void fb_softmax(float (&sc)[kFbBK / 2],
                                           const float2 (&bq)[kFbBK / 8][2],
                                           int tg, float scale, int nk, float (&m)[2],
                                           float (&l)[2], float& alpha0, float& alpha1, FbP& pa) {
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int i = 0; i < kFbBK / 8; ++i) {
    const float2 b0 = bq[i][0], b1 = bq[i][1];
    float x0 = fmaf(sc[4 * i], scale, b0.x), x1 = fmaf(sc[4 * i + 1], scale, b0.y);
    float x2 = fmaf(sc[4 * i + 2], scale, b1.x), x3 = fmaf(sc[4 * i + 3], scale, b1.y);
    if (MASK) {
      const int key = 8 * i + 2 * tg;
      if (key >= nk) x0 = x2 = -INFINITY;
      if (key + 1 >= nk) x1 = x3 = -INFINITY;
    }
    sc[4 * i] = x0;
    sc[4 * i + 1] = x1;
    sc[4 * i + 2] = x2;
    sc[4 * i + 3] = x3;
    mx0 = fmaxf(mx0, fmaxf(x0, x1));
    mx1 = fmaxf(mx1, fmaxf(x2, x3));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  alpha0 = ex2_ftz((m[0] - mx0) * kLog2e);
  alpha1 = ex2_ftz((m[1] - mx1) * kLog2e);
  m[0] = mx0;
  m[1] = mx1;
  const float mb0 = mx0 * kLog2e, mb1 = mx1 * kLog2e;
  l[0] *= alpha0;
  l[1] *= alpha1;
#pragma unroll
  for (int kk = 0; kk < kFbBK / 16; ++kk) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = 2 * kk + hf;
      const float p0 = ex2_ftz(fmaf(sc[4 * i], kLog2e, -mb0));
      const float p1 = ex2_ftz(fmaf(sc[4 * i + 1], kLog2e, -mb0));
      const float p2 = ex2_ftz(fmaf(sc[4 * i + 2], kLog2e, -mb1));
      const float p3 = ex2_ftz(fmaf(sc[4 * i + 3], kLog2e, -mb1));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa.hi[kk][2 * hf] = pack_bf16(p0, p1);
      pa.hi[kk][2 * hf + 1] = pack_bf16(p2, p3);
      pa.lo[kk][2 * hf] = pack_bf16_rest(p0, p1, pa.hi[kk][2 * hf]);
      pa.lo[kk][2 * hf + 1] = pack_bf16_rest(p2, p3, pa.hi[kk][2 * hf + 1]);
    }
  }
}

// One box of row slot g's q, k or v at sequence position s0 into shared
// memory at `dst`, completing on `bar`, through the LAYOUT's map (H heads:
// natural only).
template <int LAYOUT>
__device__ __forceinline__ void fb_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int s0, int g, int H) {
  if constexpr (LAYOUT == kFbNatural) tma_load_4d(dst, map, bar, 0, g % H, s0, g / H);
  else if constexpr (LAYOUT == kFbSeqMinor) tma_load_3d(dst, map, bar, s0, 0, g);
  else tma_load_3d(dst, map, bar, 0, s0, g);
}

// 64 output rows of row slot g from position s0, staged at `src`, to the
// LAYOUT's output map in this thread's open bulk group.
template <int LAYOUT>
__device__ __forceinline__ void fb_store(const CUtensorMap* map, uint32_t src, int s0, int g,
                                         int H) {
  if constexpr (LAYOUT == kFbNatural) tma_store_4d_async(map, src, 0, g % H, s0, g / H);
  else tma_store_3d_async(map, src, 0, s0, g);
}

// One 128-row query tile of kFbT rows; blockIdx.x is query tile × nrg +
// row group (nrg = ceil(BH / kFbT) groups). The maps are those of
// launch_attn_wgmma_bias<TB, LAYOUT>. `lse` null or the float [BH, Sq]
// rows. `smem` has FbBias<TB>::kSmem bytes. `H`: the heads of the natural
// layout (its row slot g is head g % H of batch row g / H). Without
// SPLIT_P, P·V takes P rounded once to bf16 (one product a k-step).
template <typename TB, int LAYOUT = kFbFolded, bool SPLIT_P = true>
__device__ __forceinline__ void attn_wgmma_bias_tile(const CUtensorMap* mq, const CUtensorMap* mk,
                                                     const CUtensorMap* mv, const CUtensorMap* mo,
                                                     const CUtensorMap* mb, float* lse, int BH,
                                                     int Sq, int Sk, int nrg, float scale,
                                                     unsigned char* smem, int H = 1) {
  using B = FbBias<TB>;
  static_assert(B::kStages >= 2, "two stages fit");
  static_assert(LAYOUT != kFbSeqMinor || kFbBK == 64, "a sequence-minor tile is one 64-key box");
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* gbase = smem + (base - raw);   // `base` as a generic address
  const uint32_t sQ = base;                            // [kFbT][128 rows][64 bytes]
  const uint32_t sS = sQ + kFbT * kFbQBytes;           // stages: bias, then K_j, V_j
  const uint32_t barQ = sS + B::kStages * B::kStage;
  auto stage = [&](int s) { return sS + s * B::kStage; };
  auto kt_of = [&](int s, int j) { return stage(s) + B::kBytes + j * 2 * kFbKVBytes; };
  auto full = [&](int s) { return barQ + 8 + 8 * s; };
  auto empty = [&](int s) { return barQ + 8 + 8 * (B::kStages + s); };

  const int rg = blockIdx.x % nrg, q0 = blockIdx.x / nrg * kFbBQ;
  const int g0 = rg * kFbT, nv = min(kFbT, BH - g0);  // this block's folded rows
  // the folded row of a block's row slot j: past nv the last one again
  // (computed, not stored), so every block runs kFbT rows in one order
  auto row_of = [&](int j) { return g0 + min(j, nv - 1); };
  const int ntiles = (Sk + kFbBK - 1) / kFbBK;
  const int ncons = q0 + 64 < Sq ? 2 : 1;              // consumers with query rows in range
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < B::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * ncons);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgProducerRegs));
    if (threadIdx.x == 0) {
      tma_prefetch(mq);
      tma_prefetch(mk);
      tma_prefetch(mv);
      tma_prefetch(mo);
      tma_prefetch(mb);
      mbar_expect_tx(barQ, kFbT * kFbQBytes);
      for (int j = 0; j < kFbT; ++j) {
        fb_load<LAYOUT>(sQ + j * kFbQBytes, mq, barQ, q0, row_of(j), H);
        if constexpr (LAYOUT == kFbSeqMinor)   // the second consumer's box of 64 queries
          fb_load<LAYOUT>(sQ + j * kFbQBytes + kFbQBytes / 2, mq, barQ, q0 + 64, row_of(j), H);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % B::kStages;
        if (t >= B::kStages) mbar_wait(empty(s), ((t / B::kStages) - 1) & 1);
        mbar_expect_tx(full(s), B::kStage);
        for (int b = 0; b < B::kBoxes; ++b)
          tma_load_2d(stage(s) + b * B::kBoxBytes, mb, full(s), t * kFbBK + b * B::kBoxCols, q0);
        for (int j = 0; j < kFbT; ++j) {
          fb_load<LAYOUT>(kt_of(s, j), mk, full(s), t * kFbBK, row_of(j), H);
          fb_load<LAYOUT>(kt_of(s, j) + kFbKVBytes, mv, full(s), t * kFbBK, row_of(j), H);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
    const int cw = wg - 1;               // this consumer's 64 rows of the tile
    if (cw >= ncons) return;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tg = lane & 3;
    const int r = 64 * cw + 16 * warp + g;   // rows r and r + 8 of the bias tile
    float o[kFbT][16];
    float m[kFbT][2], l[kFbT][2];            // natural-unit max, this thread's part of the sum
#pragma unroll
    for (int j = 0; j < kFbT; ++j) {
#pragma unroll
      for (int i = 0; i < 16; ++i) o[j][i] = 0.f;
      m[j][0] = m[j][1] = kNegInf;
      l[j][0] = l[j][1] = 0.f;
    }
    float sc[kFbBK / 2];                     // S of the row in flight
    FbP pa[2];                               // P of row slots j (pa[j & 1]) and j - 1
    auto fence_o = [&]() {
#pragma unroll
      for (int j = 0; j < kFbT; ++j) fence_regs(o[j]);
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    };
    // S_j = Q_j·K_jᵀ issued from stage s (two k-steps at D = 32): Q and K
    // K-major (32 bytes a k-step), or sequence-minor both MN-major (16
    // head-dim rows of 128 bytes, 2048 bytes, a k-step)
    auto qk = [&](int s, int j) {
      if constexpr (LAYOUT == kFbSeqMinor) {
        const uint64_t dq = wg_desc(sQ + j * kFbQBytes + cw * (kFbQBytes / 2));
        const uint64_t dk = wg_desc(kt_of(s, j));
#pragma unroll
        for (int ks = 0; ks < kFbD / 16; ++ks)
          wgmma_ss_mn<kFbBK>(sc, dq + 128 * ks, dk + 128 * ks, ks);
      } else {
        const uint64_t dq = wg_desc64(sQ + j * kFbQBytes + cw * (kFbQBytes / 2));
        const uint64_t dk = wg_desc64(kt_of(s, j));
#pragma unroll
        for (int ks = 0; ks < kFbD / 16; ++ks) wgmma_ss<kFbBK>(sc, dq + 2 * ks, dk + 2 * ks, ks);
      }
    };
    // acc += P·V issued, V at shared address `va` (MN-major: 16 key rows,
    // 1024 bytes, a k-step; sequence-minor K-major: 32 bytes a k-step in
    // its rows of 64 keys), with SPLIT_P the lo product before the hi one
    // at each step
    auto pv = [&](float (&acc)[16], FbP& p, uint32_t va) {
      if constexpr (LAYOUT == kFbSeqMinor) {
        const uint64_t dv = wg_desc(va);
#pragma unroll
        for (int kk = 0; kk < kFbBK / 16; ++kk) {
          if constexpr (SPLIT_P) wgmma_rs_n32<0>(acc, p.lo[kk], dv + 2 * kk);
          wgmma_rs_n32<0>(acc, p.hi[kk], dv + 2 * kk);
        }
      } else {
        const uint64_t dv = wg_desc64(va);
#pragma unroll
        for (int kk = 0; kk < kFbBK / 16; ++kk) {
          if constexpr (SPLIT_P) wgmma_rs_n32<1>(acc, p.lo[kk], dv + kk * (1024 >> 4));
          wgmma_rs_n32<1>(acc, p.hi[kk], dv + kk * (1024 >> 4));
        }
      }
    };
    mbar_wait(barQ, 0);

    // the key loop: item (t, j) issues S_j of tile t and the P·V of the item
    // before (row j - 1, or row kFbT - 1 of tile t - 1) back to back, runs
    // S_j's softmax while that P·V is on the tensor cores, then rescales
    // O_j. The arithmetic is one row at a time's; P of the two items lives
    // in two register sets that swap roles (kFbT is even), so no register a
    // running product reads is written before it completes, and no product
    // is in flight from one item to the next.
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % B::kStages;
      mbar_wait(full(s), (t / B::kStages) & 1);
      const int nk = min(kFbBK, Sk - t * kFbBK);
      // this thread's pairs of the tile's bias, rows r and r + 8, read
      // once for the kFbT rows
      const unsigned char* sb = gbase + (stage(s) - base);
      float2 bq[kFbBK / 8][2];
#pragma unroll
      for (int i = 0; i < kFbBK / 8; ++i) {
        bq[i][0] = fb_bias<TB>(sb, r, i, tg);
        bq[i][1] = fb_bias<TB>(sb, r + 8, i, tg);
      }
#pragma unroll
      for (int j = 0; j < kFbT; ++j) {
        float a0, a1;
        wgmma_fence();
        qk(s, j);
        wgmma_commit();
        if (j > 0 || t > 0) {
          const int pj = j > 0 ? j - 1 : kFbT - 1;
          pv(o[pj], pa[(j + 1) & 1], kt_of(j > 0 ? s : (t - 1) % B::kStages, pj) + kFbKVBytes);
          wgmma_commit();
          wgmma_wait<1>();                   // S_j has landed; the P·V may still run
          fence_regs(sc);
          if (nk < kFbBK) fb_softmax<true>(sc, bq, tg, scale, nk, m[j], l[j], a0, a1, pa[j & 1]);
          else fb_softmax<false>(sc, bq, tg, scale, nk, m[j], l[j], a0, a1, pa[j & 1]);
          wgmma_wait<0>();
          fence_regs(o[pj]);
          fence_regs_u(pa[(j + 1) & 1].hi);
          if constexpr (SPLIT_P) fence_regs_u(pa[(j + 1) & 1].lo);
          if (j == 0) release((t - 1) % B::kStages);   // its last P·V completed
        } else {
          wgmma_wait<0>();
          fence_regs(sc);
          if (nk < kFbBK) fb_softmax<true>(sc, bq, tg, scale, nk, m[j], l[j], a0, a1, pa[j & 1]);
          else fb_softmax<false>(sc, bq, tg, scale, nk, m[j], l[j], a0, a1, pa[j & 1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[j][4 * i] *= a0;
          o[j][4 * i + 1] *= a0;
          o[j][4 * i + 2] *= a1;
          o[j][4 * i + 3] *= a1;
        }
      }
    }
    // the last item's P·V
    wgmma_fence();
    pv(o[kFbT - 1], pa[(kFbT - 1) & 1],
       kt_of((ntiles - 1) % B::kStages, kFbT - 1) + kFbKVBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_o();
    release((ntiles - 1) % B::kStages);

    // epilogue, each folded row: the sums over the quad; with an lse the
    // rows' m + ln l (a zero sum replaced by 1); divide by the sum, bf16
    // into this consumer's own rows of the row's Q tile (64-byte swizzled:
    // chunk i of row rr at i ^ ((rr >> 1) & 3); sequence-minor, over its
    // own Q box), then TMA stores that clip the rows past Sq
    const int rr = 16 * warp + g;            // rows rr and rr + 8 of this consumer's 64
    const int sw = (rr >> 1) & 3;
#pragma unroll
    for (int j = 0; j < kFbT; ++j) {
      if (j < nv) {
        float l0 = l[j][0], l1 = l[j][1];
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        l0 = l0 == 0.f ? 1.f : l0;
        l1 = l1 == 0.f ? 1.f : l1;
        if (lse != nullptr && tg == 0) {
          const int row = q0 + 64 * cw + rr;
          float* lrow = lse + (long)(g0 + j) * Sq;
          if (row < Sq) lrow[row] = m[j][0] == kNegInf ? kNegInf : m[j][0] + log2f(l0) * kLn2;
          if (row + 8 < Sq)
            lrow[row + 8] = m[j][1] == kNegInf ? kNegInf : m[j][1] + log2f(l1) * kLn2;
        }
        const float inv0 = 1.f / l0, inv1 = 1.f / l1;
        const uint32_t rowa = sQ + j * kFbQBytes + cw * (kFbQBytes / 2) + rr * 64 + tg * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t a = rowa + (uint32_t)((i ^ sw) << 4);
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a),
                       "r"(pack_bf16(o[j][4 * i] * inv0, o[j][4 * i + 1] * inv0)) : "memory");
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a + 8 * 64),
                       "r"(pack_bf16(o[j][4 * i + 2] * inv1, o[j][4 * i + 3] * inv1)) : "memory");
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1 + cw, 128);
    if ((threadIdx.x & 127) == 0) {
      for (int j = 0; j < nv; ++j)
        fb_store<LAYOUT>(mo, sQ + j * kFbQBytes + cw * (kFbQBytes / 2), q0 + 64 * cw, g0 + j, H);
      bulk_commit();
      bulk_wait_all();
    }
  }
}

// The map of one [n2, n1, n0] bf16 operand of 64-byte rows (n0 = 32): dims
// {n0, n1, n2}, boxes of `rows` rows of one slab, 64-byte swizzle.
inline bool make_fb_map(CUtensorMap* map, const void* ptr, int n2, int n1, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)kFbD, (cuuint64_t)n1, (cuuint64_t)n2};
  const cuuint64_t strides[2] = {(cuuint64_t)kFbRowBytes, (cuuint64_t)kFbRowBytes * n1};
  const cuuint32_t box[3] = {(cuuint32_t)kFbD, (cuuint32_t)rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 3, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_64B);
}

// The map of one [B, S, H, 32] bf16 operand (the natural layout): dims
// {32, H, S, B}, row stride H·64 bytes, boxes of `rows` rows of one head,
// 64-byte swizzle.
inline bool make_fb_map_4d(CUtensorMap* map, const void* ptr, int Bn, int S, int H, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)kFbD, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)Bn};
  const cuuint64_t strides[3] = {(cuuint64_t)kFbRowBytes, (cuuint64_t)kFbRowBytes * H,
                                 (cuuint64_t)kFbRowBytes * H * S};
  const cuuint32_t box[4] = {(cuuint32_t)kFbD, 1, (cuuint32_t)rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 4, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_64B);
}

// Launch `kern` (a __global__ taking the five maps, then lse, BH, Sq, Sk,
// nrg and scale, and for the natural layout H) for
// attn_wgmma_bias_tile<TB, LAYOUT> on bf16 q, k, v in the LAYOUT's order
// (folded q [BH, Sq, 32], k/v [BH, Sk, 32]; natural q [BH / H, Sq, H, 32],
// k/v [BH / H, Sk, H, 32]; sequence-minor q [BH, 32, Sq], k/v [BH, 32, Sk]),
// out [BH, Sq, 32] (natural [BH / H, Sq, H, 32]) and a TB bias [Sq, Sk], lse
// null or float [BH, Sq], kFbT rows a block. Refuses
// (cudaErrorInvalidValue) pointers of q, k, v, out or the bias off a
// 16-byte boundary, a bias row of Sk elements that is no multiple of 16
// bytes (the map's row stride), H not dividing BH, sequence-minor an Sq or
// Sk that is no multiple of 8 (its maps' row strides), a map the driver
// does not encode, and a build whose launch registers would not cover the
// consumers' setmaxnreg.
template <typename TB, int LAYOUT = kFbFolded, typename Kern>
int launch_attn_wgmma_bias(Kern kern, const void* q, const void* k, const void* v,
                           const void* bias, void* out, float* lse, int BH, int Sq, int Sk,
                           float scale, cudaStream_t stream, int H = 1) {
  using B = FbBias<TB>;
  if ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out | (uintptr_t)bias) & 15) !=
          0 ||
      BH < 1 || Sq < 1 || Sk < 1 || (Sk * (int)sizeof(TB)) % 16 != 0 || H < 1 || BH % H != 0 ||
      (LAYOUT == kFbSeqMinor && (Sq % 8 != 0 || Sk % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo, mb;
  const auto tb = sizeof(TB) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  bool maps;
  if constexpr (LAYOUT == kFbNatural) {
    const int Bn = BH / H;
    maps = make_fb_map_4d(&mq, q, Bn, Sq, H, kFbBQ) && make_fb_map_4d(&mk, k, Bn, Sk, H, kFbBK) &&
           make_fb_map_4d(&mv, v, Bn, Sk, H, kFbBK) &&
           make_fb_map_4d(&mo, out, Bn, Sq, H, kFbBQ / 2);
  } else if constexpr (LAYOUT == kFbSeqMinor) {   // boxes of 64 positions × 32 head-dim rows
    maps = make_wg_map_3d(&mq, q, BH, kFbD, Sq, kFbD, 64) &&
           make_wg_map_3d(&mk, k, BH, kFbD, Sk, kFbD, 64) &&
           make_wg_map_3d(&mv, v, BH, kFbD, Sk, kFbD, 64) &&
           make_fb_map(&mo, out, BH, Sq, kFbBQ / 2);
  } else {
    maps = make_fb_map(&mq, q, BH, Sq, kFbBQ) && make_fb_map(&mk, k, BH, Sk, kFbBK) &&
           make_fb_map(&mv, v, BH, Sk, kFbBK) && make_fb_map(&mo, out, BH, Sq, kFbBQ / 2);
  }
  if (!maps || !make_map_2d(&mb, tb, (int)sizeof(TB), bias, Sq, Sk, B::kBoxCols, kFbBQ,
                            CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs < kWgLaunchRegs) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)B::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int nrg = (BH + kFbT - 1) / kFbT;
  const unsigned blocks = (unsigned)((long)nrg * ((Sq + kFbBQ - 1) / kFbBQ));
  if constexpr (LAYOUT == kFbNatural)
    kern<<<blocks, kWgThreads, B::kSmem, stream>>>(mq, mk, mv, mo, mb, lse, BH, Sq, Sk, nrg,
                                                   scale, H);
  else
    kern<<<blocks, kWgThreads, B::kSmem, stream>>>(mq, mk, mv, mo, mb, lse, BH, Sq, Sk, nrg,
                                                   scale);
  return (int)cudaGetLastError();
}

}  // namespace i360
