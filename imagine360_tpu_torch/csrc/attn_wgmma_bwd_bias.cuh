// The Hopper bodies of the streaming attention backward for bf16 storage at
// head dim 32 under one float32 [Sq, Sk] bias shared by every batch row and
// head: every K5b (flash_bwd_dq.cu, flash_bwd_dq_bias_wgmma_kernel) and K5c
// (flash_bwd_dkv.cu, flash_bwd_dkv_bias_wgmma_kernel) launch that
// kernels.bwd_bias_wgmma_route gives them, which is every launch of the
// training step at the WarpAttn sites, a rank's row block of the bias
// included. They replace, for those launches, the `mma.sync` tiles of
// attn_mma_bwd.cuh, and with them the TPU kernels
// imagine360_tpu/ops/pallas_attention.py: _flash_bwd_dq_kernel (K5b) and
// _flash_bwd_dkv_kernel (K5c) as _shared_trainable_bwd calls them (the
// bias [1, 1, Sq, Sk], the lse of K3's forward).
//
// What they compute, from the forward's float32 lse and delta =
// rowsum(dO ∘ O), both [B, H, Sq]:
//   x = S·scale + bias (one FFMA, as the forward of attn_wgmma_bias.cuh),
//   S = Q·Kᵀ; P = 2^(x·log2 e − lse·log2 e) (ex2.approx.ftz: results below
//   2^-126 flushed to 0; a bias of -inf gives P = 0, a fully masked row
//   too, its lse being the forward's finite floor);
//   dP = dO·Vᵀ, dS = P ∘ (dP − delta);
//   K5b: dq = scale · Σ_k dS·K, summed over the key tiles in order;
//   K5c: dv = Σ_q Pᵀ·dO and dk = scale · Σ_q dSᵀ·Q, summed over the query
//   tiles in order.
// No atomics: a block owns its output rows and walks the other side in a
// loop, so the result is deterministic. P and dS stay float32 in the
// kernels replaced, so every product that takes them takes the exact split
// x = hi + lo of two bf16 values (bw_pack), the lo product before the hi
// one at each k-step. A key at or past Sk, or a query at or past Sq, gets
// P = dS = 0.
//
// What bounds them on the H100: at D = 32 a logit carries 6·32 (K5b) or
// 8·32 (K5c) tensor-core operations, 4/3 and 6/4 of that with the split,
// against some ten instructions of a thread (the biased FFMA, the exponent's
// FFMA and MUFU, dP − delta, the product with P, one or two hi + lo packs)
// and one bias read: the instruction issue, not the tensor cores, is the
// floor, as in the forward of attn_wgmma_bias.cuh. And the bias is as many
// bytes as the logits, so it is read once for T (batch, head) row slots.
//
// The design: the D = 64 bodies of attn_wgmma_bwd.cuh (one producer
// warpgroup issuing TMA copies into an mbarrier ring, two consumer
// warpgroups of 64 rows on `wgmma`, setmaxnreg 40 / 232, S and dP from
// shared memory through descriptors, the dS and P products with their A
// operand in registers and B MN-major through the transpose bit, TMA
// stores that clip the tails), with the operands and the bias tile of the
// forward's natural layout (attn_wgmma_bias.cuh, kFbNatural):
// - Operands: q, k, v, dO, dq, dk and dv are [B, S, H, 32], read and
//   written through the 4-D maps {32, H, S, B} of 64-byte rows under the
//   64-byte swizzle (make_fb_map_4d, wg_desc64); row slot g = b·H + h is
//   head g % H of batch row g / H. Two k-steps of 16 at D = 32.
// - The bias tile by TMA, one of each stage of the ring, read once a tile
//   into registers in the fragment layout of S (K5b) or Sᵀ (K5c) for all T
//   row slots. K5b: the [128 query × 64 key] tile of the forward (FbBias:
//   boxes of 128-byte rows under the 128-byte swizzle), read as fb_softmax
//   reads it. K5c: a [64 query × 128 key] tile, four boxes of 32 keys,
//   read transposed: a thread's element (key kr, query q) at chunk
//   ((kr % 32) / 4) ^ (q % 8) of row q of box kr / 32; a warp's read (its
//   8 key rows × 4 query pairs) falls on 32 distinct banks
//   (tests/test_torch_wgmma_bwd_warp.py emulates the addresses).
// - Row slots: a block computes T (batch, head) row slots of one query tile
//   (K5b, kBqbT) or key tile (K5c, kBkbT) under each staged bias tile, in
//   one fixed order; the last group's slots past B·H repeat its last row
//   (computed, not stored), so no product depends on a run-time row count.
//   The row groups are the fastest grid axis, so the blocks in flight read
//   the same bias rows (K5b) or columns (K5c) from L2.
// - K5b (attn_wgmma_bwd_dq_bias_tile): a block owns 128 queries of T slots,
//   64 a consumer; Q and dO of every slot arrive once (16 KB a slot); a
//   stage holds the bias tile (32 KB) and the K and V tiles of 64 keys of
//   every slot (8 KB a slot); a thread keeps its two rows' lse (log2 units)
//   and delta of every slot in registers. Item (t, j), slot j under key
//   tile t: S_j and dP_j issued (the previous slot's dS·K still in flight),
//   P_j while dP_j runs, dS_j, then dq_j += dS_j·K_j issued and left in
//   flight into the next slot's item; the tile's last is waited for before
//   the next tile (left in flight across the key loop's back edge, ptxas
//   serialised every product of the loop, C7515, and the body ran
//   27-29% slower). A thread holds dq of every slot (16 floats a slot), S and dP
//   (32 each), dS hi + lo (32) and the tile's bias pairs (32).
// - K5c (attn_wgmma_bwd_dkv_bias_tile): a block owns 128 keys of T slots,
//   64 a consumer; K and V of every slot arrive once (16 KB a slot); a
//   stage holds the bias tile (32 KB), the Q and dO tiles of 64 queries of
//   every slot (8 KB a slot), and, in a ring of their own, their lse and
//   delta rows (2-D float32 maps {Sq, B·H}, boxes of 64: Sq a multiple of
//   4, which the launcher checks). Item (t, j): Sᵀ_j = K_j·Q_jᵀ and dPᵀ_j =
//   V_j·dO_jᵀ issued, Pᵀ_j while dPᵀ_j runs, dv_j += Pᵀ_j·dO_j issued,
//   dSᵀ_j while it runs, then, that product complete, dSᵀ_j packed into the
//   same registers as Pᵀ_j and dk_j += dSᵀ_j·Q_j issued and waited for
//   (left in flight under the next slot's Sᵀ and dPᵀ it spilled and ran
//   slower; across the query loop's back edge ptxas serialised the loop).
//   A thread holds dk and dv of every slot (32 floats a slot), Sᵀ and dPᵀ
//   (32 each), one set of hi + lo fragments (32) and the tile's bias values
//   (32). The two consumers interleave on the SM, so one's elementwise work
//   runs under the other's products.
// - The output tile of a consumer and slot is staged, bf16, in that slot's
//   own rows of Q (K5b) or of K and V (K5c), their last products having
//   completed, and leaves by TMA stores that clip the rows past Sq (Sk).
//   scripts/torch_wgmma_variants.py builds other T, the bias read again
//   for each slot, and the other placings of the waits (K5b every item's
//   product waited for at once, or none; K5c's left in flight within a
//   tile, or across tiles) by text edits of a copy of this header and times
//   them against it (PERF.md §6).
//
// Budget: K5b 16 KB a slot of Q and dO and, per stage, 32 KB of bias and
// 8 KB a slot of K and V (T = 4: two stages, 192 KB); K5c 16 KB a slot of K
// and V and, per stage, 32 KB of bias, 8 KB a slot of Q and dO and 512
// bytes a slot of rows (T = 2: three stages, 179 KB); plus the barriers and
// 1 KB to align the tiles. 384 threads, 168 registers a thread at launch
// (__launch_bounds__(384, 1)). The ptxas report that build_library() keeps
// beside the library gives registers and spills.
#pragma once

#include "attn_wgmma_bias.cuh"
#include "attn_wgmma_bwd.cuh"

namespace i360 {

constexpr int kBqbT = 4;            // K5b: row slots a block under one bias tile
constexpr int kBkbT = 2;            // K5c: row slots a block under one bias tile
constexpr int kBbMaxStages = 4;
constexpr int kBkbBQ = 64;          // K5c: queries a tile of the ring
constexpr int kBkbBoxCols = 32;     // K5c: keys of one 128-byte bias box row
constexpr int kBkbBoxBytes = kBkbBQ * 128;              // one [64 query, 32 key] box
constexpr int kBkbBiasBytes = (kFbBQ / kBkbBoxCols) * kBkbBoxBytes;  // [64, 128] float32
constexpr int kBkbQBytes = kBkbBQ * kFbRowBytes;        // one slot's Q or dO tile
constexpr int kBkbRowBytes = kBkbBQ * 4;                // one slot's lse or delta tile

// K5b's shared memory for T row slots: Q and dO of every slot, then the
// stages (the bias tile, then K_j and V_j of every slot), then the barriers
template <int T> struct BqbPlan {
  using FB = FbBias<float>;
  static constexpr int kStage = FB::kBytes + 2 * T * kFbKVBytes;
  static constexpr int kFit = (kWgSmemLimit - 1024 - 256 - 2 * T * kFbQBytes) / kStage;
  static constexpr int kStages = kFit < kBbMaxStages ? kFit : kBbMaxStages;
  static constexpr size_t kSmem =
      1024 + 2 * (size_t)T * kFbQBytes + (size_t)kStages * kStage + 8 * (1 + 2 * kStages);
  static_assert(kStages >= 2, "two stages fit");
};

// K5c's: K and V of every slot, the stages (the bias tile, then Q_j and
// dO_j of every slot), the lse and delta rows of every stage and slot, then
// the barriers
template <int T> struct BkbPlan {
  static constexpr int kStage = kBkbBiasBytes + 2 * T * kBkbQBytes;
  static constexpr int kRows = 2 * T * kBkbRowBytes;
  static constexpr int kFit =
      (kWgSmemLimit - 1024 - 256 - 2 * T * kFbQBytes) / (kStage + kRows);
  static constexpr int kStages = kFit < kBbMaxStages ? kFit : kBbMaxStages;
  static constexpr size_t kSmem = 1024 + 2 * (size_t)T * kFbQBytes +
                                  (size_t)kStages * (kStage + kRows) + 8 * (1 + 2 * kStages);
  static_assert(kStages >= 2, "two stages fit");
};

// d += (hi + lo)·b over the 4 k-steps of 16 rows of a 64-row MN-major B
// tile 32 columns wide at shared address `b` (64-byte swizzle: 1024 bytes a
// k-step): the lo product before the hi one.
__device__ __forceinline__ void bb_rs(float (&d)[16], const uint32_t (&hi)[4][4],
                                      const uint32_t (&lo)[4][4], uint32_t b) {
  const uint64_t db = wg_desc64(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs_n32<1>(d, lo[kk], db + kk * (1024 >> 4));
    wgmma_rs_n32<1>(d, hi[kk], db + kk * (1024 >> 4));
  }
}

// d = a·bᵀ, m64n64 over D = 32 (two k-steps), a and b 64-byte-swizzled
// K-major tiles at shared addresses `a` and `b`.
__device__ __forceinline__ void bb_ss(float (&d)[32], uint32_t a, uint32_t b) {
  const uint64_t da = wg_desc64(a), db = wg_desc64(b);
#pragma unroll
  for (int ks = 0; ks < kFbD / 16; ++ks) wgmma_ss_n64<0, 0>(d, da + 2 * ks, db + 2 * ks, ks);
}

// The 64 × 32 float accumulator `x` of a consumer (times `mul`), bf16, into
// its 64 rows of 64 bytes at `rows` (64-byte swizzled, as a 4-D map of
// attn_wgmma_bias.cuh reads them): row warp·16 + g (+ 8), columns 8i + 2tg,
// + 1 at chunk i ^ ((row >> 1) & 3).
__device__ __forceinline__ void bb_stage_out(const float (&x)[16], float mul, uint32_t rows,
                                             int warp, int g, int tg) {
  const int rr = 16 * warp + g;
  const uint32_t row = rows + rr * 64 + tg * 4;
  const int sw = (rr >> 1) & 3;                       // rows rr and rr + 8: the same pattern
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a = row + (uint32_t)((i ^ sw) << 4);
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a),
                 "r"(pack_bf16(x[4 * i] * mul, x[4 * i + 1] * mul)) : "memory");
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a + 8 * 64),
                 "r"(pack_bf16(x[4 * i + 2] * mul, x[4 * i + 3] * mul)) : "memory");
  }
}

// K5b: dq of one 128-row query tile of T row slots; blockIdx.x is query
// tile × nrg + row group (nrg = ceil(BH / T) groups). mq, mg, mdq are the
// maps of q, dO and dq [B, Sq, H, 32] (boxes of 128, 128 and 64 rows), mk
// and mv of k and v [B, Sk, H, 32] (boxes of kFbBK rows), mb of the bias
// [Sq, Sk] (boxes of 32 keys × 128 rows); lse and delta point at the float
// [B·H, Sq] rows. `smem` has BqbPlan<T>::kSmem bytes.
template <int T>
__device__ __forceinline__ void attn_wgmma_bwd_dq_bias_tile(
    const CUtensorMap* mq, const CUtensorMap* mk, const CUtensorMap* mv, const CUtensorMap* mg,
    const CUtensorMap* mdq, const CUtensorMap* mb, const float* lse, const float* delta, int BH,
    int Sq, int Sk, int H, int nrg, float scale, unsigned char* smem) {
  using P = BqbPlan<T>;
  using FB = FbBias<float>;
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* gbase = smem + (base - raw);   // `base` as a generic address
  const uint32_t sQ = base;                            // [T][128 rows][64 bytes]
  const uint32_t sG = sQ + T * kFbQBytes;              // dO, the same
  const uint32_t sS = sG + T * kFbQBytes;              // stages: bias, then K_j, V_j
  const uint32_t barQ = sS + P::kStages * P::kStage;
  auto stage = [&](int s) { return sS + s * P::kStage; };
  auto kt_of = [&](int s, int j) { return stage(s) + FB::kBytes + j * 2 * kFbKVBytes; };
  auto full = [&](int s) { return barQ + 8 + 8 * s; };
  auto empty = [&](int s) { return barQ + 8 + 8 * (P::kStages + s); };

  const int rg = blockIdx.x % nrg, q0 = blockIdx.x / nrg * kFbBQ;
  const int g0 = rg * T, nv = min(T, BH - g0);         // this block's row slots
  // the row of slot j: past nv the last one again (computed, not stored)
  auto row_of = [&](int j) { return g0 + min(j, nv - 1); };
  const int ntiles = (Sk + kFbBK - 1) / kFbBK;
  const int ncons = q0 + 64 < Sq ? 2 : 1;              // consumers with query rows in range
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(full(s), 1);
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
      tma_prefetch(mg);
      tma_prefetch(mdq);
      tma_prefetch(mb);
      mbar_expect_tx(barQ, 2 * T * kFbQBytes);
      for (int j = 0; j < T; ++j) {
        fb_load<kFbNatural>(sQ + j * kFbQBytes, mq, barQ, q0, row_of(j), H);
        fb_load<kFbNatural>(sG + j * kFbQBytes, mg, barQ, q0, row_of(j), H);
      }
      bw_produce<P::kStages>(ntiles, P::kStage, full, empty, [&](int s, int t) {
        for (int b = 0; b < FB::kBoxes; ++b)
          tma_load_2d(stage(s) + b * FB::kBoxBytes, mb, full(s), t * kFbBK + b * FB::kBoxCols,
                      q0);
        for (int j = 0; j < T; ++j) {
          fb_load<kFbNatural>(kt_of(s, j), mk, full(s), t * kFbBK, row_of(j), H);
          fb_load<kFbNatural>(kt_of(s, j) + kFbKVBytes, mv, full(s), t * kFbBK, row_of(j), H);
        }
      });
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
    const int cw = wg - 1;               // this consumer's 64 rows of the tile
    if (cw >= ncons) return;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tg = lane & 3;
    const int r = 64 * cw + 16 * warp + g;   // rows r and r + 8 of the tile
    // lse (log2 units) and delta of this thread's rows of every slot
    float l2[T][2], de[T][2];
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = q0 + r + 8 * hr;
        const long o = (long)row_of(j) * Sq + row;
        l2[j][hr] = row < Sq ? lse[o] * kLog2e : 0.f;
        de[j][hr] = row < Sq ? delta[o] : 0.f;
      }
    float acc[T][16];
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[j][i] = 0.f;
    float sc[kFbBK / 2], dp[kFbBK / 2];
    uint32_t dh[kFbBK / 16][4], dl[kFbBK / 16][4];
    auto release = [&](int stg) {        // this warp is done with stage stg
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stg));
    };
    mbar_wait(barQ, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % P::kStages;
      mbar_wait(full(s), (t / P::kStages) & 1);
      const int nk = Sk - t * kFbBK;
      // this thread's pairs of the tile's bias, rows r and r + 8, read once
      // for the T slots
      const unsigned char* sb = gbase + (stage(s) - base);
      float2 bq[kFbBK / 8][2];
#pragma unroll
      for (int i = 0; i < kFbBK / 8; ++i) {
        bq[i][0] = fb_bias<float>(sb, r, i, tg);
        bq[i][1] = fb_bias<float>(sb, r + 8, i, tg);
      }
      // item (t, j): S_j and dP_j issued behind the previous slot's dS·K
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const uint32_t sKj = kt_of(s, j);
        wgmma_fence();
        bb_ss(sc, sQ + j * kFbQBytes + cw * (kFbQBytes / 2), sKj);
        wgmma_commit();
        bb_ss(dp, sG + j * kFbQBytes + cw * (kFbQBytes / 2), sKj + kFbKVBytes);
        wgmma_commit();
        wgmma_wait<1>();                  // S_j, and the previous slot's dS·K before it
        fence_regs(sc);
        // P = 2^(x·log2 e − lse·log2 e), x = S·scale + bias, in place; on
        // the last, partial tile (MASK) keys at or beyond Sk 0
        auto probs = [&](auto mask) {
#pragma unroll
          for (int i = 0; i < kFbBK / 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 b = bq[i][e >> 1];
              const float x = fmaf(sc[4 * i + e], scale, (e & 1) ? b.y : b.x);
              const float p = ex2_ftz(fmaf(x, kLog2e, -l2[j][e >> 1]));
              sc[4 * i + e] = decltype(mask)::value && 8 * i + 2 * tg + (e & 1) >= nk ? 0.f : p;
            }
        };
        if (nk < kFbBK) probs(std::true_type{});
        else probs(std::false_type{});
        wgmma_wait<0>();                  // dP_j
        fence_regs(dp);
        // dS = P ∘ (dP − delta), split as the A fragments of dq_j += dS·K_j
#pragma unroll
        for (int i = 0; i < kFbBK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * i + e] = sc[4 * i + e] * (dp[4 * i + e] - de[j][e >> 1]);
        bw_pack<kFbBK>(dp, dh, dl);
        // dq_j += dS·K_j, K MN-major (the transpose bit), left in flight
        // under the next slot's S and dP; the tile's last is waited for here
        // and the stage returned: one left in flight across the key loop's
        // back edge makes ptxas serialise every product of the loop (C7515)
        wgmma_fence();
        bb_rs(acc[j], dh, dl, sKj);
        wgmma_commit();
        if (j == T - 1) {
          wgmma_wait<0>();
          fence_regs(acc[j]);
          release(s);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < T; ++j) fence_regs(acc[j]);

    // epilogue: dq·scale of every slot in range, bf16, into this consumer's
    // own rows of the slot's Q tile (its last Q·Kᵀ has completed), then TMA
    // stores that clip the rows past Sq
#pragma unroll
    for (int j = 0; j < T; ++j)
      if (j < nv) bb_stage_out(acc[j], scale, sQ + j * kFbQBytes + cw * (kFbQBytes / 2), warp, g,
                               tg);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1 + cw, 128);
    if ((threadIdx.x & 127) == 0) {
      for (int j = 0; j < nv; ++j)
        fb_store<kFbNatural>(mdq, sQ + j * kFbQBytes + cw * (kFbQBytes / 2), q0 + 64 * cw, g0 + j,
                             H);
      bulk_commit();
      bulk_wait_all();
    }
  }
}

// This thread's bias value at (query q, key kr) of K5c's staged [64, 128]
// float32 tile at `sb` (generic address of its first box): box kr / 32,
// row q, 16-byte chunk ((kr % 32) / 4) ^ (q % 8), word kr % 4.
__device__ __forceinline__ float bkb_bias(const unsigned char* sb, int q, int kr) {
  const int chunk = ((kr % kBkbBoxCols) >> 2) ^ (q & 7);
  return *reinterpret_cast<const float*>(sb + (kr / kBkbBoxCols) * kBkbBoxBytes + q * 128 +
                                         (chunk << 4) + (kr & 3) * 4);
}

// K5c: dk and dv of one 128-row key tile of T row slots; blockIdx.x is key
// tile × nrg + row group. mk, mv are the maps of k and v [B, Sk, H, 32]
// (boxes of 128 rows), mdk, mdv of dk and dv (boxes of 64), mq, mg of q and
// dO [B, Sq, H, 32] (boxes of kBkbBQ), ml, md of the float lse and delta
// rows {Sq, B·H} (boxes of kBkbBQ), mb of the bias [Sq, Sk] (boxes of 32
// keys × kBkbBQ rows). `smem` has BkbPlan<T>::kSmem bytes.
template <int T>
__device__ __forceinline__ void attn_wgmma_bwd_dkv_bias_tile(
    const CUtensorMap* mq, const CUtensorMap* mk, const CUtensorMap* mv, const CUtensorMap* mg,
    const CUtensorMap* ml, const CUtensorMap* md, const CUtensorMap* mdk, const CUtensorMap* mdv,
    const CUtensorMap* mb, int BH, int Sq, int Sk, int H, int nrg, float scale,
    unsigned char* smem) {
  using P = BkbPlan<T>;
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* gbase = smem + (base - raw);   // `base` as a generic address
  const uint32_t sK = base;                            // [T][128 rows][64 bytes]
  const uint32_t sV = sK + T * kFbQBytes;              // the same
  const uint32_t sS = sV + T * kFbQBytes;              // stages: bias, then Q_j, dO_j
  const uint32_t sR = sS + P::kStages * P::kStage;     // rows: lse_j, then delta_j
  const uint32_t barKV = sR + P::kStages * P::kRows;
  auto stage = [&](int s) { return sS + s * P::kStage; };
  auto qt_of = [&](int s, int j) { return stage(s) + kBkbBiasBytes + j * 2 * kBkbQBytes; };
  auto lrow_of = [&](int s, int j) { return sR + s * P::kRows + j * kBkbRowBytes; };
  auto drow_of = [&](int s, int j) { return lrow_of(s, j) + T * kBkbRowBytes; };
  auto full = [&](int s) { return barKV + 8 + 8 * s; };
  auto empty = [&](int s) { return barKV + 8 + 8 * (P::kStages + s); };

  const int rg = blockIdx.x % nrg, k0 = blockIdx.x / nrg * kFbBQ;
  const int g0 = rg * T, nv = min(T, BH - g0);
  auto row_of = [&](int j) { return g0 + min(j, nv - 1); };
  const int ntiles = (Sq + kBkbBQ - 1) / kBkbBQ;
  const int ncons = k0 + 64 < Sk ? 2 : 1;              // consumers with key rows in range
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(barKV, 1);
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * ncons);
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
      tma_prefetch(mg);
      tma_prefetch(ml);
      tma_prefetch(md);
      tma_prefetch(mdk);
      tma_prefetch(mdv);
      tma_prefetch(mb);
      mbar_expect_tx(barKV, 2 * T * kFbQBytes);
      for (int j = 0; j < T; ++j) {
        fb_load<kFbNatural>(sK + j * kFbQBytes, mk, barKV, k0, row_of(j), H);
        fb_load<kFbNatural>(sV + j * kFbQBytes, mv, barKV, k0, row_of(j), H);
      }
      bw_produce<P::kStages>(ntiles, P::kStage + P::kRows, full, empty, [&](int s, int t) {
        for (int b = 0; b < kFbBQ / kBkbBoxCols; ++b)
          tma_load_2d(stage(s) + b * kBkbBoxBytes, mb, full(s), k0 + b * kBkbBoxCols,
                      t * kBkbBQ);
        for (int j = 0; j < T; ++j) {
          fb_load<kFbNatural>(qt_of(s, j), mq, full(s), t * kBkbBQ, row_of(j), H);
          fb_load<kFbNatural>(qt_of(s, j) + kBkbQBytes, mg, full(s), t * kBkbBQ, row_of(j), H);
          tma_load_2d(lrow_of(s, j), ml, full(s), t * kBkbBQ, row_of(j));
          tma_load_2d(drow_of(s, j), md, full(s), t * kBkbBQ, row_of(j));
        }
      });
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
    const int cw = wg - 1;               // this consumer's 64 keys of the tile
    if (cw >= ncons) return;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tg = lane & 3;
    const int kr = 64 * cw + 16 * warp + g;   // keys kr and kr + 8 of the tile
    float dka[T][16], dva[T][16];
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) dka[j][i] = dva[j][i] = 0.f;
    float st[32], dpt[32];               // Sᵀ (then Pᵀ) and dPᵀ (then dSᵀ)
    uint32_t fh[4][4], fl[4][4];         // Pᵀ, then dSᵀ, split
    auto release = [&](int stg) {        // this warp is done with stage stg
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stg));
    };
    mbar_wait(barKV, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % P::kStages;
      mbar_wait(full(s), (t / P::kStages) & 1);
      const int nq = Sq - t * kBkbBQ;
      // this thread's values of the tile's bias, Sᵀ's element 4i + e: key
      // kr (e < 2) or kr + 8, query 8i + 2tg + (e & 1); read once for the T
      // slots
      const unsigned char* sb = gbase + (stage(s) - base);
      float bt[32];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bt[4 * i + e] = bkb_bias(sb, 8 * i + 2 * tg + (e & 1), kr + 8 * (e >> 1));
      // item (t, j): Sᵀ_j and dPᵀ_j, Pᵀ_j under dPᵀ_j, dv_j += Pᵀ_j·dO_j
      // under dSᵀ_j, then dk_j += dSᵀ_j·Q_j
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const uint32_t sQj = qt_of(s, j), sGj = sQj + kBkbQBytes;
        const float* lrow = reinterpret_cast<const float*>(gbase + (lrow_of(s, j) - base));
        const float* drow = reinterpret_cast<const float*>(gbase + (drow_of(s, j) - base));
        wgmma_fence();
        bb_ss(st, sK + j * kFbQBytes + cw * (kFbQBytes / 2), sQj);
        wgmma_commit();
        bb_ss(dpt, sV + j * kFbQBytes + cw * (kFbQBytes / 2), sGj);
        wgmma_commit();
        wgmma_wait<1>();                  // Sᵀ_j
        fence_regs(st);
        // Pᵀ = 2^(x·log2 e − lse·log2 e), x = Sᵀ·scale + bias, in place; on
        // the last, partial tile (MASK) queries at or beyond Sq 0
        auto probs = [&](auto mask) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float2 l = *reinterpret_cast<const float2*>(lrow + 8 * i + 2 * tg);
            const float lc[2] = {l.x * kLog2e, l.y * kLog2e};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x = fmaf(st[4 * i + e], scale, bt[4 * i + e]);
              const float p = ex2_ftz(fmaf(x, kLog2e, -lc[e & 1]));
              st[4 * i + e] = decltype(mask)::value && 8 * i + 2 * tg + (e & 1) >= nq ? 0.f : p;
            }
          }
        };
        if (nq < kBkbBQ) probs(std::true_type{});
        else probs(std::false_type{});
        bw_pack<64>(st, fh, fl);
        // dv_j += Pᵀ·dO_j, dO MN-major (the transpose bit)
        wgmma_fence();
        bb_rs(dva[j], fh, fl, sGj);
        wgmma_commit();
        wgmma_wait<1>();                  // dPᵀ_j; Pᵀ·dO may still run
        fence_regs(dpt);
        // dSᵀ = Pᵀ ∘ (dPᵀ − delta), in place
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 d = *reinterpret_cast<const float2*>(drow + 8 * i + 2 * tg);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[4 * i + e] = st[4 * i + e] * (dpt[4 * i + e] - ((e & 1) ? d.y : d.x));
        }
        wgmma_wait<0>();                  // Pᵀ·dO: its fragments are free
        fence_regs(dva[j]);
        fence_regs_u(fh);
        fence_regs_u(fl);
        bw_pack<64>(dpt, fh, fl);
        // dk_j += dSᵀ·Q_j, Q MN-major, waited for at once: left in flight
        // under the next slot's Sᵀ and dPᵀ it was slower and spilled, and
        // across the query loop's back edge ptxas serialises every product
        // of the loop (C7515; PERF.md §6)
        wgmma_fence();
        bb_rs(dka[j], fh, fl, sQj);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dka[j]);
        if (j == T - 1) release(s);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < T; ++j) {
      fence_regs(dka[j]);
      fence_regs(dva[j]);
    }

    // epilogue: dk·scale and dv of every slot in range, bf16, into this
    // consumer's own rows of the slot's K and V (their last products have
    // completed), then TMA stores that clip the rows past Sk
#pragma unroll
    for (int j = 0; j < T; ++j)
      if (j < nv) {
        bb_stage_out(dka[j], scale, sK + j * kFbQBytes + cw * (kFbQBytes / 2), warp, g, tg);
        bb_stage_out(dva[j], 1.f, sV + j * kFbQBytes + cw * (kFbQBytes / 2), warp, g, tg);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1 + cw, 128);
    if ((threadIdx.x & 127) == 0) {
      for (int j = 0; j < nv; ++j) {
        fb_store<kFbNatural>(mdk, sK + j * kFbQBytes + cw * (kFbQBytes / 2), k0 + 64 * cw, g0 + j,
                             H);
        fb_store<kFbNatural>(mdv, sV + j * kFbQBytes + cw * (kFbQBytes / 2), k0 + 64 * cw, g0 + j,
                             H);
      }
      bulk_commit();
      bulk_wait_all();
    }
  }
}

// Launch `kern` (a __global__ taking the maps of q, k, v, dO, dq and the
// bias, then lse, delta, BH, Sq, Sk, H, the row groups and scale) for
// attn_wgmma_bwd_dq_bias_tile<T> on bf16 q/dO/dq [B, Sq, H, 32], k/v
// [B, Sk, H, 32], a float32 bias [Sq, Sk] (rows Sk apart: a row block of a
// larger matrix allowed) and float lse/delta [B, H, Sq]. Refuses
// (cudaErrorInvalidValue) a pointer of q, k, v, dO, dq or the bias that is
// not 16-byte aligned, a bias row of Sk elements that is no multiple of 16
// bytes, a null lse or delta, a map the driver does not encode, and a build
// whose launch registers would not cover the consumers' setmaxnreg.
template <int T, typename Kern>
int launch_bwd_dq_bias_wgmma(Kern kern, const void* q, const void* k, const void* v,
                             const void* g, const float* bias, const float* lse,
                             const float* delta, void* dq, int B, int Sq, int Sk, int H,
                             float scale, cudaStream_t stream) {
  using P = BqbPlan<T>;
  using FB = FbBias<float>;
  if (lse == nullptr || delta == nullptr || (Sk * 4) % 16 != 0) return (int)cudaErrorInvalidValue;
  int err = bw_prepare(kern, P::kSmem, {q, k, v, g, bias, dq}, B, Sq, Sk, H);
  if (err != 0) return err;
  CUtensorMap mq, mk, mv, mg, mdq, mb;
  if (!make_fb_map_4d(&mq, q, B, Sq, H, kFbBQ) || !make_fb_map_4d(&mk, k, B, Sk, H, kFbBK) ||
      !make_fb_map_4d(&mv, v, B, Sk, H, kFbBK) || !make_fb_map_4d(&mg, g, B, Sq, H, kFbBQ) ||
      !make_fb_map_4d(&mdq, dq, B, Sq, H, kFbBQ / 2) ||
      !make_map_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, bias, Sq, Sk, FB::kBoxCols, kFbBQ,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const int BH = B * H, nrg = (BH + T - 1) / T;
  const unsigned blocks = (unsigned)((long)nrg * ((Sq + kFbBQ - 1) / kFbBQ));
  kern<<<blocks, kWgThreads, P::kSmem, stream>>>(mq, mk, mv, mg, mdq, mb, lse, delta, BH, Sq, Sk,
                                                 H, nrg, scale);
  return (int)cudaGetLastError();
}

// Launch `kern` (a __global__ taking the maps of q, k, v, dO, lse, delta,
// dk, dv and the bias, then BH, Sq, Sk, H, the row groups and scale) for
// attn_wgmma_bwd_dkv_bias_tile<T> on bf16 q/dO [B, Sq, H, 32],
// k/v/dk/dv [B, Sk, H, 32], a float32 bias [Sq, Sk] (rows Sk apart) and
// float lse/delta [B, H, Sq]. Refuses (cudaErrorInvalidValue) a pointer
// that is not 16-byte aligned (lse and delta included: TMA reads them), a
// bias row that is no multiple of 16 bytes, an Sq that is no multiple of
// kBwRowMultiple (the row stride of the lse and delta maps), a map the
// driver does not encode, and a build whose launch registers would not
// cover the consumers' setmaxnreg.
template <int T, typename Kern>
int launch_bwd_dkv_bias_wgmma(Kern kern, const void* q, const void* k, const void* v,
                              const void* g, const float* bias, const float* lse,
                              const float* delta, void* dk, void* dv, int B, int Sq, int Sk,
                              int H, float scale, cudaStream_t stream) {
  using P = BkbPlan<T>;
  if (lse == nullptr || delta == nullptr || Sq % kBwRowMultiple != 0 || (Sk * 4) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int err = bw_prepare(kern, P::kSmem, {q, k, v, g, bias, lse, delta, dk, dv}, B, Sq, Sk, H);
  if (err != 0) return err;
  CUtensorMap mq, mk, mv, mg, ml, md, mdk, mdv, mb;
  const long BH = (long)B * H;
  if (!make_fb_map_4d(&mq, q, B, Sq, H, kBkbBQ) || !make_fb_map_4d(&mk, k, B, Sk, H, kFbBQ) ||
      !make_fb_map_4d(&mv, v, B, Sk, H, kFbBQ) || !make_fb_map_4d(&mg, g, B, Sq, H, kBkbBQ) ||
      !make_map_2d(&ml, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, lse, BH, Sq, kBkbBQ, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map_2d(&md, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, delta, BH, Sq, kBkbBQ, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_fb_map_4d(&mdk, dk, B, Sk, H, kFbBQ / 2) ||
      !make_fb_map_4d(&mdv, dv, B, Sk, H, kFbBQ / 2) ||
      !make_map_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, bias, Sq, Sk, kBkbBoxCols, kBkbBQ,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const int nrg = (int)((BH + T - 1) / T);
  const unsigned blocks = (unsigned)((long)nrg * ((Sk + kFbBQ - 1) / kFbBQ));
  kern<<<blocks, kWgThreads, P::kSmem, stream>>>(mq, mk, mv, mg, ml, md, mdk, mdv, mb, (int)BH,
                                                 Sq, Sk, H, nrg, scale);
  return (int)cudaGetLastError();
}

}  // namespace i360
