// The Hopper bodies of the streaming attention backward for bf16 storage at
// head dim 64 without a bias: every K5b (flash_bwd_dq.cu,
// flash_bwd_dq_wgmma_kernel) and K5c (flash_bwd_dkv.cu,
// flash_bwd_dkv_wgmma_kernel) launch that kernels.wgmma_route gives them,
// which is every launch of the training step at the pano's spatial
// self-attention. They replace, for those launches, the `mma.sync` tiles of
// attn_mma_bwd.cuh, and with them the TPU kernels
// imagine360_tpu/ops/pallas_attention.py: _flash_bwd_dq_kernel (K5b) and
// _flash_bwd_dkv_kernel (K5c), the two pallas_calls of _flash_bhsd_bwd.
//
// What they compute is what flash_bwd_dq_tile_mma and flash_bwd_dkv_tile_mma
// compute for a problem without a bias, from the forward's float32 lse and
// delta = rowsum(dO ∘ O), both [B, H, Sq]:
//   P = 2^(S·scale·log2 e − lse·log2 e) with S = Q·Kᵀ (ex2.approx.ftz, as
//   the forward of attn_wgmma.cuh: results below 2^-126 flushed to 0),
//   dP = dO·Vᵀ, dS = P ∘ (dP − delta),
//   K5b: dq = scale · Σ_k dS·K, summed over the key tiles in order;
//   K5c: dv = Σ_q Pᵀ·dO and dk = scale · Σ_q dSᵀ·Q, summed over the query
//   tiles in order.
// No atomics: a block owns its output rows and walks the other side in a
// loop, as the sequential grid axis of the TPU kernels did, so the result is
// deterministic. P and dS stay float32 in the kernels replaced, so every
// product that takes them (dS in K5b; P and dS in K5c) takes the exact
// split x = hi + lo of two bf16 values (attn_mma.cuh pack_bf16_rest), the
// lo product before the hi one at each k-step.
//
// What bounds them on the H100: 6·Sq·Sk·64 (K5b: S, dP, dS·K) and
// 8·Sq·Sk·64 (K5c: Sᵀ, dPᵀ, Pᵀ·dO, dSᵀ·Q) operations per (batch, head)
// against (3·Sq + 2·Sk)·128 and (2·Sq + 4·Sk)·128 bytes plus the float32
// rows: far above the card's ~295 bf16 operations a byte, so bound by
// operations, 989 TFLOP/s bf16 on the tensor cores. The split adds a
// product to each of the 3 (K5b) or 2 (K5c) products it touches, so the
// tensor cores do 4/3 (K5b) and 6/4 (K5c) of the counted work; the
// elementwise work (2^x, dS, two packs and a subtraction a logit) runs
// beside them on the SM.
//
// What held the `mma.sync` tiles back (12-14% of that bound), and what this
// design does about it:
// - The instruction: a warp's m16n8k16 with both operands reloaded by
//   ldmatrix. Here every product is a warpgroup's `wgmma.mma_async`
//   (m64n64k16, or m64nBKk16 for K5b's S and dP): the products of S and dP
//   (K5c: their transposes) with both operands read from shared memory
//   through descriptors, the dS (and P) products with their A operand in
//   registers, the accumulator layout packed to bf16 pairs, as the forward's
//   P·V; the B operand there (K: [key][d], Q and dO: [query][d]) is
//   MN-major, read through the descriptor's transpose bit, so no transposed
//   copy is made.
// - The copies: one producer thread issues TMA copies into an mbarrier
//   ring, the two consumer warpgroups wait only for their own tiles and
//   return a stage once their last product on it has completed; setmaxnreg
//   moves registers from the producer warpgroup (40) to the consumers (232),
//   as in attn_wgmma.cuh.
// - The products under the elementwise work, inside a warpgroup. K5b, key
//   tile t: S_t and dP_t issued (the previous tile's dS·K still in flight
//   before them); P_t computed while dP_t runs; then dS_t, and dQ += dS_t·K_t
//   issued and left in flight into tile t + 1. K5c, query tile t: Sᵀ_t and
//   dPᵀ_t issued (the previous tile's dSᵀ·Q still in flight); Pᵀ_t computed
//   while dPᵀ_t runs; dV += Pᵀ_t·dO_t issued; dSᵀ_t computed while it runs;
//   dK += dSᵀ_t·Q_t issued and left in flight. One register set of each
//   operand suffices: a set is rewritten only after a wait that completes
//   the product reading it. The two consumers also interleave on the SM.
//   scripts/torch_wgmma_variants.py builds the serial form (each tile's last
//   product waited for at once) and K5b on 128-key tiles by text edits of a
//   copy of this header (PERF.md §6).
//
// K5b (attn_wgmma_bwd_dq_tile): a block owns one (batch, head) and 128
// queries, 64 a consumer; Q and dO arrive once (16 KB each), the ring
// carries K and V tiles of kBqBK keys; a thread keeps its two rows' lse (log2
// units) and delta in registers, read once from device memory (a row at or
// past Sq reads none and is never stored). Keys at or beyond Sk (zero rows
// of the last tile's copies) get P = dS = 0. A thread holds S and dP of a
// tile (kBqBK/2 floats each), dS hi + lo (kBqBK/2 registers) and dq (32).
// The query tile is the fastest grid axis, so the blocks that run together
// read one (batch, head)'s K and V from L2.
//
// K5c (attn_wgmma_bwd_dkv_tile): a block owns one (batch, head) and 128 keys,
// 64 a consumer; its K and V arrive once (16 KB each), the ring carries the
// Q and dO tiles of 64 queries (8 KB each) and their lse and delta rows
// (2-D float32 maps {Sq, B·H}, boxes of 64: Sq must be a multiple of 4 so
// that a row of Sq·4 bytes is a multiple of 16, which the launcher
// checks). The transposed tiles land in the rows of the dk and dv
// accumulators: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with both operands K-major; in
// them lse and delta vary along the columns (queries 8i + 2tg, + 1 of a
// thread), so a thread reads its 16 pairs of each from the staged rows. A
// query at or beyond Sq (zero rows of the copies) gets P = dS = 0. A thread
// holds Sᵀ (32 floats, P in place), dPᵀ (32, dS in place), P and dS hi + lo
// (32 registers each), dk and dv (32 each). The key tile is the fastest
// grid axis, so the blocks that run together read one (batch, head)'s Q,
// dO and rows from L2.
//
// Operands in shared memory, all but the float32 rows 128-byte swizzled as
// TMA writes them, with the 4-D maps {64, H, S, B} of attn_wgmma.cuh
// (make_wg_map): a tile is a box of rows of 128 bytes (one position's 64
// head-dim elements). A row past S is zero-filled inside its own (batch,
// head) slab. The output tile of a consumer is staged in its own rows of Q
// (K5b) or of K and V (K5c), their last products having completed, and
// leaves by TMA stores that clip the rows past Sq (Sk).
//
// Budget: K5b 32 KB of Q and dO and, per stage, kBqBK·256 bytes of K and V
// (4 stages of 64 keys: 64 KB); K5c 32 KB of K and V and, per stage, 16.5 KB
// of Q, dO and the rows (4 stages: 66 KB); plus the barriers and 1 KB to
// align the tiles. 384 threads, 168 registers a thread at launch
// (__launch_bounds__(384, 1)): one block an SM. The ptxas report that
// build_library() keeps beside the library gives registers and spills.
#pragma once

#include <initializer_list>
#include <type_traits>

#include "wgmma_ops.cuh"

namespace i360 {

constexpr int kBqBK = 64;        // K5b: keys a tile of the ring
constexpr int kBqStages = 4;     // K5b: stages of the K/V ring
constexpr int kBkBQ = 64;        // K5c: queries a tile of the ring
constexpr int kBkStages = 4;     // K5c: stages of the Q/dO ring
constexpr int kBwRowMultiple = 4;   // K5c: Sq a multiple of this (the rows' maps)
constexpr int kBqKVBytes = kBqBK * kWgD * 2;   // one K or V tile of K5b
constexpr int kBkQBytes = kBkBQ * kWgD * 2;    // one Q or dO tile of K5c
constexpr int kBkRowBytes = kBkBQ * 4;         // one float32 lse or delta tile of K5c

// Q and dO, the K and V ring, then the barriers: Q's, and per stage full and
// empty; plus 1 KB to align the tiles
constexpr size_t kBqSmemBytes = 1024 + 2 * (size_t)kWgQBytes +
                                2 * (size_t)kBqStages * kBqKVBytes + 8 * (1 + 2 * kBqStages);
// K and V, the Q and dO ring, the lse and delta ring, then the barriers
constexpr size_t kBkSmemBytes = 1024 + 2 * (size_t)kWgQBytes + 2 * (size_t)kBkStages * kBkQBytes +
                                2 * (size_t)kBkStages * kBkRowBytes + 8 * (1 + 2 * kBkStages);
static_assert(kBqSmemBytes <= (size_t)kWgSmemLimit && kBkSmemBytes <= (size_t)kWgSmemLimit,
              "a block's shared memory");

// One float32 accumulator of a consumer packed as the A fragments of the
// N/16 k-steps of a product that takes it: element 4i + j is row g (j < 2)
// or g + 8, column 8i + 2tg + (j & 1), so k-step kk is the column tiles 2kk
// and 2kk + 1. hi = bf16(x), lo = bf16(x - hi).
template <int N>
__device__ __forceinline__ void bw_pack(const float (&x)[N / 2], uint32_t (&hi)[N / 16][4],
                                        uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = 2 * kk + hf;
      hi[kk][2 * hf] = pack_bf16(x[4 * i], x[4 * i + 1]);
      hi[kk][2 * hf + 1] = pack_bf16(x[4 * i + 2], x[4 * i + 3]);
      lo[kk][2 * hf] = pack_bf16_rest(x[4 * i], x[4 * i + 1], hi[kk][2 * hf]);
      lo[kk][2 * hf + 1] = pack_bf16_rest(x[4 * i + 2], x[4 * i + 3], hi[kk][2 * hf + 1]);
    }
  }
}

// d += (hi + lo)·b over the N/16 k-steps of 16 rows of an MN-major B tile
// at descriptor db (16 rows of 128 bytes, 2048 bytes, a k-step): the lo
// product before the hi one.
template <int N>
__device__ __forceinline__ void bw_rs(float (&d)[32], const uint32_t (&hi)[N / 16][4],
                                      const uint32_t (&lo)[N / 16][4], uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    wgmma_m64n64k16_rs<1>(d, lo[kk], db + 128 * kk);
    wgmma_m64n64k16_rs<1>(d, hi[kk], db + 128 * kk);
  }
}

// The producer thread's ring: `n` tiles, tile t into stage t % STAGES once
// the consumers have returned that stage; `load(s, t)` issues its copies
// completing on full(s) with `bytes` bytes.
template <int STAGES, typename Full, typename Empty, typename Load>
__device__ __forceinline__ void bw_produce(int n, int bytes, Full full, Empty empty, Load load) {
  for (int t = 0; t < n; ++t) {
    const int s = t % STAGES;
    if (t >= STAGES) mbar_wait(empty(s), ((t / STAGES) - 1) & 1);
    mbar_expect_tx(full(s), bytes);
    load(s, t);
  }
}

// The 64 × 64 float accumulator `x` of a consumer (times `mul`), bf16, into
// its 64 rows of 128 bytes at `rows` (128-byte swizzled, as a 4-D map
// reads them): row warp·16 + g (+ 8), columns 8i + 2tg, + 1.
__device__ __forceinline__ void bw_stage_out(const float (&x)[32], float mul, uint32_t rows,
                                             int warp, int g, int tg) {
  const uint32_t row = rows + (warp * 16 + g) * 128 + tg * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t chunk = (uint32_t)((i ^ g) << 4);   // rows g and g + 8: the same pattern
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(row + chunk),
                 "r"(pack_bf16(x[4 * i] * mul, x[4 * i + 1] * mul)) : "memory");
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(row + 8 * 128 + chunk),
                 "r"(pack_bf16(x[4 * i + 2] * mul, x[4 * i + 3] * mul)) : "memory");
  }
}

// K5b: dq of one query tile (128 rows) of one (batch, head); blockIdx.x is
// (batch × head) × query tiles + query tile. mq, mg, mdq are the maps of q,
// dO and dq [B, Sq, H·64] (boxes of 128, 128 and 64 rows), mk and mv of k
// and v [B, Sk, H·64] (boxes of kBqBK rows); lse and delta point at the
// float [B·H, Sq] rows. `sl2` is scale·log2(e). `smem` has kBqSmemBytes.
__device__ __forceinline__ void attn_wgmma_bwd_dq_tile(
    const CUtensorMap* mq, const CUtensorMap* mk, const CUtensorMap* mv, const CUtensorMap* mg,
    const CUtensorMap* mdq, const float* lse, const float* delta, int Sq, int Sk, int H, int nqt,
    float sl2, float scale, unsigned char* smem) {
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sG = sQ + kWgQBytes;
  const uint32_t sK = sG + kWgQBytes;
  const uint32_t sV = sK + kBqStages * kBqKVBytes;
  const uint32_t barQ = sV + kBqStages * kBqKVBytes;
  auto full = [&](int s) { return barQ + 8 + 8 * s; };
  auto empty = [&](int s) { return barQ + 8 + 8 * (kBqStages + s); };

  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * kWgBQ;
  const int b = bh / H, h = bh - b * H;
  const int ntiles = (Sk + kBqBK - 1) / kBqBK;
  const int ncons = q0 + 64 < Sq ? 2 : 1;   // consumers with query rows in range
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < kBqStages; ++s) {
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
      mbar_expect_tx(barQ, 2 * kWgQBytes);
      tma_load_4d(sQ, mq, barQ, 0, h, q0, b);
      tma_load_4d(sG, mg, barQ, 0, h, q0, b);
      bw_produce<kBqStages>(ntiles, 2 * kBqKVBytes, full, empty, [&](int s, int t) {
        tma_load_4d(sK + s * kBqKVBytes, mk, full(s), 0, h, t * kBqBK, b);
        tma_load_4d(sV + s * kBqKVBytes, mv, full(s), 0, h, t * kBqBK, b);
      });
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
    const int cw = wg - 1;               // this consumer's 64 rows of the tile
    if (cw >= ncons) return;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tg = lane & 3;
    const uint32_t sQc = sQ + cw * (kWgQBytes / 2);
    const uint64_t q_desc = wg_desc(sQc), g_desc = wg_desc(sG + cw * (kWgQBytes / 2));
    // lse (log2 units) and delta of rows g and g + 8
    const int r0 = q0 + 64 * cw + 16 * warp + g;
    const long row0 = (long)bh * Sq;
    float l2[2], de[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const bool ok = r0 + 8 * hr < Sq;
      l2[hr] = ok ? lse[row0 + r0 + 8 * hr] * kLog2e : 0.f;
      de[hr] = ok ? delta[row0 + r0 + 8 * hr] : 0.f;
    }
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float sc[kBqBK / 2], dp[kBqBK / 2];
    uint32_t dh[kBqBK / 16][4], dl[kBqBK / 16][4];
    mbar_wait(barQ, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kBqStages;
      const uint32_t sKs = sK + s * kBqKVBytes;
      mbar_wait(full(s), (t / kBqStages) & 1);
      // S = Q·K_tᵀ and dP = dO·V_tᵀ, both operands K-major (32 bytes a k-step)
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWgD / 16; ++ks)
        wgmma_ss<kBqBK>(sc, q_desc + 2 * ks, wg_desc(sKs) + 2 * ks, ks);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < kWgD / 16; ++ks)
        wgmma_ss<kBqBK>(dp, g_desc + 2 * ks, wg_desc(sV + s * kBqKVBytes) + 2 * ks, ks);
      wgmma_commit();
      wgmma_wait<1>();                  // S_t, and dQ += dS_{t-1}·K_{t-1} before it
      fence_regs(sc);
      if (t > 0) {                      // this warp is done with stage t - 1
        __syncwarp();
        if (lane == 0) mbar_arrive(empty((t - 1) % kBqStages));
      }
      // P = 2^(S·scale·log2 e − lse·log2 e) in place; on the last, partial
      // tile (MASK) keys at or beyond Sk 0
      const int nk = Sk - t * kBqBK;
      auto probs = [&](auto mask) {
#pragma unroll
        for (int i = 0; i < kBqBK / 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = ex2_ftz(sc[4 * i + j] * sl2 - l2[j >> 1]);
            sc[4 * i + j] = decltype(mask)::value && 8 * i + 2 * tg + (j & 1) >= nk ? 0.f : p;
          }
      };
      if (nk < kBqBK) probs(std::true_type{});
      else probs(std::false_type{});
      wgmma_wait<0>();                  // dP_t
      fence_regs(dp);
      // dS = P ∘ (dP − delta), split as the A fragments of dQ += dS·K
#pragma unroll
      for (int i = 0; i < kBqBK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[4 * i + j] = sc[4 * i + j] * (dp[4 * i + j] - de[j >> 1]);
      bw_pack<kBqBK>(dp, dh, dl);
      // dQ += dS·K_t, K MN-major (the transpose bit), left in flight
      wgmma_fence();
      bw_rs<kBqBK>(acc, dh, dl, wg_desc(sKs));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: dq·scale, bf16, into this consumer's own Q rows (its last
    // Q·Kᵀ has completed), then one TMA store that clips the rows past Sq
    bw_stage_out(acc, scale, sQc, warp, g, tg);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1 + cw, 128);
    if ((threadIdx.x & 127) == 0) tma_store_4d(mdq, sQc, 0, h, q0 + 64 * cw, b);
  }
}

// K5c: dk and dv of one key tile (128 rows) of one (batch, head);
// blockIdx.x is (batch × head) × key tiles + key tile. mk, mv are the maps
// of k and v [B, Sk, H·64] (boxes of 128 rows), mdk, mdv of dk and dv
// (boxes of 64), mq, mg of q and dO [B, Sq, H·64] (boxes of kBkBQ), ml, md
// of the float lse and delta rows {Sq, B·H} (boxes of kBkBQ). `sl2` is
// scale·log2(e). `smem` has kBkSmemBytes.
__device__ __forceinline__ void attn_wgmma_bwd_dkv_tile(
    const CUtensorMap* mq, const CUtensorMap* mk, const CUtensorMap* mv, const CUtensorMap* mg,
    const CUtensorMap* ml, const CUtensorMap* md, const CUtensorMap* mdk, const CUtensorMap* mdv,
    int Sq, int Sk, int H, int nkt, float sl2, float scale, unsigned char* smem) {
  const uint32_t base0 = smem_u32(smem);
  const uint32_t base = (base0 + 1023u) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sV = sK + kWgQBytes;
  const uint32_t sQ = sV + kWgQBytes;
  const uint32_t sG = sQ + kBkStages * kBkQBytes;
  const uint32_t sL = sG + kBkStages * kBkQBytes;
  const uint32_t sD = sL + kBkStages * kBkRowBytes;
  const uint32_t barKV = sD + kBkStages * kBkRowBytes;
  auto full = [&](int s) { return barKV + 8 + 8 * s; };
  auto empty = [&](int s) { return barKV + 8 + 8 * (kBkStages + s); };

  const int bh = blockIdx.x / nkt, k0 = (blockIdx.x - bh * nkt) * kWgBQ;
  const int b = bh / H, h = bh - b * H;
  const int ntiles = (Sq + kBkBQ - 1) / kBkBQ;
  const int ncons = k0 + 64 < Sk ? 2 : 1;   // consumers with key rows in range
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(barKV, 1);
    for (int s = 0; s < kBkStages; ++s) {
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
      mbar_expect_tx(barKV, 2 * kWgQBytes);
      tma_load_4d(sK, mk, barKV, 0, h, k0, b);
      tma_load_4d(sV, mv, barKV, 0, h, k0, b);
      bw_produce<kBkStages>(ntiles, 2 * (kBkQBytes + kBkRowBytes), full, empty,
                            [&](int s, int t) {
        tma_load_4d(sQ + s * kBkQBytes, mq, full(s), 0, h, t * kBkBQ, b);
        tma_load_4d(sG + s * kBkQBytes, mg, full(s), 0, h, t * kBkBQ, b);
        tma_load_2d(sL + s * kBkRowBytes, ml, full(s), t * kBkBQ, bh);
        tma_load_2d(sD + s * kBkRowBytes, md, full(s), t * kBkBQ, bh);
      });
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
    const int cw = wg - 1;               // this consumer's 64 keys of the tile
    if (cw >= ncons) return;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tg = lane & 3;
    const uint32_t sKc = sK + cw * (kWgQBytes / 2), sVc = sV + cw * (kWgQBytes / 2);
    const uint64_t k_desc = wg_desc(sKc), v_desc = wg_desc(sVc);
    float dka[32], dva[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
    float st[32], dpt[32];               // Sᵀ (then Pᵀ) and dPᵀ (then dSᵀ)
    uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
    mbar_wait(barKV, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kBkStages;
      const uint32_t sQs = sQ + s * kBkQBytes, sGs = sG + s * kBkQBytes;
      // this thread's columns (queries 8i + 2tg, + 1) of the staged rows
      const float* lrow = reinterpret_cast<const float*>(smem + (sL + s * kBkRowBytes - base0));
      const float* drow = reinterpret_cast<const float*>(smem + (sD + s * kBkRowBytes - base0));
      mbar_wait(full(s), (t / kBkStages) & 1);
      // Sᵀ = K·Q_tᵀ and dPᵀ = V·dO_tᵀ, both operands K-major
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWgD / 16; ++ks)
        wgmma_ss_n64<0, 0>(st, k_desc + 2 * ks, wg_desc(sQs) + 2 * ks, ks);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < kWgD / 16; ++ks)
        wgmma_ss_n64<0, 0>(dpt, v_desc + 2 * ks, wg_desc(sGs) + 2 * ks, ks);
      wgmma_commit();
      wgmma_wait<1>();                  // Sᵀ_t, and dK += dSᵀ_{t-1}·Q_{t-1} before it
      fence_regs(st);
      if (t > 0) {                      // this warp is done with stage t - 1
        __syncwarp();
        if (lane == 0) mbar_arrive(empty((t - 1) % kBkStages));
      }
      // Pᵀ = 2^(Sᵀ·scale·log2 e − lse·log2 e) in place; on the last, partial
      // tile (MASK) queries at or beyond Sq 0
      const int nq = Sq - t * kBkBQ;
      auto probs = [&](auto mask) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 l = *reinterpret_cast<const float2*>(lrow + 8 * i + 2 * tg);
          const float lc[2] = {l.x * kLog2e, l.y * kLog2e};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = ex2_ftz(st[4 * i + j] * sl2 - lc[j & 1]);
            st[4 * i + j] = decltype(mask)::value && 8 * i + 2 * tg + (j & 1) >= nq ? 0.f : p;
          }
        }
      };
      if (nq < kBkBQ) probs(std::true_type{});
      else probs(std::false_type{});
      bw_pack<64>(st, ph, pl);
      // dV += Pᵀ·dO_t, dO MN-major (the transpose bit)
      wgmma_fence();
      bw_rs<64>(dva, ph, pl, wg_desc(sGs));
      wgmma_commit();
      wgmma_wait<1>();                  // dPᵀ_t; Pᵀ·dO may still run
      fence_regs(dpt);
      // dSᵀ = Pᵀ ∘ (dPᵀ − delta), in place
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 d = *reinterpret_cast<const float2*>(drow + 8 * i + 2 * tg);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dpt[4 * i + j] = st[4 * i + j] * (dpt[4 * i + j] - ((j & 1) ? d.y : d.x));
      }
      bw_pack<64>(dpt, dh, dl);
      // dK += dSᵀ·Q_t, Q MN-major, left in flight
      wgmma_fence();
      bw_rs<64>(dka, dh, dl, wg_desc(sQs));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);

    // epilogue: dk·scale and dv, bf16, into this consumer's own K and V rows
    // (their last products have completed), then TMA stores that clip the
    // rows past Sk
    bw_stage_out(dka, scale, sKc, warp, g, tg);
    bw_stage_out(dva, 1.f, sVc, warp, g, tg);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1 + cw, 128);
    if ((threadIdx.x & 127) == 0) {
      tma_store_4d(mdk, sKc, 0, h, k0 + 64 * cw, b);
      tma_store_4d(mdv, sVc, 0, h, k0 + 64 * cw, b);
    }
  }
}

// The checks both launchers share: 16-byte-aligned pointers, positive
// sizes, a build whose launch registers cover the consumers' setmaxnreg
// (else the launch would wait forever), and the dynamic shared memory.
template <typename Kern>
inline int bw_prepare(Kern kern, size_t smem, std::initializer_list<const void*> ptrs, int B,
                      int Sq, int Sk, int H) {
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= (uintptr_t)p;
  if ((any & 15) != 0 || B < 1 || Sq < 1 || Sk < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs < kWgLaunchRegs) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launch `kern` (a __global__ taking the maps of q, k, v, dO and dq, then
// lse, delta, Sq, Sk, H, the query tiles a (batch, head), scale·log2(e) and
// scale) for attn_wgmma_bwd_dq_tile on bf16 q/dO/dq [B, Sq, H·64], k/v
// [B, Sk, H·64], float lse/delta [B, H, Sq]. Refuses (cudaErrorInvalidValue)
// a pointer of q, k, v, g or dq that is not 16-byte aligned, a null lse or
// delta, a map the driver does not encode.
template <typename Kern>
int launch_bwd_dq_wgmma(Kern kern, const void* q, const void* k, const void* v, const void* g,
                        const float* lse, const float* delta, void* dq, int B, int Sq, int Sk,
                        int H, float scale, cudaStream_t stream) {
  if (lse == nullptr || delta == nullptr) return (int)cudaErrorInvalidValue;
  int err = bw_prepare(kern, kBqSmemBytes, {q, k, v, g, dq}, B, Sq, Sk, H);
  if (err != 0) return err;
  CUtensorMap mq, mk, mv, mg, mdq;
  if (!make_wg_map(&mq, q, B, Sq, H, kWgBQ) || !make_wg_map(&mk, k, B, Sk, H, kBqBK) ||
      !make_wg_map(&mv, v, B, Sk, H, kBqBK) || !make_wg_map(&mg, g, B, Sq, H, kWgBQ) ||
      !make_wg_map(&mdq, dq, B, Sq, H, kWgBQ / 2))
    return (int)cudaErrorInvalidValue;
  const int nqt = (Sq + kWgBQ - 1) / kWgBQ;
  const unsigned blocks = (unsigned)((long)B * H * nqt);
  kern<<<blocks, kWgThreads, kBqSmemBytes, stream>>>(mq, mk, mv, mg, mdq, lse, delta, Sq, Sk, H,
                                                    nqt, scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

// Launch `kern` (a __global__ taking the maps of q, k, v, dO, lse, delta, dk
// and dv, then Sq, Sk, H, the key tiles a (batch, head), scale·log2(e) and
// scale) for attn_wgmma_bwd_dkv_tile on bf16 q/dO [B, Sq, H·64],
// k/v/dk/dv [B, Sk, H·64], float lse/delta [B, H, Sq]. Refuses
// (cudaErrorInvalidValue) a pointer that is not 16-byte aligned (lse and
// delta included), an Sq that is no multiple of kBwRowMultiple (the row
// stride of the lse and delta maps), a map the driver does not encode.
template <typename Kern>
int launch_bwd_dkv_wgmma(Kern kern, const void* q, const void* k, const void* v, const void* g,
                         const float* lse, const float* delta, void* dk, void* dv, int B, int Sq,
                         int Sk, int H, float scale, cudaStream_t stream) {
  if (lse == nullptr || delta == nullptr || Sq % kBwRowMultiple != 0)
    return (int)cudaErrorInvalidValue;
  int err = bw_prepare(kern, kBkSmemBytes, {q, k, v, g, lse, delta, dk, dv}, B, Sq, Sk, H);
  if (err != 0) return err;
  CUtensorMap mq, mk, mv, mg, ml, md, mdk, mdv;
  const long BH = (long)B * H;
  if (!make_wg_map(&mq, q, B, Sq, H, kBkBQ) || !make_wg_map(&mk, k, B, Sk, H, kWgBQ) ||
      !make_wg_map(&mv, v, B, Sk, H, kWgBQ) || !make_wg_map(&mg, g, B, Sq, H, kBkBQ) ||
      !make_map_2d(&ml, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, lse, BH, Sq, kBkBQ, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map_2d(&md, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, delta, BH, Sq, kBkBQ, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_wg_map(&mdk, dk, B, Sk, H, kWgBQ / 2) || !make_wg_map(&mdv, dv, B, Sk, H, kWgBQ / 2))
    return (int)cudaErrorInvalidValue;
  const int nkt = (Sk + kWgBQ - 1) / kWgBQ;
  const unsigned blocks = (unsigned)(BH * nkt);
  kern<<<blocks, kWgThreads, kBkSmemBytes, stream>>>(mq, mk, mv, mg, ml, md, mdk, mdv, Sq, Sk, H,
                                                    nkt, scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

}  // namespace i360
