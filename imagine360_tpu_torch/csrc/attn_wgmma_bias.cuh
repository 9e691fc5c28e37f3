// The Hopper attention body at head dim 32 under one shared [Sq, Sk] bias:
// every bf16 launch of K6b (shared_bias_folded.cu,
// shared_bias_folded_wgmma_kernel, one per bias dtype) whose bias rows and
// pointers TMA can take (kernels.folded_wgmma_route). It replaces, for those
// launches, the `mma.sync` body of attn_mma.cuh (i360::flash_tile_mma under
// a staged bias tile, at most two folded rows a block), and with it the TPU
// kernel imagine360_tpu/ops/pallas_attention.py:_shared_bias_kernel.
//
// What it computes is what flash_tile_mma computes there: softmax(q·kᵀ·scale
// + bias)·v for each folded row of q [BH, Sq, 32] against k, v [BH, Sk, 32],
// one bias [Sq, Sk] (float32 or bfloat16) for all BH rows; keys at or beyond
// Sk masked; the row sum over the unrounded P; P·V on the exact split
// hi = bf16(p), lo = bf16(p - hi) (the kernel replaced keeps P in float32);
// the output divided by the sum (a zero sum replaced by 1) and rounded to
// bf16 once; with an lse pointer, lse = m + ln(l) in float32 [BH, Sq].
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
// - Shared memory: q, k, v and the output have 64-byte rows (64-byte
//   swizzle; wg_desc64: 8-row groups 512 bytes apart, V's k-step 1024
//   bytes); the bias tile lies as boxes of 128-byte rows under the 128-byte
//   swizzle (32 float32 or 64 bf16 keys a box), so the 8 rows a warp reads
//   fall on different banks: a thread reads its pair of keys (8i + 2tg,
//   +1) of row r at 16-byte chunk c ^ (r & 7). Read again for each row
//   instead of once a tile, the body is slower (the variants script's
//   `fb_smem_bias`, PERF.md §6).
// - The output of a row is staged, bf16, in the consumer's own rows of that
//   row's Q tile (its last Q·Kᵀ has completed) and leaves by TMA stores that
//   clip the rows past Sq; the lse by scalar stores.
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

// One 128-row query tile of kFbT folded rows; blockIdx.x is query tile ×
// nrg + row group (nrg = ceil(BH / kFbT) groups). The maps are those of
// launch_attn_wgmma_bias. `lse` null or the float [BH, Sq] rows. `smem` has
// FbBias<TB>::kSmem bytes.
template <typename TB>
__device__ __forceinline__ void attn_wgmma_bias_tile(const CUtensorMap* mq, const CUtensorMap* mk,
                                                     const CUtensorMap* mv, const CUtensorMap* mo,
                                                     const CUtensorMap* mb, float* lse, int BH,
                                                     int Sq, int Sk, int nrg, float scale,
                                                     unsigned char* smem) {
  using B = FbBias<TB>;
  static_assert(B::kStages >= 2, "two stages fit");
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
      for (int j = 0; j < kFbT; ++j) tma_load_3d(sQ + j * kFbQBytes, mq, barQ, 0, q0, row_of(j));
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % B::kStages;
        if (t >= B::kStages) mbar_wait(empty(s), ((t / B::kStages) - 1) & 1);
        mbar_expect_tx(full(s), B::kStage);
        for (int b = 0; b < B::kBoxes; ++b)
          tma_load_2d(stage(s) + b * B::kBoxBytes, mb, full(s), t * kFbBK + b * B::kBoxCols, q0);
        for (int j = 0; j < kFbT; ++j) {
          tma_load_3d(kt_of(s, j), mk, full(s), 0, t * kFbBK, row_of(j));
          tma_load_3d(kt_of(s, j) + kFbKVBytes, mv, full(s), 0, t * kFbBK, row_of(j));
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
    // S_j = Q_j·K_jᵀ issued from stage s (two k-steps at D = 32)
    auto qk = [&](int s, int j) {
      const uint64_t dq = wg_desc64(sQ + j * kFbQBytes + cw * (kFbQBytes / 2));
      const uint64_t dk = wg_desc64(kt_of(s, j));
#pragma unroll
      for (int ks = 0; ks < kFbD / 16; ++ks) wgmma_ss<kFbBK>(sc, dq + 2 * ks, dk + 2 * ks, ks);
    };
    // acc += P·V issued, V at shared address `va` (MN-major: 16 key rows,
    // 1024 bytes, a k-step), the lo product before the hi one at each step
    auto pv = [&](float (&acc)[16], FbP& p, uint32_t va) {
      const uint64_t dv = wg_desc64(va);
#pragma unroll
      for (int kk = 0; kk < kFbBK / 16; ++kk) {
        wgmma_rs_n32<1>(acc, p.lo[kk], dv + kk * (1024 >> 4));
        wgmma_rs_n32<1>(acc, p.hi[kk], dv + kk * (1024 >> 4));
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
          fence_regs_u(pa[(j + 1) & 1].lo);
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
    // chunk i of row rr at i ^ ((rr >> 1) & 3)), then TMA stores that clip
    // the rows past Sq
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
        tma_store_3d_async(mo, sQ + j * kFbQBytes + cw * (kFbQBytes / 2), 0, q0 + 64 * cw,
                           g0 + j);
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

// Launch `kern` (a __global__ taking the five maps, then lse, BH, Sq, Sk,
// nrg and scale) for attn_wgmma_bias_tile<TB> on bf16 q [BH, Sq, 32], k/v
// [BH, Sk, 32], out [BH, Sq, 32] and a TB bias [Sq, Sk], lse null or float
// [BH, Sq], kFbT folded rows a block. Refuses (cudaErrorInvalidValue)
// pointers of q, k, v, out or the bias off a
// 16-byte boundary, a bias row of Sk elements that is no multiple of 16
// bytes (the map's row stride), a map the driver does not encode, and a
// build whose launch registers would not cover the consumers' setmaxnreg.
template <typename TB, typename Kern>
int launch_attn_wgmma_bias(Kern kern, const void* q, const void* k, const void* v,
                           const void* bias, void* out, float* lse, int BH, int Sq, int Sk,
                           float scale, cudaStream_t stream) {
  using B = FbBias<TB>;
  if ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out | (uintptr_t)bias) & 15) !=
          0 ||
      BH < 1 || Sq < 1 || Sk < 1 || (Sk * (int)sizeof(TB)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo, mb;
  const auto tb = sizeof(TB) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_fb_map(&mq, q, BH, Sq, kFbBQ) || !make_fb_map(&mk, k, BH, Sk, kFbBK) ||
      !make_fb_map(&mv, v, BH, Sk, kFbBK) || !make_fb_map(&mo, out, BH, Sq, kFbBQ / 2) ||
      !make_map_2d(&mb, tb, (int)sizeof(TB), bias, Sq, Sk, B::kBoxCols, kFbBQ,
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
  kern<<<blocks, kWgThreads, B::kSmem, stream>>>(mq, mk, mv, mo, mb, lse, BH, Sq, Sk, nrg,
                                                 scale);
  return (int)cudaGetLastError();
}

}  // namespace i360
