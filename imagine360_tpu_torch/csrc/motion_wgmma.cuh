// The Hopper body of L2 (motion_fused.cu, fused_motion_wgmma_kernel): bf16
// storage, head dim 40, 80 or 160, no exp_bf16, 16-byte-aligned pointers,
// F dividing 64 and packs of S = G·F tokens a multiple of 128
// (kernels.fused_wgmma_route): every bf16 L2 launch of the lab that is not
// exp_bf16. It replaces, for those launches, the `mma.sync` streaming body
// of attn_mma.cuh with gathered rows (fused_motion_mma_kernel), and with it
// the TPU kernel scripts/exp_motion_kernels.py:_fused_kernel (wrapper
// fused_motion_attention).
//
// What it computes is L2's function: for q, k, v [B, F, HW, C] with H heads
// of D = C / H, the G neighbouring locations of a pack form one sequence of
// S = G·F tokens in block order (row g·F + f: location g, frame f), and
// every (batch row, pack, head) problem takes softmax(q·kᵀ·scale + bias)·v
// over all S keys under one bias [S, S] (float32 or bf16) shared by every
// problem: the online softmax per key tile, the logit and the bias meeting
// in one FFMA (x = s·scale + bias, natural units), 2^x as ex2.approx.ftz of
// x·log2 e − m·log2 e, float32 sums over the unrounded P, P rounded once to
// bf16 for P·V (as the mma.sync body rounds it, before the division), O
// divided by the sum and rounded once. -inf in the bias gives p = 0; a fully
// masked row is outside the wrapper's contract.
//
// What bounds it on the H100: the lab site (40, 16, 1024, 320, 8) at G = 32
// is 2.68·10⁹ logits (1280 packs × 8 heads × 512²). Each costs a MUFU ex2
// (16 a clock an SM: ~0.7 ms), some eight instructions of a thread (the
// bias FFMA, the max, the exponent's FFMA, the ex2, the sum, the packing,
// the bias read: ~0.6 ms of issue) and 176 tensor-core operations at
// D = 40 (~0.5 ms), against 0.50 ms for the bytes. So the body has to keep
// the softmax under the products and keep the traffic the bias causes, not
// its 1 MB, off the critical path: read once a block for T row slots, and
// K and V once for 128 query rows.
//
// The design (attn_wgmma_bias.cuh's, at L2's widths and rows):
// - A block is three warpgroups: one producer and two consumers of 64
//   query rows each (128 rows of a pack), setmaxnreg 40 / 232. It owns one
//   128-row query tile of T = mw_slots(D) row slots: T heads of one pack
//   (4 at D = 40, 2 at 80, 1 at 160: O takes D / 2 floats a thread a slot),
//   whose columns are neighbours in C; past H the last head again
//   (computed, not stored). The query tile is the fastest grid axis, then
//   the head group, the pack and the batch row: a pack's K and V come from
//   L2 for its other query tiles, and the one [S, S] bias stays in L2.
// - One producer thread issues TMA copies: the T Q tiles once, then for
//   each key tile of 64 keys one stage of a ring of kMwStages: the
//   [128, 64] bias tile once, in its own dtype (128-byte-swizzled boxes,
//   as attn_wgmma_bias.cuh stages it), and under it the K and V tiles of
//   the T slots; full and empty mbarriers.
// - The rows need no gather: a 5-D map {8, F, HW, C / 8, B} (byte strides
//   {HW·C·2, C·2, 16, F·HW·C·2}, out of order) with box {8, F, rows / F,
//   D / 8, 1} lands a tile as [D / 8][g·F + f][8]: 16-byte core matrices
//   in packed row order, which a no-swizzle `wgmma` descriptor reads
//   directly (K-major Q and K: 8-row groups 128 bytes apart, k-chunks a
//   chunk apart; V MN-major, the transpose bit: 8-key groups 128 bytes
//   apart, 8-column groups a chunk apart).
// - At D = 40, Q·Kᵀ's third k-step covers columns 32-47: Q's and K's
//   buffers have a sixth chunk that the block zeroes once and TMA never
//   writes, so columns 40-47 add 0 and no column of another head enters.
// - A consumer walks the key tiles and, under each, its T slots: S =
//   Q·Kᵀ (wgmma m64n64k16 SS), the online softmax (mw_softmax: fb_softmax's
//   arithmetic, each bias pair read from the staged tile (fb_bias) where it
//   meets its logit, since T slots of O leave no room to hold a tile's
//   pairs), O rescaled, O += P·V (m64nDk16, P from registers). A slot's S is issued
//   with the previous slot's P·V and its softmax runs while that P·V is on
//   the tensor cores (P of the two in two register sets, swapped item by
//   item); no product stays in flight from one item to the next (C7515).
// - The output of a slot is staged, bf16, in the consumer's own rows of
//   its Q tile (its last Q·Kᵀ has completed) and leaves by TMA stores, one
//   a 16-byte chunk of 64 rows.
// Budget: Q T·128 rows of DC = 2·ceil(D / 16) chunks (40 KB at T·D = 160,
// 48 KB at D = 40); a stage the bias tile (32 KB float32, 16 KB bf16) and
// the K and V tiles of T slots (T·64·(DC + D / 8)·16 bytes, 40-44 KB):
// kMwStages = 2 fit the 227 KB. A consumer thread holds O of the T slots
// (80 floats), S (32) and P of two slots (32); with a tile's bias pairs
// (32) held too ptxas spilled 132 bytes at D = 40 (an H100 build), and
// with the row statistics (4 a slot) 44-68, so the pairs are read where
// they are used and the statistics wait in the thread's own 16 bytes of
// shared memory a slot (T·4 KB). The ptxas report gives spills.
// scripts/torch_motion_hopper_variants.py builds other forms (row slots,
// ring depth) by text edits of a copy of this header and times them.
#pragma once

#include <type_traits>

#include "attn_wgmma_bias.cuh"

namespace i360 {

constexpr int kMwBQ = 128;          // query rows a block: two consumers of 64
constexpr int kMwBK = 64;           // keys a tile (fb_softmax's kFbBK)
constexpr int kMwStages = 2;        // stages of the ring
static_assert(kMwBK == kFbBK && kMwBQ == kFbBQ, "the biased body's tile and softmax");

// Row slots a block takes at head dim D: O's D / 2 floats a thread each
// within 80 (the register plan above).
__host__ __device__ constexpr int mw_slots(int D) { return D <= 40 ? 4 : D <= 80 ? 2 : 1; }

// The layout of one head dim D and bias type TB.
template <int D, typename TB> struct MwPlan {
  static constexpr int T = mw_slots(D);
  static constexpr int DV = D / 8;                        // 16-byte chunks of a row
  static constexpr int DC = (D + 15) / 16 * 2;            // ... padded to whole k-steps
  static constexpr int KS = DC / 2;                       // k-steps of Q·Kᵀ
  static constexpr int kQSlot = DC * kMwBQ * 16;          // a slot's Q tile
  static constexpr int kKSlot = DC * kMwBK * 16;          // a slot's K tile
  static constexpr int kVSlot = DV * kMwBK * 16;          // a slot's V tile
  static constexpr int kQTx = DV * kMwBQ * 16;            // bytes TMA writes of a Q tile
  static constexpr int kBias = FbBias<TB>::kBytes;
  static constexpr int kStage = kBias + T * (kKSlot + kVSlot);
  static constexpr int kStats = T * 256 * 16;            // each consumer thread's (m, l) a slot
  static constexpr size_t kSmem =
      1024 + (size_t)T * kQSlot + (size_t)kMwStages * kStage + kStats + 256;
  static_assert(kSmem <= (size_t)kWgSmemLimit, "the stages fit a block");
  static_assert(D % 8 == 0, "whole 16-byte chunks");
};

// d += a·b for one m64nNk16 step: a the bf16 A fragment in registers, b
// from shared memory MN-major (the transpose bit): P·V at N = D.
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t db);

// fb_softmax's arithmetic for one row slot of one key tile, with each bias
// pair read from the staged tile at `sb` (rows r and r + 8) where it meets
// its logit instead of held in registers for the tile (T slots of O would
// not leave room for them), and only P's hi part: x = s·scale + bias, the
// row max over the quad, α = 2^((m_old - m_new)·log2 e), the sums rescaled
// by α and added the unrounded P = 2^(x·log2 e - m_new·log2 e), P packed to
// bf16 as the A fragments of the kMwBK/16 k-steps of P·V.
template <typename TB>
__device__ __forceinline__ void mw_softmax(float (&sc)[kFbBK / 2], const unsigned char* sb, int r,
                                           int tg, float scale, float (&m)[2], float (&l)[2],
                                           float& alpha0, float& alpha1,
                                           uint32_t (&hi)[kFbBK / 16][4]) {
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int i = 0; i < kFbBK / 8; ++i) {
    const float2 b0 = fb_bias<TB>(sb, r, i, tg), b1 = fb_bias<TB>(sb, r + 8, i, tg);
    sc[4 * i] = fmaf(sc[4 * i], scale, b0.x);
    sc[4 * i + 1] = fmaf(sc[4 * i + 1], scale, b0.y);
    sc[4 * i + 2] = fmaf(sc[4 * i + 2], scale, b1.x);
    sc[4 * i + 3] = fmaf(sc[4 * i + 3], scale, b1.y);
    mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
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
      hi[kk][2 * hf] = pack_bf16(p0, p1);
      hi[kk][2 * hf + 1] = pack_bf16(p2, p3);
    }
  }
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<40>(float (&d)[20], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<80>(float (&d)[40], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_mn<160>(float (&d)[80], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n"
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
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One 128-row query tile of T row slots of one pack; blockIdx.x is
// ((batch row · packs + pack) · head groups + head group) · query tiles +
// query tile. Maps as launch_fused_wgmma encodes them; `smem` has
// MwPlan<D, TB>::kSmem bytes.
template <int D, typename TB>
__device__ __forceinline__ void fused_wgmma_body(const CUtensorMap* mq, const CUtensorMap* mk,
                                                 const CUtensorMap* mv, const CUtensorMap* mo,
                                                 const CUtensorMap* mb, int F, int HW, int H,
                                                 int G, float scale, unsigned char* smem) {
  using P = MwPlan<D, TB>;
  constexpr int T = P::T;
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* gbase = smem + (base - raw);   // `base` as a generic address
  const uint32_t sQ = base;                            // [T][DC][128 rows][16 bytes]
  const uint32_t sS = sQ + T * P::kQSlot;              // stages: bias, then K_j, V_j
  const uint32_t sStats = sS + kMwStages * P::kStage;   // [T][256 threads] of (m0, m1, l0, l1)
  const uint32_t barQ = sStats + P::kStats;
  auto stage = [&](int s) { return sS + s * P::kStage; };
  auto kt_of = [&](int s, int j) { return stage(s) + P::kBias + j * (P::kKSlot + P::kVSlot); };
  auto full = [&](int s) { return barQ + 8 + 8 * s; };
  auto empty = [&](int s) { return barQ + 8 + 8 * (kMwStages + s); };

  const int S = G * F, nqt = S / kMwBQ, nhg = (H + T - 1) / T, npk = HW / G;
  long bx = blockIdx.x;
  const int qt = (int)(bx % nqt);
  bx /= nqt;
  const int hg = (int)(bx % nhg);
  bx /= nhg;
  const int pk = (int)(bx % npk);
  const int b = (int)(bx / npk);
  const int q0 = qt * kMwBQ, h0 = hg * T, nv = min(T, H - h0);
  const int loc0 = pk * G;                             // the pack's first location
  // the head of row slot j: past H the last one again (computed, not stored)
  auto head_of = [&](int j) { return h0 + min(j, nv - 1); };
  const int ntiles = S / kMwBK;
  const int wg = threadIdx.x / 128;

  // the zero chunk of an odd D / 8 (Q·Kᵀ's last k-step): written once here,
  // never by TMA
  if constexpr (P::DC > P::DV) {
    for (int i = threadIdx.x; i < T * kMwBQ + kMwStages * T * kMwBK; i += blockDim.x) {
      uint32_t a;
      if (i < T * kMwBQ) {
        a = sQ + (i / kMwBQ) * P::kQSlot + P::DV * kMwBQ * 16 + (i % kMwBQ) * 16;
      } else {
        const int r = i - T * kMwBQ, sj = r / kMwBK;
        a = kt_of(sj / T, sj % T) + P::DV * kMwBK * 16 + (r % kMwBK) * 16;
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(a), "r"(0u) : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < kMwStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);           // lane 0 of each consumer warp
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
      mbar_expect_tx(barQ, T * P::kQTx);
      for (int j = 0; j < T; ++j)
        tma_load_5d(sQ + j * P::kQSlot, mq, barQ, 0, 0, loc0 + q0 / F, head_of(j) * P::DV, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kMwStages;
        if (t >= kMwStages) mbar_wait(empty(s), ((t / kMwStages) - 1) & 1);
        mbar_expect_tx(full(s), P::kBias + T * 2 * P::kVSlot);
        for (int bx2 = 0; bx2 < FbBias<TB>::kBoxes; ++bx2)
          tma_load_2d(stage(s) + bx2 * FbBias<TB>::kBoxBytes, mb, full(s),
                      t * kMwBK + bx2 * FbBias<TB>::kBoxCols, q0);
        const int l = loc0 + t * kMwBK / F;
        for (int j = 0; j < T; ++j) {
          tma_load_5d(kt_of(s, j), mk, full(s), 0, 0, l, head_of(j) * P::DV, b);
          tma_load_5d(kt_of(s, j) + P::kKSlot, mv, full(s), 0, 0, l, head_of(j) * P::DV, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
    const int cw = wg - 1;               // this consumer's 64 rows of the tile
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tg = lane & 3;
    const int r = 64 * cw + 16 * warp + g;   // rows r and r + 8 of the bias tile
    float o[T][D / 2];
    // slot j's natural-unit row maxima and this thread's parts of the row
    // sums, kept in this thread's own 16 bytes of shared memory between
    // its items (T slots of them in registers did not leave room at D = 40)
    const uint32_t my_stats = sStats + (threadIdx.x - 128) * 16;
    auto load_stats = [&](int j, float (&m)[2], float (&l)[2]) {
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(m[0]), "=f"(m[1]), "=f"(l[0]), "=f"(l[1])
                   : "r"(my_stats + j * 256 * 16) : "memory");
    };
    auto store_stats = [&](int j, const float (&m)[2], const float (&l)[2]) {
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(my_stats + j * 256 * 16),
                   "f"(m[0]), "f"(m[1]), "f"(l[0]), "f"(l[1]) : "memory");
    };
#pragma unroll
    for (int j = 0; j < T; ++j) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[j][i] = 0.f;
      const float m0[2] = {kNegInf, kNegInf}, l0[2] = {0.f, 0.f};
      store_stats(j, m0, l0);
    }
    float sc[kMwBK / 2];                     // S of the slot in flight
    uint32_t pa[2][kMwBK / 16][4];           // P of the item in flight and of the one before
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    };
    // S_j = Q_j·K_jᵀ from stage s: both K-major, 8-row groups 128 bytes
    // apart, k-chunks 2048 (Q) or 1024 (K) bytes apart, a k-step two chunks
    auto qk = [&](int s, int j) {
      const uint64_t dq = wg_desc_noswz(sQ + j * P::kQSlot + cw * 1024, kMwBQ * 16, 128);
      const uint64_t dk = wg_desc_noswz(kt_of(s, j), kMwBK * 16, 128);
#pragma unroll
      for (int ks = 0; ks < P::KS; ++ks)
        wgmma_ss_n64<0, 0>(sc, dq + ks * (2 * kMwBQ * 16 >> 4), dk + ks * (2 * kMwBK * 16 >> 4),
                           ks);
    };
    // acc += P·V, V at `va` MN-major: 8-key groups 128 bytes apart (LBO),
    // 8-column groups a chunk apart (SBO), a k-step 16 keys (256 bytes)
    auto pv = [&](float (&acc)[D / 2], uint32_t (&p)[kMwBK / 16][4], uint32_t va) {
      const uint64_t dv = wg_desc_noswz(va, 128, kMwBK * 16);
#pragma unroll
      for (int kk = 0; kk < kMwBK / 16; ++kk) wgmma_rs_mn<D>(acc, p[kk], dv + kk * (256 >> 4));
    };
    mbar_wait(barQ, 0);

    // tile t: item (t, j) issues S_j and the P·V of the item before (slot
    // j - 1, or slot T - 1 of tile t - 1) back to back, runs S_j's softmax
    // while that P·V is on the tensor cores, then rescales O_j. The P
    // register set of item (t, j) is (t·T + j) & 1 (PAR: t's parity, a
    // constant, so with T odd the loop takes two tiles a turn).
    auto tile = [&](int t, auto par) {
      constexpr int PAR = decltype(par)::value;
      const int s = t % kMwStages;
      mbar_wait(full(s), (t / kMwStages) & 1);
      const unsigned char* sb = gbase + (stage(s) - base);
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const int cur = (PAR * T + j) & 1, prev = cur ^ 1;
        float a0, a1, m[2], l[2];
        load_stats(j, m, l);
        wgmma_fence();
        qk(s, j);
        wgmma_commit();
        if (j > 0 || t > 0) {
          const int pj = j > 0 ? j - 1 : T - 1;
          pv(o[pj], pa[prev], kt_of(j > 0 ? s : (t - 1) % kMwStages, pj) + P::kKSlot);
          wgmma_commit();
          wgmma_wait<1>();                   // S_j has landed; the P·V may still run
          fence_regs(sc);
          mw_softmax<TB>(sc, sb, r, tg, scale, m, l, a0, a1, pa[cur]);
          wgmma_wait<0>();
          fence_regs(o[pj]);
          fence_regs_u(pa[prev]);
          if (j == 0) release((t - 1) % kMwStages);   // its last P·V completed
        } else {
          wgmma_wait<0>();
          fence_regs(sc);
          mw_softmax<TB>(sc, sb, r, tg, scale, m, l, a0, a1, pa[cur]);
        }
        store_stats(j, m, l);
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          o[j][4 * i] *= a0;
          o[j][4 * i + 1] *= a0;
          o[j][4 * i + 2] *= a1;
          o[j][4 * i + 3] *= a1;
        }
      }
    };
    if constexpr (T % 2 == 0) {
      for (int t = 0; t < ntiles; ++t) tile(t, std::integral_constant<int, 0>{});
    } else {
      for (int t = 0; t < ntiles; t += 2) {   // ntiles is even: S % 128 == 0
        tile(t, std::integral_constant<int, 0>{});
        tile(t + 1, std::integral_constant<int, 1>{});
      }
    }
    // the last item's P·V: item (ntiles - 1, T - 1), whose register set is
    // (ntiles·T - 1) & 1 = 1 (ntiles is even)
    wgmma_fence();
    pv(o[T - 1], pa[1], kt_of((ntiles - 1) % kMwStages, T - 1) + P::kKSlot);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < T; ++j) fence_regs(o[j]);
    release((ntiles - 1) % kMwStages);

    // epilogue, each slot: the sums over the quad (a zero sum replaced by
    // 1), divide, bf16 into this consumer's own rows of the slot's Q tile
    // (chunk n of row rr at n·2048 + cw·1024 + rr·16), then TMA stores of
    // its D / 8 chunks of 64 rows
    const int rr = 16 * warp + g;            // rows rr and rr + 8 of this consumer's 64
#pragma unroll
    for (int j = 0; j < T; ++j) {
      float m[2], l[2];
      load_stats(j, m, l);
      float l0 = l[0], l1 = l[1];
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
      const uint32_t rowa = sQ + j * P::kQSlot + cw * 1024 + rr * 16 + tg * 4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const uint32_t a = rowa + n * (kMwBQ * 16);
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a),
                     "r"(pack_bf16(o[j][4 * n] * inv0, o[j][4 * n + 1] * inv0)) : "memory");
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a + 8 * 16),
                     "r"(pack_bf16(o[j][4 * n + 2] * inv1, o[j][4 * n + 3] * inv1)) : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1 + cw, 128);
    if ((threadIdx.x & 127) == 0) {
      const int l = loc0 + (q0 + 64 * cw) / F;
      for (int j = 0; j < nv; ++j)
        for (int n = 0; n < P::DV; ++n)
          tma_store_5d_async(mo, sQ + j * P::kQSlot + n * (kMwBQ * 16) + cw * 1024, 0, 0, l,
                             (h0 + j) * P::DV + n, b);
      bulk_commit();
      bulk_wait_all();
    }
  }
}

// The map of one bf16 [B, F, HW, C] tensor for this body: dims {8, F, HW,
// C / 8, B}, byte strides {HW·C·2, C·2, 16, F·HW·C·2}, boxes {8, F, locs,
// chunks, 1}; no swizzle.
inline bool make_mw_map(CUtensorMap* map, const void* ptr, int B, int F, int HW, int C, int locs,
                        int chunks) {
  wg_encode_fn encode = wg_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[5] = {8, (cuuint64_t)F, (cuuint64_t)HW, (cuuint64_t)(C / 8),
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)HW * C * 2, (cuuint64_t)C * 2, 16,
                                 (cuuint64_t)F * HW * C * 2};
  const cuuint32_t box[5] = {8, (cuuint32_t)F, (cuuint32_t)locs, (cuuint32_t)chunks, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch `kern` (a __global__ taking the five maps, F, HW, H, G and scale)
// for fused_wgmma_body<D, TB> on bf16 q/k/v/out [B, F, HW, H·D] and a TB
// bias [G·F, G·F]. Refuses (cudaErrorInvalidValue) what
// kernels.fused_wgmma_route refuses: a pointer off a 16-byte boundary, F
// not dividing 64, HW not a multiple of G, S = G·F not a multiple of 128;
// and a map the driver does not encode, and a build whose launch registers
// would not cover the consumers' setmaxnreg.
template <int D, typename TB, typename Kern>
int launch_fused_wgmma(Kern kern, const void* q, const void* k, const void* v, const void* bias,
                       void* out, int B, int F, int HW, int H, int G, float scale,
                       cudaStream_t stream) {
  using P = MwPlan<D, TB>;
  const int S = G * F;
  if ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out | (uintptr_t)bias) & 15) !=
          0 ||
      B < 1 || H < 1 || F < 1 || kMwBK % F != 0 || G < 1 || HW % G != 0 || S % kMwBQ != 0)
    return (int)cudaErrorInvalidValue;
  const int C = H * D;
  CUtensorMap mq, mk, mv, mo, mb;
  const auto tb = sizeof(TB) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_mw_map(&mq, q, B, F, HW, C, kMwBQ / F, P::DV) ||
      !make_mw_map(&mk, k, B, F, HW, C, kMwBK / F, P::DV) ||
      !make_mw_map(&mv, v, B, F, HW, C, kMwBK / F, P::DV) ||
      !make_mw_map(&mo, out, B, F, HW, C, 64 / F, 1) ||
      !make_map_2d(&mb, tb, (int)sizeof(TB), bias, S, S, FbBias<TB>::kBoxCols, kMwBQ,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs < kWgLaunchRegs) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)B * (HW / G) * ((H + P::T - 1) / P::T) * (S / kMwBQ);
  if (blocks >= (1L << 31)) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kWgThreads, P::kSmem, stream>>>(mq, mk, mv, mo, mb, F, HW, H, G,
                                                           scale);
  return (int)cudaGetLastError();
}

}  // namespace i360
