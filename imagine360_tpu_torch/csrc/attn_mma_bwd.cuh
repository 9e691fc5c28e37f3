// The tensor-core tiles of the streaming attention backward for bf16 storage
// and head dims 1..160: K5c's (flash_bwd_dkv.cu) and K5b's
// (flash_bwd_dq.cu). Each computes what flash_bwd.cuh's float tile does,
// with its products on `mma.sync.m16n8k16` bf16 fragments and float32
// accumulators (attn_mma.cuh's primitives).
//
// K5c: for one (batch, head) and 64 keys, a block of 4 warps walks the query
// tiles and sums
//   dv = Σ_q Pᵀ·dO,  dk = scale · Σ_q dSᵀ·Q,  where
//   P = exp(S − lse), S = scale·Q·Kᵀ + bias, dP = dO·Vᵀ, dS = P ∘ (dP − delta).
// Each warp owns 16 key rows and computes the transposed tiles directly, so
// that they land in the rows of its dk and dv accumulators:
//   Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: A = the warp's K (V) rows, B = the staged Q
//   (dO) tile by plain ldmatrix, since a [query][d] tile is (Qᵀ)ᵀ row-major;
//   dV += Pᵀ·dO and dK += dSᵀ·Q: A = the Pᵀ and dSᵀ accumulators repacked in
//   registers (the accumulator layout of two 8-query tiles is the A fragment
//   of one 16-query k-step, as the forward repacks P), B = dO and Q by
//   ldmatrix.trans.
// P and dS stay float32 in the kernel this replaces, and Q, K, V and dO are
// exact in bf16, so only the two products that take P and dS need care:
// they take the exact split x = hi + lo of two bf16 values (attn_mma.cuh
// pack_bf16_rest), six mma groups a k-step in place of four. SPLIT false
// (one bf16 rounding of P and dS) is built only by
// scripts/torch_attn_mma_variants.py, which times what the split costs.
//
// K5c's staging: K and V of the block's 64 keys once; Q, dO, the tile's lse and
// delta rows and the [64 query × 64 key] float bias tile by cp.async in two
// stages, the next query tile's copies in flight while one is computed. The
// bias tile is read transposed (a lane needs bias[q][key] for its key row and
// two query columns), so its rows are 68 floats: the 32 lanes of one read
// (8 key rows × 4 query pairs) then fall into 32 distinct banks; with 72 the
// query pairs two apart would share one. Masks: a query at or beyond the
// tail or a key at or beyond nk gets P = dS = 0, so a ragged tail adds
// nothing to any sum; rows of Q and dO past the tail are zero-filled. A
// fully masked row has the floored lse −1e30 and −inf logits, so its P is
// exp2(−inf) = 0.
//
// Registers: at DP ≤ 64 a thread holds the warp's K and V fragments (32
// registers at DP = 64), Sᵀ and dPᵀ of 64 queries (64) and the dk and dv
// accumulators (64). Above, the K and V fragments are read from shared
// memory each k-step and a warp scores 32 (DP = 96) or 16 (DP ≥ 128)
// queries at a time, so that the dk and dv accumulators (DP registers
// together) and the scores fit without a spill (chip_smoke.py phase 1 fails
// on one; 32 queries spilled at DP = 128).
//
// K5b turns the roles: for one (batch, head) and 64 queries, a block of 4
// warps walks the key tiles and sums dq = scale · Σ_k dS·K. Each warp owns
// 16 query rows, as in the forward (attn_mma.cuh flash_tile_mma):
//   S = Q·Kᵀ and dP = dO·Vᵀ: A = the warp's Q (dO) rows, B = the staged K
//   (V) tile by plain ldmatrix;
//   dQ += dS·K: A = the dS accumulator repacked in registers, B = K by
//   ldmatrix.trans (the forward's P·V with K in V's place).
// dS is the only float32 operand of a product, so it alone is split (SPLIT,
// four mma groups a k-step in place of three). The bias tile is the
// forward's ([64 query × 64 key] floats, rows of 72: a lane reads two keys of
// one query row in one 8-byte read), staged with K and V in the same two
// `cp.async` stages. The lse and delta of a lane's two query rows are read
// once into registers. Masks as in K5c: a query past the tail or a key at
// or beyond Sk gets P = dS = 0, and a fully masked row P = exp2(−inf) = 0.
// Registers as in K5c: at DP ≤ 64 a thread holds the warp's Q and dO
// fragments (32 registers at DP = 64), S and dP of 64 keys (64) and the dq
// accumulator (32); above, the Q and dO fragments are read from shared
// memory each k-step and a warp scores 32 (DP = 96) or 16 (DP ≥ 128) keys
// at a time beside its DP / 2 accumulators.
#pragma once

#include "attn_mma.cuh"

namespace i360 {

constexpr int kBwdBQ = 64;                 // query rows of a staged tile
constexpr int kBwdBiasLd = kMmaBK + 4;     // floats a staged bias row (see above)
constexpr int kBwdNW = 4;                  // warps: 16 key rows each

// Shared memory of one block: two stages of the bias tile (with a bias),
// two stages of the lse and delta rows, the K and V tiles and two stages of
// the Q and dO tiles, in that order.
template <int DP>
inline size_t bwd_dkv_mma_smem_bytes(bool with_bias) {
  return (with_bias ? sizeof(float) * 2 * (size_t)kBwdBQ * kBwdBiasLd : 0) +
         sizeof(float) * 4 * kBwdBQ + sizeof(bf16) * 6 * (size_t)kMmaBK * (DP + 8);
}

// dk and dv of one block: keys [k0, k0 + nk) of one (batch, head). q and g
// point at (query 0, head h) of their [*, Sq, H·D] rows, k, v, dk and dv at
// (key k0, head h) of [*, Sk, H·D]: all rows of stride `ld`. lse and delta
// point at query 0 of this problem's float [Sq] rows; `bias`, when not null,
// at (query 0, key k0) of a float [Sq, Sk] matrix. `vec`: 16-byte copies and
// stores (D % 8 == 0, 16-byte-aligned pointers), else 2-byte accesses.
// `smem` has bwd_dkv_mma_smem_bytes<DP>(bias != nullptr) bytes, 16-byte
// aligned. SPLIT: Pᵀ·dO and dSᵀ·Q on the exact bf16 hi + lo split.
template <int DP, bool SPLIT = true>
__device__ __forceinline__ void flash_bwd_dkv_tile_mma(
    const bf16* q, const bf16* k, const bf16* v, const bf16* g, const float* lse,
    const float* delta, const float* bias, bool bias_vec, bf16* dk, bf16* dv, long ld, int Sq,
    int Sk, int nk, int D, float scale, bool vec, unsigned char* smem) {
  constexpr int NT = 32 * kBwdNW, LDS = DP + 8;
  constexpr int KS = DP / 16;     // k-steps of Sᵀ and dPᵀ
  constexpr int NO = DP / 8;      // 8-column tiles of dk and dv
  constexpr bool HOLD = DP <= 64;                          // K, V fragments in registers
  constexpr int QC = DP <= 64 ? 64 : (DP <= 96 ? 32 : 16);   // queries scored at once
  constexpr int NQ = QC / 8;
  static_assert(DP % 16 == 0, "head-dim buckets are multiples of 16");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;   // row in an 8-row group; pair of columns
  const int kr = warp * 16;                  // this warp's first key row
  float* sbias = (float*)smem;                                        // 2 × [64][kBwdBiasLd]
  float* srow = sbias + (bias != nullptr ? 2 * kBwdBQ * kBwdBiasLd : 0);  // 2 × lse, delta
  bf16* sK = (bf16*)(srow + 4 * kBwdBQ);     // [64][LDS]
  bf16* sV = sK + kMmaBK * LDS;              // [64][LDS]
  bf16* sQ = sV + kMmaBK * LDS;              // 2 × [64][LDS]
  bf16* sG = sQ + 2 * kBwdBQ * LDS;          // 2 × [64][LDS]
  const int nqt = (Sq + kBwdBQ - 1) / kBwdBQ;
  const float sl2 = scale * kLog2e;

  // Q, dO, lse, delta and the bias of query tile t into stage t & 1
  auto stage_q = [&](int t) {
    const int q0 = t * kBwdBQ, n = min(kBwdBQ, Sq - q0), st = t & 1;
    stage_rows<DP, NT>(sQ + st * kBwdBQ * LDS, q + (long)q0 * ld, ld, kBwdBQ, n, D, vec, tid);
    stage_rows<DP, NT>(sG + st * kBwdBQ * LDS, g + (long)q0 * ld, ld, kBwdBQ, n, D, vec, tid);
    float* r = srow + st * 2 * kBwdBQ;
    for (int i = tid; i < 2 * kBwdBQ; i += NT) {
      const int j = i % kBwdBQ;
      const bool ok = j < n;
      cp_async4(smem_u32(r + i), ok ? (i < kBwdBQ ? lse : delta) + q0 + j : lse, ok);
    }
    if (bias != nullptr)
      stage_bias<kBwdBiasLd>(sbias + st * kBwdBQ * kBwdBiasLd, bias + (long)q0 * Sk, Sk,
                             kBwdBQ, n, nk, bias_vec);
  };

  stage_rows<DP, NT>(sK, k, ld, kMmaBK, nk, D, vec, tid);
  stage_rows<DP, NT>(sV, v, ld, kMmaBK, nk, D, vec, tid);
  stage_q(0);
  cp_async_commit();

  uint32_t kf[KS][4], vf[KS][4];   // read only when HOLD
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[n][j] = dva[n][j] = 0.f;
  const bool kval[2] = {kr + gr < nk, kr + gr + 8 < nk};

  for (int t = 0; t < nqt; ++t) {
    if (t + 1 < nqt) {                // the next tile's copies fly during this one
      stage_q(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (HOLD && t == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int off = (kr + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8;
        ldsm_x4(kf[ks], smem_u32(sK + off));
        ldsm_x4(vf[ks], smem_u32(sV + off));
      }
    }
    const int nq = min(kBwdBQ, Sq - t * kBwdBQ);
    const bf16* cQ = sQ + (t & 1) * kBwdBQ * LDS;
    const bf16* cG = sG + (t & 1) * kBwdBQ * LDS;
    const float* cL = srow + (t & 1) * 2 * kBwdBQ;        // lse, then delta
    const float* cB = sbias + (t & 1) * kBwdBQ * kBwdBiasLd;

#pragma unroll 1
    for (int c0 = 0; c0 < kBwdBQ; c0 += QC) {
      if (c0 >= nq) break;            // nq is the same for the whole block
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, 16 queries (two 8-query tiles) at a time
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        if (HOLD) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ka[j] = kf[ks][j];
            va[j] = vf[ks][j];
          }
        } else {
          const int off = (kr + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8;
          ldsm_x4(ka, smem_u32(sK + off));
          ldsm_x4(va, smem_u32(sV + off));
        }
#pragma unroll
        for (int p = 0; p < QC / 16; ++p) {
          if (c0 + p * 16 < nq) {
            const int off = (c0 + p * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + ks * 16 +
                            ((lane >> 3) & 1) * 8;
            uint32_t b[4];
            ldsm_x4(b, smem_u32(cQ + off));
            mma_bf16(s[2 * p], ka, b[0], b[1]);
            mma_bf16(s[2 * p + 1], ka, b[2], b[3]);
            ldsm_x4(b, smem_u32(cG + off));
            mma_bf16(dp[2 * p], va, b[0], b[1]);
            mma_bf16(dp[2 * p + 1], va, b[2], b[3]);
          }
        }
      }

      // Pᵀ = 2^(Sᵀ·scale·log2 e + bias·log2 e − lse·log2 e) and dSᵀ = Pᵀ ∘
      // (dPᵀ − delta) in place; element j of tile n: key row kr + gr + 8·(j / 2),
      // query c0 + 8n + 2tg + j % 2
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = c0 + n * 8 + tg * 2 + c;
          const float l2 = cL[qi] * kLog2e, de = cL[kBwdBQ + qi];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int j = hr * 2 + c;
            float x = s[n][j] * sl2 - l2;
            if (bias != nullptr) x = fmaf(cB[qi * kBwdBiasLd + kr + gr + hr * 8], kLog2e, x);
            const float pv = (qi < nq && kval[hr]) ? exp2f(x) : 0.f;
            s[n][j] = pv;
            dp[n][j] = pv * (dp[n][j] - de);
          }
        }
      }

      // dV += Pᵀ·dO and dK += dSᵀ·Q, 16 queries a k-step, 16 columns (two
      // 8-column tiles) at a time
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        if (c0 + kk * 16 >= nq) break;
        uint32_t ph[4], pl[4], dh[4], dl[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 2 * kk + h;
          ph[h * 2] = pack_bf16(s[n][0], s[n][1]);
          ph[h * 2 + 1] = pack_bf16(s[n][2], s[n][3]);
          dh[h * 2] = pack_bf16(dp[n][0], dp[n][1]);
          dh[h * 2 + 1] = pack_bf16(dp[n][2], dp[n][3]);
          if (SPLIT) {
            pl[h * 2] = pack_bf16_rest(s[n][0], s[n][1], ph[h * 2]);
            pl[h * 2 + 1] = pack_bf16_rest(s[n][2], s[n][3], ph[h * 2 + 1]);
            dl[h * 2] = pack_bf16_rest(dp[n][0], dp[n][1], dh[h * 2]);
            dl[h * 2 + 1] = pack_bf16_rest(dp[n][2], dp[n][3], dh[h * 2 + 1]);
          }
        }
        const int row = (c0 + kk * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
#pragma unroll
        for (int n2 = 0; n2 < NO / 2; ++n2) {
          uint32_t b[4];
          ldsm_x4_trans(b, smem_u32(cG + row + n2 * 16));
          if (SPLIT) {
            mma_bf16(dva[2 * n2], pl, b[0], b[1]);
            mma_bf16(dva[2 * n2 + 1], pl, b[2], b[3]);
          }
          mma_bf16(dva[2 * n2], ph, b[0], b[1]);
          mma_bf16(dva[2 * n2 + 1], ph, b[2], b[3]);
          ldsm_x4_trans(b, smem_u32(cQ + row + n2 * 16));
          if (SPLIT) {
            mma_bf16(dka[2 * n2], dl, b[0], b[1]);
            mma_bf16(dka[2 * n2 + 1], dl, b[2], b[3]);
          }
          mma_bf16(dka[2 * n2], dh, b[0], b[1]);
          mma_bf16(dka[2 * n2 + 1], dh, b[2], b[3]);
        }
      }
    }
    __syncthreads();   // this stage is refilled two tiles on
  }

  const int rows = min(16, nk - kr);   // this warp's keys inside the tile
  if (rows <= 0) return;
  if (vec) {
    // through the warp's own rows of the K and V tiles (no warp reads them
    // after the last tile's barrier)
    bf16* oK = sK + kr * LDS;
    bf16* oV = sV + kr * LDS;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + tg * 2;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        *reinterpret_cast<__nv_bfloat162*>(oK + (gr + hr * 8) * LDS + c) =
            __floats2bfloat162_rn(dka[n][hr * 2] * scale, dka[n][hr * 2 + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(oV + (gr + hr * 8) * LDS + c) =
            __floats2bfloat162_rn(dva[n][hr * 2], dva[n][hr * 2 + 1]);
      }
    }
    __syncwarp();
    const int cpr = D / 8;
    for (int idx = lane; idx < rows * cpr; idx += 32) {
      const int r = idx / cpr, c = idx - r * cpr;
      *reinterpret_cast<uint4*>(dk + (long)(kr + r) * ld + c * 8) =
          *reinterpret_cast<const uint4*>(oK + r * LDS + c * 8);
      *reinterpret_cast<uint4*>(dv + (long)(kr + r) * ld + c * 8) =
          *reinterpret_cast<const uint4*>(oV + r * LDS + c * 8);
    }
  } else {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = gr + (j >> 1) * 8, c = n * 8 + tg * 2 + (j & 1);
        if (r < rows && c < D) {
          dk[(long)(kr + r) * ld + c] = __float2bfloat16(dka[n][j] * scale);
          dv[(long)(kr + r) * ld + c] = __float2bfloat16(dva[n][j]);
        }
      }
    }
  }
}

// Shared memory of one K5b block: two stages of the forward's bias tile
// (with a bias), the Q and dO tiles, and two stages of the K and V tiles, in
// that order.
template <int DP>
inline size_t bwd_dq_mma_smem_bytes(bool with_bias) {
  return (with_bias ? attn_mma_bias_bytes(kBwdBQ) : 0) +
         sizeof(bf16) * 6 * (size_t)kBwdBQ * (DP + 8);
}

// dq of one block: queries [q0, q0 + nq) of one (batch, head). q, g and dq
// point at (query q0, head h) of their [*, Sq, H·D] rows, k and v at (key 0,
// head h) of [*, Sk, H·D]: all rows of stride `ld`. lse and delta point at
// query q0 of this problem's float [Sq] rows; `bias`, when not null, at
// (query q0, key 0) of a float [Sq, Sk] matrix. `vec`: 16-byte copies and
// stores (D % 8 == 0, 16-byte-aligned pointers), else 2-byte accesses.
// `smem` has bwd_dq_mma_smem_bytes<DP>(bias != nullptr) bytes, 16-byte
// aligned. SPLIT: dS·K on the exact bf16 hi + lo split of dS.
template <int DP, bool SPLIT = true>
__device__ __forceinline__ void flash_bwd_dq_tile_mma(
    const bf16* q, const bf16* k, const bf16* v, const bf16* g, const float* lse,
    const float* delta, const float* bias, bool bias_vec, bf16* dq, long ld, int nq, int Sk,
    int D, float scale, bool vec, unsigned char* smem) {
  constexpr int NT = 32 * kBwdNW, LDS = DP + 8;
  constexpr int KS = DP / 16;     // k-steps of S and dP
  constexpr int NO = DP / 8;      // 8-column tiles of dq
  constexpr bool HOLD = DP <= 64;                          // Q, dO fragments in registers
  constexpr int KC = DP <= 64 ? 64 : (DP <= 96 ? 32 : 16);   // keys scored at once
  constexpr int NK = KC / 8;
  static_assert(DP % 16 == 0, "head-dim buckets are multiples of 16");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;   // row in an 8-row group; pair of columns
  const int qr = warp * 16;                  // this warp's first query row
  float* sbias = (float*)smem;                                       // 2 × [64][kBiasLd]
  bf16* sQ = (bf16*)(sbias + (bias != nullptr ? 2 * kBwdBQ * kBiasLd : 0));   // [64][LDS]
  bf16* sG = sQ + kBwdBQ * LDS;              // [64][LDS]
  bf16* sK = sG + kBwdBQ * LDS;              // 2 × [64][LDS]
  bf16* sV = sK + 2 * kMmaBK * LDS;          // 2 × [64][LDS]
  const int ntiles = (Sk + kMmaBK - 1) / kMmaBK;
  const float sl2 = scale * kLog2e;

  // K, V and the bias of the key tile at k1 into stage st
  auto stage_kv = [&](int st, int k1) {
    const int n = min(kMmaBK, Sk - k1);
    stage_rows<DP, NT>(sK + st * kMmaBK * LDS, k + (long)k1 * ld, ld, kMmaBK, n, D, vec, tid);
    stage_rows<DP, NT>(sV + st * kMmaBK * LDS, v + (long)k1 * ld, ld, kMmaBK, n, D, vec, tid);
    if (bias != nullptr)
      stage_bias(sbias + st * kBwdBQ * kBiasLd, bias + k1, Sk, kBwdBQ, nq, n, bias_vec);
  };
  stage_rows<DP, NT>(sQ, q, ld, kBwdBQ, nq, D, vec, tid);
  stage_rows<DP, NT>(sG, g, ld, kBwdBQ, nq, D, vec, tid);
  stage_kv(0, 0);
  cp_async_commit();

  // lse (log2 units) and delta of rows gr and gr + 8; P = 0 past the tail
  bool qval[2];
  float l2[2], de[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = qr + gr + hr * 8;
    qval[hr] = r < nq;
    l2[hr] = qval[hr] ? lse[r] * kLog2e : 0.f;
    de[hr] = qval[hr] ? delta[r] : 0.f;
  }
  uint32_t qf[KS][4], gf[KS][4];   // read only when HOLD
  float dqa[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int nk = min(kMmaBK, Sk - t * kMmaBK);
    if (t + 1 < ntiles) {             // the next tile's copies fly during this one
      stage_kv((t + 1) & 1, (t + 1) * kMmaBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (HOLD && t == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int off = (qr + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8;
        ldsm_x4(qf[ks], smem_u32(sQ + off));
        ldsm_x4(gf[ks], smem_u32(sG + off));
      }
    }
    const bf16* cK = sK + (t & 1) * kMmaBK * LDS;
    const bf16* cV = sV + (t & 1) * kMmaBK * LDS;
    const float* cB = sbias + (t & 1) * kBwdBQ * kBiasLd + (qr + gr) * kBiasLd + tg * 2;

#pragma unroll 1
    for (int c0 = 0; c0 < kMmaBK; c0 += KC) {
      if (c0 >= nk) break;            // nk is the same for the whole block
      // S = Q·Kᵀ and dP = dO·Vᵀ, 16 keys (two 8-key tiles) at a time
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[4], ga[4];
        if (HOLD) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            qa[j] = qf[ks][j];
            ga[j] = gf[ks][j];
          }
        } else {
          const int off = (qr + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8;
          ldsm_x4(qa, smem_u32(sQ + off));
          ldsm_x4(ga, smem_u32(sG + off));
        }
#pragma unroll
        for (int p = 0; p < KC / 16; ++p) {
          if (c0 + p * 16 < nk) {
            const int off = (c0 + p * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + ks * 16 +
                            ((lane >> 3) & 1) * 8;
            uint32_t b[4];
            ldsm_x4(b, smem_u32(cK + off));
            mma_bf16(s[2 * p], qa, b[0], b[1]);
            mma_bf16(s[2 * p + 1], qa, b[2], b[3]);
            ldsm_x4(b, smem_u32(cV + off));
            mma_bf16(dp[2 * p], ga, b[0], b[1]);
            mma_bf16(dp[2 * p + 1], ga, b[2], b[3]);
          }
        }
      }

      // P = 2^(S·scale·log2 e + bias·log2 e − lse·log2 e) and dS = P ∘ (dP −
      // delta) in place; element j of tile n: query row qr + gr + 8·(j / 2),
      // key c0 + 8n + 2tg + j % 2 (two keys of a row in one 8-byte bias read)
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float2 bv = make_float2(0.f, 0.f);
          if (bias != nullptr)
            bv = *reinterpret_cast<const float2*>(cB + hr * 8 * kBiasLd + c0 + n * 8);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = hr * 2 + c;
            const int key = c0 + n * 8 + tg * 2 + c;
            const float x = fmaf(c ? bv.y : bv.x, kLog2e, s[n][j] * sl2 - l2[hr]);
            const float pv = (qval[hr] && key < nk) ? exp2f(x) : 0.f;
            dp[n][j] = pv * (dp[n][j] - de[hr]);
          }
        }
      }

      // dQ += dS·K, 16 keys a k-step, 16 columns (two 8-column tiles) at a
      // time
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        if (c0 + kk * 16 >= nk) break;
        uint32_t dh[4], dl[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 2 * kk + h;
          dh[h * 2] = pack_bf16(dp[n][0], dp[n][1]);
          dh[h * 2 + 1] = pack_bf16(dp[n][2], dp[n][3]);
          if (SPLIT) {
            dl[h * 2] = pack_bf16_rest(dp[n][0], dp[n][1], dh[h * 2]);
            dl[h * 2 + 1] = pack_bf16_rest(dp[n][2], dp[n][3], dh[h * 2 + 1]);
          }
        }
        const int row = (c0 + kk * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
#pragma unroll
        for (int n2 = 0; n2 < NO / 2; ++n2) {
          uint32_t b[4];
          ldsm_x4_trans(b, smem_u32(cK + row + n2 * 16));
          if (SPLIT) {
            mma_bf16(dqa[2 * n2], dl, b[0], b[1]);
            mma_bf16(dqa[2 * n2 + 1], dl, b[2], b[3]);
          }
          mma_bf16(dqa[2 * n2], dh, b[0], b[1]);
          mma_bf16(dqa[2 * n2 + 1], dh, b[2], b[3]);
        }
      }
    }
    __syncthreads();   // this stage is refilled two tiles on
  }

  const int rows = min(16, nq - qr);   // this warp's queries inside the tile
  if (rows <= 0) return;
  if (vec) {
    // through the warp's own rows of the Q tile (no warp reads them after the
    // last tile's barrier)
    bf16* oQ = sQ + qr * LDS;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + tg * 2;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<__nv_bfloat162*>(oQ + (gr + hr * 8) * LDS + c) =
            __floats2bfloat162_rn(dqa[n][hr * 2] * scale, dqa[n][hr * 2 + 1] * scale);
    }
    __syncwarp();
    const int cpr = D / 8;
    for (int idx = lane; idx < rows * cpr; idx += 32) {
      const int r = idx / cpr, c = idx - r * cpr;
      *reinterpret_cast<uint4*>(dq + (long)(qr + r) * ld + c * 8) =
          *reinterpret_cast<const uint4*>(oQ + r * LDS + c * 8);
    }
  } else {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = gr + (j >> 1) * 8, c = n * 8 + tg * 2 + (j & 1);
        if (r < rows && c < D) dq[(long)(qr + r) * ld + c] = __float2bfloat16(dqa[n][j] * scale);
      }
    }
  }
}

}  // namespace i360
