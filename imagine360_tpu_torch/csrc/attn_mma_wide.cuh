// The tensor-core tile of the wide K1 (tiny_attention_wide.cu) and K2
// (mh_flash_wide.cu) for bf16 storage and head dims 161..512. The VAE's
// mid-block attention (one head of 512, 16-byte-aligned, K1 without a bias)
// runs the `wgmma` body of attn_wgmma_wide.cuh instead
// (kernels.wide_wgmma_route); this tile keeps D 161..511 (the tiny VAE's
// 192), K1 at D = 512 under a bias and unaligned views: what flash_tile_mma
// (attn_mma.cuh) computes, with Q·Kᵀ and P·V on `mma.sync.m16n8k16` bf16
// fragments and float32 accumulators, the PTX helpers of attn_mma.cuh, and a
// layout for a head dim that does not fit one warp.
//
// Why the narrow layout does not carry over: a warp owning 16 query rows ×
// 512 columns of O would hold 256 float32 accumulators a thread, and Q's A
// fragments another 128 registers. So the work of a block is cut twice, once
// for each product, and what one product hands the other goes through shared
// memory.
//
// Layout: a block owns BQ = 64 query rows of one (batch, head) problem in the
// natural [B, S, H·D] layout and walks every 64-key tile; 16 warps, 512
// threads, one block an SM (the launch bounds say so: ptxas would spill to
// buy occupancy). The Q tile, one K tile and one V tile of 64 rows × DP
// (D padded with zero columns to the bucket DP) stay in shared memory, rows
// DP + 8 bf16 long so that the eight 16-byte rows of an ldmatrix fall into
// distinct banks: 3 × 66,560 bytes at DP = 512.
// - Q·Kᵀ: warp w scores rows 16·(w / 4) .. + 15 against keys 16·(w % 4) ..
//   + 15 over the whole head dim, Q's A fragments and K's B fragments both by
//   ldmatrix from the staged tiles (nothing of Q is kept in registers), into
//   8 float32 accumulators (two chains of even and odd k-steps, 16). The
//   four warps of a row group split the keys, not the head dim, so no partial
//   sums of S are exchanged and every logit is exponentiated once.
// - The online softmax of flash_tile_mma in log2 units with the finite
//   kNegInf: each warp takes the max of its rows over its 16 keys (a quad
//   reduces with __shfl_xor_sync), the four warps of a row group exchange
//   theirs through shared memory behind a named barrier of the group
//   (`bar.sync 1 + group, 128`), and all four then hold the same running
//   max, so their parts of a row's sum rescale by the same α and add up at
//   the end. P = 2^(S - m) is rounded once to bf16, as the JAX kernels cast
//   the probabilities to v.dtype before P·V (no hi + lo split: their bodies
//   keep P in bf16); the sums are taken over the unrounded probabilities.
//   The bf16 P ([64][72]) and α of each row go to shared memory.
// - P·V: warp w owns rows 32·(w / 8) .. + 31 and columns DP/8·(w % 8) .. of
//   O, 2 × DP/16 8-column tiles of 4 accumulators (64 a thread at DP =
//   512). Per 16 keys it reads two A fragments of P by ldmatrix and each V
//   fragment by ldmatrix.trans once for both 16-row tiles.
// Per 64-key tile: the block waits for K and syncs; V (and the bias tile)
// are copied by cp.async while S is computed; the block waits and syncs;
// the next K tile is copied while the softmax and P·V run. Three block
// barriers and one group barrier a tile.
//
// Head-dim buckets: 256 and 512. The main path runs D = 512 alone; 256
// halves the work of heads of 161..256 (the tiny VAE of phase 3 has one of
// 192) for one more instantiation of each kernel. Finer buckets (192, 384)
// would add instantiations that no model of the repo reaches.
//
// The optional float32 bias of K1 ([Sq, Sk], shared by every row and head)
// is staged as attn_mma.cuh:stage_bias does, one [64][72] stage, beside V.
// The epilogue is flash_tile_mma's: divide by the sum (a zero sum replaced
// by 1), stage the bf16 rows in the Q tile (read by no warp after the last
// tile's barriers), write them with 16-byte stores, masking the ragged query
// tail. Where D is no multiple of 8 or a pointer is not 16-byte aligned
// (`vec` false), the tiles are staged and written with 2-byte accesses
// instead; nothing reroutes.
//
// Shared memory at DP = 512: Q, K, V 199,680 bytes, P 9,216, the row maxima
// 1,024, α 256, with a bias 18,432 more: 228,608 of the 232,448 a block may
// have.
#pragma once

#include "attn_mma.cuh"

namespace i360 {

constexpr int kWideBQ = 64;                  // query rows a block
constexpr int kWideNW = 16;                  // warps a block
constexpr int kWideNT = 32 * kWideNW;
constexpr int kWidePLd = kMmaBK + 8;         // bf16 a staged probability row
constexpr int kWideMaxD = 512;

// Shared memory of one block: [bias stage,] row maxima, α, P, Q, K, V.
template <int DP>
inline size_t wide_mma_smem_bytes(bool bias) {
  return (bias ? sizeof(float) * kWideBQ * kBiasLd : 0) + sizeof(float) * kWideBQ * 5 +
         sizeof(bf16) * kWideBQ * kWidePLd + sizeof(bf16) * 3 * (size_t)kWideBQ * (DP + 8);
}

// `bar.sync id, n`: the n threads of the warps that name barrier `id`.
__device__ __forceinline__ void bar_sync_named(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// Streaming attention of one 64-row query tile of one (batch, head) problem
// on the tensor cores, the whole block of kWideNT threads. q/k/v/out point at
// element (row 0, head h) of their [*, S, H·D] rows, row stride `ld`; `nq`
// valid query rows. `bias`, when not null, points at row q0 of a [Sq, Sk]
// float matrix with row stride Sk. `smem` has wide_mma_smem_bytes<DP>(bias
// != nullptr) bytes, 16-byte aligned.
template <int DP>
__device__ __forceinline__ void wide_tile_mma(const bf16* q, const bf16* k, const bf16* v,
                                              bf16* out, const float* bias, bool bias_vec,
                                              long ld, int nq, int Sk, int D, float scale,
                                              bool vec, unsigned char* smem) {
  constexpr int LDS = DP + 8;
  constexpr int KS = DP / 16;    // k-steps of Q·Kᵀ
  constexpr int CW = DP / 8;     // columns of O a warp owns
  constexpr int NO = CW / 8;     // 8-column tiles of O in each 16-row tile
  static_assert(DP % 128 == 0 && DP <= kWideMaxD, "head-dim buckets are 256 and 512");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;   // row in an 8-row group; pair of columns
  const int sr = warp >> 2, sk = warp & 3;  // Q·Kᵀ: row group (16 rows), key slice (16 keys)
  const int pr = warp >> 3, pc = warp & 7;  // P·V: 32 rows, CW columns
  float* sbias = reinterpret_cast<float*>(smem);               // [BQ][kBiasLd]
  float* smax = sbias + (bias != nullptr ? kWideBQ * kBiasLd : 0);   // [BQ][4]
  float* salpha = smax + kWideBQ * 4;                          // [BQ]
  bf16* sP = reinterpret_cast<bf16*>(salpha + kWideBQ);        // [BQ][kWidePLd]
  bf16* sQ = sP + kWideBQ * kWidePLd;                          // [BQ][LDS]
  bf16* sK = sQ + kWideBQ * LDS;                               // [64][LDS]
  bf16* sV = sK + kMmaBK * LDS;                                // [64][LDS]
  const float sl2 = scale * kLog2e;
  const int ntiles = (Sk + kMmaBK - 1) / kMmaBK;
  const int srow = sr * 16 + g;             // this lane's rows srow, srow + 8 in Q·Kᵀ

  stage_rows<DP, kWideNT>(sQ, q, ld, kWideBQ, nq, D, vec, tid);
  stage_rows<DP, kWideNT>(sK, k, ld, kMmaBK, min(kMmaBK, Sk), D, vec, tid);
  cp_async_commit();

  float o[2][NO][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < NO; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // running max of rows srow, srow + 8, log2 units
  float l[2] = {0.f, 0.f};           // this lane's part of their running sums

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kMmaBK;
    const int nk = min(kMmaBK, Sk - k0);
    cp_async_wait<0>();
    __syncthreads();   // K visible; the last tile's P·V is done with V, P, α and the bias
    stage_rows<DP, kWideNT>(sV, v + (long)k0 * ld, ld, kMmaBK, nk, D, vec, tid);
    if (bias != nullptr) stage_bias(sbias, bias + k0, Sk, kWideBQ, nq, nk, bias_vec);
    cp_async_commit();

    // S = Q·Kᵀ for this warp's 16 rows and 16 keys, even and odd k-steps in
    // two chains; a key slice past the last key is skipped (nk is the same
    // for the whole block)
    float s2[2][2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int n = 0; n < 2; ++n) s2[c][n][0] = s2[c][n][1] = s2[c][n][2] = s2[c][n][3] = 0.f;
    if (sk * 16 < nk) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4], b[4];
        ldsm_x4(a, smem_u32(sQ + (sr * 16 + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8));
        ldsm_x4(b, smem_u32(sK + (sk * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + ks * 16 +
                            ((lane >> 3) & 1) * 8));
        mma_bf16(s2[ks & 1][0], a, b[0], b[1]);
        mma_bf16(s2[ks & 1][1], a, b[2], b[3]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // every warp done with K; V and the bias visible
    if (t + 1 < ntiles)   // the next K tile's copies fly during the softmax and P·V
      stage_rows<DP, kWideNT>(sK, k + (long)(k0 + kMmaBK) * ld, ld, kMmaBK,
                              min(kMmaBK, Sk - k0 - kMmaBK), D, vec, tid);
    cp_async_commit();

    // scale, bias (two neighbouring keys of one row in one 8-byte read), key
    // mask, this warp's row max over its keys
    const float* cB = sbias + srow * kBiasLd + sk * 16 + tg * 2;
    float s[2][4];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {      // rows srow and srow + 8
        float2 bv = make_float2(0.f, 0.f);
        if (bias != nullptr) bv = *reinterpret_cast<const float2*>(cB + hr * 8 * kBiasLd + n * 8);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = hr * 2 + c;
          const int key = sk * 16 + n * 8 + tg * 2 + c;
          float x = fmaf(c ? bv.y : bv.x, kLog2e, (s2[0][n][j] + s2[1][n][j]) * sl2);
          if (key >= nk) x = kNegInf;
          s[n][j] = x;
          mx[hr] = fmaxf(mx[hr], x);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (tg == 0) smax[(srow + r * 8) * 4 + sk] = mx[r];
    }
    bar_sync_named(1 + sr, 128);   // the four warps of this row group
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float4 w = *reinterpret_cast<const float4*>(smax + (srow + r * 8) * 4);
      const float mnew = fmaxf(fmaxf(w.x, w.y), fmaxf(w.z, w.w));
      const float alpha = exp2f(m[r] - mnew);
      m[r] = mnew;
      l[r] *= alpha;
      if (sk == 0 && tg == 0) salpha[srow + r * 8] = alpha;
    }
    // P = 2^(S - m): summed unrounded, rounded once to bf16 into sP
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float p0 = exp2f(s[n][0] - m[0]), p1 = exp2f(s[n][1] - m[0]);
      const float p2 = exp2f(s[n][2] - m[1]), p3 = exp2f(s[n][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      bf16* dst = sP + srow * kWidePLd + sk * 16 + n * 8 + tg * 2;
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(p0, p1);
      *reinterpret_cast<uint32_t*>(dst + 8 * kWidePLd) = pack_bf16(p2, p3);
    }
    __syncthreads();   // P and α visible

    // O = α·O + P·V over this warp's 32 rows and CW columns, 16 keys at a time
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float a0 = salpha[pr * 32 + mt * 16 + g], a1 = salpha[pr * 32 + mt * 16 + g + 8];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[mt][n][0] *= a0;
        o[mt][n][1] *= a0;
        o[mt][n][2] *= a1;
        o[mt][n][3] *= a1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk * 16 < nk) {
        uint32_t pa[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(pa[mt], smem_u32(sP + (pr * 32 + mt * 16 + (lane & 15)) * kWidePLd + kk * 16 +
                                   (lane >> 4) * 8));
#pragma unroll
        for (int n2 = 0; n2 < NO / 2; ++n2) {
          uint32_t b[4];
          ldsm_x4_trans(b, smem_u32(sV + (kk * 16 + (lane & 15)) * LDS + pc * CW + n2 * 16 +
                                    (lane >> 4) * 8));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(o[mt][2 * n2], pa[mt], b[0], b[1]);
            mma_bf16(o[mt][2 * n2 + 1], pa[mt], b[2], b[3]);
          }
        }
      }
    }
  }

  // the row sums: the four warps of a row group hold parts over their keys;
  // they take the place of the row maxima, which no warp reads after the
  // last tile's "P and α visible" barrier
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (tg == 0) {
    smax[srow * 4 + sk] = l[0];
    smax[(srow + 8) * 4 + sk] = l[1];
  }
  __syncthreads();
  float inv[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float4 w =
          *reinterpret_cast<const float4*>(smax + (pr * 32 + mt * 16 + g + hr * 8) * 4);
      const float sum = (w.x + w.y) + (w.z + w.w);
      inv[mt][hr] = 1.f / (sum == 0.f ? 1.f : sum);
    }
  const int r0 = pr * 32, c0 = pc * CW;
  const int rows = min(32, nq - r0);   // this warp's rows inside the tile
  if (rows <= 0) return;
  if (vec) {
    // through this warp's own block of the Q tile, which no warp reads after
    // the last tile's Q·Kᵀ
    bf16* sO = sQ + r0 * LDS + c0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int r = mt * 16 + g, c = n * 8 + tg * 2;
        *reinterpret_cast<__nv_bfloat162*>(sO + r * LDS + c) =
            __floats2bfloat162_rn(o[mt][n][0] * inv[mt][0], o[mt][n][1] * inv[mt][0]);
        *reinterpret_cast<__nv_bfloat162*>(sO + (r + 8) * LDS + c) =
            __floats2bfloat162_rn(o[mt][n][2] * inv[mt][1], o[mt][n][3] * inv[mt][1]);
      }
    __syncwarp();
    constexpr int CPR = CW / 8;   // 16-byte chunks of a row of this warp's block
    for (int idx = lane; idx < rows * CPR; idx += 32) {
      const int r = idx / CPR, c = idx - r * CPR;
      if (c0 + c * 8 < D)
        *reinterpret_cast<uint4*>(out + (long)(r0 + r) * ld + c0 + c * 8) =
            *reinterpret_cast<const uint4*>(sO + r * LDS + c * 8);
    }
  } else {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = mt * 16 + g + (j >> 1) * 8, c = c0 + n * 8 + tg * 2 + (j & 1);
          if (r < rows && c < D)
            out[(long)(r0 + r) * ld + c] = __float2bfloat16(o[mt][n][j] * inv[mt][j >> 1]);
        }
  }
}

// The two head-dim buckets.
#define I360_WIDE_DP_SWITCH(D, ...)                         \
  do {                                                      \
    if ((D) <= 256) { constexpr int DP = 256; __VA_ARGS__; } \
    else { constexpr int DP = 512; __VA_ARGS__; }           \
  } while (0)

}  // namespace i360
