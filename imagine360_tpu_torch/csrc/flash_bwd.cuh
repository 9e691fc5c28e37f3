// Device helpers of the two streaming attention-backward kernels on the
// CUDA cores (K5b: dq; K5c in float32: dk and dv; K5c in bf16 takes the
// tensor-core tile of attn_mma_bwd.cuh).
//
// Both recompute, tile by tile, the probabilities from the forward's
// log-sum-exp instead of reading an [Sq, Sk] matrix from device memory:
//   s  = q k^T * scale + bias        p  = exp(s - lse)
//   dp = dO v^T                      ds = p * (dp - delta)
// with delta = rowsum(dO * O) computed outside the kernels. Everything is
// float: the tiles are staged as float, the dots are float, and p is never
// rounded (imagine360_tpu/ops/pallas_attention.py:_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel do the same).
#pragma once

#include "attn_common.cuh"

namespace i360 {

constexpr int BWD_BQ = 64;   // query rows of a tile
constexpr int BWD_BK = 64;   // key rows of a tile
constexpr int BWD_NT = 256;

// Copy `rows` floats of a [B, H, Sq] row vector into shared memory; rows at
// or beyond `nvalid` become 0.
__device__ __forceinline__ void load_rowvec(float* dst, const float* src, int rows,
                                            int nvalid) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) dst[i] = i < nvalid ? src[i] : 0.f;
}

// p (when WITH_P) and ds of one [BWD_BQ, BWD_BK] tile from the staged q, dO,
// k and v tiles (row stride DP + 1). `bias`, when not null, points at
// element (q0, k0) of a float matrix with row stride Sk. Rows at or beyond
// nq and keys at or beyond nk get p = ds = 0, so a ragged tail adds nothing
// to any sum.
template <int DP, bool WITH_P>
__device__ __forceinline__ void bwd_tile_scores(const float* qs, const float* dos,
                                                const float* ks, const float* vs,
                                                const float* lse_s, const float* delta_s,
                                                const float* bias, int Sk, int nq, int nk,
                                                float scale, float* ps, float* dss) {
  constexpr int LD = DP + 1;
  constexpr int PLD = BWD_BK + 1;
  for (int idx = threadIdx.x; idx < BWD_BQ * BWD_BK; idx += BWD_NT) {
    const int i = idx / BWD_BK, j = idx - i * BWD_BK;
    float s = 0.f, dp = 0.f;
#pragma unroll 16
    for (int d = 0; d < DP; ++d) {
      s += qs[i * LD + d] * ks[j * LD + d];
      dp += dos[i * LD + d] * vs[j * LD + d];
    }
    float p = 0.f;
    if (i < nq && j < nk) {
      s *= scale;
      if (bias != nullptr) s += bias[(long)i * Sk + j];
      p = __expf(s - lse_s[i]);
    }
    if (WITH_P) ps[i * PLD + j] = p;
    dss[i * PLD + j] = p * (dp - delta_s[i]);
  }
}

}  // namespace i360
