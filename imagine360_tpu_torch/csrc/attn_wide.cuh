// Device helpers for the wide-head variants of K1 and K2 in float32: head
// dims 161..512 (the VAE mid-block attention has one head of 512). bf16 takes
// the tensor-core tile of attn_mma_wide.cuh.
//
// At D = 512 the tiles of attn_common.cuh do not fit: a 64-row Q tile and a
// 64-row K/V tile of 513 floats each take 263 KB of shared memory against
// the 227 KB a block may have, and a [64, 512] accumulator is 128 floats per
// thread. Here the query tile stays whole in shared memory ([BQ][513]
// floats, BQ = 16 or 32) while K and V are staged in slabs of 64 columns of
// the head dim ([64][65] floats): a logit is summed slab by slab in
// registers, and each V slab updates its own 64 columns of the accumulator.
//
// 256 threads form a 16 x 16 grid. In the QK^T product thread (ti, tj) owns
// rows ti + 16a (a < BQ/16) and keys tj + 16b (b < 4); in the PV product it
// owns the same rows and columns tj + 16b of every slab. Per step of the
// inner loop a thread loads BQ/16 + 4 floats from shared memory for
// 4 * BQ/16 multiply-adds (the one-output-per-thread loop of
// attn_common.cuh loads 2 per multiply-add), the key/value reads of a warp
// fall on 16 consecutive banks, and the query/probability reads are
// broadcasts.
#pragma once

#include "attn_common.cuh"

namespace i360 {

constexpr int WIDE_MAX_D = 512;            // head dim, zero padded to this in the Q tile
constexpr int WIDE_DS = 64;                // columns of the head dim staged at a time
constexpr int WIDE_BK = 64;                // keys per tile
constexpr int WIDE_NT = 256;
constexpr int WIDE_NSLAB = WIDE_MAX_D / WIDE_DS;
constexpr int WIDE_QLD = WIDE_MAX_D + 1;   // odd row strides: a column walk hits
constexpr int WIDE_KLD = WIDE_DS + 1;      // distinct banks

// Rows [0, BQ) of q (row stride `ld`, D valid columns, `nq` valid rows) into
// qs [BQ][WIDE_QLD], zero elsewhere.
template <typename T, int BQ>
__device__ __forceinline__ void wide_load_q(float* qs, const T* q, long ld, int nq, int D) {
  for (int idx = threadIdx.x; idx < BQ * WIDE_MAX_D; idx += WIDE_NT) {
    const int r = idx / WIDE_MAX_D, d = idx - r * WIDE_MAX_D;
    float x = 0.f;
    if (r < nq && d < D) x = to_f(q[(long)r * ld + d]);
    qs[r * WIDE_QLD + d] = x;
  }
}

// Columns [d0, d0 + WIDE_DS) of WIDE_BK rows of src into ks [WIDE_BK][WIDE_KLD];
// rows at or beyond `nvalid` and columns at or beyond D are written as 0.
template <typename T>
__device__ __forceinline__ void wide_load_slab(float* ks, const T* src, long ld, int nvalid,
                                               int D, int d0) {
  for (int idx = threadIdx.x; idx < WIDE_BK * WIDE_DS; idx += WIDE_NT) {
    const int r = idx / WIDE_DS, d = idx - r * WIDE_DS;
    float x = 0.f;
    if (r < nvalid && d0 + d < D) x = to_f(src[(long)r * ld + d0 + d]);
    ks[r * WIDE_KLD + d] = x;
  }
}

// s[a][b] = dot(q row ti + 16a, key tj + 16b) over the whole head dim, for
// one tile of WIDE_BK keys starting at `k`. Every thread must call it: it
// synchronises the block around each slab, the first time before it touches
// `ks`, so whatever the block did with `ks` and `qs` before is complete.
template <typename T, int BQ>
__device__ __forceinline__ void wide_qk(const float* qs, float* ks, const T* k, long ld,
                                        int nk, int D, float (&s)[BQ / 16][4]) {
  constexpr int RT = BQ / 16;
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
  for (int d0 = 0; d0 < D; d0 += WIDE_DS) {
    __syncthreads();
    wide_load_slab(ks, k, ld, nk, D, d0);
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < WIDE_DS; ++d) {
      float kk[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) kk[b] = ks[(tj + 16 * b) * WIDE_KLD + d];
#pragma unroll
      for (int a = 0; a < RT; ++a) {
        const float qv = qs[(ti + 16 * a) * WIDE_QLD + d0 + d];
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] += qv * kk[b];
      }
    }
  }
}

// acc[slab][a][b] += sum_j p[row ti + 16a][j] * v[j][slab * 64 + tj + 16b]
// over one tile of WIDE_BK keys. `p` points at the tile's first column of
// the probability rows (row stride `pld`). Rows of v at or beyond `nk` count
// as 0. Every thread must call it; it synchronises like wide_qk.
template <typename T, int BQ>
__device__ __forceinline__ void wide_pv(const float* p, int pld, float* ks, const T* v, long ld,
                                        int nk, int D,
                                        float (&acc)[WIDE_NSLAB][BQ / 16][4]) {
  constexpr int RT = BQ / 16;
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
#pragma unroll
  for (int sl = 0; sl < WIDE_NSLAB; ++sl) {
    if (sl * WIDE_DS < D) {          // the same for every thread of the block
      __syncthreads();
      wide_load_slab(ks, v, ld, nk, D, sl * WIDE_DS);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < WIDE_BK; ++j) {
        float vv[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) vv[b] = ks[j * WIDE_KLD + tj + 16 * b];
#pragma unroll
        for (int a = 0; a < RT; ++a) {
          const float pv = p[(ti + 16 * a) * pld + j];
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[sl][a][b] += pv * vv[b];
        }
      }
    }
  }
}

// out[row ti + 16a][slab * 64 + tj + 16b] = acc * inv[a] for the valid rows
// and columns.
template <typename T, int BQ>
__device__ __forceinline__ void wide_store(T* out, long ld, int nq, int D,
                                           const float (&acc)[WIDE_NSLAB][BQ / 16][4],
                                           const float (&inv)[BQ / 16]) {
  constexpr int RT = BQ / 16;
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
#pragma unroll
  for (int sl = 0; sl < WIDE_NSLAB; ++sl)
#pragma unroll
    for (int a = 0; a < RT; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = ti + 16 * a, d = sl * WIDE_DS + tj + 16 * b;
        if (i < nq && d < D) out[(long)i * ld + d] = from_f<T>(acc[sl][a][b] * inv[a]);
      }
}

}  // namespace i360
