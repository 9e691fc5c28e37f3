// Shared device helpers for the attention kernels (K1-K6) on the CUDA cores.
//
// Storage types are float and __nv_bfloat16 (K1, K2, K3, K5a and K6a take
// bf16 on the tensor cores instead, attn_mma.cuh). Every kernel stages its tiles
// in shared memory as float, takes the dots in float (a bf16 x bf16 product
// is exact in float, so this equals the reference's bf16 dot with f32
// accumulation), keeps the softmax in float, and rounds the probabilities to
// the storage type before the PV product, as the plain reference casts
// `probs` to v.dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace i360 {

// Masked logit. Finite, like the JAX kernels' NEG_INF, so that exp(x - m)
// of a masked key is exactly 0 once one real key set the running max.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the storage type T and widened back to float.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy `rows` rows of D contiguous elements (row stride `ld` elements) into
// a float tile [rows][ldsm]. Rows at or beyond `nvalid` and columns in
// [D, dpad) are written as 0, so a padded head dim or a ragged sequence tail
// adds nothing to a dot product.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ldsm, const T* src, long ld,
                                          int rows, int nvalid, int D, int dpad) {
  for (int idx = threadIdx.x; idx < rows * dpad; idx += blockDim.x) {
    const int r = idx / dpad, d = idx - r * dpad;
    float x = 0.f;
    if (r < nvalid && d < D) x = to_f(src[(long)r * ld + d]);
    dst[r * ldsm + d] = x;
  }
}

// The same tile from a sequence-minor source: element (row r, column d) is
// src[d * ld + r], the rows of one column contiguous. Neighbouring threads
// take neighbouring rows, so a warp reads 32 contiguous elements; its
// transposed stores into dst[r * ldsm + d] hit 32 different banks when ldsm
// is odd.
template <typename T>
__device__ __forceinline__ void load_tile_t(float* dst, int ldsm, const T* src, long ld,
                                            int rows, int nvalid, int D, int dpad) {
  for (int idx = threadIdx.x; idx < rows * dpad; idx += blockDim.x) {
    const int d = idx / rows, r = idx - d * rows;
    float x = 0.f;
    if (r < nvalid && d < D) x = to_f(src[(long)d * ld + r]);
    dst[r * ldsm + d] = x;
  }
}

// Streaming (online-softmax) attention of one query tile of one (batch,
// head) problem: the body K2, K3, K5a and K6a share in float32. BQ query
// rows, key tiles of BK, head dim padded to DP, NT threads. q/k/v/out point at element (row 0,
// head h) of their [*, S, H*D] rows, with row stride `ld`. `bias`, when not
// null, points at row q0 of a [Sq, Sk] float matrix with row stride Sk.
// `lse`, when not null, points at row q0 of this problem's float
// log-sum-exp row and receives m + log(l), the residual the streaming
// backward recomputes the probabilities from. ROUND_P rounds the
// probabilities to the storage type before the PV product (K2, K3, as the
// plain reference casts them to v.dtype); K5a and K6a keep them in float,
// as the kernels they replace do. With SEQ_MINOR (K6a) q, k and v are
// sequence-minor instead: q points at query q0 of a [D, Sq] matrix and k/v
// at key 0 of [D, Sk] matrices, `ldq` and `ldk` are Sq and Sk, and only the
// loads differ; `ld` stays the row stride of `out`.
template <typename T, int DP, int BQ, int BK, int NT, bool ROUND_P = true,
          bool SEQ_MINOR = false>
__device__ __forceinline__ void flash_tile(const T* q, const T* k, const T* v, T* out,
                                           const float* bias, float* lse, long ld, int nq,
                                           int Sk, int D, float scale, float* smem,
                                           long ldq = 0, long ldk = 0) {
  constexpr int LD = DP + 1;      // odd row stride: column walks hit distinct banks
  constexpr int PLD = BK + 1;
  constexpr int NR = (BQ * DP + NT - 1) / NT;
  float* qs = smem;               // [BQ][LD]
  float* kv = qs + BQ * LD;       // [BK][LD]   K tile, then V tile
  float* ps = kv + BK * LD;       // [BQ][PLD]  logits, then probabilities
  float* m_s = ps + BQ * PLD;     // [BQ] running max
  float* l_s = m_s + BQ;          // [BQ] running sum
  float* a_s = l_s + BQ;          // [BQ] rescale of this tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (SEQ_MINOR) load_tile_t(qs, LD, q, ldq, BQ, nq, D, DP);
  else load_tile(qs, LD, q, ld, BQ, nq, D, DP);
  for (int i = tid; i < BQ; i += NT) { m_s[i] = kNegInf; l_s[i] = 0.f; }
  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    const int nk = min(BK, Sk - k0);
    __syncthreads();
    if (SEQ_MINOR) load_tile_t(kv, LD, k + k0, ldk, BK, nk, D, DP);
    else load_tile(kv, LD, k + (long)k0 * ld, ld, BK, nk, D, DP);
    __syncthreads();
    for (int idx = tid; idx < BQ * BK; idx += NT) {
      const int i = idx / BK, j = idx - i * BK;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < DP; ++d) s += qs[i * LD + d] * kv[j * LD + d];
      s *= scale;
      if (j >= nk) s = kNegInf;
      else if (bias != nullptr && i < nq) s += bias[(long)i * Sk + k0 + j];
      ps[i * PLD + j] = s;
    }
    __syncthreads();
    for (int i = warp; i < BQ; i += NT / 32) {
      float mx = kNegInf;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, ps[i * PLD + j]);
      mx = warp_max(mx);
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = __expf(ps[i * PLD + j] - m_new);
        sum += p;
        ps[i * PLD + j] = ROUND_P ? round_to<T>(p) : p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        a_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();
    if (SEQ_MINOR) load_tile_t(kv, LD, v + k0, ldk, BK, nk, D, DP);
    else load_tile(kv, LD, v + (long)k0 * ld, ld, BK, nk, D, DP);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int idx = tid + r * NT;
      if (idx < BQ * DP) {
        const int i = idx / DP, d = idx - i * DP;
        float a = acc[r] * a_s[i];
        for (int j = 0; j < BK; ++j) a += ps[i * PLD + j] * kv[j * LD + d];
        acc[r] = a;
      }
    }
  }
  __syncthreads();
  if (lse != nullptr) {
    for (int i = tid; i < nq; i += NT) {
      const float l = l_s[i];
      lse[i] = m_s[i] + logf(l == 0.f ? 1.f : l);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int idx = tid + r * NT;
    if (idx < BQ * DP) {
      const int i = idx / DP, d = idx - i * DP;
      if (i < nq && d < D) {
        float l = l_s[i];
        l = (l == 0.f) ? 1.f : l;
        out[(long)i * ld + d] = from_f<T>(acc[r] / l);
      }
    }
  }
}

template <int BQ, int BK, int DP>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + BK) * (DP + 1) + (size_t)BQ * (BK + 1) + 3 * BQ);
}

// Head-dim buckets: the smallest DP >= D among these is instantiated. The
// production sites of K1-K3 use D = 64 and 32, the tiny configs 16 and 32;
// every bucket costs one instantiation per kernel and dtype, and nvcc time.
#define I360_DP_SWITCH(D, ...)                                    \
  do {                                                            \
    if ((D) <= 16) { constexpr int DP = 16; __VA_ARGS__; }        \
    else if ((D) <= 32) { constexpr int DP = 32; __VA_ARGS__; }   \
    else if ((D) <= 64) { constexpr int DP = 64; __VA_ARGS__; }   \
    else if ((D) <= 96) { constexpr int DP = 96; __VA_ARGS__; }   \
    else if ((D) <= 128) { constexpr int DP = 128; __VA_ARGS__; } \
    else { constexpr int DP = 160; __VA_ARGS__; }                 \
  } while (0)

}  // namespace i360
