// K1: whole-row attention for short key sequences.
//
// Replaces imagine360_tpu/ops/pallas_attention.py:_tiny_packed_kernel
// (wrapper tiny_packed_attention). Computes, for every (batch row, head),
// softmax(q k^T * scale + bias) v with one optional [Sq, Sk] float bias
// shared by every row and head, in the natural [B, S, H*D] layout.
//
// What bounds it on the H100: at the production sites (perspective spatial
// self-attention, Sq = Sk = 1024/256/64, and text/IP cross-attention with
// Sk = 77/64) the work is the two dots, O(Sq*Sk*D) per problem, against
// O((Sq+Sk)*D) bytes, so it is compute bound; this simple kernel runs the
// dots on the CUDA cores from shared memory (no tensor cores yet), and
// shared-memory bandwidth is its limit.
//
// Design: the TPU kernel packed tiny sequences under a block-diagonal bias
// and padded keys to 128 lanes, so that the MXU saw large tiles. Here a
// block owns BQ = 16 query rows of one (batch, head) and keeps their whole
// [16, Sk] row of logits in shared memory (64 KB at Sk = 1024): the softmax
// is exact in two passes (max, then sum) with no running rescale, the key
// tail is masked by Sk inside the kernel, and no packing or padding exists
// on the host side.
#include "attn_common.cuh"

namespace i360 {

constexpr int K1_BQ = 16;
constexpr int K1_BK = 64;
constexpr int K1_NT = 256;
constexpr int K1_MAX_SK = 1024;

template <typename T, int DP>
__global__ void __launch_bounds__(K1_NT)
tiny_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      T* __restrict__ out, int Sq, int Sk, int H, int D, float scale) {
  constexpr int LD = DP + 1;
  constexpr int NR = (K1_BQ * DP + K1_NT - 1) / K1_NT;
  extern __shared__ float smem[];
  const int skp = (Sk + K1_BK - 1) / K1_BK * K1_BK;
  const int PLD = skp + 1;
  float* qs = smem;                 // [BQ][LD]
  float* kv = qs + K1_BQ * LD;      // [BK][LD]
  float* ps = kv + K1_BK * LD;      // [BQ][PLD] whole rows of logits

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * K1_BQ;
  const int nq = min(K1_BQ, Sq - q0);
  const long ld = (long)H * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + ((long)b * Sq + q0) * ld + (long)h * D;
  const T* kb = k + (long)b * Sk * ld + (long)h * D;
  const T* vb = v + (long)b * Sk * ld + (long)h * D;

  load_tile(qs, LD, qb, ld, K1_BQ, nq, D, DP);
  for (int k0 = 0; k0 < skp; k0 += K1_BK) {
    const int nk = min(K1_BK, Sk - k0);
    __syncthreads();
    load_tile(kv, LD, kb + (long)k0 * ld, ld, K1_BK, nk, D, DP);
    __syncthreads();
    for (int idx = tid; idx < K1_BQ * K1_BK; idx += K1_NT) {
      const int i = idx / K1_BK, j = idx - i * K1_BK;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < DP; ++d) s += qs[i * LD + d] * kv[j * LD + d];
      s *= scale;
      if (j >= nk) s = kNegInf;
      else if (bias != nullptr && i < nq) s += bias[(long)(q0 + i) * Sk + k0 + j];
      ps[i * PLD + k0 + j] = s;
    }
  }
  __syncthreads();
  // exact softmax per row: one warp per row
  for (int i = warp; i < K1_BQ; i += K1_NT / 32) {
    float* row = ps + i * PLD;
    float mx = kNegInf;
    for (int j = lane; j < skp; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < skp; j += 32) {
      const float e = __expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const float inv = 1.f / sum;
    for (int j = lane; j < skp; j += 32) row[j] = round_to<T>(row[j] * inv);
  }
  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < skp; k0 += K1_BK) {
    const int nk = min(K1_BK, Sk - k0);
    __syncthreads();
    load_tile(kv, LD, vb + (long)k0 * ld, ld, K1_BK, nk, D, DP);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int idx = tid + r * K1_NT;
      if (idx < K1_BQ * DP) {
        const int i = idx / DP, d = idx - i * DP;
        const float* prow = ps + i * PLD + k0;
        float a = acc[r];
        for (int j = 0; j < K1_BK; ++j) a += prow[j] * kv[j * LD + d];
        acc[r] = a;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int idx = tid + r * K1_NT;
    if (idx < K1_BQ * DP) {
      const int i = idx / DP, d = idx - i * DP;
      if (i < nq && d < D) out[((long)b * Sq + q0 + i) * ld + (long)h * D + d] = from_f<T>(acc[r]);
    }
  }
}

template <typename T>
int launch_tiny(const void* q, const void* k, const void* v, const float* bias, void* out,
                int B, int Sq, int Sk, int H, int D, float scale, cudaStream_t stream) {
  const int skp = (Sk + K1_BK - 1) / K1_BK * K1_BK;
  const dim3 grid(B * H, (Sq + K1_BQ - 1) / K1_BQ);
  I360_DP_SWITCH(D, {
    const size_t smem = sizeof(float) *
        ((size_t)(K1_BQ + K1_BK) * (DP + 1) + (size_t)K1_BQ * (skp + 1));
    auto kern = tiny_attention_kernel<T, DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, K1_NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, bias,
                                        (T*)out, Sq, Sk, H, D, scale);
  });
  return (int)cudaGetLastError();
}

}  // namespace i360

// q [B, Sq, H*D], k/v [B, Sk, H*D], out [B, Sq, H*D], all contiguous;
// bias null or a contiguous [Sq, Sk] float matrix. dtype 0 = float32,
// 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int i360_tiny_attention(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int B, int Sq, int Sk,
                                   int H, int D, float scale, int dtype, void* stream) {
  if (Sk > i360::K1_MAX_SK || D > 160 || D < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto bp = (const float*)bias;
  if (dtype == 1)
    return i360::launch_tiny<__nv_bfloat16>(q, k, v, bp, out, B, Sq, Sk, H, D, scale, s);
  return i360::launch_tiny<float>(q, k, v, bp, out, B, Sq, Sk, H, D, scale, s);
}
