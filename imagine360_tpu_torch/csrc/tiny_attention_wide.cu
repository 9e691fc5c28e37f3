// K1 at head dims 161..512: whole-row attention for short key sequences.
//
// The second half of the replacement of
// imagine360_tpu/ops/pallas_attention.py:_tiny_packed_kernel (wrapper
// tiny_packed_attention); csrc/tiny_attention.cu takes D <= 160. The site is
// the VAE's mid-block attention on the perspective views: one head of 512,
// 1024 tokens per 256x256 view, 80 view-frames per call.
//
// What bounds it on the H100: 4*Sq*Sk*D operations per view-frame against
// (2*Sq + 2*Sk)*D elements, so it is bound by operations: 989 TFLOP/s bf16
// on the tensor cores.
//
// bf16 at D = 512 without a bias, 16-byte-aligned pointers (the main path:
// kernels.wide_wgmma_route): the Hopper body of attn_wgmma_wide.cuh, the one
// of the wide K2 (tiny_attention_wide_wgmma_kernel). Other bf16 launches (a
// bias, D 161..511, unaligned views): the wide tensor-core tile of
// attn_mma_wide.cuh (i360::wide_tile_mma, the wide K2's other body) over the
// at most 16 key tiles, with the optional [Sq, Sk] float32 bias staged one
// [64][72] tile at a time beside V. It streams the keys through the online softmax and
// rounds the unnormalised probabilities to bf16 before P·V, dividing by the
// sum at the end, as the narrow K1 has done since it took the tensor cores;
// the JAX kernel's order (the max and sum of the whole row first, then the
// normalised probabilities rounded) would need the [64, 1024] float32 row
// of logits (256 KB) in shared memory beside the tiles. 80 problems of 16
// query tiles fill the card with 1280 blocks of one an SM.
//
// float32 (phase 3's tiny VAE of width 192, phase 2's f32 checks): the
// CUDA-core kernel below. As in csrc/tiny_attention.cu a block owns 16 query
// rows of one (batch, head) and keeps their whole row of logits in shared
// memory (64 KB at Sk = 1024), so the softmax is exact in two passes. At D =
// 512 the [16, 512] query tile is staged once and K and V stream through a
// [64][64] slab of the head dim (attn_wide.cuh): 112 KB in all, two blocks on
// an SM.
#include "attn_mma_wide.cuh"
#include "attn_wgmma_wide.cuh"
#include "attn_wide.cuh"

namespace i360 {

constexpr int K1W_BQ = 16;
constexpr int K1W_MAX_SK = 1024;

template <typename T>
__global__ void __launch_bounds__(WIDE_NT)
tiny_attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bias,
                           T* __restrict__ out, int Sq, int Sk, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int skp = (Sk + WIDE_BK - 1) / WIDE_BK * WIDE_BK;
  const int PLD = skp + 1;
  float* qs = smem;                       // [BQ][WIDE_QLD]
  float* ks = qs + K1W_BQ * WIDE_QLD;     // [WIDE_BK][WIDE_KLD]
  float* ps = ks + WIDE_BK * WIDE_KLD;    // [BQ][PLD] whole rows of logits

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * K1W_BQ;
  const int nq = min(K1W_BQ, Sq - q0);
  const long ld = (long)H * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ti = tid >> 4, tj = tid & 15;
  const T* qb = q + ((long)b * Sq + q0) * ld + (long)h * D;
  const T* kb = k + (long)b * Sk * ld + (long)h * D;
  const T* vb = v + (long)b * Sk * ld + (long)h * D;

  wide_load_q<T, K1W_BQ>(qs, qb, ld, nq, D);
  for (int k0 = 0; k0 < skp; k0 += WIDE_BK) {
    const int nk = min(WIDE_BK, Sk - k0);
    float s[1][4];
    wide_qk<T, K1W_BQ>(qs, ks, kb + (long)k0 * ld, ld, nk, D, s);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tj + 16 * c;
      float x = s[0][c] * scale;
      if (j >= nk) x = kNegInf;
      else if (bias != nullptr && ti < nq) x += bias[(long)(q0 + ti) * Sk + k0 + j];
      ps[ti * PLD + k0 + j] = x;
    }
  }
  __syncthreads();
  // exact softmax per row: one warp per row
  for (int i = warp; i < K1W_BQ; i += WIDE_NT / 32) {
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
  float acc[WIDE_NSLAB][1][4];
#pragma unroll
  for (int sl = 0; sl < WIDE_NSLAB; ++sl)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[sl][0][c] = 0.f;
  for (int k0 = 0; k0 < skp; k0 += WIDE_BK)
    wide_pv<T, K1W_BQ>(ps + k0, PLD, ks, vb + (long)k0 * ld, ld, min(WIDE_BK, Sk - k0), D,
                       acc);
  const float one[1] = {1.f};
  wide_store<T, K1W_BQ>(out + ((long)b * Sq + q0) * ld + (long)h * D, ld, nq, D, acc, one);
}

template <typename T>
int launch_tiny_wide(const void* q, const void* k, const void* v, const float* bias, void* out,
                     int B, int Sq, int Sk, int H, int D, float scale, cudaStream_t stream) {
  const int skp = (Sk + WIDE_BK - 1) / WIDE_BK * WIDE_BK;
  const dim3 grid(B * H, (Sq + K1W_BQ - 1) / K1W_BQ);
  const size_t smem = sizeof(float) * ((size_t)K1W_BQ * WIDE_QLD + (size_t)WIDE_BK * WIDE_KLD +
                                       (size_t)K1W_BQ * (skp + 1));
  auto kern = tiny_attention_wide_kernel<T>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<grid, WIDE_NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, bias, (T*)out,
                                        Sq, Sk, H, D, scale);
  return (int)cudaGetLastError();
}

// bf16 on the tensor cores; block index = (batch x head) x query tiles +
// query tile
template <int DP>
__global__ void __launch_bounds__(kWideNT, 1)
tiny_attention_wide_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const float* __restrict__ bias,
                               bf16* __restrict__ out, int Sq, int Sk, int H, int D,
                               float scale, int vec, int bias_vec) {
  extern __shared__ __align__(16) unsigned char k1w_smem[];
  const int nqt = (Sq + kWideBQ - 1) / kWideBQ;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * kWideBQ;
  const int b = bh / H, h = bh - b * H;
  const long ld = (long)H * D;
  const long qoff = ((long)b * Sq + q0) * ld + (long)h * D;
  const long koff = (long)b * Sk * ld + (long)h * D;
  wide_tile_mma<DP>(q + qoff, k + koff, v + koff, out + qoff,
                    bias == nullptr ? nullptr : bias + (long)q0 * Sk, bias_vec != 0, ld,
                    min(kWideBQ, Sq - q0), Sk, D, scale, vec != 0, k1w_smem);
}

int launch_tiny_wide_mma(const void* q, const void* k, const void* v, const float* bias,
                         void* out, int B, int Sq, int Sk, int H, int D, float scale,
                         cudaStream_t stream) {
  const unsigned blocks = (unsigned)((long)B * H * ((Sq + kWideBQ - 1) / kWideBQ));
  const int vec = attn_mma_vec(D, q, k, v, out);
  const int bias_vec = attn_mma_bias_vec(Sk, bias);
  I360_WIDE_DP_SWITCH(D, {
    const size_t smem = wide_mma_smem_bytes<DP>(bias != nullptr);
    auto kern = tiny_attention_wide_mma_kernel<DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<blocks, kWideNT, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                            bias, (bf16*)out, Sq, Sk, H, D, scale, vec,
                                            bias_vec);
  });
  return (int)cudaGetLastError();
}

// bf16 at D = 512 without a bias on wgmma (attn_wgmma_wide.cuh); block
// index = (batch x head) x query tiles + query tile
__global__ void __launch_bounds__(kWwThreads, 1)
tiny_attention_wide_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                                 const __grid_constant__ CUtensorMap mk,
                                 const __grid_constant__ CUtensorMap mv,
                                 const __grid_constant__ CUtensorMap mo, int Sq, int Sk, int H,
                                 int nqt, float sl2) {
  extern __shared__ __align__(1024) unsigned char k1w_wg_smem[];
  attn_wide_wgmma_tile(&mq, &mk, &mv, &mo, Sq, Sk, H, nqt, sl2, k1w_wg_smem);
}

}  // namespace i360

// q [B, Sq, H*D], k/v [B, Sk, H*D], out [B, Sq, H*D], all contiguous,
// D <= 512, Sk <= 1024; bias null or a contiguous [Sq, Sk] float matrix.
// dtype 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor
// cores). Returns the cudaError_t of the launch.
extern "C" int i360_tiny_attention_wide(const void* q, const void* k, const void* v,
                                        const void* bias, void* out, int B, int Sq, int Sk,
                                        int H, int D, float scale, int dtype, void* stream) {
  if (Sk > i360::K1W_MAX_SK || Sk < 1 || D > i360::WIDE_MAX_D || D < 1)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto bp = (const float*)bias;
  if (dtype == 1)
    return i360::launch_tiny_wide_mma(q, k, v, bp, out, B, Sq, Sk, H, D, scale, s);
  return i360::launch_tiny_wide<float>(q, k, v, bp, out, B, Sq, Sk, H, D, scale, s);
}

// bf16, D = 512, no bias, Sk <= 1024, q/k/v/out 16-byte aligned
// (kernels.wide_wgmma_route): the wgmma body of the wide K2. Returns the
// cudaError_t of the launch; anything else it refuses with
// cudaErrorInvalidValue and launches nothing.
extern "C" int i360_tiny_attention_wide_wgmma(const void* q, const void* k, const void* v,
                                              void* out, int B, int Sq, int Sk, int H, int D,
                                              float scale, void* stream) {
  if (Sk > i360::K1W_MAX_SK || D != i360::kWwD) return (int)cudaErrorInvalidValue;
  return i360::launch_wide_wgmma(i360::tiny_attention_wide_wgmma_kernel, q, k, v, out, B, Sq, Sk,
                                 H, scale, (cudaStream_t)stream);
}
