// K2 at head dims 161..512: streaming attention, no bias.
//
// The second half of the replacement of
// imagine360_tpu/ops/pallas_attention.py:_mh_flash_kernel (wrapper
// mh_flash_attention); csrc/mh_flash.cu takes D <= 160. The sites are the
// VAE's mid-block attention on panoramas: one head of 512, 8192 tokens per
// frame when encoding and 8704 when decoding with the circular pad.
//
// What bounds it on the H100: 4*Sq*Sk*D operations per frame (2.2 TFLOP for
// 16 frames at 8192 tokens) against (2*Sq + 2*Sk)*D elements, so it is
// bound by operations: 989 TFLOP/s bf16 on the tensor cores.
//
// bf16 at D = 512 with 16-byte-aligned pointers (the main path:
// kernels.wide_wgmma_route): the Hopper body of attn_wgmma_wide.cuh
// (mh_flash_wide_wgmma_kernel: TMA copies of 64-column boxes, one producer
// and two consumer warpgroups on wgmma, the head dim split between the
// consumers, the partial logits exchanged through shared memory). Other
// bf16 launches (D 161..511, unaligned views): the wide tensor-core tile of
// attn_mma_wide.cuh (i360::wide_tile_mma: 64 query rows and 16 warps a
// block, Q·Kᵀ split over the keys, P·V over the head dim, one block an SM).
// Both are launched over the whole key range with the query tile the
// fastest grid axis, so the blocks that run together share one frame's K
// and V (8 MB at 8192 tokens) in L2.
//
// float32 (phase 3's tiny VAE of width 192, phase 2's f32 checks): the
// CUDA-core kernel below. One head per batch row leaves only 4-16 (batch,
// head) problems, so the query tiles supply the blocks: 32 rows each, 256 or
// 272 tiles per frame. The [32, 512] query tile is staged once; K and V
// stream through a [64][64] slab of the head dim (attn_wide.cuh), so a block
// needs 89 KB of shared memory and two fit on an SM. The [32, 512]
// accumulator is 64 floats per thread, in registers.
#include "attn_mma_wide.cuh"
#include "attn_wgmma_wide.cuh"
#include "attn_wide.cuh"

namespace i360 {

constexpr int K2W_BQ = 32;
constexpr int K2W_RT = K2W_BQ / 16;
constexpr int K2W_PLD = WIDE_BK + 1;

constexpr size_t k2w_smem_bytes() {
  return sizeof(float) * ((size_t)K2W_BQ * WIDE_QLD + (size_t)WIDE_BK * WIDE_KLD +
                          (size_t)K2W_BQ * K2W_PLD + 3 * K2W_BQ);
}

template <typename T>
__global__ void __launch_bounds__(WIDE_NT)
mh_flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int Sq, int Sk, int H, int D, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [BQ][WIDE_QLD]
  float* ks = qs + K2W_BQ * WIDE_QLD;      // [WIDE_BK][WIDE_KLD]  K slab, then V slab
  float* ps = ks + WIDE_BK * WIDE_KLD;     // [BQ][PLD]  logits, then probabilities
  float* m_s = ps + K2W_BQ * K2W_PLD;      // [BQ] running max
  float* l_s = m_s + K2W_BQ;               // [BQ] running sum
  float* a_s = l_s + K2W_BQ;               // [BQ] rescale of this tile

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * K2W_BQ;
  const int nq = min(K2W_BQ, Sq - q0);
  const long ld = (long)H * D;
  const T* qb = q + ((long)b * Sq + q0) * ld + (long)h * D;
  const T* kb = k + (long)b * Sk * ld + (long)h * D;
  const T* vb = v + (long)b * Sk * ld + (long)h * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ti = tid >> 4, tj = tid & 15;

  wide_load_q<T, K2W_BQ>(qs, qb, ld, nq, D);
  for (int i = tid; i < K2W_BQ; i += WIDE_NT) { m_s[i] = kNegInf; l_s[i] = 0.f; }
  float acc[WIDE_NSLAB][K2W_RT][4];
#pragma unroll
  for (int sl = 0; sl < WIDE_NSLAB; ++sl)
#pragma unroll
    for (int a = 0; a < K2W_RT; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[sl][a][c] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += WIDE_BK) {
    const int nk = min(WIDE_BK, Sk - k0);
    float s[K2W_RT][4];
    wide_qk<T, K2W_BQ>(qs, ks, kb + (long)k0 * ld, ld, nk, D, s);
#pragma unroll
    for (int a = 0; a < K2W_RT; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tj + 16 * c;
        ps[(ti + 16 * a) * K2W_PLD + j] = (j < nk) ? s[a][c] * scale : kNegInf;
      }
    __syncthreads();
    for (int i = warp; i < K2W_BQ; i += WIDE_NT / 32) {
      float* row = ps + i * K2W_PLD;
      float mx = kNegInf;
      for (int j = lane; j < WIDE_BK; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < WIDE_BK; j += 32) {
        const float p = __expf(row[j] - m_new);
        sum += p;
        row[j] = round_to<T>(p);
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
#pragma unroll
    for (int a = 0; a < K2W_RT; ++a) {
      const float alpha = a_s[ti + 16 * a];
#pragma unroll
      for (int sl = 0; sl < WIDE_NSLAB; ++sl)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[sl][a][c] *= alpha;
    }
    wide_pv<T, K2W_BQ>(ps, K2W_PLD, ks, vb + (long)k0 * ld, ld, nk, D, acc);
  }
  float inv[K2W_RT];
#pragma unroll
  for (int a = 0; a < K2W_RT; ++a) {
    const float l = l_s[ti + 16 * a];
    inv[a] = (l == 0.f) ? 1.f : 1.f / l;
  }
  wide_store<T, K2W_BQ>(out + ((long)b * Sq + q0) * ld + (long)h * D, ld, nq, D, acc, inv);
}

template <typename T>
int launch_mh_flash_wide(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                         int Sk, int H, int D, float scale, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + K2W_BQ - 1) / K2W_BQ);
  constexpr size_t smem = k2w_smem_bytes();
  auto kern = mh_flash_wide_kernel<T>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<grid, WIDE_NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk,
                                        H, D, scale);
  return (int)cudaGetLastError();
}

// bf16 on the tensor cores; block index = (batch x head) x query tiles +
// query tile
template <int DP>
__global__ void __launch_bounds__(kWideNT, 1)
mh_flash_wide_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out, int Sq, int Sk,
                         int H, int D, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char k2w_smem[];
  const int nqt = (Sq + kWideBQ - 1) / kWideBQ;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * kWideBQ;
  const int b = bh / H, h = bh - b * H;
  const long ld = (long)H * D;
  const long qoff = ((long)b * Sq + q0) * ld + (long)h * D;
  const long koff = (long)b * Sk * ld + (long)h * D;
  wide_tile_mma<DP>(q + qoff, k + koff, v + koff, out + qoff, nullptr, false, ld,
                    min(kWideBQ, Sq - q0), Sk, D, scale, vec != 0, k2w_smem);
}

int launch_mh_flash_wide_mma(const void* q, const void* k, const void* v, void* out, int B,
                             int Sq, int Sk, int H, int D, float scale, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((long)B * H * ((Sq + kWideBQ - 1) / kWideBQ));
  const int vec = attn_mma_vec(D, q, k, v, out);
  I360_WIDE_DP_SWITCH(D, {
    const size_t smem = wide_mma_smem_bytes<DP>(false);
    auto kern = mh_flash_wide_mma_kernel<DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<blocks, kWideNT, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                            (bf16*)out, Sq, Sk, H, D, scale, vec);
  });
  return (int)cudaGetLastError();
}

// bf16 at D = 512 without a bias on wgmma (attn_wgmma_wide.cuh); block
// index = (batch x head) x query tiles + query tile
__global__ void __launch_bounds__(kWwThreads, 1)
mh_flash_wide_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mo, int Sq, int Sk, int H, int nqt,
                           float sl2) {
  extern __shared__ __align__(1024) unsigned char k2w_wg_smem[];
  attn_wide_wgmma_tile(&mq, &mk, &mv, &mo, Sq, Sk, H, nqt, sl2, k2w_wg_smem);
}

}  // namespace i360

// q [B, Sq, H*D], k/v [B, Sk, H*D], out [B, Sq, H*D], contiguous, D <= 512.
// dtype 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor
// cores). Returns the cudaError_t of the launch.
extern "C" int i360_mh_flash_attention_wide(const void* q, const void* k, const void* v,
                                            void* out, int B, int Sq, int Sk, int H, int D,
                                            float scale, int dtype, void* stream) {
  if (D > i360::WIDE_MAX_D || D < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (dtype == 1)
    return i360::launch_mh_flash_wide_mma(q, k, v, out, B, Sq, Sk, H, D, scale, s);
  return i360::launch_mh_flash_wide<float>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
}

// bf16, D = 512, q/k/v/out 16-byte aligned (kernels.wide_wgmma_route): the
// wgmma body. Returns the cudaError_t of the launch; anything else it
// refuses with cudaErrorInvalidValue and launches nothing.
extern "C" int i360_mh_flash_attention_wide_wgmma(const void* q, const void* k, const void* v,
                                                  void* out, int B, int Sq, int Sk, int H, int D,
                                                  float scale, void* stream) {
  if (D != i360::kWwD) return (int)cudaErrorInvalidValue;
  return i360::launch_wide_wgmma(i360::mh_flash_wide_wgmma_kernel, q, k, v, out, B, Sq, Sk, H,
                                 scale, (cudaStream_t)stream);
}
