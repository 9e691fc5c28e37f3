// K6a: streaming attention on sequence-minor inputs, q [B, H, D, Sq] and
// k/v [B, H, D, Sk], with an optional float bias [1|B, 1|H, Sq, Sk]; the
// output is [B, H, Sq, D] and no lse is written.
//
// Replaces imagine360_tpu/ops/pallas_attention.py:_flash_kernel_t (wrapper
// _flash_bhds, reached through flash_attention under the opt-in `attn_v2`
// switch): online softmax with every product in float and the
// probabilities kept in float through the PV product, masked keys at the
// finite -1e30, and a zero denominator replaced by 1.
//
// What bounds it on the H100: the same work as K2 and K3 at the same sites
// (pano spatial self-attention at 8192 and 2048 tokens, WarpAttn r2 and r4),
// 4*Sq*Sk*D operations per (batch, head) against O((Sq+Sk)*D) bytes:
// compute bound, at 989 TFLOP/s bf16 on the tensor cores.
//
// Design: the TPU kernel put the sequence on the 128 lanes so that a head
// dim of 32 or 64 padded nothing, kept a broadcast bias block resident in
// VMEM and walked the key blocks on a sequential grid axis.
// bf16 at D = 64 without a bias, Sq and Sk multiples of 8, 16-byte-aligned
// pointers (the pano sites under attn_v2; kernels.wgmma_route decides, the C
// entry refuses the rest): the Hopper body of attn_wgmma.cuh with SEQ_MINOR
// and SPLIT_P (flash_t_wgmma_kernel): 3-D tensor maps {S, 64, B·H} copy
// boxes of 64 sequence positions × 64 head-dim rows as they lie, Q read by
// wgmma MN-major (the transpose bit for A), K MN-major and V K-major; the
// output [B, H, Sq, 64] leaves by a TMA store through a map {64, Sq, B·H};
// 128-key tiles (two boxes each), a tile's softmax under the previous
// tile's P·V.
// bf16 at D = 32 under a bias shared by every batch row and head, Sq and Sk
// multiples of 8, 16-byte-aligned pointers (the WarpAttn sites under
// attn_v2; kernels.flash_t_bias_wgmma_route decides, the C entry refuses
// the rest): the biased Hopper body of attn_wgmma_bias.cuh in its
// sequence-minor layout (flash_t_bias_wgmma_kernel): K6b's body with 3-D
// maps {S, 32, B·H} copying boxes of 64 positions × 32 head-dim rows as
// they lie, Q and K MN-major, V K-major, one [128, 64] bias tile by TMA
// under the K and V tiles of four (batch, head) rows, P split; the output
// [B, H, Sq, 32] leaves by TMA stores.
// Other bf16 launches, D <= 160 (a per-batch or per-head bias, no bias at
// D = 32, ragged or unaligned inputs): K5a's tensor-core body
// (i360::flash_tile_mma, attn_mma.cuh) with SEQ_MINOR: the Q, K and V
// tiles are staged as they lie, [D][64 sequence positions], by 16-byte
// cp.async copies along the sequence in two stages, and their fragments come
// from ldmatrix with the transposition flipped; no transposed copy is made.
// P·V takes SPLIT_P, the exact bf16 split p = hi + lo, since the kernel it
// replaces keeps the probabilities float32. The bias strides and staging
// are K5a's. The 16-byte path needs Sq, Sk and D multiples of 8 and 16-byte
// aligned pointers (every production site); else the tiles move by 2-byte
// accesses in the same body. The query tile is the fastest grid axis, as in
// K5a.
// float32: i360::flash_tile on the CUDA cores with a transposing loader (a
// warp reads 32 contiguous sequence positions of one head-dim row and stores
// them into the [rows][D + 1] float tile, whose odd stride spreads the
// stores over the 32 banks); grid (batch x head, query tile), so the blocks
// in flight read the same rows of a broadcast bias from L2. Ragged Sq and
// Sk are masked inside the tile; the host pads nothing. One pair of bias
// strides (0 for a broadcast axis) covers every bias shape.
#include "attn_mma.cuh"
#include "attn_wgmma.cuh"
#include "attn_wgmma_bias.cuh"

namespace i360 {

constexpr int K6A_BQ = 64;
constexpr int K6A_BK = 64;
constexpr int K6A_NT = 256;
constexpr int K6A_MMA_NW = 4;   // warps of the bf16 block: 64 query rows

template <int DP>
__global__ void __launch_bounds__(K6A_NT)
flash_t_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               float* __restrict__ out, int Sq, int Sk, int H, int D, long bias_bs,
               long bias_hs, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * K6A_BQ;
  const float* bp =
      bias == nullptr ? nullptr : bias + b * bias_bs + h * bias_hs + (long)q0 * Sk;
  const long koff = (long)bh * D * Sk;
  flash_tile<float, DP, K6A_BQ, K6A_BK, K6A_NT, false, true>(
      q + (long)bh * D * Sq + q0, k + koff, v + koff, out + ((long)bh * Sq + q0) * D, bp,
      nullptr, (long)D, min(K6A_BQ, Sq - q0), Sk, D, scale, smem, (long)Sq, (long)Sk);
}

// bf16 on the tensor cores; block index = (batch x head) x query tiles +
// query tile.
template <int DP>
__global__ void __launch_bounds__(K6A_MMA_NW * 32)
flash_t_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ bias,
                   bf16* __restrict__ out, int Sq, int Sk, int H, int D, long bias_bs,
                   long bias_hs, float scale, int vec, int bias_vec) {
  extern __shared__ __align__(16) unsigned char k6a_smem[];
  constexpr int BQ = 16 * K6A_MMA_NW;
  const int nqt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * BQ;
  const int b = bh / H, h = bh - b * H;
  const float* bp =
      bias == nullptr ? nullptr : bias + b * bias_bs + h * bias_hs + (long)q0 * Sk;
  const long koff = (long)bh * D * Sk;
  // the bias stages (when there is a bias) before the Q, K and V tiles
  const size_t bias_bytes = bias == nullptr ? 0 : attn_mma_bias_bytes(BQ);
  flash_tile_mma<DP, K6A_MMA_NW, true, true>(
      q + (long)bh * D * Sq + q0, k + koff, v + koff, out + ((long)bh * Sq + q0) * D, nullptr,
      bp, bias_vec != 0, (long)D, min(BQ, Sq - q0), Sk, D, scale, vec != 0, kMmaBK,
      (bf16*)(k6a_smem + bias_bytes), (float*)k6a_smem, (long)Sq, (long)Sk);
}

int launch_flash_t_mma(const void* q, const void* k, const void* v, const float* bias,
                       void* out, int B, int Sq, int Sk, int H, int D, long bias_bs,
                       long bias_hs, float scale, cudaStream_t stream) {
  constexpr int BQ = 16 * K6A_MMA_NW;
  const unsigned blocks = (unsigned)((long)B * H * ((Sq + BQ - 1) / BQ));
  // 16-byte copies along the sequence and 16-byte stores of output rows
  const int vec = Sq % 8 == 0 && Sk % 8 == 0 && attn_mma_vec(D, q, k, v, out);
  const int bias_vec = attn_mma_bias_vec(Sk, bias);
  I360_DP_SWITCH(D, {
    const size_t smem = attn_mma_t_smem_bytes<DP>(BQ) +
                        (bias == nullptr ? 0 : attn_mma_bias_bytes(BQ));
    auto kern = flash_t_mma_kernel<DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<blocks, K6A_MMA_NW * 32, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, bias, (bf16*)out, Sq, Sk, H, D,
        bias_bs, bias_hs, scale, vec, bias_vec);
  });
  return (int)cudaGetLastError();
}

// bf16 at D = 64 without a bias on wgmma (attn_wgmma.cuh), sequence-minor
// tiles and P split; block index = (batch x head) x query tiles + query tile
__global__ void __launch_bounds__(kWgThreads, 1)
flash_t_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const __grid_constant__ CUtensorMap mo, int Sq, int Sk, int H, int nqt,
                     float sl2) {
  extern __shared__ __align__(1024) unsigned char k6a_wg_smem[];
  attn_wgmma_tile<false, true, true>(&mq, &mk, &mv, &mo, nullptr, Sq, Sk, H, nqt, sl2,
                                     k6a_wg_smem);
}

// bf16 at D = 32 on the biased wgmma body (attn_wgmma_bias.cuh),
// sequence-minor tiles under one float32 bias; block index = query tile x
// row groups + row group; no lse (the pointer is null)
__global__ void __launch_bounds__(kWgThreads, 1)
flash_t_bias_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mo,
                          const __grid_constant__ CUtensorMap mb, float* __restrict__ lse, int BH,
                          int Sq, int Sk, int nrg, float scale) {
  extern __shared__ __align__(1024) unsigned char k6a_wgb_smem[];
  attn_wgmma_bias_tile<float, kFbSeqMinor>(&mq, &mk, &mv, &mo, &mb, lse, BH, Sq, Sk, nrg, scale,
                                           k6a_wgb_smem);
}

int launch_flash_t(const void* q, const void* k, const void* v, const float* bias, void* out,
                   int B, int Sq, int Sk, int H, int D, long bias_bs, long bias_hs,
                   float scale, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + K6A_BQ - 1) / K6A_BQ);
  I360_DP_SWITCH(D, {
    const size_t smem = flash_smem_bytes<K6A_BQ, K6A_BK, DP>();
    auto kern = flash_t_kernel<DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, K6A_NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                         bias, (float*)out, Sq, Sk, H, D, bias_bs, bias_hs,
                                         scale);
  });
  return (int)cudaGetLastError();
}

}  // namespace i360

// q [B, H, D, Sq], k/v [B, H, D, Sk], out [B, H, Sq, D], all contiguous;
// bias null or float with rows of Sk contiguous elements, batch stride
// bias_bs and head stride bias_hs in elements (0 for a broadcast axis).
// dtype 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor
// cores). Returns the cudaError_t of the launch.
extern "C" int i360_flash_attention_t(const void* q, const void* k, const void* v,
                                      const void* bias, void* out, int B, int Sq, int Sk,
                                      int H, int D, long bias_bs, long bias_hs, float scale,
                                      int dtype, void* stream) {
  if (D > 160 || D < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto bp = (const float*)bias;
  if (dtype == 1)
    return i360::launch_flash_t_mma(q, k, v, bp, out, B, Sq, Sk, H, D, bias_bs, bias_hs,
                                    scale, s);
  return i360::launch_flash_t(q, k, v, bp, out, B, Sq, Sk, H, D, bias_bs, bias_hs, scale, s);
}

// bf16, D = 64, no bias, Sq and Sk multiples of 8, q/k/v/out 16-byte
// aligned (kernels.wgmma_route): the wgmma body. Returns the cudaError_t of
// the launch; anything else it refuses with cudaErrorInvalidValue and
// launches nothing.
extern "C" int i360_flash_attention_t_wgmma(const void* q, const void* k, const void* v,
                                            void* out, int B, int Sq, int Sk, int H, int D,
                                            float scale, void* stream) {
  if (D != i360::kWgD) return (int)cudaErrorInvalidValue;
  return i360::launch_attn_wgmma<true>(i360::flash_t_wgmma_kernel, q, k, v, out, B, Sq, Sk, H,
                                       scale, (cudaStream_t)stream);
}

// bf16 q [B, H, 32, Sq], k/v [B, H, 32, Sk], out [B, H, Sq, 32], a float32
// bias [Sq, Sk] shared by every batch row and head; Sq and Sk multiples of
// 8, q, k, v, out and the bias 16-byte aligned
// (kernels.flash_t_bias_wgmma_route): the biased wgmma body. Returns the
// cudaError_t of the launch; anything else it refuses with
// cudaErrorInvalidValue and launches nothing.
extern "C" int i360_flash_attention_t_bias_wgmma(const void* q, const void* k, const void* v,
                                                 const void* bias, void* out, int B, int Sq,
                                                 int Sk, int H, int D, float scale,
                                                 void* stream) {
  if (D != i360::kFbD || bias == nullptr || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  return i360::launch_attn_wgmma_bias<float, i360::kFbSeqMinor>(
      i360::flash_t_bias_wgmma_kernel, q, k, v, bias, out, nullptr, B * H, Sq, Sk, scale,
      (cudaStream_t)stream);
}
