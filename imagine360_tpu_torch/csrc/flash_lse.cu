// K5a: streaming attention forward that also emits the log-sum-exp of every
// query row, the forward of the trained long-sequence sites.
//
// Replaces imagine360_tpu/ops/pallas_attention.py:_flash_kernel (wrapper
// _flash_bhsd, reached under grad through flash_attention_fwd_res):
// softmax(q k^T * scale + bias) v with an optional float bias
// [1|B, 1|H, Sq, Sk], the output in q's dtype and lse = m + log(l) in float
// [B, H, Sq]. Dots and probabilities stay in float (no rounding of the
// probabilities to bf16 before the PV product, unlike K2 and K3), a zero
// denominator is replaced by 1 before the divide and the log, and the
// running max starts at the finite -1e30.
//
// What bounds it on the H100: the pano spatial self-attention under grad
// (Sq = Sk = 8192 with 5 heads, 2048 with 10, D = 64, 16 frames) does
// 4*Sq*Sk*D operations per (batch, head) against O((Sq+Sk)*D) bytes:
// compute bound, at 989 TFLOP/s bf16 on the tensor cores.
//
// Design: the TPU kernel carried m, l and the accumulator in VMEM scratch
// across a sequential key-block grid axis and took a transposed
// [B, H, S, D] layout. Here q/k/v stay [B, S, H, D]; a block owns a 64-row
// query tile of one (batch, head) and walks the key tiles in a loop.
// Ragged Sq and Sk are masked inside the tile, so the host pads nothing.
// One pair of bias strides (0 for a broadcast axis) covers every bias
// shape.
// The probabilities stay float32 in the kernel it replaces, so in bf16 P·V
// takes the exact bf16 split p = hi + lo, two products per k-step (about 16
// significant bits of p; one bf16 rounding keeps 8), in both bodies below.
// bf16 at D = 64 without a bias, 16-byte-aligned pointers (every launch of
// the training step; kernels.wgmma_route decides, the C entry refuses the
// rest): the Hopper body of attn_wgmma.cuh with LSE and SPLIT_P
// (flash_lse_wgmma_kernel: a producer warpgroup feeding K/V tiles by TMA
// through an mbarrier ring, two consumer warpgroups of 64 query rows on
// wgmma, 128-key tiles, a tile's softmax under the previous tile's P·V).
// Other bf16 launches
// (a bias, another head dim up to 160, unaligned pointers): the tensor-core
// body of attn_mma.cuh (i360::flash_tile_mma: 4 warps of 16 query rows,
// mma.sync on bf16 fragments, K/V and the bias tile by cp.async in two
// stages) with the lse output and SPLIT_P. In both the query tile is the
// fastest grid axis, as in K2: with no bias (the production sites) the
// blocks in flight share one (batch, head)'s K and V in L2.
// float32: i360::flash_tile on the CUDA cores (no rounding of the
// probabilities), grid (batch x head, query tile).
#include "attn_mma.cuh"
#include "attn_wgmma.cuh"

namespace i360 {

constexpr int K5A_BQ = 64;
constexpr int K5A_BK = 64;
constexpr int K5A_NT = 256;
constexpr int K5A_MMA_NW = 4;   // warps of the bf16 block: 64 query rows

template <int DP>
__global__ void __launch_bounds__(K5A_NT)
flash_lse_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H,
                 int D, long bias_bs, long bias_hs, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * K5A_BQ;
  const long ld = (long)H * D;
  const long qoff = ((long)b * Sq + q0) * ld + (long)h * D;
  const long koff = (long)b * Sk * ld + (long)h * D;
  const float* bp =
      bias == nullptr ? nullptr : bias + b * bias_bs + h * bias_hs + (long)q0 * Sk;
  flash_tile<float, DP, K5A_BQ, K5A_BK, K5A_NT, false>(
      q + qoff, k + koff, v + koff, out + qoff, bp, lse + (long)bh * Sq + q0, ld,
      min(K5A_BQ, Sq - q0), Sk, D, scale, smem);
}

// bf16 on the tensor cores; block index = (batch x head) x query tiles +
// query tile. The library builds SPLIT_P true only; false (P rounded once to
// bf16, as in K2) is built by scripts/torch_attn_mma_variants.py, which
// measures what the split costs and what it changes in the output.
template <int DP, bool SPLIT_P = true>
__global__ void __launch_bounds__(K5A_MMA_NW * 32)
flash_lse_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     bf16* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H,
                     int D, long bias_bs, long bias_hs, float scale, int vec, int bias_vec,
                     int kt_rows) {
  extern __shared__ __align__(16) unsigned char k5a_smem[];
  constexpr int BQ = 16 * K5A_MMA_NW;
  const int nqt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * BQ;
  const int b = bh / H, h = bh - b * H;
  const long ld = (long)H * D;
  const long qoff = ((long)b * Sq + q0) * ld + (long)h * D;
  const long koff = (long)b * Sk * ld + (long)h * D;
  const float* bp =
      bias == nullptr ? nullptr : bias + b * bias_bs + h * bias_hs + (long)q0 * Sk;
  // the bias stages (when there is a bias) before the Q, K and V tiles
  const size_t bias_bytes = bias == nullptr ? 0 : attn_mma_bias_bytes(BQ);
  flash_tile_mma<DP, K5A_MMA_NW, SPLIT_P>(q + qoff, k + koff, v + koff, out + qoff,
                                          lse + (long)bh * Sq + q0, bp, bias_vec != 0, ld,
                                          min(BQ, Sq - q0), Sk, D, scale, vec != 0, kt_rows,
                                          (bf16*)(k5a_smem + bias_bytes), (float*)k5a_smem);
}

int launch_flash_lse_mma(const void* q, const void* k, const void* v, const float* bias,
                         void* out, float* lse, int B, int Sq, int Sk, int H, int D,
                         long bias_bs, long bias_hs, float scale, cudaStream_t stream) {
  constexpr int BQ = 16 * K5A_MMA_NW;
  const int kt_rows = attn_mma_kt_rows(Sk);
  const unsigned blocks = (unsigned)((long)B * H * ((Sq + BQ - 1) / BQ));
  const int vec = attn_mma_vec(D, q, k, v, out);
  const int bias_vec = attn_mma_bias_vec(Sk, bias);
  I360_DP_SWITCH(D, {
    const size_t smem = attn_mma_smem_bytes<DP>(BQ, kt_rows) +
                        (bias == nullptr ? 0 : attn_mma_bias_bytes(BQ));
    auto kern = flash_lse_mma_kernel<DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<blocks, K5A_MMA_NW * 32, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, bias, (bf16*)out, lse, Sq, Sk, H, D,
        bias_bs, bias_hs, scale, vec, bias_vec, kt_rows);
  });
  return (int)cudaGetLastError();
}

// bf16 at D = 64 without a bias on wgmma (attn_wgmma.cuh), with the lse
// and P split; block index = (batch x head) x query tiles + query tile
__global__ void __launch_bounds__(kWgThreads, 1)
flash_lse_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mo, float* __restrict__ lse, int Sq,
                       int Sk, int H, int nqt, float sl2) {
  extern __shared__ __align__(1024) unsigned char k5a_wg_smem[];
  attn_wgmma_tile<true, true>(&mq, &mk, &mv, &mo, lse, Sq, Sk, H, nqt, sl2, k5a_wg_smem);
}

int launch_flash_lse(const void* q, const void* k, const void* v, const float* bias, void* out,
                     float* lse, int B, int Sq, int Sk, int H, int D, long bias_bs,
                     long bias_hs, float scale, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + K5A_BQ - 1) / K5A_BQ);
  I360_DP_SWITCH(D, {
    const size_t smem = flash_smem_bytes<K5A_BQ, K5A_BK, DP>();
    auto kern = flash_lse_kernel<DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, K5A_NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                         bias, (float*)out, lse, Sq, Sk, H, D, bias_bs,
                                         bias_hs, scale);
  });
  return (int)cudaGetLastError();
}

}  // namespace i360

// q [B, Sq, H, D], k/v [B, Sk, H, D], out [B, Sq, H, D], lse [B, H, Sq]
// float, all contiguous; bias null or float with rows of Sk contiguous
// elements, batch stride bias_bs and head stride bias_hs in elements (0 for
// a broadcast axis). dtype 0 = float32 (the CUDA-core kernel), 1 = bfloat16
// (the tensor cores). Returns the cudaError_t of the launch.
extern "C" int i360_flash_attention_lse(const void* q, const void* k, const void* v,
                                        const void* bias, void* out, void* lse, int B, int Sq,
                                        int Sk, int H, int D, long bias_bs, long bias_hs,
                                        float scale, int dtype, void* stream) {
  if (D > 160 || D < 1 || lse == nullptr) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto bp = (const float*)bias;
  auto lp = (float*)lse;
  if (dtype == 1)
    return i360::launch_flash_lse_mma(q, k, v, bp, out, lp, B, Sq, Sk, H, D, bias_bs, bias_hs,
                                      scale, s);
  return i360::launch_flash_lse(q, k, v, bp, out, lp, B, Sq, Sk, H, D, bias_bs, bias_hs, scale,
                                s);
}

// bf16, D = 64, no bias, q/k/v/out 16-byte aligned, an lse
// (kernels.wgmma_route; the lse leaves by scalar stores, not by TMA): the
// wgmma body. Returns the cudaError_t of the launch; anything else it
// refuses with cudaErrorInvalidValue and launches nothing.
extern "C" int i360_flash_attention_lse_wgmma(const void* q, const void* k, const void* v,
                                              void* out, void* lse, int B, int Sq, int Sk, int H,
                                              int D, float scale, void* stream) {
  if (D != i360::kWgD || lse == nullptr) return (int)cudaErrorInvalidValue;
  return i360::launch_attn_wgmma(i360::flash_lse_wgmma_kernel, q, k, v, out, B, Sq, Sk, H, scale,
                                 (cudaStream_t)stream, (float*)lse);
}
