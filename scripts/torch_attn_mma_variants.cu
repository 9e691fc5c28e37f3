// Variants of K3 and K5a that the kernel library does not build, for
// scripts/torch_attn_mma_variants.py, which compiles this file with the
// library's nvcc flags and -I imagine360_tpu_torch/csrc. The kernels are
// the library's own templates, included below, at other parameters:
//   K3 at G = 1, 2 or 4 (batch, head) problems a block under one staged
//   bias tile, head dims 17..32 (the WarpAttn sites; the library builds
//   k3_groups(32) = 2), no lse;
//   K5a with P·V on the exact bf16 split P = hi + lo (split 1, the
//   library's kernel) or on P rounded once to bf16 (split 0), head dims
//   33..64, no bias;
//   K5c with Pᵀ·dO and dSᵀ·Q on the exact split of P and dS (split 1, the
//   library's kernel) or on both rounded once to bf16 (split 0), head dims
//   17..64, no bias or one [Sq, Sk] bias shared by every batch row and head.
// Each returns the cudaError_t of its launch.
#include "shared_bias.cu"
#include "flash_lse.cu"
#include "flash_bwd_dkv.cu"

extern "C" int exp_shared_bias_groups(const void* q, const void* k, const void* v,
                                      const void* bias, void* out, int B, int Sq, int Sk,
                                      int H, int D, float scale, int groups, void* stream) {
  if (D <= 16 || D > 32) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto bp = (const float*)bias;
  switch (groups) {
    case 1:
      return i360::launch_shared_bias_mma_g<32, 1>(q, k, v, bp, out, nullptr, B, Sq, Sk, H, D,
                                                   scale, s);
    case 2:
      return i360::launch_shared_bias_mma_g<32, 2>(q, k, v, bp, out, nullptr, B, Sq, Sk, H, D,
                                                   scale, s);
    case 4:
      return i360::launch_shared_bias_mma_g<32, 4>(q, k, v, bp, out, nullptr, B, Sq, Sk, H, D,
                                                   scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int exp_flash_lse_split(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int B, int Sq, int Sk, int H, int D, float scale,
                                   int split, void* stream) {
  using namespace i360;
  if (D <= 32 || D > 64) return (int)cudaErrorInvalidValue;
  constexpr int DP = 64, BQ = 16 * K5A_MMA_NW;
  const int kt_rows = attn_mma_kt_rows(Sk);
  const unsigned blocks = (unsigned)((long)B * H * ((Sq + BQ - 1) / BQ));
  const size_t smem = attn_mma_smem_bytes<DP>(BQ, kt_rows);
  auto kern = split ? flash_lse_mma_kernel<DP, true> : flash_lse_mma_kernel<DP, false>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<blocks, K5A_MMA_NW * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, nullptr, (bf16*)out, (float*)lse, Sq, Sk,
      H, D, 0, 0, scale, (int)attn_mma_vec(D, q, k, v, out), 0, kt_rows);
  return (int)cudaGetLastError();
}

template <int DP, bool SPLIT>
int exp_dkv_launch(const void* q, const void* k, const void* v, const float* bias,
                   const void* g, const float* lse, const float* delta, void* dk, void* dv,
                   int B, int Sq, int Sk, int H, int D, float scale, cudaStream_t stream) {
  using namespace i360;
  const unsigned blocks = (unsigned)((long)B * H * ((Sk + kMmaBK - 1) / kMmaBK));
  const size_t smem = bwd_dkv_mma_smem_bytes<DP>(bias != nullptr);
  auto kern = flash_bwd_dkv_mma_kernel<DP, SPLIT>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<blocks, kBwdNW * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, bias, (const bf16*)g, lse, delta,
      (bf16*)dk, (bf16*)dv, Sq, Sk, H, D, 0, 0, scale,
      (int)(attn_mma_vec(D, q, k, v, g) && attn_mma_vec(D, dk, dv, dk, dv)),
      (int)attn_mma_bias_vec(Sk, bias));
  return (int)cudaGetLastError();
}

extern "C" int exp_flash_bwd_dkv_split(const void* q, const void* k, const void* v,
                                       const void* bias, const void* g, const void* lse,
                                       const void* delta, void* dk, void* dv, int B, int Sq,
                                       int Sk, int H, int D, float scale, int split,
                                       void* stream) {
  if (D <= 16 || D > 64) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto bp = (const float*)bias;
  auto lp = (const float*)lse;
  auto dp = (const float*)delta;
  if (D <= 32)
    return split ? exp_dkv_launch<32, true>(q, k, v, bp, g, lp, dp, dk, dv, B, Sq, Sk, H, D,
                                            scale, s)
                 : exp_dkv_launch<32, false>(q, k, v, bp, g, lp, dp, dk, dv, B, Sq, Sk, H, D,
                                             scale, s);
  return split ? exp_dkv_launch<64, true>(q, k, v, bp, g, lp, dp, dk, dv, B, Sq, Sk, H, D,
                                          scale, s)
               : exp_dkv_launch<64, false>(q, k, v, bp, g, lp, dp, dk, dv, B, Sq, Sk, H, D,
                                           scale, s);
}
