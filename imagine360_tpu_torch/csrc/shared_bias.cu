// K3: streaming attention with one [Sq, Sk] bias shared by every batch row
// and head (the WarpAttn correspondence masks, the CLIP causal mask).
//
// Replaces imagine360_tpu/ops/pallas_attention.py:_shared_bias_kernel_t
// (wrapper _flash_shared_bias_t), its optional log-sum-exp output included:
// with a non-null `lse` [B, H, Sq] float the kernel also writes m + log(l)
// per query row, the residual of the streaming backward (K5b, K5c). The
// output does not depend on whether the lse is written.
//
// What bounds it on the H100: the r2 site (2048 <-> 5120 tokens, 10 heads,
// D = 32, 32 batch rows) does 4*Sq*Sk*D operations per (batch, head), 0.43
// ms of the bf16 tensor cores, and reads the Sq*Sk float bias, 42 MB. Read
// once per (batch, head) that bias would move 320 x 42 MB = 13.4 GB: at
// D = 32 a 4-byte bias element carries 128 operations, 32 a byte, far below
// the card's ~295 bf16 operations a byte of HBM (and not much above what
// its L2 gives). So once the products run on the tensor cores, the bias is
// the limit.
//
// Design: the TPU kernel folded t_rows = 32 (batch*head) rows into one grid
// step so that each bias block was streamed once per row group, and used a
// [D, S] transposed layout so that D = 32 wasted no lanes. Here q/k/v stay
// [B, S, H, D].
// bf16 at D = 32 with a bias TMA can take (float32 rows of Sk a multiple of
// 4) and 16-byte-aligned pointers (every WarpAttn launch, its per-shard row
// blocks of the bias included; kernels.shared_bias_wgmma_route decides, the
// C entry refuses the rest): the Hopper body of attn_wgmma_bias.cuh in its
// natural layout (shared_bias_wgmma_kernel), K6b's body with the rows
// addressed through 4-D tensor maps {32, H, S, B}: a producer warpgroup
// loads each [128, 64] bias tile once by TMA and, under it, the K and V
// tiles of kFbT = 4 (batch, head) rows; two consumer warpgroups of 64 query
// rows take those rows in turn on wgmma, a row's softmax under the previous
// row's P·V, the logit and the bias in one FFMA; P·V on P rounded once to
// bf16, as the kernel replaced rounds it to the inputs' dtype (no split,
// one product a k-step: K6b's SPLIT_P off); the lse by scalar stores.
// Other bf16 launches, D <= 160 (the CLIP causal mask at D = 64): a block
// owns one 64-row query tile for G (batch, head) problems: G groups of 4
// warps, each group with its own Q, K and V tiles and the tensor-core body
// of attn_mma.cuh (i360::flash_tile_mma), all of them under one staged
// [64, 64] float bias tile of each key tile, so the bias is read once per G
// problems. G is 2 up to D = 64 and 1 above (k3_groups); a ragged last
// group computes a real problem again and stores nothing. The groups of
// (batch, head) are the fastest grid axis, so the blocks in flight read the
// same bias rows and the bias comes from L2 (50 MB) rather than device
// memory. (Walking the groups in windows of 4 to 32, so that a window's K
// and V stay in L2 while its query tiles pass, gained nothing at the
// WarpAttn sites on this body.)
// float32: i360::flash_tile on the CUDA cores, grid (batch x head, query
// tile), batch*head again the fastest axis.
#include "attn_mma.cuh"
#include "attn_wgmma_bias.cuh"

namespace i360 {

constexpr int K3_BQ = 64;
constexpr int K3_BK = 64;
constexpr int K3_NT = 256;
constexpr int K3_MMA_NW = 4;   // warps of a group: 64 query rows

template <int DP>
__global__ void __launch_bounds__(K3_NT)
shared_bias_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias,
                   float* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H,
                   int D, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * K3_BQ;
  const long ld = (long)H * D;
  const long qoff = ((long)b * Sq + q0) * ld + (long)h * D;
  const long koff = (long)b * Sk * ld + (long)h * D;
  flash_tile<float, DP, K3_BQ, K3_BK, K3_NT>(
      q + qoff, k + koff, v + koff, out + qoff, bias + (long)q0 * Sk,
      lse == nullptr ? nullptr : lse + (long)bh * Sq + q0, ld, min(K3_BQ, Sq - q0), Sk, D,
      scale, smem);
}

// bf16 on the tensor cores: block (x, y) owns query tile y of the problems
// x*G .. x*G + G - 1; group gi of its warps takes problem x*G + gi. (The
// minimum of 1 block an SM in the launch bounds keeps ptxas from trading
// registers for occupancy: without it the DP = 128 instantiation spilled.)
template <int DP, int G>
__global__ void __launch_bounds__(G * K3_MMA_NW * 32, 1)
shared_bias_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ bias,
                       bf16* __restrict__ out, float* __restrict__ lse, int BH, int Sq, int Sk,
                       int H, int D, float scale, int vec, int bias_vec, int kt_rows) {
  extern __shared__ __align__(16) unsigned char k3_smem[];
  constexpr int BQ = 16 * K3_MMA_NW;
  const int gi = threadIdx.x / (K3_MMA_NW * 32);
  int bh = blockIdx.x * G + gi;
  const bool active = bh < BH;
  if (!active) bh = BH - 1;    // the ragged last group: same work, no stores
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const long ld = (long)H * D;
  const long qoff = ((long)b * Sq + q0) * ld + (long)h * D;
  const long koff = (long)b * Sk * ld + (long)h * D;
  // [bias stages][group 0 tiles][group 1 tiles]...
  bf16* tiles = (bf16*)(k3_smem + attn_mma_bias_bytes(BQ)) +
                (size_t)gi * (BQ + 4 * kt_rows) * (DP + 8);
  flash_tile_mma<DP, K3_MMA_NW>(
      q + qoff, k + koff, v + koff, active ? out + qoff : nullptr,
      lse == nullptr ? nullptr : lse + (long)bh * Sq + q0, bias + (long)q0 * Sk, bias_vec != 0,
      ld, min(BQ, Sq - q0), Sk, D, scale, vec != 0, kt_rows, tiles, (float*)k3_smem);
}

// G (batch, head) problems a block: 2 up to DP = 64, 1 above, where one
// group's tiles take 67-108 KB of shared memory (two at DP = 160 would not
// fit a block's 227 KB). At the WarpAttn sites (DP = 32) on an H100, G = 2
// is faster than G = 1 and G = 4 (scripts/torch_attn_mma_variants.py).
constexpr int k3_groups(int DP) { return DP <= 64 ? 2 : 1; }

template <int DP, int G>
int launch_shared_bias_mma_g(const void* q, const void* k, const void* v, const float* bias,
                             void* out, float* lse, int B, int Sq, int Sk, int H, int D,
                             float scale, cudaStream_t stream) {
  constexpr int BQ = 16 * K3_MMA_NW;
  const int BH = B * H, kt_rows = attn_mma_kt_rows(Sk);
  const size_t smem = attn_mma_bias_bytes(BQ) + G * attn_mma_smem_bytes<DP>(BQ, kt_rows);
  auto kern = shared_bias_mma_kernel<DP, G>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((BH + G - 1) / G, (Sq + BQ - 1) / BQ);
  kern<<<grid, G * K3_MMA_NW * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, bias, (bf16*)out, lse, BH, Sq, Sk, H, D,
      scale, (int)attn_mma_vec(D, q, k, v, out), (int)attn_mma_bias_vec(Sk, bias), kt_rows);
  return (int)cudaGetLastError();
}

int launch_shared_bias_mma(const void* q, const void* k, const void* v, const float* bias,
                           void* out, float* lse, int B, int Sq, int Sk, int H, int D,
                           float scale, cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  I360_DP_SWITCH(D, {
    err = launch_shared_bias_mma_g<DP, k3_groups(DP)>(q, k, v, bias, out, lse, B, Sq, Sk, H,
                                                      D, scale, stream);
  });
  return err;
}

// bf16 at D = 32 on wgmma (attn_wgmma_bias.cuh), the natural layout under
// one float32 bias, P rounded once; block index = query tile x row groups
// + row group
__global__ void __launch_bounds__(kWgThreads, 1)
shared_bias_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mo,
                         const __grid_constant__ CUtensorMap mb, float* __restrict__ lse, int BH,
                         int Sq, int Sk, int nrg, float scale, int H) {
  extern __shared__ __align__(1024) unsigned char k3_wg_smem[];
  attn_wgmma_bias_tile<float, kFbNatural, false>(&mq, &mk, &mv, &mo, &mb, lse, BH, Sq, Sk, nrg,
                                                 scale, k3_wg_smem, H);
}

int launch_shared_bias(const void* q, const void* k, const void* v, const float* bias,
                       void* out, float* lse, int B, int Sq, int Sk, int H, int D, float scale,
                       cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + K3_BQ - 1) / K3_BQ);
  I360_DP_SWITCH(D, {
    const size_t smem = flash_smem_bytes<K3_BQ, K3_BK, DP>();
    auto kern = shared_bias_kernel<DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, K3_NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v, bias,
                                        (float*)out, lse, Sq, Sk, H, D, scale);
  });
  return (int)cudaGetLastError();
}

}  // namespace i360

// q [B, Sq, H, D], k/v [B, Sk, H, D], out [B, Sq, H, D], bias [Sq, Sk]
// float, lse null or [B, H, Sq] float, all contiguous. dtype 0 = float32
// (the CUDA-core kernel), 1 = bfloat16 (the tensor cores). Returns the
// cudaError_t of the launch.
extern "C" int i360_shared_bias_attention(const void* q, const void* k, const void* v,
                                          const void* bias, void* out, void* lse, int B,
                                          int Sq, int Sk, int H, int D, float scale,
                                          int dtype, void* stream) {
  if (D > 160 || D < 1 || bias == nullptr) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto bp = (const float*)bias;
  auto lp = (float*)lse;
  if (dtype == 1)
    return i360::launch_shared_bias_mma(q, k, v, bp, out, lp, B, Sq, Sk, H, D, scale, s);
  return i360::launch_shared_bias(q, k, v, bp, out, lp, B, Sq, Sk, H, D, scale, s);
}

// bf16 q [B, Sq, H, 32], k/v [B, Sk, H, 32], out [B, Sq, H, 32], a float32
// bias [Sq, Sk] (rows Sk apart, a row block of a larger matrix allowed),
// lse null or float [B, H, Sq]; q, k, v, out and the bias 16-byte aligned
// and the bias row of Sk elements a multiple of 16 bytes
// (kernels.shared_bias_wgmma_route; the lse leaves by scalar stores): the
// wgmma body, kFbT (batch, head) rows a block. Returns the cudaError_t of
// the launch; anything else it refuses with cudaErrorInvalidValue and
// launches nothing.
extern "C" int i360_shared_bias_attention_wgmma(const void* q, const void* k, const void* v,
                                                const void* bias, void* out, void* lse, int B,
                                                int Sq, int Sk, int H, int D, float scale,
                                                void* stream) {
  if (D != i360::kFbD || bias == nullptr || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  return i360::launch_attn_wgmma_bias<float, i360::kFbNatural>(
      i360::shared_bias_wgmma_kernel, q, k, v, bias, out, (float*)lse, B * H, Sq, Sk, scale,
      (cudaStream_t)stream, H);
}
