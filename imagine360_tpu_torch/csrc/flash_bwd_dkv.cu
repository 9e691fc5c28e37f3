// K5c: streaming attention backward, the key and value gradients.
//
// Replaces imagine360_tpu/ops/pallas_attention.py:_flash_bwd_dkv_kernel
// (second pallas_call of _flash_bhsd_bwd): dv = sum_q p^T dO and
// dk = (sum_q ds^T q) * scale with p = exp(s - lse), dp = dO v^T,
// ds = p * (dp - delta), at the same sites as K5b.
//
// What bounds it on the H100: four products per (query, key) pair,
// 8*Sq*Sk*D operations per (batch, head) against O((Sq+Sk)*D) bytes:
// compute bound, at 989 TFLOP/s bf16 on the tensor cores.
//
// Design: the TPU kernel accumulated dk and dv in VMEM scratch across a
// sequential query-block grid axis. Here a block owns a key tile (64 rows;
// 128 on the wgmma body) of one (batch, head) and walks the query tiles in
// a loop: no atomics, a fixed summation order.
// bf16 at D = 64 without a bias, 16-byte-aligned pointers, Sq a multiple of
// 4 (every launch of the training step's pano spatial self-attention;
// kernels.wgmma_route decides, the C entry refuses the rest): the Hopper
// body of attn_wgmma_bwd.cuh (flash_bwd_dkv_wgmma_kernel: a producer
// warpgroup feeding Q/dO tiles of 64 queries and their lse and delta rows by
// TMA through an mbarrier ring, two consumer warpgroups of 64 key rows on
// wgmma, the transposed tiles, Pᵀ·dO and dSᵀ·Q on the exact split).
// Other bf16 launches (the WarpAttn sites: D = 32 under a bias), D <= 160:
// the tensor-core tile of attn_mma_bwd.cuh
// (i360::flash_bwd_dkv_tile_mma: 4 warps of 16 key rows, the transposed
// tiles Sᵀ and dPᵀ on mma.sync, Pᵀ·dO and dSᵀ·Q on the exact bf16 split of
// the float32 P and dS; Q, dO, lse, delta and the bias tile by cp.async in
// two stages). The key tile is the fastest grid axis, so the blocks in
// flight share one (batch, head)'s Q and dO in L2.
// float32: the CUDA-core loop below, on float tiles in shared memory. A
// block keeps its k and v tiles in shared memory and its two [64, D]
// accumulators in registers (2 * 64 * D / 256 floats a thread: 32 at D =
// 64, 80 at the largest bucket, D = 160), and walks the query tiles in a
// loop, staging q, dO, lse and delta. Keeping the accumulators out of
// shared memory is what lets the D = 160 bucket fit: four [64][161] float
// tiles and two [64][65] score tiles are 199 KB of the 227 KB a block may
// have. The bias is walked by columns (a key tile against every query row);
// batch*head is the fastest grid axis, so with a broadcast bias the blocks
// in flight read the same 64-column strip from L2.
#include "attn_mma_bwd.cuh"
#include "attn_wgmma_bwd.cuh"
#include "flash_bwd.cuh"

namespace i360 {

template <int DP>
constexpr size_t bwd_dkv_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * BWD_BQ + 2 * BWD_BK) * (DP + 1)
                          + (size_t)2 * BWD_BQ * (BWD_BK + 1) + 2 * BWD_BQ);
}

template <int DP>
__global__ void __launch_bounds__(BWD_NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const float* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Sk, int H, int D, long bias_bs,
                     long bias_hs, float scale) {
  constexpr int LD = DP + 1;
  constexpr int PLD = BWD_BK + 1;
  constexpr int NR = (BWD_BK * DP + BWD_NT - 1) / BWD_NT;
  extern __shared__ float smem[];
  float* ks = smem;                       // [BK][LD]
  float* vs = ks + BWD_BK * LD;           // [BK][LD]
  float* qs = vs + BWD_BK * LD;           // [BQ][LD]
  float* dos = qs + BWD_BQ * LD;          // [BQ][LD]
  float* ps = dos + BWD_BQ * LD;          // [BQ][PLD]
  float* dss = ps + BWD_BQ * PLD;         // [BQ][PLD]
  float* lse_s = dss + BWD_BQ * PLD;      // [BQ]
  float* delta_s = lse_s + BWD_BQ;        // [BQ]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * BWD_BK;
  const int nk = min(BWD_BK, Sk - k0);
  const long ld = (long)H * D;
  const long qoff = (long)b * Sq * ld + (long)h * D;
  const long koff = ((long)b * Sk + k0) * ld + (long)h * D;
  const float* bp = bias == nullptr ? nullptr : bias + b * bias_bs + h * bias_hs + k0;
  const int tid = threadIdx.x;

  load_tile(ks, LD, k + koff, ld, BWD_BK, nk, D, DP);
  load_tile(vs, LD, v + koff, ld, BWD_BK, nk, D, DP);
  float dk_acc[NR], dv_acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) { dk_acc[r] = 0.f; dv_acc[r] = 0.f; }

  for (int q0 = 0; q0 < Sq; q0 += BWD_BQ) {
    const int nq = min(BWD_BQ, Sq - q0);
    __syncthreads();
    load_tile(qs, LD, q + qoff + (long)q0 * ld, ld, BWD_BQ, nq, D, DP);
    load_tile(dos, LD, g + qoff + (long)q0 * ld, ld, BWD_BQ, nq, D, DP);
    load_rowvec(lse_s, lse + (long)bh * Sq + q0, BWD_BQ, nq);
    load_rowvec(delta_s, delta + (long)bh * Sq + q0, BWD_BQ, nq);
    __syncthreads();
    bwd_tile_scores<DP, true>(qs, dos, ks, vs, lse_s, delta_s,
                              bp == nullptr ? nullptr : bp + (long)q0 * Sk, Sk, nq, nk, scale,
                              ps, dss);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int idx = tid + r * BWD_NT;
      if (idx < BWD_BK * DP) {
        const int j = idx / DP, d = idx - j * DP;
        float a = dk_acc[r], c = dv_acc[r];
        for (int i = 0; i < BWD_BQ; ++i) {
          a += dss[i * PLD + j] * qs[i * LD + d];
          c += ps[i * PLD + j] * dos[i * LD + d];
        }
        dk_acc[r] = a;
        dv_acc[r] = c;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int idx = tid + r * BWD_NT;
    if (idx < BWD_BK * DP) {
      const int j = idx / DP, d = idx - j * DP;
      if (j < nk && d < D) {
        dk[koff + (long)j * ld + d] = dk_acc[r] * scale;
        dv[koff + (long)j * ld + d] = dv_acc[r];
      }
    }
  }
}

// bf16 on the tensor cores; block index = (batch x head) x key tiles + key
// tile. The library builds SPLIT true only; false (P and dS rounded once to
// bf16) is built by scripts/torch_attn_mma_variants.py, which measures what
// the split costs and what it changes in dk and dv. At least one block an
// SM: ptxas may not trade registers for occupancy and spill.
template <int DP, bool SPLIT = true>
__global__ void __launch_bounds__(kBwdNW * 32, 1)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ bias,
                         const bf16* __restrict__ g, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int Sq, int Sk, int H, int D, long bias_bs,
                         long bias_hs, float scale, int vec, int bias_vec) {
  extern __shared__ __align__(16) unsigned char k5c_smem[];
  const int nkt = (Sk + kMmaBK - 1) / kMmaBK;
  const int bh = blockIdx.x / nkt, k0 = (blockIdx.x - bh * nkt) * kMmaBK;
  const int b = bh / H, h = bh - b * H;
  const long ld = (long)H * D;
  const long qoff = (long)b * Sq * ld + (long)h * D;
  const long koff = ((long)b * Sk + k0) * ld + (long)h * D;
  const float* bp = bias == nullptr ? nullptr : bias + b * bias_bs + h * bias_hs + k0;
  flash_bwd_dkv_tile_mma<DP, SPLIT>(q + qoff, k + koff, v + koff, g + qoff,
                                    lse + (long)bh * Sq, delta + (long)bh * Sq, bp,
                                    bias_vec != 0, dk + koff, dv + koff, ld, Sq, Sk,
                                    min(kMmaBK, Sk - k0), D, scale, vec != 0, k5c_smem);
}

template <bool SPLIT = true>
int launch_flash_bwd_dkv_mma(const void* q, const void* k, const void* v, const float* bias,
                             const void* g, const float* lse, const float* delta, void* dk,
                             void* dv, int B, int Sq, int Sk, int H, int D, long bias_bs,
                             long bias_hs, float scale, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((long)B * H * ((Sk + kMmaBK - 1) / kMmaBK));
  const int vec = attn_mma_vec(D, q, k, v, g) && attn_mma_vec(D, dk, dv, dk, dv);
  const int bias_vec = attn_mma_bias_vec(Sk, bias);
  I360_DP_SWITCH(D, {
    const size_t smem = bwd_dkv_mma_smem_bytes<DP>(bias != nullptr);
    auto kern = flash_bwd_dkv_mma_kernel<DP, SPLIT>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<blocks, kBwdNW * 32, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, bias, (const bf16*)g, lse, delta,
        (bf16*)dk, (bf16*)dv, Sq, Sk, H, D, bias_bs, bias_hs, scale, vec, bias_vec);
  });
  return (int)cudaGetLastError();
}

// bf16 at D = 64 without a bias on wgmma (attn_wgmma_bwd.cuh); block index
// = (batch x head) x key tiles + key tile
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mg,
                           const __grid_constant__ CUtensorMap ml,
                           const __grid_constant__ CUtensorMap md,
                           const __grid_constant__ CUtensorMap mdk,
                           const __grid_constant__ CUtensorMap mdv, int Sq, int Sk, int H,
                           int nkt, float sl2, float scale) {
  extern __shared__ __align__(1024) unsigned char k5c_wg_smem[];
  attn_wgmma_bwd_dkv_tile(&mq, &mk, &mv, &mg, &ml, &md, &mdk, &mdv, Sq, Sk, H, nkt, sl2, scale,
                          k5c_wg_smem);
}

int launch_flash_bwd_dkv(const void* q, const void* k, const void* v, const float* bias,
                         const void* g, const float* lse, const float* delta, void* dk,
                         void* dv, int B, int Sq, int Sk, int H, int D, long bias_bs,
                         long bias_hs, float scale, cudaStream_t stream) {
  const dim3 grid(B * H, (Sk + BWD_BK - 1) / BWD_BK);
  I360_DP_SWITCH(D, {
    const size_t smem = bwd_dkv_smem_bytes<DP>();
    auto kern = flash_bwd_dkv_kernel<DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, BWD_NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                         bias, (const float*)g, lse, delta, (float*)dk,
                                         (float*)dv, Sq, Sk, H, D, bias_bs, bias_hs, scale);
  });
  return (int)cudaGetLastError();
}

}  // namespace i360

// q/g [B, Sq, H, D], k/v/dk/dv [B, Sk, H, D], lse/delta [B, H, Sq] float,
// all contiguous; bias null or float with rows of Sk contiguous elements,
// batch stride bias_bs and head stride bias_hs in elements (0 for a
// broadcast axis). dtype 0 = float32 (the CUDA-core kernel), 1 = bfloat16
// (the tensor cores). Returns the cudaError_t of the launch.
extern "C" int i360_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* bias, const void* g, const void* lse,
                                  const void* delta, void* dk, void* dv, int B, int Sq, int Sk,
                                  int H, int D, long bias_bs, long bias_hs, float scale,
                                  int dtype, void* stream) {
  if (D > 160 || D < 1 || lse == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto bp = (const float*)bias;
  auto lp = (const float*)lse;
  auto dp = (const float*)delta;
  if (dtype == 1)
    return i360::launch_flash_bwd_dkv_mma(q, k, v, bp, g, lp, dp, dk, dv, B, Sq, Sk, H, D,
                                          bias_bs, bias_hs, scale, s);
  return i360::launch_flash_bwd_dkv(q, k, v, bp, g, lp, dp, dk, dv, B, Sq, Sk, H, D, bias_bs,
                                    bias_hs, scale, s);
}

// bf16, D = 64, no bias, every pointer 16-byte aligned (lse and delta too:
// TMA reads them), Sq a multiple of 4 (kernels.wgmma_route): the wgmma body.
// Returns the cudaError_t of the launch; anything else it refuses with
// cudaErrorInvalidValue and launches nothing.
extern "C" int i360_flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                                        const void* g, const void* lse, const void* delta,
                                        void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
                                        float scale, void* stream) {
  if (D != i360::kWgD) return (int)cudaErrorInvalidValue;
  return i360::launch_bwd_dkv_wgmma(i360::flash_bwd_dkv_wgmma_kernel, q, k, v, g,
                                    (const float*)lse, (const float*)delta, dk, dv, B, Sq, Sk,
                                    H, scale, (cudaStream_t)stream);
}
