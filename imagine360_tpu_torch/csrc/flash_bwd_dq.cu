// K5b: streaming attention backward, the query gradient.
//
// Replaces imagine360_tpu/ops/pallas_attention.py:_flash_bwd_dq_kernel
// (first pallas_call of _flash_bhsd_bwd): dq = (sum_k ds k) * scale with
// p = exp(s - lse), dp = dO v^T, ds = p * (dp - delta), for the trained
// long-sequence sites: pano spatial self-attention (no bias, lse from K5a)
// and the WarpAttn sites (one shared [Sq, Sk] bias, lse from K3).
//
// What bounds it on the H100: three products per (query, key) pair,
// 6*Sq*Sk*D operations per (batch, head) against O((Sq+Sk)*D) bytes:
// compute bound, at 989 TFLOP/s bf16 on the tensor cores.
//
// Design: the TPU kernel accumulated dq in VMEM scratch across a sequential
// key-block grid axis. Here a block owns a query tile (64 rows; 128 on
// the wgmma body) of one (batch, head) and walks the key tiles in a loop:
// no atomics, a fixed summation order. q/k/v/dO stay [B, S, H, D]; ragged
// Sq and Sk are masked inside.
// bf16 at D = 64 without a bias, 16-byte-aligned pointers (every launch of
// the training step's pano spatial self-attention; kernels.wgmma_route
// decides, the C entry refuses the rest): the Hopper body of
// attn_wgmma_bwd.cuh (flash_bwd_dq_wgmma_kernel: a producer warpgroup feeding
// K/V tiles of 64 keys by TMA through an mbarrier ring, two consumer
// warpgroups of 64 query rows on wgmma, dS·K on the exact split of dS left
// in flight under the next tile's S and dP).
// Other bf16 launches (the WarpAttn sites: D = 32 under a bias), D <= 160:
// the tensor-core tile of attn_mma_bwd.cuh
// (i360::flash_bwd_dq_tile_mma: 4 warps of 16 query rows, S and dP on
// mma.sync as in the forward, dS·K on the exact bf16 split of the float32
// dS; K, V and the bias tile by cp.async in two stages). The (batch, head)
// is the fastest grid axis: with the shared bias of the WarpAttn sites the
// blocks in flight read the bias rows of one or two query tiles, from L2.
// The other order (the query tile fastest) shares one (batch, head)'s K and
// V instead; on the H100 the two orders took the same time to within 2% at
// every training site, the sign changing from one run to the next
// (scripts/torch_attn_mma_variants.py times both): the kernel is bound by
// its arithmetic, not by these reads.
// float32: the CUDA-core loop below, on float tiles in shared memory
// (flash_bwd.cuh:bwd_tile_scores): the block keeps its q and dO tiles, lse
// and delta rows in shared memory and its [64, D] dq accumulator in
// registers. batch*head is its fastest grid axis, so with a broadcast bias
// the blocks in flight read the same bias rows from L2.
#include "attn_mma_bwd.cuh"
#include "attn_wgmma_bwd.cuh"
#include "flash_bwd.cuh"

namespace i360 {

template <int DP>
constexpr size_t bwd_dq_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * BWD_BQ + 2 * BWD_BK) * (DP + 1)
                          + (size_t)BWD_BQ * (BWD_BK + 1) + 2 * BWD_BQ);
}

template <int DP>
__global__ void __launch_bounds__(BWD_NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ bias,
                    const float* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int Sq, int Sk,
                    int H, int D, long bias_bs, long bias_hs, float scale) {
  constexpr int LD = DP + 1;
  constexpr int PLD = BWD_BK + 1;
  constexpr int NR = (BWD_BQ * DP + BWD_NT - 1) / BWD_NT;
  extern __shared__ float smem[];
  float* qs = smem;                       // [BQ][LD]
  float* dos = qs + BWD_BQ * LD;          // [BQ][LD]
  float* ks = dos + BWD_BQ * LD;          // [BK][LD]
  float* vs = ks + BWD_BK * LD;           // [BK][LD]
  float* dss = vs + BWD_BK * LD;          // [BQ][PLD]
  float* lse_s = dss + BWD_BQ * PLD;      // [BQ]
  float* delta_s = lse_s + BWD_BQ;        // [BQ]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * BWD_BQ;
  const int nq = min(BWD_BQ, Sq - q0);
  const long ld = (long)H * D;
  const long qoff = ((long)b * Sq + q0) * ld + (long)h * D;
  const long koff = (long)b * Sk * ld + (long)h * D;
  const float* bp =
      bias == nullptr ? nullptr : bias + b * bias_bs + h * bias_hs + (long)q0 * Sk;
  const int tid = threadIdx.x;

  load_tile(qs, LD, q + qoff, ld, BWD_BQ, nq, D, DP);
  load_tile(dos, LD, g + qoff, ld, BWD_BQ, nq, D, DP);
  load_rowvec(lse_s, lse + (long)bh * Sq + q0, BWD_BQ, nq);
  load_rowvec(delta_s, delta + (long)bh * Sq + q0, BWD_BQ, nq);
  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += BWD_BK) {
    const int nk = min(BWD_BK, Sk - k0);
    __syncthreads();
    load_tile(ks, LD, k + koff + (long)k0 * ld, ld, BWD_BK, nk, D, DP);
    load_tile(vs, LD, v + koff + (long)k0 * ld, ld, BWD_BK, nk, D, DP);
    __syncthreads();
    bwd_tile_scores<DP, false>(qs, dos, ks, vs, lse_s, delta_s,
                               bp == nullptr ? nullptr : bp + k0, Sk, nq, nk, scale, nullptr,
                               dss);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int idx = tid + r * BWD_NT;
      if (idx < BWD_BQ * DP) {
        const int i = idx / DP, d = idx - i * DP;
        float a = acc[r];
        for (int j = 0; j < BWD_BK; ++j) a += dss[i * PLD + j] * ks[j * LD + d];
        acc[r] = a;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int idx = tid + r * BWD_NT;
    if (idx < BWD_BQ * DP) {
      const int i = idx / DP, d = idx - i * DP;
      if (i < nq && d < D) dq[qoff + (long)i * ld + d] = acc[r] * scale;
    }
  }
}

// bf16 on the tensor cores; block index = query tile x (batch x head) +
// (batch x head), or with `bh_fast` 0 (batch x head) x query tiles + query
// tile. The library builds SPLIT true and launches bh_fast 1; SPLIT false
// (dS rounded once to bf16) and bh_fast 0 are built and launched by
// scripts/torch_attn_mma_variants.py, which times them. At least one block
// an SM: ptxas may not trade registers for occupancy and spill.
template <int DP, bool SPLIT = true>
__global__ void __launch_bounds__(kBwdNW * 32, 1)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        const bf16* __restrict__ g, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk,
                        int H, int D, long bias_bs, long bias_hs, float scale, int vec,
                        int bias_vec, int bh_fast) {
  extern __shared__ __align__(16) unsigned char k5b_smem[];
  const int nqt = (Sq + kBwdBQ - 1) / kBwdBQ;
  int bh, qt;
  if (bh_fast) {
    const int BH = (int)(gridDim.x / nqt);
    qt = blockIdx.x / BH;
    bh = blockIdx.x - qt * BH;
  } else {
    bh = blockIdx.x / nqt;
    qt = blockIdx.x - bh * nqt;
  }
  const int q0 = qt * kBwdBQ;
  const int b = bh / H, h = bh - b * H;
  const long ld = (long)H * D;
  const long qoff = ((long)b * Sq + q0) * ld + (long)h * D;
  const long koff = (long)b * Sk * ld + (long)h * D;
  const float* bp =
      bias == nullptr ? nullptr : bias + b * bias_bs + h * bias_hs + (long)q0 * Sk;
  flash_bwd_dq_tile_mma<DP, SPLIT>(q + qoff, k + koff, v + koff, g + qoff,
                                   lse + (long)bh * Sq + q0, delta + (long)bh * Sq + q0, bp,
                                   bias_vec != 0, dq + qoff, ld, min(kBwdBQ, Sq - q0), Sk, D,
                                   scale, vec != 0, k5b_smem);
}

template <bool SPLIT = true>
int launch_flash_bwd_dq_mma(const void* q, const void* k, const void* v, const float* bias,
                            const void* g, const float* lse, const float* delta, void* dq,
                            int B, int Sq, int Sk, int H, int D, long bias_bs, long bias_hs,
                            float scale, int bh_fast, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((long)B * H * ((Sq + kBwdBQ - 1) / kBwdBQ));
  const int vec = attn_mma_vec(D, q, k, v, g) && attn_mma_vec(D, dq, dq, dq, dq);
  const int bias_vec = attn_mma_bias_vec(Sk, bias);
  I360_DP_SWITCH(D, {
    const size_t smem = bwd_dq_mma_smem_bytes<DP>(bias != nullptr);
    auto kern = flash_bwd_dq_mma_kernel<DP, SPLIT>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<blocks, kBwdNW * 32, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, bias, (const bf16*)g, lse, delta,
        (bf16*)dq, Sq, Sk, H, D, bias_bs, bias_hs, scale, vec, bias_vec, bh_fast);
  });
  return (int)cudaGetLastError();
}

// bf16 at D = 64 without a bias on wgmma (attn_wgmma_bwd.cuh); block index
// = (batch x head) x query tiles + query tile
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mg,
                          const __grid_constant__ CUtensorMap mdq, const float* __restrict__ lse,
                          const float* __restrict__ delta, int Sq, int Sk, int H, int nqt,
                          float sl2, float scale) {
  extern __shared__ __align__(1024) unsigned char k5b_wg_smem[];
  attn_wgmma_bwd_dq_tile(&mq, &mk, &mv, &mg, &mdq, lse, delta, Sq, Sk, H, nqt, sl2, scale,
                         k5b_wg_smem);
}

int launch_flash_bwd_dq(const void* q, const void* k, const void* v, const float* bias,
                        const void* g, const float* lse, const float* delta, void* dq, int B,
                        int Sq, int Sk, int H, int D, long bias_bs, long bias_hs, float scale,
                        cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + BWD_BQ - 1) / BWD_BQ);
  I360_DP_SWITCH(D, {
    const size_t smem = bwd_dq_smem_bytes<DP>();
    auto kern = flash_bwd_dq_kernel<DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, BWD_NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                         bias, (const float*)g, lse, delta, (float*)dq, Sq, Sk,
                                         H, D, bias_bs, bias_hs, scale);
  });
  return (int)cudaGetLastError();
}

}  // namespace i360

// q/g/dq [B, Sq, H, D], k/v [B, Sk, H, D], lse/delta [B, H, Sq] float, all
// contiguous; bias null or float with rows of Sk contiguous elements, batch
// stride bias_bs and head stride bias_hs in elements (0 for a broadcast
// axis). dtype 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the
// tensor cores). Returns the cudaError_t of the launch.
extern "C" int i360_flash_bwd_dq(const void* q, const void* k, const void* v, const void* bias,
                                 const void* g, const void* lse, const void* delta, void* dq,
                                 int B, int Sq, int Sk, int H, int D, long bias_bs,
                                 long bias_hs, float scale, int dtype, void* stream) {
  if (D > 160 || D < 1 || lse == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto bp = (const float*)bias;
  auto lp = (const float*)lse;
  auto dp = (const float*)delta;
  if (dtype == 1)
    return i360::launch_flash_bwd_dq_mma(q, k, v, bp, g, lp, dp, dq, B, Sq, Sk, H, D, bias_bs,
                                         bias_hs, scale, 1, s);
  return i360::launch_flash_bwd_dq(q, k, v, bp, g, lp, dp, dq, B, Sq, Sk, H, D, bias_bs,
                                   bias_hs, scale, s);
}

// bf16, D = 64, no bias, q/k/v/g/dq 16-byte aligned (kernels.wgmma_route; lse
// and delta are read by scalar loads): the wgmma body. Returns the
// cudaError_t of the launch; anything else it refuses with
// cudaErrorInvalidValue and launches nothing.
extern "C" int i360_flash_bwd_dq_wgmma(const void* q, const void* k, const void* v, const void* g,
                                       const void* lse, const void* delta, void* dq, int B,
                                       int Sq, int Sk, int H, int D, float scale, void* stream) {
  if (D != i360::kWgD) return (int)cudaErrorInvalidValue;
  return i360::launch_bwd_dq_wgmma(i360::flash_bwd_dq_wgmma_kernel, q, k, v, g,
                                   (const float*)lse, (const float*)delta, dq, B, Sq, Sk, H,
                                   scale, (cudaStream_t)stream);
}
