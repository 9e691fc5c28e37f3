// K2: streaming multi-head attention for long key sequences, no bias.
//
// Replaces imagine360_tpu/ops/pallas_attention.py:_mh_flash_kernel
// (wrapper mh_flash_attention): online-softmax attention in the natural
// [B, S, H*D] layout, keys at or beyond Sk masked, a zero denominator
// replaced by 1.
//
// What bounds it on the H100: the pano spatial self-attention (Sq = Sk =
// 8192 with 5 heads, 2048 with 10, D = 64) does O(Sq*Sk*D) multiply-adds
// per problem against O((Sq+Sk)*D) bytes, so it is bound by operations: 989
// TFLOP/s bf16 on the tensor cores.
//
// Design: on the TPU the key axis was a sequential grid axis that carried
// the running max/sum in VMEM scratch between grid steps. Blocks on Hopper
// run in no order, so one block owns a 64-row query tile of one (batch,
// head) and walks all key tiles in a loop, keeping the running max, sum and
// the [64, D] accumulator on chip. Logits never reach device memory.
//
// bf16 at D = 64 (the main path: every K2 site of the models): the Hopper
// body of attn_wgmma.cuh (mh_flash_wgmma_kernel: a producer warpgroup
// feeding K/V tiles of 128 keys by TMA through an mbarrier ring, two
// consumer warpgroups of 64 query rows on wgmma), for 16-byte-aligned
// pointers (kernels.wgmma_route decides, the C entry refuses the rest).
// Other bf16 head dims up to 160 and unaligned pointers: the tensor-core
// body of attn_mma.cuh (i360::flash_tile_mma: 4 warps of 16 query rows,
// mma.sync on bf16 fragments, K/V tiles by cp.async in two stages). In
// both the query tile is the fastest grid axis, so the blocks that run
// together share one (batch, head)'s K and V in L2 (2 MB at the 8192-token
// site).
// float32: i360::flash_tile on the CUDA cores (float tiles in shared memory),
// grid (batch x head, query tile).
#include "attn_mma.cuh"
#include "attn_wgmma.cuh"

namespace i360 {

constexpr int K2_BQ = 64;
constexpr int K2_BK = 64;
constexpr int K2_NT = 256;
constexpr int K2_MMA_NW = 4;   // warps of the bf16 block: 64 query rows

template <int DP>
__global__ void __launch_bounds__(K2_NT)
mh_flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, int Sq, int Sk, int H,
                int D, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * K2_BQ;
  const long ld = (long)H * D;
  const long qoff = ((long)b * Sq + q0) * ld + (long)h * D;
  const long koff = (long)b * Sk * ld + (long)h * D;
  flash_tile<float, DP, K2_BQ, K2_BK, K2_NT>(q + qoff, k + koff, v + koff, out + qoff,
                                             nullptr, nullptr, ld, min(K2_BQ, Sq - q0), Sk, D,
                                             scale, smem);
}

// bf16 on the tensor cores; block index = (batch x head) x query tiles +
// query tile
template <int DP>
__global__ void __launch_bounds__(K2_MMA_NW * 32)
mh_flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out, int Sq, int Sk, int H,
                    int D, float scale, int vec, int kt_rows) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  constexpr int BQ = 16 * K2_MMA_NW;
  const int nqt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * BQ;
  const int b = bh / H, h = bh - b * H;
  const long ld = (long)H * D;
  const long qoff = ((long)b * Sq + q0) * ld + (long)h * D;
  const long koff = (long)b * Sk * ld + (long)h * D;
  flash_tile_mma<DP, K2_MMA_NW>(q + qoff, k + koff, v + koff, out + qoff, nullptr, nullptr,
                                false, ld, min(BQ, Sq - q0), Sk, D, scale, vec != 0, kt_rows,
                                (bf16*)k2_smem, nullptr);
}

int launch_mh_flash_mma(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                        int Sk, int H, int D, float scale, cudaStream_t stream) {
  constexpr int BQ = 16 * K2_MMA_NW;
  const int kt_rows = attn_mma_kt_rows(Sk);
  const unsigned blocks = (unsigned)((long)B * H * ((Sq + BQ - 1) / BQ));
  const int vec = attn_mma_vec(D, q, k, v, out);
  I360_DP_SWITCH(D, {
    const size_t smem = attn_mma_smem_bytes<DP>(BQ, kt_rows);
    auto kern = mh_flash_mma_kernel<DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<blocks, K2_MMA_NW * 32, smem, stream>>>((const bf16*)q, (const bf16*)k,
                                                   (const bf16*)v, (bf16*)out, Sq, Sk, H, D,
                                                   scale, vec, kt_rows);
  });
  return (int)cudaGetLastError();
}

// bf16 at D = 64 on wgmma (attn_wgmma.cuh); block index = (batch x head) x
// query tiles + query tile
__global__ void __launch_bounds__(kWgThreads, 1)
mh_flash_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mo, int Sq, int Sk, int H, int nqt,
                      float sl2) {
  extern __shared__ __align__(1024) unsigned char k2_wg_smem[];
  attn_wgmma_tile(&mq, &mk, &mv, &mo, nullptr, Sq, Sk, H, nqt, sl2, k2_wg_smem);
}

int launch_mh_flash(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                    int Sk, int H, int D, float scale, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + K2_BQ - 1) / K2_BQ);
  I360_DP_SWITCH(D, {
    const size_t smem = flash_smem_bytes<K2_BQ, K2_BK, DP>();
    auto kern = mh_flash_kernel<DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, K2_NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                        (float*)out, Sq, Sk, H, D, scale);
  });
  return (int)cudaGetLastError();
}

}  // namespace i360

// q [B, Sq, H*D], k/v [B, Sk, H*D], out [B, Sq, H*D], contiguous.
// dtype 0 = float32 (the CUDA-core body), 1 = bfloat16 (the tensor cores).
// Returns the cudaError_t of the launch.
extern "C" int i360_mh_flash_attention(const void* q, const void* k, const void* v, void* out,
                                       int B, int Sq, int Sk, int H, int D, float scale,
                                       int dtype, void* stream) {
  if (D > 160 || D < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (dtype == 1) return i360::launch_mh_flash_mma(q, k, v, out, B, Sq, Sk, H, D, scale, s);
  return i360::launch_mh_flash(q, k, v, out, B, Sq, Sk, H, D, scale, s);
}

// bf16, D = 64, no bias, q/k/v/out 16-byte aligned (kernels.wgmma_route):
// the wgmma body. Returns the cudaError_t of the launch; anything else it
// refuses with cudaErrorInvalidValue and launches nothing.
extern "C" int i360_mh_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                             void* out, int B, int Sq, int Sk, int H, int D,
                                             float scale, void* stream) {
  if (D != i360::kWgD) return (int)cudaErrorInvalidValue;
  return i360::launch_attn_wgmma(i360::mh_flash_wgmma_kernel, q, k, v, out, B, Sq, Sk, H, scale,
                                 (cudaStream_t)stream);
}
