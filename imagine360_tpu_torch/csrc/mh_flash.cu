// K2: streaming multi-head attention for long key sequences, no bias.
//
// Replaces imagine360_tpu/ops/pallas_attention.py:_mh_flash_kernel
// (wrapper mh_flash_attention): online-softmax attention in the natural
// [B, S, H*D] layout, keys at or beyond Sk masked, a zero denominator
// replaced by 1.
//
// What bounds it on the H100: the pano spatial self-attention (Sq = Sk =
// 8192 with 5 heads, 2048 with 10, D = 64) does O(Sq*Sk*D) multiply-adds
// per problem against O((Sq+Sk)*D) bytes, so it is compute bound; this
// simple kernel runs the dots on the CUDA cores from shared memory and is
// limited by shared-memory bandwidth (tensor cores are later work).
//
// Design: on the TPU the key axis was a sequential grid axis that carried
// the running max/sum in VMEM scratch between grid steps. Blocks on Hopper
// run in no order, so one block owns a 64-row query tile of one (batch,
// head) and walks all key tiles in a loop (i360::flash_tile), keeping the
// running max, sum and the [64, D] accumulator on chip. Logits never reach
// device memory.
#include "attn_common.cuh"

namespace i360 {

constexpr int K2_BQ = 64;
constexpr int K2_BK = 64;
constexpr int K2_NT = 256;

template <typename T, int DP>
__global__ void __launch_bounds__(K2_NT)
mh_flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, int Sq, int Sk, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * K2_BQ;
  const long ld = (long)H * D;
  const long qoff = ((long)b * Sq + q0) * ld + (long)h * D;
  const long koff = (long)b * Sk * ld + (long)h * D;
  flash_tile<T, DP, K2_BQ, K2_BK, K2_NT>(q + qoff, k + koff, v + koff, out + qoff, nullptr,
                                         nullptr, ld, min(K2_BQ, Sq - q0), Sk, D, scale, smem);
}

template <typename T>
int launch_mh_flash(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                    int Sk, int H, int D, float scale, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + K2_BQ - 1) / K2_BQ);
  I360_DP_SWITCH(D, {
    const size_t smem = flash_smem_bytes<K2_BQ, K2_BK, DP>();
    auto kern = mh_flash_kernel<T, DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, K2_NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)out, Sq,
                                        Sk, H, D, scale);
  });
  return (int)cudaGetLastError();
}

}  // namespace i360

// q [B, Sq, H*D], k/v [B, Sk, H*D], out [B, Sq, H*D], contiguous.
// dtype 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int i360_mh_flash_attention(const void* q, const void* k, const void* v, void* out,
                                       int B, int Sq, int Sk, int H, int D, float scale,
                                       int dtype, void* stream) {
  if (D > 160 || D < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (dtype == 1)
    return i360::launch_mh_flash<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
  return i360::launch_mh_flash<float>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
}
