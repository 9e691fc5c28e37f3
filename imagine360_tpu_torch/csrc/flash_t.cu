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
// compute bound, and here limited by shared-memory bandwidth, since the
// dots run on the CUDA cores from float shared memory like K2's.
//
// Design: the TPU kernel put the sequence on the 128 lanes so that a head
// dim of 32 or 64 padded nothing, kept a broadcast bias block resident in
// VMEM and walked the key blocks on a sequential grid axis. On this card no
// layout pads the head dim, so only the loader differs from K5a: a warp
// reads 32 contiguous sequence positions of one head-dim row and stores
// them transposed into the [rows][D + 1] float tile that i360::flash_tile
// consumes (the odd row stride spreads the transposed stores over all 32
// banks). The softmax and PV core is the shared one. Ragged Sq and Sk are
// masked inside the tile; the host pads nothing. One pair of bias strides
// (0 for a broadcast axis) covers every bias shape, and batch*head is the
// fastest grid axis, so the blocks in flight read the same rows of a
// broadcast bias from L2.
#include "attn_common.cuh"

namespace i360 {

constexpr int K6A_BQ = 64;
constexpr int K6A_BK = 64;
constexpr int K6A_NT = 256;

template <typename T, int DP>
__global__ void __launch_bounds__(K6A_NT)
flash_t_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ bias, T* __restrict__ out, int Sq, int Sk, int H,
               int D, long bias_bs, long bias_hs, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * K6A_BQ;
  const float* bp =
      bias == nullptr ? nullptr : bias + b * bias_bs + h * bias_hs + (long)q0 * Sk;
  const long koff = (long)bh * D * Sk;
  flash_tile<T, DP, K6A_BQ, K6A_BK, K6A_NT, false, true>(
      q + (long)bh * D * Sq + q0, k + koff, v + koff, out + ((long)bh * Sq + q0) * D, bp,
      nullptr, (long)D, min(K6A_BQ, Sq - q0), Sk, D, scale, smem, (long)Sq, (long)Sk);
}

template <typename T>
int launch_flash_t(const void* q, const void* k, const void* v, const float* bias, void* out,
                   int B, int Sq, int Sk, int H, int D, long bias_bs, long bias_hs,
                   float scale, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + K6A_BQ - 1) / K6A_BQ);
  I360_DP_SWITCH(D, {
    const size_t smem = flash_smem_bytes<K6A_BQ, K6A_BK, DP>();
    auto kern = flash_t_kernel<T, DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, K6A_NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, bias, (T*)out,
                                         Sq, Sk, H, D, bias_bs, bias_hs, scale);
  });
  return (int)cudaGetLastError();
}

}  // namespace i360

// q [B, H, D, Sq], k/v [B, H, D, Sk], out [B, H, Sq, D], all contiguous;
// bias null or float with rows of Sk contiguous elements, batch stride
// bias_bs and head stride bias_hs in elements (0 for a broadcast axis).
// dtype 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int i360_flash_attention_t(const void* q, const void* k, const void* v,
                                      const void* bias, void* out, int B, int Sq, int Sk,
                                      int H, int D, long bias_bs, long bias_hs, float scale,
                                      int dtype, void* stream) {
  if (D > 160 || D < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto bp = (const float*)bias;
  if (dtype == 1)
    return i360::launch_flash_t<__nv_bfloat16>(q, k, v, bp, out, B, Sq, Sk, H, D, bias_bs,
                                               bias_hs, scale, s);
  return i360::launch_flash_t<float>(q, k, v, bp, out, B, Sq, Sk, H, D, bias_bs, bias_hs,
                                     scale, s);
}
