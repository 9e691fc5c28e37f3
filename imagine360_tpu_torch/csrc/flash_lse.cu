// K5a: streaming attention forward that also emits the log-sum-exp of every
// query row, the forward of the trained long-sequence sites.
//
// Replaces imagine360_tpu/ops/pallas_attention.py:_flash_kernel (wrapper
// _flash_bhsd, reached under grad through flash_attention_fwd_res):
// softmax(q k^T * scale + bias) v with an optional float bias
// [1|B, 1|H, Sq, Sk], the output in q's dtype and lse = m + log(l) in float
// [B, H, Sq]. Dots and probabilities stay in float (no rounding of the
// probabilities before the PV product, unlike K2 and K3), a zero
// denominator is replaced by 1 before the divide and the log, and the
// running max starts at the finite -1e30.
//
// What bounds it on the H100: the pano spatial self-attention under grad
// (Sq = Sk = 8192 with 5 heads, 2048 with 10, D = 64, 16 frames) does
// 4*Sq*Sk*D operations per (batch, head) against O((Sq+Sk)*D) bytes:
// compute bound. This simple kernel runs the dots on the CUDA cores from
// float shared memory, like K2, and is limited by shared-memory bandwidth.
//
// Design: the TPU kernel carried m, l and the accumulator in VMEM scratch
// across a sequential key-block grid axis and took a transposed
// [B, H, S, D] layout. Here q/k/v stay [B, S, H, D]; a block owns a 64-row
// query tile of one (batch, head) and walks the key tiles in a loop
// (i360::flash_tile). Ragged Sq and Sk are masked inside the tile, so the
// host pads nothing. One pair of bias strides (0 for a broadcast axis)
// covers every bias shape. batch*head is the fastest grid axis, so with a
// broadcast bias the blocks in flight read the same bias rows from L2.
#include "attn_common.cuh"

namespace i360 {

constexpr int K5A_BQ = 64;
constexpr int K5A_BK = 64;
constexpr int K5A_NT = 256;

template <typename T, int DP>
__global__ void __launch_bounds__(K5A_NT)
flash_lse_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int D, long bias_bs,
                 long bias_hs, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * K5A_BQ;
  const long ld = (long)H * D;
  const long qoff = ((long)b * Sq + q0) * ld + (long)h * D;
  const long koff = (long)b * Sk * ld + (long)h * D;
  const float* bp =
      bias == nullptr ? nullptr : bias + b * bias_bs + h * bias_hs + (long)q0 * Sk;
  flash_tile<T, DP, K5A_BQ, K5A_BK, K5A_NT, false>(
      q + qoff, k + koff, v + koff, out + qoff, bp, lse + (long)bh * Sq + q0, ld,
      min(K5A_BQ, Sq - q0), Sk, D, scale, smem);
}

template <typename T>
int launch_flash_lse(const void* q, const void* k, const void* v, const float* bias, void* out,
                     float* lse, int B, int Sq, int Sk, int H, int D, long bias_bs,
                     long bias_hs, float scale, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + K5A_BQ - 1) / K5A_BQ);
  I360_DP_SWITCH(D, {
    const size_t smem = flash_smem_bytes<K5A_BQ, K5A_BK, DP>();
    auto kern = flash_lse_kernel<T, DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, K5A_NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, bias, (T*)out,
                                         lse, Sq, Sk, H, D, bias_bs, bias_hs, scale);
  });
  return (int)cudaGetLastError();
}

}  // namespace i360

// q [B, Sq, H, D], k/v [B, Sk, H, D], out [B, Sq, H, D], lse [B, H, Sq]
// float, all contiguous; bias null or float with rows of Sk contiguous
// elements, batch stride bias_bs and head stride bias_hs in elements (0 for
// a broadcast axis). dtype 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch.
extern "C" int i360_flash_attention_lse(const void* q, const void* k, const void* v,
                                        const void* bias, void* out, void* lse, int B, int Sq,
                                        int Sk, int H, int D, long bias_bs, long bias_hs,
                                        float scale, int dtype, void* stream) {
  if (D > 160 || D < 1 || lse == nullptr) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto bp = (const float*)bias;
  auto lp = (float*)lse;
  if (dtype == 1)
    return i360::launch_flash_lse<__nv_bfloat16>(q, k, v, bp, out, lp, B, Sq, Sk, H, D,
                                                 bias_bs, bias_hs, scale, s);
  return i360::launch_flash_lse<float>(q, k, v, bp, out, lp, B, Sq, Sk, H, D, bias_bs,
                                       bias_hs, scale, s);
}
