// K3: streaming attention with one [Sq, Sk] bias shared by every batch row
// and head (the WarpAttn correspondence masks).
//
// Replaces imagine360_tpu/ops/pallas_attention.py:_shared_bias_kernel_t
// (wrapper _flash_shared_bias_t), its optional log-sum-exp output included:
// with a non-null `lse` [B, H, Sq] float the kernel also writes m + log(l)
// per query row, the residual of the streaming backward (K5b, K5c).
//
// What bounds it on the H100: the r2 site (2048 <-> 5120 tokens, 10 heads,
// D = 32, 32 batch rows) does O(Sq*Sk*D) multiply-adds per (batch, head)
// and reads the Sq*Sk float bias, 42 MB, once per (batch, head) if nothing
// is shared: 320 such reads would move 13 GB. It is compute bound on the
// dots once the bias is served from cache.
//
// Design: the TPU kernel folded T (batch*head) rows into one grid step so
// that each bias block was streamed once per row group, and used a [D, S]
// transposed layout so that D = 32 wasted no lanes. Neither carries over.
// Here q/k/v stay [B, S, H, D]; a block owns a 64-row query tile of one
// (batch, head) and walks the key tiles (i360::flash_tile). The grid puts
// batch*head on x, the fastest launch axis, so all blocks of one query tile
// run together and read the same 64 bias rows: the bias comes from L2
// (50 MB) rather than device memory.
#include "attn_common.cuh"

namespace i360 {

constexpr int K3_BQ = 64;
constexpr int K3_BK = 64;
constexpr int K3_NT = 256;

template <typename T, int DP>
__global__ void __launch_bounds__(K3_NT)
shared_bias_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ bias, T* __restrict__ out,
                   float* __restrict__ lse, int Sq, int Sk, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * K3_BQ;
  const long ld = (long)H * D;
  const long qoff = ((long)b * Sq + q0) * ld + (long)h * D;
  const long koff = (long)b * Sk * ld + (long)h * D;
  flash_tile<T, DP, K3_BQ, K3_BK, K3_NT>(
      q + qoff, k + koff, v + koff, out + qoff, bias + (long)q0 * Sk,
      lse == nullptr ? nullptr : lse + (long)bh * Sq + q0, ld, min(K3_BQ, Sq - q0), Sk, D,
      scale, smem);
}

template <typename T>
int launch_shared_bias(const void* q, const void* k, const void* v, const float* bias,
                       void* out, float* lse, int B, int Sq, int Sk, int H, int D,
                       float scale, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + K3_BQ - 1) / K3_BQ);
  I360_DP_SWITCH(D, {
    const size_t smem = flash_smem_bytes<K3_BQ, K3_BK, DP>();
    auto kern = shared_bias_kernel<T, DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, K3_NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, bias, (T*)out,
                                        lse, Sq, Sk, H, D, scale);
  });
  return (int)cudaGetLastError();
}

}  // namespace i360

// q [B, Sq, H, D], k/v [B, Sk, H, D], out [B, Sq, H, D], bias [Sq, Sk]
// float, lse null or [B, H, Sq] float, all contiguous. dtype 0 = float32,
// 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int i360_shared_bias_attention(const void* q, const void* k, const void* v,
                                          const void* bias, void* out, void* lse, int B,
                                          int Sq, int Sk, int H, int D, float scale,
                                          int dtype, void* stream) {
  if (D > 160 || D < 1 || bias == nullptr) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto bp = (const float*)bias;
  auto lp = (float*)lse;
  if (dtype == 1)
    return i360::launch_shared_bias<__nv_bfloat16>(q, k, v, bp, out, lp, B, Sq, Sk, H, D,
                                                   scale, s);
  return i360::launch_shared_bias<float>(q, k, v, bp, out, lp, B, Sq, Sk, H, D, scale, s);
}
