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
// compute bound. The dots run on the CUDA cores from float shared memory.
//
// Design: the TPU kernel accumulated dq in VMEM scratch across a sequential
// key-block grid axis. Here a block owns a 64-row query tile of one (batch,
// head), keeps its q and dO tiles, lse and delta rows in shared memory and
// its [64, D] dq accumulator in registers, and walks the key tiles in a
// loop: no atomics, a fixed summation order. q/k/v/dO stay [B, S, H, D];
// ragged Sq and Sk are masked inside (bwd_tile_scores). batch*head is the
// fastest grid axis, so with a broadcast bias the blocks in flight read the
// same bias rows from L2.
#include "flash_bwd.cuh"

namespace i360 {

template <int DP>
constexpr size_t bwd_dq_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * BWD_BQ + 2 * BWD_BK) * (DP + 1)
                          + (size_t)BWD_BQ * (BWD_BK + 1) + 2 * BWD_BQ);
}

template <typename T, int DP>
__global__ void __launch_bounds__(BWD_NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ bias, const T* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int Sq, int Sk, int H, int D, long bias_bs,
                    long bias_hs, float scale) {
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
      if (i < nq && d < D) dq[qoff + (long)i * ld + d] = from_f<T>(acc[r] * scale);
    }
  }
}

template <typename T>
int launch_flash_bwd_dq(const void* q, const void* k, const void* v, const float* bias,
                        const void* g, const float* lse, const float* delta, void* dq, int B,
                        int Sq, int Sk, int H, int D, long bias_bs, long bias_hs, float scale,
                        cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + BWD_BQ - 1) / BWD_BQ);
  I360_DP_SWITCH(D, {
    const size_t smem = bwd_dq_smem_bytes<DP>();
    auto kern = flash_bwd_dq_kernel<T, DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, BWD_NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, bias,
                                         (const T*)g, lse, delta, (T*)dq, Sq, Sk, H, D,
                                         bias_bs, bias_hs, scale);
  });
  return (int)cudaGetLastError();
}

}  // namespace i360

// q/g/dq [B, Sq, H, D], k/v [B, Sk, H, D], lse/delta [B, H, Sq] float, all
// contiguous; bias null or float with rows of Sk contiguous elements, batch
// stride bias_bs and head stride bias_hs in elements (0 for a broadcast
// axis). dtype 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch.
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
    return i360::launch_flash_bwd_dq<__nv_bfloat16>(q, k, v, bp, g, lp, dp, dq, B, Sq, Sk, H,
                                                    D, bias_bs, bias_hs, scale, s);
  return i360::launch_flash_bwd_dq<float>(q, k, v, bp, g, lp, dp, dq, B, Sq, Sk, H, D,
                                          bias_bs, bias_hs, scale, s);
}
