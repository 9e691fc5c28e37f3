// K1: whole-row attention for short key sequences.
//
// Replaces imagine360_tpu/ops/pallas_attention.py:_tiny_packed_kernel
// (wrapper tiny_packed_attention). Computes, for every (batch row, head),
// softmax(q k^T * scale + bias) v with one optional [Sq, Sk] float bias
// shared by every row and head, in the natural [B, S, H*D] layout.
//
// What bounds it on the H100: at the perspective spatial self-attention
// sites (Sq = Sk = 1024/256/64) the work is the two dots, O(Sq*Sk*D) per
// problem, against O((Sq+Sk)*D) bytes, so they are bound by operations: 989
// TFLOP/s bf16 on the tensor cores. At the text and image-prompt
// cross-attention sites (Sk = 77/64/13, one key tile) a query row does
// 4*Sk*D operations against its 4*D bytes of q and out, about 77
// operations a byte at Sk = 77, far below the card's ~295: they are bound
// by bytes, 3.35 TB/s.
//
// bf16 at D = 64 without a bias, Sq > 32 and Sk > 128 (the spatial
// self-attention sites of the models): the Hopper body of attn_wgmma.cuh
// (tiny_attention_wgmma_kernel: TMA and an mbarrier ring feed two consumer
// warpgroups of 64 query rows on wgmma), for 16-byte-aligned pointers
// (kernels.wgmma_route decides, the C entry refuses the rest). The same
// with Sq > 32 and at most 128 keys, not both Sq and Sk at most 64 (the
// cross-attention sites): the persistent TMA-streaming body of
// attn_wgmma_xattn.cuh (tiny_attention_xattn_wgmma_kernel, one
// instantiation for 64, 80 and 128 keys; kernels.xattn_route). Other bf16
// launches (a bias, Sq <= 32, Sq and Sk at most 64, other head dims,
// unaligned pointers): the tensor-core body of
// attn_mma.cuh (i360::flash_tile_mma, mma.sync on bf16 fragments, online
// softmax in registers, K/V tiles by cp.async in two stages). A block
// there owns 64 query rows (4 warps) of one (batch, head); where Sq is at
// most 32 it owns 16 or 32 (1 or 2 warps), so that the 16-query sites (the
// TemporalProjection frame attention) do not run 75% padding rows. The
// query tile is the fastest grid axis in every body. The whole-row
// two-pass softmax of the float32 kernel does not carry over (a 16 x 1024
// logit row per warp does not fit in registers), so the bf16 path streams
// its at most 16 key tiles through the online softmax and rounds the
// unnormalised probabilities to bf16 before P V, as K2 does.
//
// float32: the CUDA-core kernel below. The TPU kernel packed tiny
// sequences under a block-diagonal bias and padded keys to 128 lanes, so
// that the MXU saw large tiles. Here a block owns BQ = 16 query rows of one
// (batch, head) and keeps their whole [16, Sk] row of logits in shared
// memory (64 KB at Sk = 1024): the softmax is exact in two passes (max,
// then sum) with no running rescale, the key tail is masked by Sk inside the
// kernel, and no packing or padding exists on the host side. It runs the
// dots on the CUDA cores from shared memory.
#include "attn_mma.cuh"
#include "attn_wgmma.cuh"
#include "attn_wgmma_xattn.cuh"

namespace i360 {

constexpr int K1_BQ = 16;
constexpr int K1_BK = 64;
constexpr int K1_NT = 256;
constexpr int K1_MAX_SK = 1024;

template <int DP>
__global__ void __launch_bounds__(K1_NT)
tiny_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      float* __restrict__ out, int Sq, int Sk, int H, int D, float scale) {
  constexpr int LD = DP + 1;
  constexpr int NR = (K1_BQ * DP + K1_NT - 1) / K1_NT;
  extern __shared__ float smem[];
  const int skp = (Sk + K1_BK - 1) / K1_BK * K1_BK;
  const int PLD = skp + 1;
  float* qs = smem;                 // [BQ][LD]
  float* kv = qs + K1_BQ * LD;      // [BK][LD]
  float* ps = kv + K1_BK * LD;      // [BQ][PLD] whole rows of logits

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * K1_BQ;
  const int nq = min(K1_BQ, Sq - q0);
  const long ld = (long)H * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qb = q + ((long)b * Sq + q0) * ld + (long)h * D;
  const float* kb = k + (long)b * Sk * ld + (long)h * D;
  const float* vb = v + (long)b * Sk * ld + (long)h * D;

  load_tile(qs, LD, qb, ld, K1_BQ, nq, D, DP);
  for (int k0 = 0; k0 < skp; k0 += K1_BK) {
    const int nk = min(K1_BK, Sk - k0);
    __syncthreads();
    load_tile(kv, LD, kb + (long)k0 * ld, ld, K1_BK, nk, D, DP);
    __syncthreads();
    for (int idx = tid; idx < K1_BQ * K1_BK; idx += K1_NT) {
      const int i = idx / K1_BK, j = idx - i * K1_BK;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < DP; ++d) s += qs[i * LD + d] * kv[j * LD + d];
      s *= scale;
      if (j >= nk) s = kNegInf;
      else if (bias != nullptr && i < nq) s += bias[(long)(q0 + i) * Sk + k0 + j];
      ps[i * PLD + k0 + j] = s;
    }
  }
  __syncthreads();
  // exact softmax per row: one warp per row
  for (int i = warp; i < K1_BQ; i += K1_NT / 32) {
    float* row = ps + i * PLD;
    float mx = kNegInf;
    for (int j = lane; j < skp; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < skp; j += 32) {
      const float e = __expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const float inv = 1.f / sum;
    for (int j = lane; j < skp; j += 32) row[j] *= inv;
  }
  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < skp; k0 += K1_BK) {
    const int nk = min(K1_BK, Sk - k0);
    __syncthreads();
    load_tile(kv, LD, vb + (long)k0 * ld, ld, K1_BK, nk, D, DP);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int idx = tid + r * K1_NT;
      if (idx < K1_BQ * DP) {
        const int i = idx / DP, d = idx - i * DP;
        const float* prow = ps + i * PLD + k0;
        float a = acc[r];
        for (int j = 0; j < K1_BK; ++j) a += prow[j] * kv[j * LD + d];
        acc[r] = a;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int idx = tid + r * K1_NT;
    if (idx < K1_BQ * DP) {
      const int i = idx / DP, d = idx - i * DP;
      if (i < nq && d < D) out[((long)b * Sq + q0 + i) * ld + (long)h * D + d] = acc[r];
    }
  }
}

int launch_tiny(const void* q, const void* k, const void* v, const float* bias, void* out,
                int B, int Sq, int Sk, int H, int D, float scale, cudaStream_t stream) {
  const int skp = (Sk + K1_BK - 1) / K1_BK * K1_BK;
  const dim3 grid(B * H, (Sq + K1_BQ - 1) / K1_BQ);
  I360_DP_SWITCH(D, {
    const size_t smem = sizeof(float) *
        ((size_t)(K1_BQ + K1_BK) * (DP + 1) + (size_t)K1_BQ * (skp + 1));
    auto kern = tiny_attention_kernel<DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, K1_NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v, bias,
                                        (float*)out, Sq, Sk, H, D, scale);
  });
  return (int)cudaGetLastError();
}

// bf16 on the tensor cores: one block per 16 * NW query rows of one (batch,
// head), the query tile the fastest grid axis
template <int DP, int NW>
__global__ void __launch_bounds__(NW * 32)
tiny_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          bf16* __restrict__ out, int Sq, int Sk, int H, int D, float scale,
                          int vec, int bias_vec, int kt_rows) {
  extern __shared__ __align__(16) unsigned char k1_smem[];
  constexpr int BQ = 16 * NW;
  const int nqt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * BQ;
  const int b = bh / H, h = bh - b * H;
  const long ld = (long)H * D;
  const long qoff = ((long)b * Sq + q0) * ld + (long)h * D;
  const long koff = (long)b * Sk * ld + (long)h * D;
  // the bias stages (when there is a bias) before the Q, K and V tiles
  const size_t bias_bytes = bias == nullptr ? 0 : attn_mma_bias_bytes(BQ);
  flash_tile_mma<DP, NW>(q + qoff, k + koff, v + koff, out + qoff, nullptr,
                         bias == nullptr ? nullptr : bias + (long)q0 * Sk,
                         bias_vec != 0, ld, min(BQ, Sq - q0), Sk, D, scale,
                         vec != 0, kt_rows, (bf16*)(k1_smem + bias_bytes), (float*)k1_smem);
}

template <int DP, int NW>
void launch_tiny_mma_nw(const void* q, const void* k, const void* v, const float* bias,
                        void* out, int B, int Sq, int Sk, int H, int D, float scale,
                        cudaStream_t stream) {
  constexpr int BQ = 16 * NW;
  const int kt_rows = attn_mma_kt_rows(Sk);
  const size_t smem = attn_mma_smem_bytes<DP>(BQ, kt_rows) +
                      (bias == nullptr ? 0 : attn_mma_bias_bytes(BQ));
  auto kern = tiny_attention_mma_kernel<DP, NW>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const unsigned blocks = (unsigned)((long)B * H * ((Sq + BQ - 1) / BQ));
  kern<<<blocks, NW * 32, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, bias,
                                          (bf16*)out, Sq, Sk, H, D, scale,
                                          (int)attn_mma_vec(D, q, k, v, out),
                                          (int)attn_mma_bias_vec(Sk, bias), kt_rows);
}

int launch_tiny_mma(const void* q, const void* k, const void* v, const float* bias, void* out,
                    int B, int Sq, int Sk, int H, int D, float scale, cudaStream_t stream) {
  // 1, 2 or 4 warps: the fewest 16-row groups that cover Sq, up to 64 rows
  I360_DP_SWITCH(D, {
    auto launch = Sq <= 16 ? &launch_tiny_mma_nw<DP, 1>
                : Sq <= 32 ? &launch_tiny_mma_nw<DP, 2> : &launch_tiny_mma_nw<DP, 4>;
    launch(q, k, v, bias, out, B, Sq, Sk, H, D, scale, stream);
  });
  return (int)cudaGetLastError();
}

// bf16 at D = 64 without a bias on wgmma (attn_wgmma.cuh); block index =
// (batch x head) x query tiles + query tile
__global__ void __launch_bounds__(kWgThreads, 1)
tiny_attention_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                            const __grid_constant__ CUtensorMap mk,
                            const __grid_constant__ CUtensorMap mv,
                            const __grid_constant__ CUtensorMap mo, int Sq, int Sk, int H, int nqt,
                            float sl2) {
  extern __shared__ __align__(1024) unsigned char k1_wg_smem[];
  attn_wgmma_tile(&mq, &mk, &mv, &mo, nullptr, Sq, Sk, H, nqt, sl2, k1_wg_smem);
}

// bf16 at D = 64 without a bias at one key tile of N keys (64, 80 or 128)
// on the persistent streaming body (attn_wgmma_xattn.cuh); block x walks
// its run of the (batch x head) x query tiles
template <int N>
__global__ void __launch_bounds__(kXaThreads, 1)
tiny_attention_xattn_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                                  const __grid_constant__ CUtensorMap mk,
                                  const __grid_constant__ CUtensorMap mv,
                                  const __grid_constant__ CUtensorMap mo, int B, int Sq, int Sk,
                                  int H, int nqt, float sl2) {
  extern __shared__ __align__(1024) unsigned char k1_xa_smem[];
  attn_xattn_body<N>(&mq, &mk, &mv, &mo, B, Sq, Sk, H, nqt, sl2, k1_xa_smem);
}

}  // namespace i360

// q [B, Sq, H*D], k/v [B, Sk, H*D], out [B, Sq, H*D], all contiguous;
// bias null or a contiguous [Sq, Sk] float matrix. dtype 0 = float32 (the
// CUDA-core kernel), 1 = bfloat16 (the tensor cores). Returns the
// cudaError_t of the launch.
extern "C" int i360_tiny_attention(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int B, int Sq, int Sk,
                                   int H, int D, float scale, int dtype, void* stream) {
  if (Sk > i360::K1_MAX_SK || D > 160 || D < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto bp = (const float*)bias;
  if (dtype == 1) return i360::launch_tiny_mma(q, k, v, bp, out, B, Sq, Sk, H, D, scale, s);
  return i360::launch_tiny(q, k, v, bp, out, B, Sq, Sk, H, D, scale, s);
}

// bf16, D = 64, no bias, q/k/v/out 16-byte aligned: the wgmma body (the
// models' launches come here where kernels.wgmma_route says so: Sq > 32 and
// Sk > 128 too, where it is the faster body). Returns the cudaError_t of
// the launch; anything else it refuses with cudaErrorInvalidValue and
// launches nothing.
extern "C" int i360_tiny_attention_wgmma(const void* q, const void* k, const void* v, void* out,
                                         int B, int Sq, int Sk, int H, int D, float scale,
                                         void* stream) {
  if (Sk > i360::K1_MAX_SK || D != i360::kWgD) return (int)cudaErrorInvalidValue;
  return i360::launch_attn_wgmma(i360::tiny_attention_wgmma_kernel, q, k, v, out, B, Sq, Sk, H,
                                 scale, (cudaStream_t)stream);
}

// bf16, D = 64, no bias, 1 <= Sk <= 128, q/k/v/out 16-byte aligned: the
// persistent one-key-tile body (the models' launches come here where
// kernels.xattn_route says so: Sq > 32 too). The instantiation covers Sk
// rounded up to 64, 80 or 128 keys. Returns the cudaError_t of the launch;
// anything else it refuses with cudaErrorInvalidValue and launches nothing.
extern "C" int i360_tiny_attention_xattn(const void* q, const void* k, const void* v, void* out,
                                         int B, int Sq, int Sk, int H, int D, float scale,
                                         void* stream) {
  if (Sk > i360::kXaMaxSk || D != i360::kWgD) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  switch (i360::xa_keys(Sk)) {
    case 64:
      return i360::launch_xattn_wgmma<64>(i360::tiny_attention_xattn_wgmma_kernel<64>, q, k, v,
                                          out, B, Sq, Sk, H, scale, s);
    case 80:
      return i360::launch_xattn_wgmma<80>(i360::tiny_attention_xattn_wgmma_kernel<80>, q, k, v,
                                          out, B, Sq, Sk, H, scale, s);
    default:
      return i360::launch_xattn_wgmma<128>(i360::tiny_attention_xattn_wgmma_kernel<128>, q, k,
                                           v, out, B, Sq, Sk, H, scale, s);
  }
}
