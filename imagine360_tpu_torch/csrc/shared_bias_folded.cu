// K6b: streaming attention with batch and head folded into one axis, q
// [BH, Sq, D] and k/v [BH, Sk, D], under one [Sq, Sk] bias of float or
// bfloat16 shared by all BH rows; optional float lse [BH, Sq].
//
// Replaces imagine360_tpu/ops/pallas_attention.py:_shared_bias_kernel
// (wrapper _flash_shared_bias): online softmax with every product in float,
// the probabilities kept in float through the PV product, masked keys at
// the finite -1e30, a zero denominator replaced by 1, lse = m + log(l).
//
// What bounds it on the H100: 4*Sq*Sk*D operations per folded row against
// O((Sq+Sk)*D) bytes and one Sq*Sk bias: at D = 32 each 4-byte bias element
// carries 128 operations per folded row, so the bias is read once for
// several rows (the TPU kernel walked T rows under one bias block) and the
// products belong on the tensor cores.
//
// bf16 (D <= 160): in memory [BH, S, D] is K3's layout with one head, and
// the kernel is K3's: a block owns one 64-row query tile of G folded rows,
// G groups of 4 warps, each with its own Q, K and V tiles and the
// tensor-core body of attn_mma.cuh (i360::flash_tile_mma), all under one
// staged [64, 64] bias tile of each key tile, in the bias's own dtype
// (16-byte cp.async copies, or 2-byte accesses where Sk or the pointer does
// not allow them). G is the caller's t_rows, at most K6B_MAX_G (two groups,
// 256 threads, so ptxas may give a thread all 255 registers) and at most
// what fits a block's shared memory (one group at head dim 160); a ragged
// last group computes a real row again and stores nothing. The folded rows
// are the fastest grid axis, so the blocks in flight read the same bias rows
// from L2. The probabilities stay float32 in the kernel replaced, so P·V
// takes the exact bf16 split p = hi + lo (SPLIT_P, as K5a): two products per
// k-step. The lse pointer stays nullable.
//
// float32: the CUDA-core body. A block owns a 64-row query tile of TR
// consecutive folded rows. The TR query tiles, the TR float accumulators and
// the running max and sum of every row live in shared memory for the whole
// block (the accumulators there and not in registers, so that TR is a
// run-time number, chosen by the host from the 227 KB a block may use and
// the size of the problem). For each key tile the block widens the [64, 64]
// bias tile into shared memory once, whatever its dtype, and then takes the
// TR rows in turn: K tile, logits plus bias, online-softmax update, V tile,
// accumulate. Ragged Sq, Sk and BH are masked inside; the host pads nothing.
#include "attn_mma.cuh"

namespace i360 {

constexpr int K6B_BQ = 64;
constexpr int K6B_BK = 64;
constexpr int K6B_NT = 256;

// shared memory: what every block holds, and what each folded row adds
template <int DP>
__host__ __device__ constexpr size_t k6b_fixed_floats() {
  return 2 * (size_t)K6B_BQ * (K6B_BK + 1) + (size_t)K6B_BK * (DP + 1) + K6B_BQ;
}
template <int DP>
__host__ __device__ constexpr size_t k6b_row_floats() {
  return (size_t)K6B_BQ * (DP + 1) + (size_t)K6B_BQ * DP + 2 * K6B_BQ;
}

template <typename T, typename TB, int DP>
__global__ void __launch_bounds__(K6B_NT)
shared_bias_folded_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const TB* __restrict__ bias,
                          T* __restrict__ out, float* __restrict__ lse, int BH, int Sq, int Sk,
                          int D, int TR, float scale) {
  constexpr int BQ = K6B_BQ, BK = K6B_BK, NT = K6B_NT;
  constexpr int LD = DP + 1, PLD = BK + 1;
  extern __shared__ float smem[];
  float* bs = smem;                   // [BQ][PLD]  bias tile, widened
  float* ps = bs + BQ * PLD;          // [BQ][PLD]  logits, then probabilities
  float* kv = ps + BQ * PLD;          // [BK][LD]   K tile, then V tile
  float* a_s = kv + BK * LD;          // [BQ]       rescale of this tile
  float* rows = a_s + BQ;             // per folded row: q tile, acc, m, l
  constexpr size_t ROW = k6b_row_floats<DP>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g0 = blockIdx.x * TR, nt = min(TR, BH - g0);
  const int q0 = blockIdx.y * BQ, nq = min(BQ, Sq - q0);

  for (int t = 0; t < nt; ++t) {
    float* qs = rows + t * ROW;
    float* acc = qs + BQ * LD;
    float* m_s = acc + BQ * DP;
    float* l_s = m_s + BQ;
    load_tile(qs, LD, q + ((long)(g0 + t) * Sq + q0) * D, (long)D, BQ, nq, D, DP);
    for (int i = tid; i < BQ * DP; i += NT) acc[i] = 0.f;
    for (int i = tid; i < BQ; i += NT) { m_s[i] = kNegInf; l_s[i] = 0.f; }
  }

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    const int nk = min(BK, Sk - k0);
    __syncthreads();   // the last row of the tile before has read bs
    for (int idx = tid; idx < BQ * BK; idx += NT) {
      const int i = idx / BK, j = idx - i * BK;
      float x = 0.f;
      if (i < nq && j < nk) x = to_f(bias[(long)(q0 + i) * Sk + k0 + j]);
      bs[i * PLD + j] = x;
    }
    for (int t = 0; t < nt; ++t) {
      float* qs = rows + t * ROW;
      float* acc = qs + BQ * LD;
      float* m_s = acc + BQ * DP;
      float* l_s = m_s + BQ;
      const long koff = ((long)(g0 + t) * Sk + k0) * D;
      __syncthreads();   // kv and ps are free, bs is written
      load_tile(kv, LD, k + koff, (long)D, BK, nk, D, DP);
      __syncthreads();
      for (int idx = tid; idx < BQ * BK; idx += NT) {
        const int i = idx / BK, j = idx - i * BK;
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < DP; ++d) s += qs[i * LD + d] * kv[j * LD + d];
        s = s * scale + bs[i * PLD + j];
        if (j >= nk) s = kNegInf;
        ps[i * PLD + j] = s;
      }
      __syncthreads();
      for (int i = warp; i < BQ; i += NT / 32) {
        float mx = kNegInf;
        for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, ps[i * PLD + j]);
        mx = warp_max(mx);
        const float m_old = m_s[i];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int j = lane; j < BK; j += 32) {
          const float p = __expf(ps[i * PLD + j] - m_new);
          sum += p;
          ps[i * PLD + j] = p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = __expf(m_old - m_new);
          a_s[i] = alpha;
          l_s[i] = l_s[i] * alpha + sum;
          m_s[i] = m_new;
        }
      }
      __syncthreads();
      load_tile(kv, LD, v + koff, (long)D, BK, nk, D, DP);
      __syncthreads();
      for (int idx = tid; idx < BQ * DP; idx += NT) {
        const int i = idx / DP, d = idx - i * DP;
        float a = acc[idx] * a_s[i];
        for (int j = 0; j < BK; ++j) a += ps[i * PLD + j] * kv[j * LD + d];
        acc[idx] = a;
      }
    }
  }
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const float* acc = rows + t * ROW + BQ * LD;
    const float* m_s = acc + BQ * DP;
    const float* l_s = m_s + BQ;
    const long row0 = (long)(g0 + t) * Sq + q0;
    if (lse != nullptr) {
      for (int i = tid; i < nq; i += NT) {
        const float l = l_s[i];
        lse[row0 + i] = m_s[i] + logf(l == 0.f ? 1.f : l);
      }
    }
    for (int idx = tid; idx < BQ * DP; idx += NT) {
      const int i = idx / DP, d = idx - i * DP;
      if (i < nq && d < D) {
        float l = l_s[i];
        l = (l == 0.f) ? 1.f : l;
        out[(row0 + i) * D + d] = from_f<T>(acc[idx] / l);
      }
    }
  }
}

// The folded rows a block takes: at most `t_rows`, at most what fits the
// block's shared memory, and no more than keeps about two blocks per SM
// busy on a small problem.
template <int DP>
int k6b_rows(int BH, int Sq, int t_rows, int smem_limit) {
  const long fit =
      ((long)smem_limit / 4 - (long)k6b_fixed_floats<DP>()) / (long)k6b_row_floats<DP>();
  long tr = t_rows < fit ? t_rows : fit;
  const long q_tiles = (Sq + K6B_BQ - 1) / K6B_BQ;
  while (tr > 1 && ((BH + tr - 1) / tr) * q_tiles < 264) tr /= 2;
  if (tr > BH) tr = BH;
  return tr < 1 ? 1 : (int)tr;
}

template <typename TB>
int launch_shared_bias_folded(const void* q, const void* k, const void* v, const void* bias,
                              void* out, float* lse, int BH, int Sq, int Sk, int D, int t_rows,
                              float scale, cudaStream_t stream) {
  int dev = 0, smem_limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  I360_DP_SWITCH(D, {
    const int TR = k6b_rows<DP>(BH, Sq, t_rows, smem_limit);
    const size_t smem = sizeof(float) * (k6b_fixed_floats<DP>() + TR * k6b_row_floats<DP>());
    const dim3 grid((BH + TR - 1) / TR, (Sq + K6B_BQ - 1) / K6B_BQ);
    auto kern = shared_bias_folded_kernel<float, TB, DP>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, K6B_NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                         (const TB*)bias, (float*)out, lse, BH, Sq, Sk, D, TR,
                                         scale);
  });
  return (int)cudaGetLastError();
}

constexpr int K6B_MMA_NW = 4;   // warps of a group: 64 query rows
constexpr int K6B_MAX_G = 2;    // groups (folded rows) of a block

// bf16 on the tensor cores: block (x, y) owns query tile y of the folded
// rows x*G .. x*G + G - 1; group gi of its warps takes row x*G + gi.
template <int DP, typename TB>
__global__ void __launch_bounds__(K6B_MAX_G * K6B_MMA_NW * 32, 1)
shared_bias_folded_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const TB* __restrict__ bias,
                              bf16* __restrict__ out, float* __restrict__ lse, int BH, int Sq,
                              int Sk, int D, int G, float scale, int vec, int bias_vec,
                              int kt_rows) {
  extern __shared__ __align__(16) unsigned char k6b_smem[];
  constexpr int BQ = 16 * K6B_MMA_NW;
  const int gi = threadIdx.x / (K6B_MMA_NW * 32);
  int bh = blockIdx.x * G + gi;
  const bool active = bh < BH;
  if (!active) bh = BH - 1;    // the ragged last group: same work, no stores
  const int q0 = blockIdx.y * BQ;
  const long qoff = ((long)bh * Sq + q0) * D;
  const long koff = (long)bh * Sk * D;
  // [bias stages][group 0 tiles][group 1 tiles]
  bf16* tiles = (bf16*)(k6b_smem + sizeof(TB) * 2 * BQ * kBiasLd) +
                (size_t)gi * (BQ + 4 * kt_rows) * (DP + 8);
  flash_tile_mma<DP, K6B_MMA_NW, true, false, TB>(
      q + qoff, k + koff, v + koff, active ? out + qoff : nullptr,
      lse == nullptr ? nullptr : lse + (long)bh * Sq + q0, bias + (long)q0 * Sk, bias_vec != 0,
      (long)D, min(BQ, Sq - q0), Sk, D, scale, vec != 0, kt_rows, tiles, (TB*)k6b_smem);
}

template <typename TB>
int launch_shared_bias_folded_mma(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, float* lse, int BH, int Sq,
                                  int Sk, int D, int t_rows, float scale, cudaStream_t stream) {
  constexpr int BQ = 16 * K6B_MMA_NW;
  int dev = 0, smem_limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int kt_rows = attn_mma_kt_rows(Sk);
  const int vec = attn_mma_vec(D, q, k, v, out);
  const int bias_vec = attn_mma_bias_vec(Sk, (const TB*)bias);
  const size_t bias_bytes = sizeof(TB) * 2 * BQ * kBiasLd;
  I360_DP_SWITCH(D, {
    const size_t group = attn_mma_smem_bytes<DP>(BQ, kt_rows);
    int G = t_rows < K6B_MAX_G ? t_rows : K6B_MAX_G;
    if (G > BH) G = BH;
    while (G > 1 && bias_bytes + G * group > (size_t)smem_limit) --G;
    const size_t smem = bias_bytes + G * group;
    const dim3 grid((BH + G - 1) / G, (Sq + BQ - 1) / BQ);
    auto kern = shared_bias_folded_mma_kernel<DP, TB>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, G * K6B_MMA_NW * 32, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const TB*)bias, (bf16*)out, lse, BH,
        Sq, Sk, D, G, scale, vec, bias_vec, kt_rows);
  });
  return (int)cudaGetLastError();
}

}  // namespace i360

// q [BH, Sq, D], k/v [BH, Sk, D], out [BH, Sq, D], bias [Sq, Sk], lse null
// or float [BH, Sq], all contiguous. dtype and bias_dtype: 0 = float32,
// 1 = bfloat16; bf16 q/k/v take the tensor cores. t_rows >= 1: the most
// folded rows one block takes under a bias tile (on the tensor cores at most
// K6B_MAX_G). Returns the cudaError_t of the launch.
extern "C" int i360_shared_bias_attention_folded(const void* q, const void* k, const void* v,
                                                 const void* bias, void* out, void* lse,
                                                 int BH, int Sq, int Sk, int D, int t_rows,
                                                 float scale, int dtype, int bias_dtype,
                                                 void* stream) {
  if (D > 160 || D < 1 || bias == nullptr || t_rows < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto lp = (float*)lse;
  using bf16 = __nv_bfloat16;
  if (dtype == 1 && bias_dtype == 1)
    return i360::launch_shared_bias_folded_mma<bf16>(q, k, v, bias, out, lp, BH, Sq, Sk, D,
                                                     t_rows, scale, s);
  if (dtype == 1)
    return i360::launch_shared_bias_folded_mma<float>(q, k, v, bias, out, lp, BH, Sq, Sk, D,
                                                      t_rows, scale, s);
  if (bias_dtype == 1)
    return i360::launch_shared_bias_folded<bf16>(q, k, v, bias, out, lp, BH, Sq, Sk, D, t_rows,
                                                 scale, s);
  return i360::launch_shared_bias_folded<float>(q, k, v, bias, out, lp, BH, Sq, Sk, D, t_rows,
                                                scale, s);
}
