// K7: token matmul, out[N, M] = x[N, K] @ w, float accumulation over K and
// one cast to x's dtype at the end.
//
// Replaces imagine360_tpu/ops/pallas_dense.py:_matmul_kernel (wrapper
// _pallas_matmul, reached through dense_matmul from models/layers.py:MMDense
// under the opt-in `pallas_dense` switch).
//
// What bounds it on the H100: 2*N*K*M operations against (N*K + K*M + N*M)
// elements. At the projection sites of the spatial transformers and motion
// modules (N = 655,360 tokens, K = M = 320) that is 160 operations a byte in
// bf16, below the 295 of the tensor cores: bytes bound, about 0.25 ms; at
// K = M = 640 and 1280 bound by operations.
//
// Design: the TPU kernel walked K on a sequential grid axis with a VMEM
// accumulator and asked for tile-divisible N. Here a block owns an output
// tile and loops over K in slabs; the host pads nothing, ragged N, K and M
// are masked in the loads and the stores. The weight comes through a pair
// of strides: [M, K] row-major as nn.Linear stores it (x @ w^T, no
// transposed copy per call) or [K, M].
// bf16 (the main path): a tensor-core GEMM on `mma.sync.m16n8k16` bf16
// fragments with float32 accumulators (attn_mma.cuh's primitives). A block
// of 8 warps owns a 128 x 128 output tile, each warp 64 rows x 32 columns
// (4 x 4 mma tiles, 64 accumulators a thread). K slabs of 64 are staged by
// 16-byte cp.async in three stages, two slabs in flight while one is
// multiplied, in bf16 rows padded by 8 elements so that the eight rows of an
// ldmatrix fall into distinct banks (108 KB a block). Two blocks an SM: the
// launch bounds hold a thread to 128 registers, and the k-step and staging
// loops stay rolled so that neither layout spills. On the H100 one block an
// SM (more registers) and K slabs of 32 were both slower at every
// production site. A fragments come from the x tile by
// plain ldmatrix; B fragments from an [M, K] weight tile by plain ldmatrix
// (rows of K contiguous are the `.col` B layout) and from a [K, M] tile by
// ldmatrix.trans. Ragged rows and columns are zero-filled by cp.async with
// source size 0. Where K (for an [M, K] weight, M) is no multiple of 8 or a
// pointer is not 16-byte aligned (the ragged site has K = 77), the slabs
// are staged with 2-byte loads instead, in the same kernel. The epilogue
// stages the bf16 tile in the pipeline's shared memory and writes it with
// 16-byte stores, or 2-byte ones where M is no multiple of 8. The column
// tiles of one row tile are neighbours in the grid, so the blocks in flight
// that read one 128-row slice of x run together and x comes from memory
// about once, the other column tiles finding it in L2 (x is 419 MB at the
// largest site, the weight at most 3.3 MB).
// float32: the CUDA-core loop below. A block of 256 threads owns a 128 x 128
// output tile and loops over K in slabs of 16 staged in shared memory as
// float, k-major, so that in the inner loop a thread reads 8 values of x and
// 8 of w and does 64 multiply-adds into registers; a thread's 8 x 8 outputs
// are strided by 16 in both directions, so neighbouring threads read
// neighbouring shared-memory words. Float inputs are multiplied in full
// float: TF32 is not used.
#include "attn_mma.cuh"

namespace i360 {

constexpr int K7_BN = 128;   // rows of x per block
constexpr int K7_BM = 128;   // output columns per block
constexpr int K7_BK = 16;    // slab of the contraction axis (float32)
constexpr int K7_NT = 256;
constexpr int K7_TH = 8;     // outputs per thread in each direction
constexpr int K7_LDN = K7_BN + 1;
constexpr int K7_LDM = K7_BM + 1;

// w element (k, m) is w[k * ws_k + m * ws_m].
__global__ void __launch_bounds__(K7_NT)
dense_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int N, int K, int M, long ws_k, long ws_m) {
  __shared__ float xs[K7_BK * K7_LDN];   // [k][row]
  __shared__ float wsm[K7_BK * K7_LDM];  // [k][col]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long n0 = (long)blockIdx.x * K7_BN;
  const int m0 = blockIdx.y * K7_BM;

  float acc[K7_TH][K7_TH];
#pragma unroll
  for (int i = 0; i < K7_TH; ++i)
#pragma unroll
    for (int j = 0; j < K7_TH; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += K7_BK) {
    // x slab: the contraction axis is contiguous in memory, so it is the
    // fastest index of the load
    for (int idx = tid; idx < K7_BN * K7_BK; idx += K7_NT) {
      const int r = idx / K7_BK, c = idx - r * K7_BK;
      float val = 0.f;
      if (n0 + r < N && k0 + c < K) val = x[(n0 + r) * K + k0 + c];
      xs[c * K7_LDN + r] = val;
    }
    if (ws_k == 1) {        // [M, K]: as above
      for (int idx = tid; idx < K7_BM * K7_BK; idx += K7_NT) {
        const int r = idx / K7_BK, c = idx - r * K7_BK;
        float val = 0.f;
        if (m0 + r < M && k0 + c < K) val = w[(long)(m0 + r) * ws_m + k0 + c];
        wsm[c * K7_LDM + r] = val;
      }
    } else {                // [K, M]: the output column is contiguous
      for (int idx = tid; idx < K7_BM * K7_BK; idx += K7_NT) {
        const int c = idx / K7_BM, r = idx - c * K7_BM;
        float val = 0.f;
        if (m0 + r < M && k0 + c < K) val = w[(long)(k0 + c) * ws_k + (m0 + r) * ws_m];
        wsm[c * K7_LDM + r] = val;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < K7_BK; ++kk) {
      float a[K7_TH], b[K7_TH];
#pragma unroll
      for (int i = 0; i < K7_TH; ++i) a[i] = xs[kk * K7_LDN + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < K7_TH; ++j) b[j] = wsm[kk * K7_LDM + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < K7_TH; ++i)
#pragma unroll
        for (int j = 0; j < K7_TH; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < K7_TH; ++i) {
    const long n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < K7_TH; ++j) {
      const int m = m0 + tx + 16 * j;
      if (m < M) out[n * M + m] = acc[i][j];
    }
  }
}

constexpr int K7_MMA_BN = 128;   // rows of x per block
constexpr int K7_MMA_BM = 128;   // output columns per block
constexpr int K7_MMA_BK = 64;    // slab of the contraction axis
constexpr int K7_MMA_NW = 8;     // warps: 2 x 4, each 64 rows x 32 columns
constexpr int K7_MMA_STAGES = 3;
constexpr int K7_MMA_MIN_BLOCKS = 2;   // blocks an SM the launch bounds ask for
constexpr int K7_LDA = K7_MMA_BK + 8;    // bf16 a staged x row, and an [M, K] weight row
constexpr int K7_LDBT = K7_MMA_BM + 8;   // bf16 a staged [K, M] weight row
constexpr int K7_LDO = K7_MMA_BM + 8;    // bf16 a staged output row

// Shared memory of one block: three stages of the x slab and the weight
// slab (128 x 72 bf16 for an [M, K] weight, 64 x 136 for a [K, M] one; the
// larger), the output tile reusing them.
__host__ __device__ constexpr size_t k7_stage_elems() {
  return (size_t)K7_MMA_BN * K7_LDA +
         (K7_MMA_BM * K7_LDA > K7_MMA_BK * K7_LDBT ? K7_MMA_BM * K7_LDA
                                                   : K7_MMA_BK * K7_LDBT);
}
constexpr size_t k7_mma_smem_bytes() {
  return sizeof(bf16) * K7_MMA_STAGES * k7_stage_elems();
}
static_assert(K7_MMA_BN * K7_LDO <= K7_MMA_STAGES * k7_stage_elems(),
              "the output tile fits the pipeline's shared memory");

// Stage `rows` x `cols` bf16 elements of a row-major matrix (row stride
// `ld`, `src` at the slab's first element) into a [rows][LDT] tile;
// elements at row >= nr or column >= nc become 0. `vec`: 16-byte cp.async
// copies (ld and nc multiples of 8 where nc < cols, 16-byte-aligned rows;
// the caller commits), else 2-byte loads and stores.
template <int ROWS, int COLS, int LDT>
__device__ __forceinline__ void k7_stage(bf16* dst, const bf16* src, long ld, int nr, int nc,
                                         bool vec) {
  if (vec) {
    constexpr int CPR = COLS / 8;
#pragma unroll 1
    for (int idx = threadIdx.x; idx < ROWS * CPR; idx += K7_MMA_NW * 32) {
      const int r = idx / CPR, c = idx - r * CPR;
      const bool ok = r < nr && c * 8 < nc;
      cp_async16(smem_u32(dst + r * LDT + c * 8), ok ? src + (long)r * ld + c * 8 : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * COLS; idx += K7_MMA_NW * 32) {
      const int r = idx / COLS, c = idx - r * COLS;
      dst[r * LDT + c] = (r < nr && c < nc) ? src[(long)r * ld + c] : __float2bfloat16(0.f);
    }
  }
}

// bf16 on the tensor cores. W_MK: the weight is [M, K] with row stride
// `ldw` (w[m * ldw + k]), else [K, M] (w[k * ldw + m]). `vec_x`, `vec_w`:
// 16-byte staging of x and of the weight; `vec_o`: 16-byte output stores.
// Block index = row tile x column tiles + column tile.
template <bool W_MK>
__global__ void __launch_bounds__(K7_MMA_NW * 32, K7_MMA_MIN_BLOCKS)
dense_matmul_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        bf16* __restrict__ out, int N, int K, int M, long ldw, int vec_x,
                        int vec_w, int vec_o) {
  extern __shared__ __align__(16) unsigned char k7_smem[];
  bf16* smem = (bf16*)k7_smem;
  constexpr int STAGE = (int)k7_stage_elems();
  const int nmt = (M + K7_MMA_BM - 1) / K7_MMA_BM;
  const long n0 = (long)(blockIdx.x / nmt) * K7_MMA_BN;
  const int m0 = (blockIdx.x % nmt) * K7_MMA_BM;
  const int nr = (int)min((long)K7_MMA_BN, N - n0), nm = min(K7_MMA_BM, M - m0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = (warp >> 2) * 64, wc = (warp & 3) * 32;   // this warp's rows and columns
  const int g = lane >> 2, tg = lane & 3;
  const int nslabs = (K + K7_MMA_BK - 1) / K7_MMA_BK;
  const bf16* xb = x + n0 * K;

  // the x and weight slabs at k0 into stage st
  auto stage = [&](int st, int k0) {
    bf16* sA = smem + st * STAGE;
    bf16* sB = sA + K7_MMA_BN * K7_LDA;
    const int nk = min(K7_MMA_BK, K - k0);
    k7_stage<K7_MMA_BN, K7_MMA_BK, K7_LDA>(sA, xb + k0, K, nr, nk, vec_x != 0);
    if (W_MK)
      k7_stage<K7_MMA_BM, K7_MMA_BK, K7_LDA>(sB, w + (long)m0 * ldw + k0, ldw, nm, nk,
                                             vec_w != 0);
    else
      k7_stage<K7_MMA_BK, K7_MMA_BM, K7_LDBT>(sB, w + (long)k0 * ldw + m0, ldw, nk, nm,
                                              vec_w != 0);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < K7_MMA_STAGES - 1; ++s) {
    if (s < nslabs) stage(s, s * K7_MMA_BK);
    cp_async_commit();   // an empty group past the last slab keeps the count
  }
  for (int t = 0; t < nslabs; ++t) {
    cp_async_wait<K7_MMA_STAGES - 2>();   // slab t has landed
    __syncthreads();                      // ... for every thread; slab t - 1 is done
    const int tn = t + K7_MMA_STAGES - 1;
    if (tn < nslabs) stage(tn % K7_MMA_STAGES, tn * K7_MMA_BK);
    cp_async_commit();
    const bf16* sA = smem + (t % K7_MMA_STAGES) * STAGE;
    const bf16* sB = sA + K7_MMA_BN * K7_LDA;
#pragma unroll 1   // unrolled, the next k-step's fragments raise the registers past 128
    for (int ks = 0; ks < K7_MMA_BK / 16; ++ks) {
      // the warp's 32 columns of this k-step as B, then its 64 rows one
      // 16-row A fragment at a time (registers: 64 accumulators, 8 of B, 4
      // of A)
      uint32_t b[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        if (W_MK)   // [m][k] rows: the `.col` B layout as it lies
          ldsm_x4(r, smem_u32(sB + (wc + p * 16 + (lane & 7) + ((lane >> 4) << 3)) * K7_LDA +
                              ks * 16 + ((lane >> 3) & 1) * 8));
        else        // [k][m] rows: transposed on the way
          ldsm_x4_trans(r, smem_u32(sB + (ks * 16 + (lane & 15)) * K7_LDBT + wc + p * 16 +
                                    (lane >> 4) * 8));
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t a[4];
        ldsm_x4(a, smem_u32(sA + (wr + i * 16 + (lane & 15)) * K7_LDA + ks * 16 +
                            (lane >> 4) * 8));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the stages: the output tile takes them

  bf16* sO = smem;   // [BN][K7_LDO]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<__nv_bfloat162*>(sO + (wr + i * 16 + g + hr * 8) * K7_LDO + wc +
                                           j * 8 + tg * 2) =
            __floats2bfloat162_rn(acc[i][j][hr * 2], acc[i][j][hr * 2 + 1]);
  __syncthreads();
  bf16* ob = out + n0 * M + m0;
  if (vec_o) {
    constexpr int CPR = K7_MMA_BM / 8;
    for (int idx = threadIdx.x; idx < nr * CPR; idx += K7_MMA_NW * 32) {
      const int r = idx / CPR, c = idx - r * CPR;
      if (c * 8 < nm)
        *reinterpret_cast<uint4*>(ob + (long)r * M + c * 8) =
            *reinterpret_cast<const uint4*>(sO + r * K7_LDO + c * 8);
    }
  } else {
    for (int idx = threadIdx.x; idx < nr * K7_MMA_BM; idx += K7_MMA_NW * 32) {
      const int r = idx / K7_MMA_BM, c = idx - r * K7_MMA_BM;
      if (c < nm) ob[(long)r * M + c] = sO[r * K7_LDO + c];
    }
  }
}

int launch_dense_matmul_mma(const void* x, const void* w, void* out, int N, int K, int M,
                            long ws_k, long ws_m, cudaStream_t stream) {
  const bool w_mk = ws_k == 1;
  const long ldw = w_mk ? ws_m : ws_k;
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec_x = K % 8 == 0 && aligned(x);
  const int vec_w = (w_mk ? K : M) % 8 == 0 && ldw % 8 == 0 && aligned(w);
  const int vec_o = M % 8 == 0 && aligned(out);
  const unsigned blocks = (unsigned)(((long)N + K7_MMA_BN - 1) / K7_MMA_BN *
                                     ((M + K7_MMA_BM - 1) / K7_MMA_BM));
  const size_t smem = k7_mma_smem_bytes();
  auto kern = w_mk ? dense_matmul_mma_kernel<true> : dense_matmul_mma_kernel<false>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<blocks, K7_MMA_NW * 32, smem, stream>>>((const bf16*)x, (const bf16*)w, (bf16*)out, N,
                                                 K, M, ldw, vec_x, vec_w, vec_o);
  return (int)cudaGetLastError();
}

int launch_dense_matmul(const void* x, const void* w, void* out, int N, int K, int M,
                        long ws_k, long ws_m, cudaStream_t stream) {
  const dim3 grid((N + K7_BN - 1) / K7_BN, (M + K7_BM - 1) / K7_BM);
  dense_matmul_kernel<<<grid, K7_NT, 0, stream>>>((const float*)x, (const float*)w,
                                                  (float*)out, N, K, M, ws_k, ws_m);
  return (int)cudaGetLastError();
}

}  // namespace i360

// x [N, K] and out [N, M] contiguous; w element (k, m) at w[k * ws_k +
// m * ws_m] (strides in elements: (1, K) for an [M, K] weight, (M, 1) for a
// [K, M] one; bf16 takes these two layouts, any row stride). dtype 0 =
// float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor cores). Returns
// the cudaError_t of the launch.
extern "C" int i360_dense_matmul(const void* x, const void* w, void* out, int N, int K, int M,
                                 long ws_k, long ws_m, int dtype, void* stream) {
  if (N < 1 || K < 1 || M < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (ws_k != 1 && ws_m != 1) return (int)cudaErrorInvalidValue;
    return i360::launch_dense_matmul_mma(x, w, out, N, K, M, ws_k, ws_m, s);
  }
  return i360::launch_dense_matmul(x, w, out, N, K, M, ws_k, ws_m, s);
}
