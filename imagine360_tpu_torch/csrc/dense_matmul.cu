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
// bf16, below the 295 of the tensor cores: bytes bound, about 0.25 ms. This
// first kernel runs its products on the CUDA cores in float and is far from
// either bound.
//
// Design: the TPU kernel walked K on a sequential grid axis with a VMEM
// accumulator and asked for tile-divisible N. Here a block of 256 threads
// owns a 128 x 128 output tile and loops over K in slabs of 16: both slabs
// are staged in shared memory as float, k-major, so that in the inner loop a
// thread reads 8 values of x and 8 of w and does 64 multiply-adds into
// registers. A thread's 8 x 8 outputs are strided by 16 in both directions,
// so neighbouring threads read neighbouring shared-memory words. The weight
// comes through a pair of strides: [M, K] row-major as nn.Linear stores it
// (x @ w^T, no transposed copy per call) or [K, M]. Ragged N, K and M are
// masked in the loads and the stores; the host pads nothing. bf16 products
// are exact in float, and float inputs are multiplied in full float: TF32
// is not used.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace i360 {

constexpr int K7_BN = 128;   // rows of x per block
constexpr int K7_BM = 128;   // output columns per block
constexpr int K7_BK = 16;    // slab of the contraction axis
constexpr int K7_NT = 256;
constexpr int K7_TH = 8;     // outputs per thread in each direction
constexpr int K7_LDN = K7_BN + 1;
constexpr int K7_LDM = K7_BM + 1;

__device__ __forceinline__ float k7_to_f(float x) { return x; }
__device__ __forceinline__ float k7_to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void k7_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void k7_store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// w element (k, m) is w[k * ws_k + m * ws_m].
template <typename T>
__global__ void __launch_bounds__(K7_NT)
dense_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                    int N, int K, int M, long ws_k, long ws_m) {
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
      if (n0 + r < N && k0 + c < K) val = k7_to_f(x[(n0 + r) * K + k0 + c]);
      xs[c * K7_LDN + r] = val;
    }
    if (ws_k == 1) {        // [M, K]: as above
      for (int idx = tid; idx < K7_BM * K7_BK; idx += K7_NT) {
        const int r = idx / K7_BK, c = idx - r * K7_BK;
        float val = 0.f;
        if (m0 + r < M && k0 + c < K) val = k7_to_f(w[(long)(m0 + r) * ws_m + k0 + c]);
        wsm[c * K7_LDM + r] = val;
      }
    } else {                // [K, M]: the output column is contiguous
      for (int idx = tid; idx < K7_BM * K7_BK; idx += K7_NT) {
        const int c = idx / K7_BM, r = idx - c * K7_BM;
        float val = 0.f;
        if (m0 + r < M && k0 + c < K) val = k7_to_f(w[(long)(k0 + c) * ws_k + (m0 + r) * ws_m]);
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
      if (m < M) k7_store(out + n * M + m, acc[i][j]);
    }
  }
}

template <typename T>
int launch_dense_matmul(const void* x, const void* w, void* out, int N, int K, int M,
                        long ws_k, long ws_m, cudaStream_t stream) {
  const dim3 grid((N + K7_BN - 1) / K7_BN, (M + K7_BM - 1) / K7_BM);
  dense_matmul_kernel<T><<<grid, K7_NT, 0, stream>>>((const T*)x, (const T*)w, (T*)out, N, K,
                                                     M, ws_k, ws_m);
  return (int)cudaGetLastError();
}

}  // namespace i360

// x [N, K] and out [N, M] contiguous; w element (k, m) at w[k * ws_k +
// m * ws_m] (strides in elements: (1, K) for an [M, K] weight, (M, 1) for a
// [K, M] one). dtype 0 = float32, 1 = bfloat16. Returns the cudaError_t of
// the launch.
extern "C" int i360_dense_matmul(const void* x, const void* w, void* out, int N, int K, int M,
                                 long ws_k, long ws_m, int dtype, void* stream) {
  if (N < 1 || K < 1 || M < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (dtype == 1)
    return i360::launch_dense_matmul<__nv_bfloat16>(x, w, out, N, K, M, ws_k, ws_m, s);
  return i360::launch_dense_matmul<float>(x, w, out, N, K, M, ws_k, ws_m, s);
}
