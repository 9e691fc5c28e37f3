// K4: attention over the frame axis at every spatial location.
//
// Replaces imagine360_tpu/ops/pallas_attention.py:_striped_kernel (wrapper
// temporal_packed_attention), the AnimateDiff motion-module attention: for
// q/k/v [B, F, HW, C] with `heads` heads of D = C / heads, each (b, location,
// head) attends over its own F frames; the probabilities are normalised,
// rounded once to the storage type and multiplied by V with float32 sums.
//
// What bounds it on the H100: F = 16 frames give 2*F*F*D multiply-adds per
// problem against 4*F*D elements moved, about 8 flops per bf16 byte: far
// below the card's ~295 flop/byte balance point, so it is memory bound and
// the aim is to read q/k/v and write the output once, in full sectors, with
// enough bytes in flight.
//
// bf16 at 16 frames, a head dim that is a multiple of 8 and 16-byte-aligned
// pointers (kernels.frame_route: every motion-module launch of the models):
// the Hopper body of frame_tma.cuh (frame_attention_tma_kernel, C entry
// i360_frame_attention_tma), which says what it does and why.
//
// bf16 otherwise, on the tensor cores (the tile of frame_mma.cuh, which
// L3, motion_diag.cu, shares under its own ownership): a block of 4 warps owns a pack
// of G neighbouring locations of one batch row with HG of their heads (all
// of them where the pack fits; the host's plan, kernels.frame_attention_plan,
// picks G, HG and the R packs a block walks from the shared memory a block
// may use). Per frame the pack is one contiguous run of G * HG * D elements
// when HG is every head (else G runs of HG * D), read once with 16-byte
// cp.async copies into bf16 tiles [FP][RS] of q, k and v, each head's D
// columns padded with zeros to DP (a multiple of 16) and the frames to FP (a
// multiple of 16); RS / 8 is odd, so the eight 16-byte rows an ldmatrix reads
// fall into distinct banks. The tiles are double-buffered: the next pack's
// copies are in flight while this one computes and writes back. Each warp
// takes one (location, head) problem at a time and 16 query frames at a time:
// S = Q·Kᵀ by mma.sync.m16n8k16 over DP / 16 k-steps and up to four 16-key
// tiles (F <= 64), keys past F at the finite -1e30, an exact softmax of the
// whole row in registers (no online rescaling), P normalised and rounded
// once to bf16 into the A fragments of P·V without leaving the registers,
// O = P·V over DP / 8 column tiles (V by ldmatrix.trans). The warp stores O
// into its own, already consumed, Q columns; after a block barrier the pack's
// output leaves with 16-byte stores, one run per frame as it came in. Where D
// is no multiple of 8 or a pointer is not 16-byte aligned, the same body
// stages and writes back with 2-byte accesses. Locations past HW (a ragged
// last pack) are zero-filled and not written.
//
// float32: one block of 128 threads per (b, location, head) problem on the
// CUDA cores: the [F, D] rows of q, k and v in float shared memory, the F x F
// logits, an exact softmax per row and the F x D output. Problems are
// numbered head-fastest, so the blocks in flight read neighbouring heads of
// one location: adjacent bytes of the same rows.
#include "frame_mma.cuh"
#include "frame_tma.cuh"

namespace i360 {

constexpr int K4_NT = 128;
constexpr int K4_MAX_F = 64;
constexpr int K4_MMA_BLOCKS = 3;   // bf16 blocks an SM holds (shared memory)

template <typename T>
__global__ void __launch_bounds__(K4_NT)
frame_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int F, int HW, int H,
                       int D, float scale) {
  extern __shared__ float smem[];
  const int FD = F * D;
  float* qs = smem;        // [F][D]
  float* ks = qs + FD;     // [F][D]
  float* vs = ks + FD;     // [F][D]
  float* ps = vs + FD;     // [F][F]
  const long p = blockIdx.x;
  const int h = (int)(p % H);
  const long bl = p / H;
  const int loc = (int)(bl % HW);
  const long b = bl / HW;
  const long C = (long)H * D;
  const long fstride = (long)HW * C;
  const long base = (b * F * HW + loc) * C + (long)h * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int idx = tid; idx < FD; idx += K4_NT) {
    const int f = idx / D, d = idx - f * D;
    const long off = base + f * fstride + d;
    qs[idx] = to_f(q[off]);
    ks[idx] = to_f(k[off]);
    vs[idx] = to_f(v[off]);
  }
  __syncthreads();
  for (int idx = tid; idx < F * F; idx += K4_NT) {
    const int i = idx / F, j = idx - i * F;
    const float* qr = qs + i * D;
    const float* kr = ks + j * D;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
    ps[idx] = s * scale;
  }
  __syncthreads();
  for (int i = warp; i < F; i += K4_NT / 32) {
    float* row = ps + i * F;
    float mx = kNegInf;
    for (int j = lane; j < F; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < F; j += 32) {
      const float e = __expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const float inv = 1.f / sum;
    for (int j = lane; j < F; j += 32) row[j] = round_to<T>(row[j] * inv);
  }
  __syncthreads();
  for (int idx = tid; idx < FD; idx += K4_NT) {
    const int i = idx / D, d = idx - i * D;
    const float* prow = ps + i * F;
    float a = 0.f;
    for (int j = 0; j < F; ++j) a += prow[j] * vs[j * D + d];
    out[base + i * fstride + d] = from_f<T>(a);
  }
}

int launch_frame(const void* q, const void* k, const void* v, void* out, int B, int F, int HW,
                 int H, int D, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)3 * F * D + (size_t)F * F);
  auto kern = frame_attention_kernel<float>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const long blocks = (long)B * HW * H;
  kern<<<(unsigned)blocks, K4_NT, smem, stream>>>((const float*)q, (const float*)k,
                                                  (const float*)v, (float*)out, F, HW, H, D,
                                                  scale);
  return (int)cudaGetLastError();
}

// bf16 on the tensor cores (the tile of frame_mma.cuh, two stages).
// Shared memory: two stages of the q, k and v tiles, [stage][tensor][FP][RS]
// bf16: at the motion sites 63-75 KB, so three blocks an SM. The launch
// bounds ask for those three, so at most 170 registers a thread: with no
// minimum ptxas traded registers for more occupancy and spilled (DP = 48,
// 112, 128), with a minimum of one it took 183 at DP = 160, two blocks an SM.
template <int DP>
__global__ void __launch_bounds__(K4_MMA_NW * 32, K4_MMA_BLOCKS)
frame_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out, int F, int HW,
                           int H, int D, int G, int HG, int R, int RS, long packs, float scale,
                           int vec) {
  extern __shared__ __align__(16) unsigned char k4_smem[];
  frame_mma_packs<DP, 2>(q, k, v, out, F, HW, H, D, G, HG, R, RS, packs, scale, vec,
                         reinterpret_cast<bf16*>(k4_smem));
}

template <int DP>
int launch_frame_mma_dp(const void* q, const void* k, const void* v, void* out, int B, int F,
                        int HW, int H, int D, int G, int HG, int R, float scale,
                        cudaStream_t stream) {
  const int FP = (F + 15) / 16 * 16;
  const int RS = k4_row_stride(G, HG, DP);
  const size_t smem = sizeof(bf16) * 6 * (size_t)FP * RS;
  int dev = 0, smem_limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)smem_limit) return (int)cudaErrorInvalidValue;
  const long packs = (long)B * ((HW + G - 1) / G) * (H / HG);
  const long blocks = (packs + R - 1) / R;
  const int vec = attn_mma_vec(D, q, k, v, out);
  auto kern = frame_attention_mma_kernel<DP>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<(unsigned)blocks, K4_MMA_NW * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, F, HW, H, D, G, HG, R, RS,
      packs, scale, vec);
  return (int)cudaGetLastError();
}

int launch_frame_mma(const void* q, const void* k, const void* v, void* out, int B, int F,
                     int HW, int H, int D, int G, int HG, int R, float scale,
                     cudaStream_t stream) {
  switch ((D + 15) / 16) {
#define I360_K4_CASE(N) \
  case N: return launch_frame_mma_dp<16 * N>(q, k, v, out, B, F, HW, H, D, G, HG, R, scale, stream);
    I360_K4_CASE(1) I360_K4_CASE(2) I360_K4_CASE(3) I360_K4_CASE(4) I360_K4_CASE(5)
    I360_K4_CASE(6) I360_K4_CASE(7) I360_K4_CASE(8) I360_K4_CASE(9) I360_K4_CASE(10)
#undef I360_K4_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// bf16 at 16 frames on the Hopper body (frame_tma.cuh): a persistent grid,
// a TMA ring of q/k/v items, per-problem TMA stores; one instantiation per
// head dim D = 8·NG.
template <int NG>
__global__ void __launch_bounds__(kFtThreads, 1)
frame_attention_tma_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mo, int B, int HW, int H, int G,
                           int HG, int S, int NW, float sl2) {
  extern __shared__ __align__(128) unsigned char k4_tma_smem[];
  frame_tma_body<NG>(&mq, &mk, &mv, &mo, B, HW, H, G, HG, S, NW, sl2, k4_tma_smem);
}

}  // namespace i360

// q/k/v/out [B, F, HW, H*D], contiguous. dtype 0 = float32 (the CUDA-core
// kernel; G, HG and R are not read), 1 = bfloat16 (the tensor cores: packs
// of G locations x HG heads, H % HG == 0, R packs a block, from
// kernels.frame_attention_plan). Returns the cudaError_t of the launch.
extern "C" int i360_frame_attention(const void* q, const void* k, const void* v, void* out,
                                    int B, int F, int HW, int H, int D, float scale, int dtype,
                                    int G, int HG, int R, void* stream) {
  if (F < 1 || F > i360::K4_MAX_F || D < 1 || D > 160) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (G < 1 || HG < 1 || H % HG != 0 || R < 1) return (int)cudaErrorInvalidValue;
    return i360::launch_frame_mma(q, k, v, out, B, F, HW, H, D, G, HG, R, scale, s);
  }
  return i360::launch_frame(q, k, v, out, B, F, HW, H, D, scale, s);
}

// bf16 q/k/v/out [B, 16, HW, H*D], contiguous, on the Hopper body
// (frame_tma.cuh) where kernels.frame_route says so: F = 16, D a multiple
// of 8 up to 160, 16-byte-aligned pointers; items of G locations x HG heads
// (H % HG == 0), S stages, NW consumer warps, `bps` blocks an SM, from
// kernels.frame_tma_plan. Returns the cudaError_t of the launch; anything
// else it refuses with cudaErrorInvalidValue and launches nothing.
extern "C" int i360_frame_attention_tma(const void* q, const void* k, const void* v, void* out,
                                        int B, int F, int HW, int H, int D, float scale, int G,
                                        int HG, int S, int NW, int bps, void* stream) {
  if (F != i360::kFtF || D < 8 || D > 160 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  switch (D / 8) {
#define I360_K4_TMA_CASE(N)                                                                  \
  case N:                                                                                    \
    return i360::launch_frame_tma<N>(i360::frame_attention_tma_kernel<N>, q, k, v, out, B, HW, \
                                     H, G, HG, S, NW, bps, scale, s);
    I360_K4_TMA_CASE(1) I360_K4_TMA_CASE(2) I360_K4_TMA_CASE(3) I360_K4_TMA_CASE(4)
    I360_K4_TMA_CASE(5) I360_K4_TMA_CASE(6) I360_K4_TMA_CASE(7) I360_K4_TMA_CASE(8)
    I360_K4_TMA_CASE(9) I360_K4_TMA_CASE(10) I360_K4_TMA_CASE(11) I360_K4_TMA_CASE(12)
    I360_K4_TMA_CASE(13) I360_K4_TMA_CASE(14) I360_K4_TMA_CASE(15) I360_K4_TMA_CASE(16)
    I360_K4_TMA_CASE(17) I360_K4_TMA_CASE(18) I360_K4_TMA_CASE(19) I360_K4_TMA_CASE(20)
#undef I360_K4_TMA_CASE
  }
  return (int)cudaErrorInvalidValue;
}
