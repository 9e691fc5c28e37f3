// K4: attention over the frame axis at every spatial location.
//
// Replaces imagine360_tpu/ops/pallas_attention.py:_striped_kernel (wrapper
// temporal_packed_attention), the AnimateDiff motion-module attention: for
// q/k/v [B, F, HW, C] with `heads` heads of D = C / heads, each (b, location,
// head) attends over its own F frames.
//
// What bounds it on the H100: F = 16 frames give 2*F*F*D multiply-adds per
// problem against 4*F*D elements moved, about 8 flops per bf16 byte: far
// below the card's ~295 flop/byte balance point, so it is memory bound and
// the aim is to read q/k/v and write the output once, in full sectors.
//
// Design: the TPU kernel packed G locations into one F*G-token sequence
// under a striped -1e9 bias so that the MXU saw large tiles. Here one block
// of 128 threads owns one (b, location, head) problem: it stages the
// [F, D] rows of q, k and v in shared memory (no head-dim padding, so
// D = 40 and 80 need no multiple of 16), computes the F x F logits, an exact
// softmax per row, and the F x D output. Problems are numbered head-fastest,
// so the blocks in flight read neighbouring heads of one location: adjacent
// bytes of the same rows.
#include "attn_common.cuh"

namespace i360 {

constexpr int K4_NT = 128;
constexpr int K4_MAX_F = 64;

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

template <typename T>
int launch_frame(const void* q, const void* k, const void* v, void* out, int B, int F, int HW,
                 int H, int D, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)3 * F * D + (size_t)F * F);
  auto kern = frame_attention_kernel<T>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const long blocks = (long)B * HW * H;
  kern<<<(unsigned)blocks, K4_NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                  (T*)out, F, HW, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace i360

// q/k/v/out [B, F, HW, H*D], contiguous. dtype 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch.
extern "C" int i360_frame_attention(const void* q, const void* k, const void* v, void* out,
                                    int B, int F, int HW, int H, int D, float scale, int dtype,
                                    void* stream) {
  if (F < 1 || F > i360::K4_MAX_F || D < 1 || D > 160) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (dtype == 1)
    return i360::launch_frame<__nv_bfloat16>(q, k, v, out, B, F, HW, H, D, scale, s);
  return i360::launch_frame<float>(q, k, v, out, B, F, HW, H, D, scale, s);
}
