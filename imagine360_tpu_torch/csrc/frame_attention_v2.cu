// L1: attention over the frame axis, a block owning packs of G neighbouring
// locations with all their heads.
//
// Replaces scripts/kernel_lab.py:_striped_v2_kernel (wrapper
// striped_v2_attention), the small-pack lab variant of the motion-module
// attention: for q/k/v [B, F, HW, C] with `heads` heads of D = C / heads,
// each (b, location, head) attends over its own F frames. The TPU kernel
// interleaves the G locations of a pack into one F*G-token sequence under a
// striped -1e9 bias and walks R packs in one grid step; the function is the
// per-location attention K4 computes.
//
// What bounds it on the H100: as for K4, about 8 flops per bf16 byte, so the
// memory: 4*B*F*HW*C elements moved once. A block reads the whole G*C-element
// run of every frame of a pack (G * 640 bytes at C = 320), each byte once and
// coalesced, and serves all G * heads problems from shared memory. It walks
// R such packs, so a grid of B * HW / (G * R) blocks trades launch
// granularity against blocks in flight.
//
// bf16 (the main path of the lab), on the tensor cores: K4's tile
// (frame_mma.cuh) under L1's ownership, HG = heads, so each pack is a whole
// location pack and block x walks packs x*R .. x*R + R - 1 of one batch row,
// as the float32 kernel does. Each frame of a pack is one contiguous G*C
// run, staged by 16-byte cp.async into zero-padded bf16 tiles (head columns
// to DP, a multiple of 16; frames to a multiple of 16); one (location, head)
// problem a warp: S = Q·Kᵀ by mma.sync.m16n8k16, an exact softmax of the
// whole row in registers (keys past F at the finite -1e30), P normalised and
// rounded once to bf16 into the A fragments of P·V, V by ldmatrix.trans, O
// into the warp's own consumed Q columns, then 16-byte stores. One stage
// (kernels.striped_v2_mma_plan): the next pack's copies start after this
// one's write-back, and the other blocks of the SM hide them. A second
// stage, the next pack in flight while this one computes, fits with as many
// blocks an SM only for single-location packs at C = 320, and was slower
// there than one stage by 7-12% on an H100 (G = 1, R = 8; slower still
// where it costs blocks). F <= 64, as for K4. Where D is no multiple of 8
// or a pointer is not 16-byte aligned the same tile stages and writes with
// 2-byte accesses.
//
// float32, on the CUDA cores: the block stages q, k and v of a pack as
// [F] rows of G*C elements in the storage type. The G * heads problems keep
// their own [F, F] logits (float, row stride F + 1) and nothing is computed
// off the stripe. The dots are register-tiled four query rows to one key
// (QK) and four query rows to one output column (PV): five shared-memory
// loads for four multiply-adds, where K4 pays eight; over an even head dim
// both walk two elements at a time (one 4-byte load for a pair, four rows to
// two output columns in PV), five loads for eight. Rows of q, k and v are
// padded to an odd number of 4-byte words, so the 16 keys a warp reads side
// by side fall into 16 banks; where the channel rows are whole 16-byte units
// they are staged 16 bytes a thread. The softmax is one thread per row.
#include "frame_mma.cuh"
#include "motion_common.cuh"

namespace i360 {

constexpr int V2_NT = 256;
constexpr size_t V2_SMEM_LIMIT = 232448;   // what one block may have on sm_90

template <typename T>
__global__ void __launch_bounds__(V2_NT)
striped_v2_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, int F, int HW, int H, int D, int G, int R, int RS,
                  float scale, bool vec, bool pair) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = H * D, GC = G * C, PL = F + 1;
  T* qs = reinterpret_cast<T*>(smem_raw);              // [F][RS]
  T* ks = qs + (size_t)F * RS;                         // [F][RS]
  T* vs = ks + (size_t)F * RS;                         // [F][RS]
  float* ps = reinterpret_cast<float*>(vs + (size_t)F * RS);   // [G*H][F][PL]
  const int groups = HW / G / R;                       // blocks per batch row
  const long b = blockIdx.x / groups;
  const int tg = blockIdx.x % groups;
  const long fstride = (long)HW * C;
  const int nIQ = (F + 3) / 4;                         // query-row quads
  const int tid = threadIdx.x;

  for (int r = 0; r < R; ++r) {
    const long base = (b * F * HW + (long)(tg * R + r) * G) * C;
    if (vec) {
      constexpr int EPU = 16 / (int)sizeof(T);         // elements of a 16-byte unit
      const int upr = GC / EPU;                        // units of one frame's run
      for (int u = tid; u < F * upr; u += V2_NT) {
        const int f = u / upr, col = (u - f * upr) * EPU;
        const long off = base + f * fstride + col;
        copy16(qs + f * RS + col, q + off);
        copy16(ks + f * RS + col, k + off);
        copy16(vs + f * RS + col, v + off);
      }
    } else {
      for (int f = 0; f < F; ++f) {
        const long off = base + f * fstride;
        for (int col = tid; col < GC; col += V2_NT) {
          qs[f * RS + col] = q[off + col];
          ks[f * RS + col] = k[off + col];
          vs[f * RS + col] = v[off + col];
        }
      }
    }
    __syncthreads();
    // logits: item = (problem p = g*H + h, row quad iq, key j), j fastest
    for (int it = tid; it < G * H * nIQ * F; it += V2_NT) {
      const int j = it % F, t2 = it / F;
      const int iq = t2 % nIQ, p = t2 / nIQ;
      const int i0 = iq * 4;
      const T* kr = ks + j * RS + p * D;
      const T* q0 = qs + min(i0, F - 1) * RS + p * D;
      const T* q1 = qs + min(i0 + 1, F - 1) * RS + p * D;
      const T* q2 = qs + min(i0 + 2, F - 1) * RS + p * D;
      const T* q3 = qs + min(i0 + 3, F - 1) * RS + p * D;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      if (pair) {
        for (int d = 0; d < D; d += 2) {
          const float2 kd = load2(kr + d);
          s0 = dot2(s0, load2(q0 + d), kd);
          s1 = dot2(s1, load2(q1 + d), kd);
          s2 = dot2(s2, load2(q2 + d), kd);
          s3 = dot2(s3, load2(q3 + d), kd);
        }
      } else {
        for (int d = 0; d < D; ++d) {
          const float kd = to_f(kr[d]);
          s0 += to_f(q0[d]) * kd;
          s1 += to_f(q1[d]) * kd;
          s2 += to_f(q2[d]) * kd;
          s3 += to_f(q3[d]) * kd;
        }
      }
      float* pr = ps + ((size_t)p * F + i0) * PL + j;
      pr[0] = s0 * scale;
      if (i0 + 1 < F) pr[PL] = s1 * scale;
      if (i0 + 2 < F) pr[2 * PL] = s2 * scale;
      if (i0 + 3 < F) pr[3 * PL] = s3 * scale;
    }
    __syncthreads();
    // exact softmax, one thread per row; probabilities rounded to T
    for (int row = tid; row < G * H * F; row += V2_NT) {
      float* pr = ps + (size_t)row * PL;
      float mx = pr[0];
      for (int j = 1; j < F; ++j) mx = fmaxf(mx, pr[j]);
      float sum = 0.f;
      for (int j = 0; j < F; ++j) {
        const float e = __expf(pr[j] - mx);
        pr[j] = e;
        sum += e;
      }
      const float inv = 1.f / sum;
      for (int j = 0; j < F; ++j) pr[j] = round_to<T>(pr[j] * inv);
    }
    __syncthreads();
    // PV: item = (row quad iq, column or column pair of the G*C run), columns
    // fastest, so a warp writes neighbouring output elements of one frame
    const int cstep = pair ? 2 : 1, ncols = GC / cstep;
    for (int it = tid; it < nIQ * ncols; it += V2_NT) {
      const int col = (it % ncols) * cstep, iq = it / ncols;
      const int p = col / D, i0 = iq * 4;
      const float* p0 = ps + ((size_t)p * F + min(i0, F - 1)) * PL;
      const float* p1 = ps + ((size_t)p * F + min(i0 + 1, F - 1)) * PL;
      const float* p2 = ps + ((size_t)p * F + min(i0 + 2, F - 1)) * PL;
      const float* p3 = ps + ((size_t)p * F + min(i0 + 3, F - 1)) * PL;
      T* o = out + base + i0 * fstride + col;
      if (pair) {
        float2 a0 = {0.f, 0.f}, a1 = a0, a2 = a0, a3 = a0;
        for (int j = 0; j < F; ++j) {
          const float2 vv = load2(vs + j * RS + col);
          a0.x += p0[j] * vv.x;
          a0.y += p0[j] * vv.y;
          a1.x += p1[j] * vv.x;
          a1.y += p1[j] * vv.y;
          a2.x += p2[j] * vv.x;
          a2.y += p2[j] * vv.y;
          a3.x += p3[j] * vv.x;
          a3.y += p3[j] * vv.y;
        }
        store2(o, a0.x, a0.y);
        if (i0 + 1 < F) store2(o + fstride, a1.x, a1.y);
        if (i0 + 2 < F) store2(o + 2 * fstride, a2.x, a2.y);
        if (i0 + 3 < F) store2(o + 3 * fstride, a3.x, a3.y);
      } else {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (int j = 0; j < F; ++j) {
          const float vv = to_f(vs[j * RS + col]);
          a0 += p0[j] * vv;
          a1 += p1[j] * vv;
          a2 += p2[j] * vv;
          a3 += p3[j] * vv;
        }
        o[0] = from_f<T>(a0);
        if (i0 + 1 < F) o[fstride] = from_f<T>(a1);
        if (i0 + 2 < F) o[2 * fstride] = from_f<T>(a2);
        if (i0 + 3 < F) o[3 * fstride] = from_f<T>(a3);
      }
    }
    __syncthreads();     // the next pack overwrites q, k, v and the logits
  }
}

template <typename T>
int launch_striped_v2(const void* q, const void* k, const void* v, void* out, int B, int F,
                      int HW, int H, int D, int G, int R, int RS, float scale,
                      cudaStream_t stream) {
  const size_t smem = sizeof(T) * 3 * F * (size_t)RS + sizeof(float) * G * H * F * (size_t)(F + 1);
  if (RS < G * H * D || (RS * sizeof(T)) % 4 != 0 || smem > V2_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  auto kern = striped_v2_kernel<T>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const long blocks = (long)B * (HW / G / R);
  kern<<<(unsigned)blocks, V2_NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                  (T*)out, F, HW, H, D, G, R, RS, scale,
                                                  runs_are_16_byte<T>(H * D, q, k, v),
                                                  pairs_are_aligned<T>(D, q, k, v, out));
  return (int)cudaGetLastError();
}

constexpr int L1_MMA_MAX_F = 64;   // frames of the tile: four 16-key tiles, as K4's

// bf16 on the tensor cores: K4's tile with HG = H (one head group) in one
// stage, block x walking packs x*R .. x*R + R - 1. The launch bounds ask for
// three blocks an SM, as K4's kernel does (at most 168 registers), but at
// DP = 144, where ptxas spilled L3's same one-stage body at 168: two there.
template <int DP>
__global__ void __launch_bounds__(K4_MMA_NW * 32, DP == 144 ? 2 : 3)
striped_v2_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out, int F, int HW, int H,
                      int D, int G, int R, int RS, long packs, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char l1_smem[];
  frame_mma_packs<DP, 1>(q, k, v, out, F, HW, H, D, G, H, R, RS, packs, scale, vec,
                         reinterpret_cast<bf16*>(l1_smem));
}

template <int DP>
int launch_striped_v2_mma_dp(const void* q, const void* k, const void* v, void* out, int B,
                             int F, int HW, int H, int D, int G, int R, float scale,
                             cudaStream_t stream) {
  const int FP = (F + 15) / 16 * 16;
  const int RS = k4_row_stride(G, H, DP);
  const size_t smem = sizeof(bf16) * 3 * (size_t)FP * RS;
  if (smem > V2_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const long packs = (long)B * (HW / G);
  auto kern = striped_v2_mma_kernel<DP>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<(unsigned)(packs / R), K4_MMA_NW * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, F, HW, H, D, G, R, RS, packs,
      scale, (int)attn_mma_vec(D, q, k, v, out));
  return (int)cudaGetLastError();
}

int launch_striped_v2_mma(const void* q, const void* k, const void* v, void* out, int B, int F,
                          int HW, int H, int D, int G, int R, float scale, cudaStream_t stream) {
  switch ((D + 15) / 16) {
#define I360_L1_CASE(N)                                                                \
  case N:                                                                              \
    return launch_striped_v2_mma_dp<16 * N>(q, k, v, out, B, F, HW, H, D, G, R, scale, \
                                            stream);
    I360_L1_CASE(1) I360_L1_CASE(2) I360_L1_CASE(3) I360_L1_CASE(4) I360_L1_CASE(5)
    I360_L1_CASE(6) I360_L1_CASE(7) I360_L1_CASE(8) I360_L1_CASE(9) I360_L1_CASE(10)
#undef I360_L1_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace i360

// q/k/v/out [B, F, HW, H*D], contiguous; HW % G == 0 and (HW / G) % R == 0.
// dtype 0 = float32 (the CUDA-core kernel; RS is the shared-memory row stride
// in elements: at least G*H*D, a whole number of 4-byte words, the caller
// makes that number odd), 1 = bfloat16 (the tensor cores, F <= 64; RS not
// read). Returns the cudaError_t of the launch.
extern "C" int i360_striped_v2_attention(const void* q, const void* k, const void* v, void* out,
                                         int B, int F, int HW, int H, int D, int G, int R,
                                         int RS, float scale, int dtype, void* stream) {
  if (F < 1 || D < 1 || D > 160 || G < 1 || R < 1 || HW % G != 0 || (HW / G) % R != 0)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (F > i360::L1_MMA_MAX_F) return (int)cudaErrorInvalidValue;
    return i360::launch_striped_v2_mma(q, k, v, out, B, F, HW, H, D, G, R, scale, s);
  }
  return i360::launch_striped_v2<float>(q, k, v, out, B, F, HW, H, D, G, R, RS, scale, s);
}
