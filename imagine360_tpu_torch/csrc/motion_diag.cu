// L3: attention over the frame axis with no bias at all, a block owning G
// neighbouring locations and walking their heads in groups.
//
// Replaces scripts/exp_motion_kernels.py:_diag_kernel (wrapper
// diag_motion_attention): K4's function for q/k/v [B, F, HW, C]. The TPU
// kernel takes the packed [G*F, G*F] product of a pack of G locations on the
// matrix unit, cuts out the G diagonal [F, F] blocks for an exact softmax
// with no -1e9 entries, and scatters the probabilities back for P V. Only the
// diagonal blocks carry the function; here nothing else is computed.
//
// What bounds it on the H100: memory, as for K4 (about 8 flops per bf16
// byte): q, k and v read once and the output written once, with enough
// bytes in flight.
//
// bf16 off the Hopper route (below), on the tensor cores: K4's tile
// (frame_mma.cuh) under L3's ownership. A block of 4 warps owns G
// neighbouring locations of one batch row and walks all their heads in
// groups of HG (kernels.diag_motion_mma_plan: the most heads whose q, k and v
// tiles let three blocks share an SM, else one head), staged with 16-byte
// cp.async copies into zero-padded bf16 tiles, in one stage: the other
// blocks of the SM hide the copies. (K4 runs the tile with a second stage,
// the next pack in flight while this one computes; for L3 one stage of
// twice the heads, as many blocks an SM, was faster at every motion site on
// an H100.) Each warp takes (location, head) problems: S = Q·Kᵀ by mma.sync.m16n8k16, an exact softmax of the
// whole row in registers (keys past F at the finite -1e30), P normalised and
// rounded once to bf16 into the A fragments of P·V, V by ldmatrix.trans, O
// into the warp's own consumed Q columns, then 16-byte stores; no block
// barrier inside a head group. Where D is no multiple of 8 or a pointer is
// not 16-byte aligned the same tile stages and writes with 2-byte accesses.
//
// float32, on the CUDA cores: the block stages q, k and v of a head group
// as [G][F] rows of HG*D elements in the storage type, each global run HG*D
// elements long and neighbouring locations neighbouring in memory, rows
// padded to an odd number of 4-byte words (kernels.diag_motion_plan: two
// blocks an SM where they fit). Then every warp takes (location, head)
// problems on its own: for F <= 32 a lane owns one (query row, key) logit of
// a pass in a register, 32 / Fp rows per pass (Fp = F rounded up to a power
// of two), the row's max and sum by shuffles inside the Fp lanes. The
// probabilities go through a warp-private [F][F] float tile to P V,
// register-tiled four rows to one head-dim element (over an even head dim
// both products walk two elements at a time).
//
// bf16 at 16 frames with D % 8 == 0 and 16-byte-aligned pointers
// (kernels.diag_route: every bf16 launch of the lab), the Hopper body:
// diag_motion_tma_kernel, K4's persistent TMA ring of frame_tma.cuh
// (frame_tma_body<NG, PACKED>) under L3's ownership. What held the
// `mma.sync` tile back here is what held K4's back: every thread issued
// cp.async copies, in one stage, so a block's copies waited for its own
// products and only the other blocks of the SM hid them, at about 8
// operations a byte. Here a persistent block takes packs of G neighbouring
// locations of one batch row (packs blockIdx.x, + gridDim.x, ...), as the
// TPU kernel's grid step holds one pack, and streams each pack through a
// ring of S stages as items of SG locations x HG heads (SG dividing G, head
// group fastest; SG and HG from kernels.diag_tma_plan, the item within
// FRAME_TMA_ITEM_BYTES a tensor), one producer thread issuing one TMA box
// of each of q, k and v an item; NW consumer warps take the problems in
// turn on mma.sync + ldmatrix and write each problem's output by a TMA
// store. The products are K4's in K4's order, so the output equals K4's
// Hopper body (and its mma.sync tile) bit for bit.
#include "frame_mma.cuh"
#include "frame_tma.cuh"
#include "motion_common.cuh"

namespace i360 {

constexpr int L3_MAX_F = 32;
constexpr int L3_MAX_WARPS = 8;
constexpr size_t L3_SMEM_LIMIT = 232448;   // what one block may have on sm_90

template <typename T>
__global__ void __launch_bounds__(L3_MAX_WARPS * 32)
diag_motion_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ out, int F, int Fp, int HW, int H, int D, int G, int HG,
                   int RS, float scale, bool vec, bool pair) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = G * F;
  T* qs = reinterpret_cast<T*>(smem_raw);              // [G][F][RS]
  T* ks = qs + (size_t)rows * RS;
  T* vs = ks + (size_t)rows * RS;
  float* ps = reinterpret_cast<float*>(vs + (size_t)rows * RS);   // [warps][F][F]
  const int packs = HW / G;
  const int t = blockIdx.x % packs;
  const long b = blockIdx.x / packs;
  const long C = (long)H * D;
  const long fstride = (long)HW * C;
  const long base = (b * F * HW + (long)t * G) * C;    // frame 0, location t*G, channel 0
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = blockDim.x >> 5;
  const int rpp = 32 / Fp;                             // query rows per pass
  const int j = lane % Fp, sub = lane / Fp;
  const int nIQ = (F + 3) / 4;
  float* pw = ps + (size_t)warp * F * F;

  for (int h0 = 0; h0 < H; h0 += HG) {
    const int hg = min(HG, H - h0), W = hg * D;
    __syncthreads();      // the previous head group's readers are done
    constexpr int EPU = 16 / (int)sizeof(T);           // elements of a 16-byte unit
    const int step = vec ? EPU : 1, upr = W / step;    // copies of one (location, frame) run
    for (int u = tid; u < rows * upr; u += nthreads) {
      const int fg = u / upr, col = (u - fg * upr) * step;
      const int g = fg % G, f = fg / G;
      const long off = base + f * fstride + g * C + (long)h0 * D + col;
      const int dst = (g * F + f) * RS + col;
      if (vec) {
        copy16(qs + dst, q + off);
        copy16(ks + dst, k + off);
        copy16(vs + dst, v + off);
      } else {
        qs[dst] = q[off];
        ks[dst] = k[off];
        vs[dst] = v[off];
      }
    }
    __syncthreads();
    for (int prob = warp; prob < G * hg; prob += nwarps) {
      const int hh = prob % hg, g = prob / hg;
      const T* qp = qs + (size_t)g * F * RS + hh * D;
      const T* kp = ks + (size_t)g * F * RS + hh * D;
      const T* vp = vs + (size_t)g * F * RS + hh * D;
      const T* kr = kp + min(j, F - 1) * RS;
      for (int i0 = 0; i0 < F; i0 += rpp) {
        const int i = i0 + sub;
        const bool valid = i < F && j < F;
        const T* qr = qp + min(i, F - 1) * RS;
        float s = 0.f;
        if (pair) {
          for (int d = 0; d < D; d += 2) s = dot2(s, load2(qr + d), load2(kr + d));
        } else {
          for (int d = 0; d < D; ++d) s += to_f(qr[d]) * to_f(kr[d]);
        }
        s = valid ? s * scale : kNegInf;
        float mx = s;
        for (int o = Fp >> 1; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float e = valid ? __expf(s - mx) : 0.f;
        float sum = e;
        for (int o = Fp >> 1; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (valid) pw[i * F + j] = round_to<T>(e / sum);
      }
      __syncwarp();
      const int dstep = pair ? 2 : 1, nd = D / dstep;
      for (int it = lane; it < nIQ * nd; it += 32) {
        const int d = (it % nd) * dstep, r0 = (it / nd) * 4;
        const float* p0 = pw + min(r0, F - 1) * F;
        const float* p1 = pw + min(r0 + 1, F - 1) * F;
        const float* p2 = pw + min(r0 + 2, F - 1) * F;
        const float* p3 = pw + min(r0 + 3, F - 1) * F;
        T* o = out + base + r0 * fstride + g * C + (long)(h0 + hh) * D + d;
        if (pair) {
          float2 a0 = {0.f, 0.f}, a1 = a0, a2 = a0, a3 = a0;
          for (int jj = 0; jj < F; ++jj) {
            const float2 vv = load2(vp + jj * RS + d);
            a0.x += p0[jj] * vv.x;
            a0.y += p0[jj] * vv.y;
            a1.x += p1[jj] * vv.x;
            a1.y += p1[jj] * vv.y;
            a2.x += p2[jj] * vv.x;
            a2.y += p2[jj] * vv.y;
            a3.x += p3[jj] * vv.x;
            a3.y += p3[jj] * vv.y;
          }
          store2(o, a0.x, a0.y);
          if (r0 + 1 < F) store2(o + fstride, a1.x, a1.y);
          if (r0 + 2 < F) store2(o + 2 * fstride, a2.x, a2.y);
          if (r0 + 3 < F) store2(o + 3 * fstride, a3.x, a3.y);
        } else {
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
          for (int jj = 0; jj < F; ++jj) {
            const float vv = to_f(vp[jj * RS + d]);
            a0 += p0[jj] * vv;
            a1 += p1[jj] * vv;
            a2 += p2[jj] * vv;
            a3 += p3[jj] * vv;
          }
          o[0] = from_f<T>(a0);
          if (r0 + 1 < F) o[fstride] = from_f<T>(a1);
          if (r0 + 2 < F) o[2 * fstride] = from_f<T>(a2);
          if (r0 + 3 < F) o[3 * fstride] = from_f<T>(a3);
        }
      }
      __syncwarp();       // the next problem overwrites this warp's tile
    }
  }
}

template <typename T>
int launch_diag_motion(const void* q, const void* k, const void* v, void* out, int B, int F,
                       int HW, int H, int D, int G, int HG, int RS, int warps, float scale,
                       cudaStream_t stream) {
  int Fp = 1;
  while (Fp < F) Fp <<= 1;
  const size_t smem = sizeof(T) * 3 * G * F * (size_t)RS + sizeof(float) * warps * F * (size_t)F;
  if (RS < HG * D || (RS * sizeof(T)) % 4 != 0 || smem > L3_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  auto kern = diag_motion_kernel<T>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const long blocks = (long)B * (HW / G);
  kern<<<(unsigned)blocks, warps * 32, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                       (T*)out, F, Fp, HW, H, D, G, HG, RS,
                                                       scale, runs_are_16_byte<T>(D, q, k, v),
                                                       pairs_are_aligned<T>(D, q, k, v, out));
  return (int)cudaGetLastError();
}

// bf16 on the tensor cores: block x owns location pack x (of B * HW / G)
// and walks its H / HG head groups in one stage of shared memory. The
// launch bounds ask for three blocks an SM, as K4's kernel does (at most
// 168 registers), but at DP = 144, where ptxas spilled 4 bytes at 168 under
// one stage (an H100 build; no motion site has a head dim in 129..144): two
// blocks there.
template <int DP>
__global__ void __launch_bounds__(K4_MMA_NW * 32, DP == 144 ? 2 : 3)
diag_motion_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int F, int HW, int H,
                       int D, int G, int HG, int RS, long packs, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char l3_smem[];
  frame_mma_packs<DP, 1>(q, k, v, out, F, HW, H, D, G, HG, H / HG, RS, packs, scale, vec,
                         reinterpret_cast<bf16*>(l3_smem));
}

template <int DP>
int launch_diag_motion_mma_dp(const void* q, const void* k, const void* v, void* out, int B,
                              int F, int HW, int H, int D, int G, int HG, float scale,
                              cudaStream_t stream) {
  const int FP = (F + 15) / 16 * 16;
  const int RS = k4_row_stride(G, HG, DP);
  const size_t smem = sizeof(bf16) * 3 * (size_t)FP * RS;
  if (smem > L3_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const long packs = (long)B * (HW / G) * (H / HG);
  auto kern = diag_motion_mma_kernel<DP>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<(unsigned)(B * (HW / G)), K4_MMA_NW * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, F, HW, H, D, G, HG, RS, packs,
      scale, (int)attn_mma_vec(D, q, k, v, out));
  return (int)cudaGetLastError();
}

int launch_diag_motion_mma(const void* q, const void* k, const void* v, void* out, int B, int F,
                           int HW, int H, int D, int G, int HG, float scale,
                           cudaStream_t stream) {
  switch ((D + 15) / 16) {
#define I360_L3_CASE(N)                                                                  \
  case N:                                                                                \
    return launch_diag_motion_mma_dp<16 * N>(q, k, v, out, B, F, HW, H, D, G, HG, scale, \
                                             stream);
    I360_L3_CASE(1) I360_L3_CASE(2) I360_L3_CASE(3) I360_L3_CASE(4) I360_L3_CASE(5)
    I360_L3_CASE(6) I360_L3_CASE(7) I360_L3_CASE(8) I360_L3_CASE(9) I360_L3_CASE(10)
#undef I360_L3_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// bf16 at 16 frames on the Hopper body: one instantiation per head dim
// D = 8·NG, as K4's.
template <int NG>
__global__ void __launch_bounds__(kFtThreads, 1)
diag_motion_tma_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mo, int B, int HW, int H, int SG,
                       int HG, int S, int NW, float sl2, int G) {
  extern __shared__ __align__(128) unsigned char l3_tma_smem[];
  frame_tma_body<NG, true>(&mq, &mk, &mv, &mo, B, HW, H, SG, HG, S, NW, sl2, l3_tma_smem, G);
}

}  // namespace i360

// bf16 q/k/v/out [B, 16, HW, H*D], contiguous, on the Hopper body where
// kernels.diag_route says so: F = 16, D a multiple of 8 up to 160,
// 16-byte-aligned pointers; packs of G locations (HW % G == 0), items of
// SG locations (G % SG == 0) x HG heads (H % HG == 0), S stages, NW consumer warps,
// `bps` blocks an SM, from kernels.diag_tma_plan. Returns the cudaError_t
// of the launch; anything else it refuses with cudaErrorInvalidValue and
// launches nothing.
extern "C" int i360_diag_motion_attention_tma(const void* q, const void* k, const void* v,
                                              void* out, int B, int F, int HW, int H, int D,
                                              int G, int SG, int HG, int S, int NW, int bps,
                                              float scale, void* stream) {
  if (F != i360::kFtF || D < 8 || D > 160 || D % 8 != 0 || G < 1 || HW % G != 0 || SG < 1 ||
      G % SG != 0)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  switch (D / 8) {
#define I360_L3_TMA_CASE(N)                                                                  \
  case N:                                                                                    \
    return i360::launch_frame_tma<N>(i360::diag_motion_tma_kernel<N>, q, k, v, out, B, HW, H, \
                                     SG, HG, S, NW, bps, scale, s, G);
    I360_L3_TMA_CASE(1) I360_L3_TMA_CASE(2) I360_L3_TMA_CASE(3) I360_L3_TMA_CASE(4)
    I360_L3_TMA_CASE(5) I360_L3_TMA_CASE(6) I360_L3_TMA_CASE(7) I360_L3_TMA_CASE(8)
    I360_L3_TMA_CASE(9) I360_L3_TMA_CASE(10) I360_L3_TMA_CASE(11) I360_L3_TMA_CASE(12)
    I360_L3_TMA_CASE(13) I360_L3_TMA_CASE(14) I360_L3_TMA_CASE(15) I360_L3_TMA_CASE(16)
    I360_L3_TMA_CASE(17) I360_L3_TMA_CASE(18) I360_L3_TMA_CASE(19) I360_L3_TMA_CASE(20)
#undef I360_L3_TMA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// q/k/v/out [B, F, HW, H*D], contiguous, F <= 32, HW % G == 0, heads staged
// HG at a time (H % HG == 0 in bfloat16). dtype 0 = float32 (the CUDA-core
// kernel: `warps` warps, 1..8, RS the shared-memory row stride in elements,
// at least HG*D, a whole number of 4-byte words), 1 = bfloat16 (the
// tensor cores; RS and warps not read).
// Returns the cudaError_t of the launch.
extern "C" int i360_diag_motion_attention(const void* q, const void* k, const void* v, void* out,
                                          int B, int F, int HW, int H, int D, int G, int HG,
                                          int RS, int warps, float scale, int dtype,
                                          void* stream) {
  if (F < 1 || F > i360::L3_MAX_F || D < 1 || D > 160 || G < 1 || HW % G != 0 || HG < 1 ||
      HG > H)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (H % HG != 0) return (int)cudaErrorInvalidValue;
    return i360::launch_diag_motion_mma(q, k, v, out, B, F, HW, H, D, G, HG, scale, s);
  }
  if (warps < 1 || warps > i360::L3_MAX_WARPS) return (int)cudaErrorInvalidValue;
  return i360::launch_diag_motion<float>(q, k, v, out, B, F, HW, H, D, G, HG, RS, warps, scale,
                                         s);
}
