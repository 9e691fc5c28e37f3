// L2: attention of a pack of G neighbouring locations as one G*F-token
// sequence under a caller's additive bias.
//
// Replaces scripts/exp_motion_kernels.py:_fused_kernel (wrapper
// fused_motion_attention): for q/k/v [B, F, HW, C] in their natural layout,
// the G locations of a pack form one sequence of S = G*F tokens in block
// order (row g*F + f), and every head attends over all S keys under
// bias[0, row, key] (float32 or bfloat16, widened to float). With the
// block-diagonal bias of ops/motion_lab.py:block_diag_bias that equals K4's
// per-location attention; with any other bias it is another function, so the
// bias is read as an operand and no tile is skipped. With `exp_bf16` the
// exponent s - max is rounded to bfloat16, the exponential is rounded to
// bfloat16, the denominator sums those probabilities in float and the
// division comes after P V.
//
// What bounds it on the H100: it does G times K4's arithmetic by design
// (4*S*S*D operations per head and pack: 0.43 TFLOP at the lab site, 0.43 ms
// of the bf16 tensor cores, against 0.50 ms for its bytes), and every head
// reads the whole [S, S] bias (1 MB in float at S = 512): at D = 40 a 4-byte
// bias element carries 160 operations a head.
//
// bf16 off the Hopper route (below: exp_bf16 and the head dims it does not
// take), D <= 160, on the tensor cores: the
// streaming body of attn_mma.cuh (flash_tile_mma, as K3 and K6b run it)
// with the pack's rows gathered (its ROWS argument, pack_rows below, which
// also selects the exp_bf16 rounding). A block owns one 64-row query tile
// of one pack for HB heads (kernels.fused_motion_mma_plan: 2, or 1 at head
// dim 160 where two do not fit), one group of 4 warps a head, each warp 16
// query rows. Per 64-key tile the block stages one [64, 64] bias tile in
// its own dtype, which all HB heads read, and each group its K and V rows; row g*F + f of a head is D contiguous elements at
// f*HW*C + g*C + h*D from the pack's origin, so Q, K and V rows are copied
// with 16-byte cp.async from those addresses into tiles of D padded with
// zero columns to DP (16, 32, 48, 64, 80, 96, 128 or 160), two stages, the
// next tile's copies in flight (2-byte accesses where D is no multiple of 8
// or a pointer is not 16-byte aligned). S = Q·Kᵀ and P·V on mma.sync
// m16n8k16, O written back through the warp's own Q rows to the gathered
// addresses with 16-byte stores. The query tiles and head groups of a pack
// are the fastest grid axes, so a pack's K and V come from L2 after their
// first read; the [S, S] bias is the same for every block and stays in L2.
// Softmax without exp_bf16: the body's online softmax per key tile in log2
// units, P rounded once to bf16 (the plain version rounds the normalised
// probabilities; the kernel rounds them before the division, as K1-K3 do).
// With exp_bf16 the plain version's roundings need each row's final max, so
// a first pass over the key tiles computes Q·Kᵀ + bias for the max alone
// (K and bias tiles only, a third of the work), and the second pass takes
// bf16(exp(bf16(s - max))) against that max, sums those probabilities in
// float, multiplies them unchanged by V and divides at the end. Rounding
// against a running max instead would round other numbers than the plain
// version does.
//
// float32, on the CUDA cores (checked against the plain version to 1e-4):
// one block of 512 threads per (batch row, pack, head). It stages the head's
// K and V [S][D] once, rows padded to an odd number of 4-byte words. The
// [S, S] logits do not fit shared memory, so the block walks the query rows
// in tiles of 16: a [16][S + 1] float tile of logits, an exact two-pass
// softmax with one warp per row, then P V. Both products are register-tiled
// four query rows to one key or output column (over an even head dim two
// elements at a time). A tile's P V has only 4 * D such items (2 * D with
// pairs), so the keys are cut into JS slices that are summed side by side
// and added up through shared memory in a fixed order. The bias tile comes
// from global memory, rows read coalesced.
#include <math_constants.h>

//
// bf16 at head dims 40, 80 and 160 without exp_bf16 (kernels.fused_wgmma_route:
// every such launch of the lab), the Hopper body of motion_wgmma.cuh
// (fused_motion_wgmma_kernel, one per head dim and bias dtype), which says
// what it does and why: TMA tiles in packed row order, T (pack, head) row
// slots of a 128-row query tile under each [128, 64] bias tile, wgmma
// products, the softmax under the previous slot's P·V. exp_bf16 and the
// other bf16 calls keep the mma.sync body above.
#include "attn_mma.cuh"
#include "motion_common.cuh"
#include "motion_wgmma.cuh"

namespace i360 {

constexpr int L2_NT = 512;
constexpr int L2_BQ = 16;
constexpr int L2_MAX_JS = 8;
constexpr size_t L2_SMEM_LIMIT = 232448;   // what one block may have on sm_90

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__global__ void __launch_bounds__(L2_NT)
fused_motion_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const void* __restrict__ bias, T* __restrict__ out, int F, int HW, int H,
                    int D, int G, int RS, int JS, float scale, int bias_bf16, int exp_bf16,
                    bool vec, bool pair) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = G * F, PL = S + 1;
  T* ks = reinterpret_cast<T*>(smem_raw);              // [S][RS]
  T* vs = ks + (size_t)S * RS;                         // [S][RS]
  T* qs = vs + (size_t)S * RS;                         // [BQ][RS]
  float* ps = reinterpret_cast<float*>(qs + (size_t)L2_BQ * RS);   // [BQ][PL]
  float* den = ps + (size_t)L2_BQ * PL;                // [BQ]
  float* part = den + L2_BQ;                           // [JS][BQ][D]
  const int packs = HW / G;
  const int h = blockIdx.x % H;
  const int t = (blockIdx.x / H) % packs;
  const long b = blockIdx.x / ((long)H * packs);
  const long C = (long)H * D;
  const long fstride = (long)HW * C;
  // element (row g*F + f, d) of this block's head lives at base + f*fstride + g*C + d
  const long base = (b * F * HW + (long)t * G) * C + (long)h * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* bias_f = static_cast<const float*>(bias);
  const __nv_bfloat16* bias_h = static_cast<const __nv_bfloat16*>(bias);

  constexpr int EPU = 16 / (int)sizeof(T);             // elements of a 16-byte unit
  const int step = vec ? EPU : 1, upr = D / step;      // copies of one row
  for (int u = tid; u < S * upr; u += L2_NT) {
    const int row = u / upr, d = (u - row * upr) * step;
    const long off = base + (row % F) * fstride + (row / F) * C + d;
    if (vec) {
      copy16(ks + row * RS + d, k + off);
      copy16(vs + row * RS + d, v + off);
    } else {
      ks[row * RS + d] = k[off];
      vs[row * RS + d] = v[off];
    }
  }

  for (int r0 = 0; r0 < S; r0 += L2_BQ) {
    const int nq = min(L2_BQ, S - r0);
    __syncthreads();      // K and V staged; the previous tile's readers are done
    // rows past the sequence's end repeat its last row; nothing of them is kept
    for (int u = tid; u < L2_BQ * upr; u += L2_NT) {
      const int i = u / upr, d = (u - i * upr) * step, row = min(r0 + i, S - 1);
      const long off = base + (row % F) * fstride + (row / F) * C + d;
      if (vec) copy16(qs + i * RS + d, q + off);
      else qs[i * RS + d] = q[off];
    }
    __syncthreads();
    // logits: item = (row quad iq, key j), j fastest
    for (int it = tid; it < (L2_BQ / 4) * S; it += L2_NT) {
      const int j = it % S, i0 = (it / S) * 4;
      const T* kr = ks + j * RS;
      const T* qr = qs + i0 * RS;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      if (pair) {
        for (int d = 0; d < D; d += 2) {
          const float2 kd = load2(kr + d);
          s0 = dot2(s0, load2(qr + d), kd);
          s1 = dot2(s1, load2(qr + RS + d), kd);
          s2 = dot2(s2, load2(qr + 2 * RS + d), kd);
          s3 = dot2(s3, load2(qr + 3 * RS + d), kd);
        }
      } else {
        for (int d = 0; d < D; ++d) {
          const float kd = to_f(kr[d]);
          s0 += to_f(qr[d]) * kd;
          s1 += to_f(qr[RS + d]) * kd;
          s2 += to_f(qr[2 * RS + d]) * kd;
          s3 += to_f(qr[3 * RS + d]) * kd;
        }
      }
      const float sv[4] = {s0, s1, s2, s3};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i0 + u < nq) {
          const long bi = (long)(r0 + i0 + u) * S + j;
          const float bv = bias_bf16 ? __bfloat162float(bias_h[bi]) : bias_f[bi];
          ps[(i0 + u) * PL + j] = sv[u] * scale + bv;
        }
      }
    }
    __syncthreads();
    // exact softmax over all S keys, one warp per row
    for (int i = warp; i < nq; i += L2_NT / 32) {
      float* pr = ps + (size_t)i * PL;
      float mx = -CUDART_INF_F;
      for (int j = lane; j < S; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      float sum = 0.f;
      if (exp_bf16) {
        for (int j = lane; j < S; j += 32) {
          const float e = round_bf16(expf(round_bf16(pr[j] - mx)));
          pr[j] = e;          // a bfloat16 value: exact in either storage type
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) den[i] = sum;
      } else {
        for (int j = lane; j < S; j += 32) {
          const float e = __expf(pr[j] - mx);
          pr[j] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        const float inv = 1.f / sum;
        for (int j = lane; j < S; j += 32) pr[j] = round_to<T>(pr[j] * inv);
        if (lane == 0) den[i] = 1.f;
      }
    }
    __syncthreads();
    // PV: item = (key slice js, row quad, head-dim element or pair d), d fastest
    const int dstep = pair ? 2 : 1, nd = D / dstep;
    for (int it = tid; it < JS * (L2_BQ / 4) * nd; it += L2_NT) {
      const int d = (it % nd) * dstep, t2 = it / nd;
      const int i0 = (t2 % (L2_BQ / 4)) * 4, js = t2 / (L2_BQ / 4);
      const int j0 = (int)((long)S * js / JS), j1 = (int)((long)S * (js + 1) / JS);
      const float* pr = ps + (size_t)i0 * PL;
      float* pp = part + ((size_t)js * L2_BQ + i0) * D + d;
      if (pair) {
        float2 a0 = {0.f, 0.f}, a1 = a0, a2 = a0, a3 = a0;
        for (int j = j0; j < j1; ++j) {
          const float2 vv = load2(vs + j * RS + d);
          a0.x += pr[j] * vv.x;
          a0.y += pr[j] * vv.y;
          a1.x += pr[PL + j] * vv.x;
          a1.y += pr[PL + j] * vv.y;
          a2.x += pr[2 * PL + j] * vv.x;
          a2.y += pr[2 * PL + j] * vv.y;
          a3.x += pr[3 * PL + j] * vv.x;
          a3.y += pr[3 * PL + j] * vv.y;
        }
        store2(pp, a0.x, a0.y);
        store2(pp + D, a1.x, a1.y);
        store2(pp + 2 * D, a2.x, a2.y);
        store2(pp + 3 * D, a3.x, a3.y);
      } else {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (int j = j0; j < j1; ++j) {
          const float vv = to_f(vs[j * RS + d]);
          a0 += pr[j] * vv;
          a1 += pr[PL + j] * vv;
          a2 += pr[2 * PL + j] * vv;
          a3 += pr[3 * PL + j] * vv;
        }
        pp[0] = a0;
        pp[D] = a1;
        pp[2 * D] = a2;
        pp[3 * D] = a3;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < nq * D; idx += L2_NT) {
      const int d = idx % D, i = idx / D, row = r0 + i;
      float a = 0.f;
      for (int js = 0; js < JS; ++js) a += part[((size_t)js * L2_BQ + i) * D + d];
      out[base + (row % F) * fstride + (row / F) * C + d] = from_f<T>(a / den[i]);
    }
  }
}

template <typename T>
int launch_fused_motion(const void* q, const void* k, const void* v, const void* bias,
                        void* out, int B, int F, int HW, int H, int D, int G, int RS,
                        float scale, int bias_bf16, int exp_bf16, cudaStream_t stream) {
  const size_t S = (size_t)G * F;
  // key slices of P V: as many as fill the block with (row quad, d) items
  const bool pair = pairs_are_aligned<T>(D, q, k, v, out);
  int JS = L2_NT / ((L2_BQ / 4) * (pair ? D / 2 : D));
  JS = JS > L2_MAX_JS ? L2_MAX_JS : JS;
  JS = JS > (int)S ? (int)S : JS;
  JS = JS < 1 ? 1 : JS;
  const size_t smem = sizeof(T) * (2 * S + L2_BQ) * RS +
                      sizeof(float) * L2_BQ * (S + 2 + (size_t)JS * D);
  if (RS < D || (RS * sizeof(T)) % 4 != 0 || smem > L2_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  auto kern = fused_motion_kernel<T>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const long blocks = (long)B * (HW / G) * H;
  kern<<<(unsigned)blocks, L2_NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, bias,
                                                  (T*)out, F, HW, H, D, G, RS, JS, scale,
                                                  bias_bf16, exp_bf16,
                                                  runs_are_16_byte<T>(D, q, k, v), pair);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int L2_MMA_NW = 4;                 // warps of a head's group
constexpr int L2_MMA_BQ = 16 * L2_MMA_NW;    // query rows of a block
constexpr int L2_MMA_GT = 32 * L2_MMA_NW;    // threads of a group

// Heads (groups) a block takes at most: 2, 256 threads, so up to 255
// registers a thread. On an H100 two heads a block beat one (the shared bias
// tile), and four, one block of 16 warps an SM, were slower than two blocks
// of two.
constexpr int L2_MMA_MAX_HB = 2;

// flash_tile_mma's gathered rows for a pack: sequence row r = g*F + f
// (frame f of the pack's location g) at f*fstride + g*C from the pack's
// frame 0, location 0; the query tile starts at row q0. EXP: the exp_bf16
// rounding, a template argument so that each softmax compiles without the
// other's branches.
template <bool EXP>
struct pack_rows {
  static constexpr bool gathered = true;
  static constexpr bool exp_bf16 = EXP;
  int F;
  long fstride, C;
  int q0;
  __device__ __forceinline__ long operator()(int r) const {
    const int g = r / F;
    return (long)(r - g * F) * fstride + g * C;
  }
};

// Block x: query tile x % nqt, head group (x / nqt) % (H / HB), pack
// (x / (nqt * H / HB)) % (HW / G), batch row x / (nqt * H / HB * HW / G);
// group gi of its warps takes head (head group) * HB + gi. Shared memory:
// [bias stages][group 0: Q, 2 K stages, 2 V stages][group 1]...
template <int DP, typename TB, bool EXP>
__global__ void __launch_bounds__(L2_MMA_MAX_HB * L2_MMA_GT, 1)
fused_motion_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const TB* __restrict__ bias,
                        bf16* __restrict__ out, int F, int HW, int H, int D, int G, float scale,
                        int vec, int bias_vec) {
  extern __shared__ __align__(16) unsigned char l2_smem[];
  constexpr int BQ = L2_MMA_BQ;
  const int HB = blockDim.x / L2_MMA_GT;
  const int S = G * F, nqt = (S + BQ - 1) / BQ, nhb = H / HB, packs = HW / G;
  long bx = blockIdx.x;
  const int qt = (int)(bx % nqt);
  bx /= nqt;
  const int hb = (int)(bx % nhb);
  bx /= nhb;
  const int t = (int)(bx % packs);
  const long b = bx / packs;
  const int gi = threadIdx.x / L2_MMA_GT;
  const long C = (long)H * D;
  // frame 0, location 0 of the pack, this group's head
  const long base = (b * F * HW + (long)t * G) * C + (long)(hb * HB + gi) * D;
  const int q0 = qt * BQ;
  const pack_rows<EXP> rows{F, (long)HW * C, C, q0};
  TB* sbias = reinterpret_cast<TB*>(l2_smem);          // 2 stages of [BQ][kBiasLd]
  bf16* tiles = reinterpret_cast<bf16*>(l2_smem + sizeof(TB) * 2 * BQ * kBiasLd) +
                (size_t)gi * (BQ + 4 * kMmaBK) * (DP + 8);
  flash_tile_mma<DP, L2_MMA_NW, false, false, TB, pack_rows<EXP>>(
      q + base, k + base, v + base, out + base, nullptr, bias + (long)q0 * S, bias_vec != 0, 0,
      min(BQ, S - q0), S, D, scale, vec != 0, kMmaBK, tiles, sbias, 0, 0, rows);
}

template <int DP, typename TB>
int launch_fused_motion_mma_dp(const void* q, const void* k, const void* v, const void* bias,
                               void* out, int B, int F, int HW, int H, int D, int G, int HB,
                               float scale, int exp_bf16, cudaStream_t stream) {
  constexpr int BQ = L2_MMA_BQ;
  if (HB < 1 || HB > L2_MMA_MAX_HB || H % HB != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(TB) * 2 * BQ * kBiasLd + HB * attn_mma_smem_bytes<DP>(BQ, kMmaBK);
  if (smem > L2_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int S = G * F;
  const long blocks = (long)B * (HW / G) * (H / HB) * ((S + BQ - 1) / BQ);
  auto kern = exp_bf16 ? fused_motion_mma_kernel<DP, TB, true>
                       : fused_motion_mma_kernel<DP, TB, false>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<(unsigned)blocks, HB * L2_MMA_GT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const TB*)bias, (bf16*)out, F, HW, H, D,
      G, scale, (int)attn_mma_vec(D, q, k, v, out),
      (int)attn_mma_bias_vec(S, (const TB*)bias));
  return (int)cudaGetLastError();
}

// Head dims padded to the next of 16, 32, 48, 64, 80, 96, 128, 160 (the
// motion modules' 40, 80 and 160 waste no k-step).
int launch_fused_motion_mma(const void* q, const void* k, const void* v, const void* bias,
                            void* out, int B, int F, int HW, int H, int D, int G, int HB,
                            float scale, int exp_bf16, int bias_bf16, cudaStream_t stream) {
#define I360_L2_CASE(DPV)                                                                     \
  if (D <= DPV)                                                                               \
    return bias_bf16 ? launch_fused_motion_mma_dp<DPV, bf16>(q, k, v, bias, out, B, F, HW, H, \
                                                              D, G, HB, scale, exp_bf16,      \
                                                              stream)                         \
                     : launch_fused_motion_mma_dp<DPV, float>(q, k, v, bias, out, B, F, HW, H, \
                                                               D, G, HB, scale, exp_bf16,     \
                                                               stream);
  I360_L2_CASE(16) I360_L2_CASE(32) I360_L2_CASE(48) I360_L2_CASE(64)
  I360_L2_CASE(80) I360_L2_CASE(96) I360_L2_CASE(128) I360_L2_CASE(160)
#undef I360_L2_CASE
  return (int)cudaErrorInvalidValue;
}

// bf16 on the Hopper body (motion_wgmma.cuh): block index ((batch row x
// packs + pack) x head groups + head group) x query tiles + query tile.
template <int D, typename TB>
__global__ void __launch_bounds__(kWgThreads, 1)
fused_motion_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mo,
                          const __grid_constant__ CUtensorMap mb, int F, int HW, int H, int G,
                          float scale) {
  extern __shared__ __align__(1024) unsigned char l2_wg_smem[];
  fused_wgmma_body<D, TB>(&mq, &mk, &mv, &mo, &mb, F, HW, H, G, scale, l2_wg_smem);
}

template <int D>
int launch_fused_motion_wgmma_d(const void* q, const void* k, const void* v, const void* bias,
                                void* out, int B, int F, int HW, int H, int G, float scale,
                                int bias_bf16, cudaStream_t stream) {
  return bias_bf16
             ? launch_fused_wgmma<D, bf16>(fused_motion_wgmma_kernel<D, bf16>, q, k, v, bias, out,
                                           B, F, HW, H, G, scale, stream)
             : launch_fused_wgmma<D, float>(fused_motion_wgmma_kernel<D, float>, q, k, v, bias,
                                            out, B, F, HW, H, G, scale, stream);
}

}  // namespace i360

// bf16 q/k/v/out [B, F, HW, H*D], contiguous, on the Hopper body where
// kernels.fused_wgmma_route says so: D of 40, 80 or 160, F dividing 64,
// HW % G == 0, S = G*F a multiple of 128, 16-byte-aligned pointers; bias
// [S, S] float32 (bias_dtype 0) or bfloat16 (1). Returns the cudaError_t of
// the launch; anything else it refuses with cudaErrorInvalidValue and
// launches nothing.
extern "C" int i360_fused_motion_attention_wgmma(const void* q, const void* k, const void* v,
                                                 const void* bias, void* out, int B, int F,
                                                 int HW, int H, int D, int G, float scale,
                                                 int bias_dtype, void* stream) {
  if (bias == nullptr || (bias_dtype != 0 && bias_dtype != 1)) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  switch (D) {
    case 40:
      return i360::launch_fused_motion_wgmma_d<40>(q, k, v, bias, out, B, F, HW, H, G, scale,
                                                   bias_dtype, s);
    case 80:
      return i360::launch_fused_motion_wgmma_d<80>(q, k, v, bias, out, B, F, HW, H, G, scale,
                                                   bias_dtype, s);
    case 160:
      return i360::launch_fused_motion_wgmma_d<160>(q, k, v, bias, out, B, F, HW, H, G, scale,
                                                    bias_dtype, s);
  }
  return (int)cudaErrorInvalidValue;
}

// q/k/v/out [B, F, HW, H*D], contiguous, HW % G == 0; bias [G*F, G*F] in
// block order, float32 (bias_dtype 0) or bfloat16 (1). dtype 0 = float32
// (the CUDA-core kernel: RS is the shared-memory row stride in elements, at
// least D, a whole number of 4-byte words, which the caller makes odd; HB
// not read), 1 = bfloat16 (the tensor cores: HB heads a block, dividing H,
// from kernels.fused_motion_mma_plan; RS not read). Returns the cudaError_t
// of the launch.
extern "C" int i360_fused_motion_attention(const void* q, const void* k, const void* v,
                                           const void* bias, void* out, int B, int F, int HW,
                                           int H, int D, int G, int RS, int HB, float scale,
                                           int exp_bf16, int dtype, int bias_dtype,
                                           void* stream) {
  if (F < 1 || D < 1 || D > 160 || G < 1 || HW % G != 0 || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (dtype == 1)
    return i360::launch_fused_motion_mma(q, k, v, bias, out, B, F, HW, H, D, G, HB, scale,
                                         exp_bf16, bias_dtype, s);
  return i360::launch_fused_motion<float>(q, k, v, bias, out, B, F, HW, H, D, G, RS, scale,
                                          bias_dtype, exp_bf16, s);
}
