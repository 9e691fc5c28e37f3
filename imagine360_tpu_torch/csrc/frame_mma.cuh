// The tensor-core tile of K4 (frame_attention.cu), L3 (motion_diag.cu) and L1
// (frame_attention_v2.cu): attention over the frame axis of packs of G
// neighbouring locations x HG heads, one (location, head) problem a warp on
// `mma.sync`. K4 picks the packs by kernels.frame_attention_plan and lets a
// block walk R of them in two stages; L3 keeps its own ownership, a block
// owning G locations and walking all of their head groups (R = H / HG,
// kernels.diag_motion_mma_plan) in one stage; L1 takes HG = H, a block
// walking R whole location packs in one stage (kernels.striped_v2_mma_plan).
// frame_attention.cu says what the tile does and why.
#pragma once

#include "attn_mma.cuh"

namespace i360 {

constexpr int K4_MMA_NW = 4;       // warps of a block of the tile

// Calls fn(t, f, g, soff, goff) once for each copy of the `tensors` staged
// tensors of a pack: tensor t, frame f, location g of the pack, and the
// copy's column offsets in the staged row (heads DP apart) and in the
// global run (heads D apart). A location's row is `cpr` copies of `step`
// elements, `chunks` of them a head. Each thread keeps its columns and walks
// the rows, so no index is divided per copy: with cpr <= NT a pass covers
// NT / cpr rows (the threads past them idle), else one row in steps of NT.
template <int NT, typename Fn>
__device__ __forceinline__ void k4_for_copies(int tensors, int F, int G, int cpr, int chunks,
                                              int step, int DP, int D, Fn&& fn) {
  const int tid = threadIdx.x;
  const bool narrow = cpr <= NT;
  const int rpp = narrow ? NT / cpr : 1;   // rows a pass
  const int row0 = narrow ? tid / cpr : 0;
  if (row0 >= rpp) return;
  for (int c = narrow ? tid - row0 * cpr : tid; c < cpr; c += narrow ? cpr : NT) {
    const int h = c / chunks, cc = c - h * chunks;
    const int soff = h * DP + cc * step, goff = h * D + cc * step;
    int t = 0, f = 0, g = row0;
    while (g >= G) {
      g -= G;
      if (++f == F) { f = 0; ++t; }
    }
    while (t < tensors) {
      fn(t, f, g, soff, goff);
      g += rpp;
      while (g >= G) {
        g -= G;
        if (++f == F) { f = 0; ++t; }
      }
    }
  }
}

// The body of a block of K4_MMA_NW warps. Pack p (of `packs`) covers head
// group p % nhg of location pack (p / nhg) % nlp of batch row
// p / (nhg * nlp); the block (blockIdx.x) walks packs x*R .. x*R + R - 1.
// `sm`: dynamic shared memory for STAGES (1 or 2) stages of the q, k and v
// tiles, [stage][tensor][FP][RS] bf16. With two stages (K4) the next pack's
// copies fly while this one computes; with one (L3) they start after its
// write-back.
template <int DP, int STAGES>
__device__ __forceinline__ void frame_mma_packs(const bf16* __restrict__ q,
                                                const bf16* __restrict__ k,
                                                const bf16* __restrict__ v,
                                                bf16* __restrict__ out, int F, int HW, int H,
                                                int D, int G, int HG, int R, int RS,
                                                long packs, float scale, int vec, bf16* sm) {
  static_assert(STAGES == 1 || STAGES == 2, "one or two stages");
  constexpr int NT = K4_MMA_NW * 32;
  constexpr int KS = DP / 16;   // k-steps of Q·Kᵀ
  constexpr int NO = DP / 8;    // 8-column tiles of O
  const int FP = (F + 15) & ~15;
  const int W = HG * DP;                 // a location's columns in a staged row
  const int tile = FP * RS;              // elements of one staged tensor
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tg = lane & 3;
  const long C = (long)H * D;
  const int nhg = H / HG, nlp = (HW + G - 1) / G;
  const long p0 = (long)blockIdx.x * R;
  const int np = packs - p0 < R ? (int)(packs - p0) : R;   // packs of this block
  const int step = vec ? 8 : 1;          // elements of one copy: 16 or 2 bytes
  const int chunks = D / step;           // copies of one head's row
  const float sl2 = scale * kLog2e;

  // head columns D..DP-1 and frames F..FP-1 stay zero for the whole kernel
  for (int i = tid; i < 3 * STAGES * tile / 8; i += NT)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // global offset of frame 0, head 0 of pack p at its first location l0
  auto pack_origin = [&](long p, int& l0) {
    const int hg = (int)(p % nhg);
    const long t = p / nhg;
    l0 = (int)(t % nlp) * G;
    return ((t / nlp) * F * HW + l0) * C + (long)hg * HG * D;
  };
  auto stage = [&](int st, long p) {
    int l0;
    const long base = pack_origin(p, l0);
    bf16* dst = sm + st * 3 * tile;
    k4_for_copies<NT>(3, F, G, HG * chunks, chunks, step, DP, D,
                      [&](int t, int f, int g, int soff, int goff) {
      const bf16* src = t == 0 ? q : (t == 1 ? k : v);
      const bool ok = l0 + g < HW;
      const long off = base + ((long)f * HW + g) * C + goff;
      bf16* d = dst + t * tile + f * RS + g * W + soff;
      if (vec) cp_async16(smem_u32(d), ok ? src + off : src, ok);
      else *d = ok ? src[off] : __float2bfloat16(0.f);
    });
  };

  stage(0, p0);
  cp_async_commit();
  for (int r = 0; r < np; ++r) {
    const int st = STAGES == 2 ? r & 1 : 0;
    if (STAGES == 2 && r + 1 < np) {   // the next pack's copies fly while this one computes
      stage(st ^ 1, p0 + r + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    bf16* sQ = sm + st * 3 * tile;
    const bf16* sK = sQ + tile;
    const bf16* sV = sK + tile;
    int l0;
    const long base = pack_origin(p0 + r, l0);

    for (int pr = warp; pr < G * HG; pr += K4_MMA_NW) {
      const int g = pr / HG;
      if (l0 + g >= HW) break;           // the rest of a ragged pack is past HW
      const int col = g * W + (pr - g * HG) * DP;
      for (int m0 = 0; m0 < F; m0 += 16) {
        // S = Q·Kᵀ for query frames m0..m0+15 and all FP keys
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, smem_u32(sQ + (m0 + (lane & 15)) * RS + col + ks * 16 + (lane >> 4) * 8));
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            if (p * 16 < FP) {
              uint32_t b[4];
              ldsm_x4(b, smem_u32(sK + (p * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS + col +
                                  ks * 16 + ((lane >> 3) & 1) * 8));
              mma_bf16(s[2 * p], a, b[0], b[1]);
              mma_bf16(s[2 * p + 1], a, b[2], b[3]);
            }
          }
        }
        // exact softmax of rows g8 and g8 + 8 over the quad (log2 units)
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (n * 8 < FP) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int key = n * 8 + tg * 2 + (j & 1);
              const float x = key < F ? s[n][j] * sl2 : kNegInf;
              s[n][j] = x;
              mx[j >> 1] = fmaxf(mx[j >> 1], x);
            }
          }
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          mx[r2] = fmaxf(mx[r2], __shfl_xor_sync(0xffffffffu, mx[r2], 1));
          mx[r2] = fmaxf(mx[r2], __shfl_xor_sync(0xffffffffu, mx[r2], 2));
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (n * 8 < FP) {    // tiles past FP hold nothing
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float e = exp2f(s[n][j] - mx[j >> 1]);
              s[n][j] = e;
              sum[j >> 1] += e;
            }
          }
        }
        float inv[2];
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          sum[r2] += __shfl_xor_sync(0xffffffffu, sum[r2], 1);
          sum[r2] += __shfl_xor_sync(0xffffffffu, sum[r2], 2);
          inv[r2] = 1.f / sum[r2];
        }
        // O = P·V, P normalised and rounded once to bf16 as the A fragment
        float o[NO][4];
#pragma unroll
        for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk * 16 < FP) {
            uint32_t ph[4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = 2 * kk + h;
              ph[h * 2] = pack_bf16(s[n][0] * inv[0], s[n][1] * inv[0]);
              ph[h * 2 + 1] = pack_bf16(s[n][2] * inv[1], s[n][3] * inv[1]);
            }
#pragma unroll
            for (int n2 = 0; n2 < NO / 2; ++n2) {
              uint32_t b[4];
              ldsm_x4_trans(b, smem_u32(sV + (kk * 16 + (lane & 15)) * RS + col + n2 * 16 +
                                        (lane >> 4) * 8));
              mma_bf16(o[2 * n2], ph, b[0], b[1]);
              mma_bf16(o[2 * n2 + 1], ph, b[2], b[3]);
            }
          }
        }
        // into this warp's Q columns, whose rows m0..m0+15 no lane reads again
        __syncwarp();
#pragma unroll
        for (int n = 0; n < NO; ++n) {
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            const int row = m0 + g8 + r2 * 8;
            if (row < F)
              *reinterpret_cast<__nv_bfloat162*>(sQ + row * RS + col + n * 8 + tg * 2) =
                  __floats2bfloat162_rn(o[n][r2 * 2], o[n][r2 * 2 + 1]);
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // write back, one run per frame and location as it came in
    k4_for_copies<NT>(1, F, G, HG * chunks, chunks, step, DP, D,
                      [&](int, int f, int g, int soff, int goff) {
      if (l0 + g >= HW) return;
      const long off = base + ((long)f * HW + g) * C + goff;
      const bf16* src = sQ + f * RS + g * W + soff;
      if (vec) *reinterpret_cast<uint4*>(out + off) = *reinterpret_cast<const uint4*>(src);
      else out[off] = *src;
    });
    __syncthreads();   // this stage is refilled two packs on (one stage: now)
    if (STAGES == 1 && r + 1 < np) {
      stage(0, p0 + r + 1);
      cp_async_commit();
    }
  }
}

// A pack's shared-memory row stride in elements: its G*HG*DP columns and 8
// more, so that RS / 8 is odd (G*HG*DP is a multiple of 16).
inline int k4_row_stride(int G, int HG, int DP) { return G * HG * DP + 8; }


}  // namespace i360
