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
// bf16 (the main path), on the tensor cores: a block of 4 warps owns a pack
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
#include "attn_mma.cuh"

namespace i360 {

constexpr int K4_NT = 128;
constexpr int K4_MAX_F = 64;
constexpr int K4_MMA_NW = 4;       // warps of the bf16 block
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

// bf16 on the tensor cores. Pack p (of `packs`) covers head group p % nhg
// of location pack (p / nhg) % nlp of batch row p / (nhg * nlp); block x
// walks packs x*R .. x*R + R - 1. Shared memory: two stages of the q, k
// and v tiles, [stage][tensor][FP][RS] bf16: at the motion sites 63-75 KB,
// so three blocks an SM. The launch bounds ask for those three, so at most
// 170 registers a thread: with no minimum ptxas traded registers for more
// occupancy and spilled (DP = 48, 112, 128), with a minimum of one it took
// 183 at DP = 160, two blocks an SM.
template <int DP>
__global__ void __launch_bounds__(K4_MMA_NW * 32, K4_MMA_BLOCKS)
frame_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out, int F, int HW,
                           int H, int D, int G, int HG, int R, int RS, long packs, float scale,
                           int vec) {
  extern __shared__ __align__(16) unsigned char k4_smem[];
  constexpr int NT = K4_MMA_NW * 32;
  constexpr int KS = DP / 16;   // k-steps of Q·Kᵀ
  constexpr int NO = DP / 8;    // 8-column tiles of O
  bf16* sm = reinterpret_cast<bf16*>(k4_smem);
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
  for (int i = tid; i < 6 * tile / 8; i += NT)
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
    const int st = r & 1;
    if (r + 1 < np) {         // the next pack's copies fly while this one computes
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
    __syncthreads();   // this stage is refilled two packs on
  }
}

// A pack's shared-memory row stride in elements: its G*HG*DP columns and 8
// more, so that RS / 8 is odd (G*HG*DP is a multiple of 16).
inline int k4_row_stride(int G, int HG, int DP) { return G * HG * DP + 8; }

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
