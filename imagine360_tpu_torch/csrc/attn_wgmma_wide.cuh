// The Hopper body of the wide K1 and K2 at head dim 512: bf16 storage, no
// bias, 16-byte-aligned pointers (kernels.wide_wgmma_route): every mid-block
// attention launch of the VAE (one head of 512) in the pipeline and the SR
// stage. It replaces, for those launches, the 16-warp `mma.sync` tile of
// attn_mma_wide.cuh, and with it the TPU kernels
// imagine360_tpu/ops/pallas_attention.py:_mh_flash_kernel (K2) and
// _tiny_packed_kernel (K1) at D = 512; mh_flash_wide.cu and
// tiny_attention_wide.cu instantiate it as mh_flash_wide_wgmma_kernel and
// tiny_attention_wide_wgmma_kernel.
//
// What it computes is what wide_tile_mma computes without a bias:
// softmax(q·kᵀ·scale)·v per (batch, head) with a running max and sum in log2
// units over tiles of 64 keys, keys at or beyond Sk given the finite
// kNegInf, P = 2^(s - m) rounded once to bf16 while the row sum is taken
// over the unrounded P, the output divided by the sum at the end (a zero
// sum replaced by 1).
//
// What bounds it on the H100: 4·Sq·Sk·512 operations a (batch, head)
// against (2·Sq + 2·Sk)·512·2 bytes, far above ~295 operations a byte: it
// is bound by operations, 989 TFLOP/s bf16 on the tensor cores.
//
// The register and shared-memory budget forces the layout. A 64-row O at
// D = 512 is 128 KB of float32, so a block is one producer warpgroup and two
// consumer warpgroups on the same 64 query rows, and consumer w owns O's
// columns 256·w .. 256·w + 255 (128 accumulator registers a thread;
// `setmaxnreg` 40 / 232).
// - S split over the head dim: consumer w computes the partial
//   S_w = Q[:, 256w:]·K[:, 256w:]ᵀ over its half, 16 k-steps of m64n64k16
//   with both operands from shared memory. The two partials are exchanged
//   through shared memory (two [64, 64] float32 tiles) behind a named
//   barrier of the 256 consumer threads: thread t of either consumer holds
//   the same (row, key) elements of its partial, so each adds the other's
//   elements to its own. Addition commutes in IEEE arithmetic, so both hold
//   the same S bit for bit and run the same softmax (the same m, α and l),
//   with no further exchange. A second named barrier keeps a consumer from
//   writing its next partial before the other has read this one.
// - O_w = α·O_w + P·V[:, 256w:]: P the A operand from registers (the S
//   accumulator's layout packed to bf16 pairs), V read MN-major through the
//   transpose bit, four m64n64k16 products (one a 64-column box of V) a
//   k-step of 16 keys.
// - Tiles of 64 columns: the 128-byte swizzle takes boxes of 64 bf16
//   columns, so Q, K and V are each staged as 8 boxes of [rows × 64], one
//   TMA copy each through the 4-D map {512, H, S, B}; the descriptors step
//   through the boxes per k-step (S, K-major) and across N (P·V, V
//   MN-major).
// - One producer thread: Q once (64 KB), then each key tile's K and V into
//   one stage, K and V on barriers of their own (full and empty apart), so
//   K of tile t + 1 lands while the exchange, softmax and P·V of tile t
//   run, and V of tile t + 1 while S of tile t + 1 runs. The key
//   tail is zero-filled by the copy and masked in registers; the query
//   tail is zero-filled, and clipped by the TMA store of the output.
// - The epilogue: consumer w divides its columns by the sum, writes them in
//   bf16 into its own half of the Q tile (which only it reads, and no more
//   after its last S), 128-byte swizzled, and stores its four boxes by TMA.
//
// Shared memory: Q 64 KB, K and V 2 × 64 KB, the exchange 2 × 16 KB, the
// barriers and 1 KB of alignment: 225 KB (the 227 KB a block may have
// leave no second stage; 32-key tiles in two stages measured slower on an
// H100, PERF.md §6).
#pragma once

#include "wgmma_ops.cuh"

namespace i360 {

constexpr int kWwD = 512;                   // the head dim this body takes
constexpr int kWwBQ = 64;                   // query rows a block
constexpr int kWwBK = 64;                   // keys a tile
constexpr int kWwThreads = 384;             // producer warpgroup + two consumer warpgroups
constexpr int kWwBoxCols = 64;              // bf16 columns of one 128-byte-swizzled box
constexpr int kWwBoxes = kWwD / kWwBoxCols;  // 8 boxes a row
constexpr int kWwQBox = kWwBQ * 128;        // bytes of one Q box (64 rows of 128 bytes)
constexpr int kWwKBox = kWwBK * 128;        // bytes of one K or V box
constexpr int kWwQBytes = kWwBoxes * kWwQBox;
constexpr int kWwKVBytes = kWwBoxes * kWwKBox;
constexpr int kWwXBytes = kWwBQ * kWwBK * 4;   // one consumer's partial S
// Q, K, V, the exchange, then the barriers: Q's, K full, V full, K empty
// and V empty; plus 1 KB to align the tiles
constexpr size_t kWwSmemBytes = 1024 + (size_t)kWwQBytes + 2 * (size_t)kWwKVBytes +
                                2 * (size_t)kWwXBytes + 8 * 5;
static_assert(kWwSmemBytes <= (size_t)kWgSmemLimit, "the block's shared memory");

// One 64-row query tile of one (batch, head) problem; blockIdx.x is (batch ×
// head) × query tiles + query tile. The maps are those of
// launch_wide_wgmma. `sl2` is scale·log2(e). `smem` has kWwSmemBytes bytes.
__device__ __forceinline__ void attn_wide_wgmma_tile(const CUtensorMap* mq, const CUtensorMap* mk,
                                                     const CUtensorMap* mv, const CUtensorMap* mo,
                                                     int Sq, int Sk, int H, int nqt, float sl2,
                                                     unsigned char* smem) {
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + kWwQBytes;
  const uint32_t sV = sK + kWwKVBytes;
  const uint32_t sX = sV + kWwKVBytes;
  const uint32_t barQ = sX + 2 * kWwXBytes;
  const uint32_t full_k = barQ + 8, full_v = barQ + 16, empty_k = barQ + 24, empty_v = barQ + 32;

  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * kWwBQ;
  const int b = bh / H, h = bh - b * H;
  const int ntiles = (Sk + kWwBK - 1) / kWwBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    mbar_init(full_k, 1);
    mbar_init(full_v, 1);
    mbar_init(empty_k, 8);   // lane 0 of each consumer warp
    mbar_init(empty_v, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread, Q once, then K and V of every key tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgProducerRegs));
    if (threadIdx.x == 0) {
      tma_prefetch(mq);
      tma_prefetch(mk);
      tma_prefetch(mv);
      tma_prefetch(mo);
      mbar_expect_tx(barQ, kWwQBytes);
#pragma unroll 1
      for (int c = 0; c < kWwBoxes; ++c)
        tma_load_4d(sQ + c * kWwQBox, mq, barQ, c * kWwBoxCols, h, q0, b);
#pragma unroll 1
      for (int t = 0; t < ntiles; ++t) {
        const uint32_t par = (t - 1) & 1;   // the consumers' release of tile t - 1
        if (t > 0) mbar_wait(empty_k, par);
        mbar_expect_tx(full_k, kWwKVBytes);
#pragma unroll 1
        for (int c = 0; c < kWwBoxes; ++c)
          tma_load_4d(sK + c * kWwKBox, mk, full_k, c * kWwBoxCols, h, t * kWwBK, b);
        if (t > 0) mbar_wait(empty_v, par);
        mbar_expect_tx(full_v, kWwKVBytes);
#pragma unroll 1
        for (int c = 0; c < kWwBoxes; ++c)
          tma_load_4d(sV + c * kWwKBox, mv, full_v, c * kWwBoxCols, h, t * kWwBK, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
  const int cw = wg - 1;                 // this consumer's half of the head dim
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const uint32_t xw = sX + cw * kWwXBytes, xr = sX + (1 - cw) * kWwXBytes;
  float o[4][32];                       // O's 4 boxes of 64 columns of this half
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;     // running max of rows g and g + 8, log2 units
  float l0 = 0.f, l1 = 0.f;             // this thread's part of their running sums
  mbar_wait(barQ, 0);

#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    const uint32_t par = t & 1;
    // S_w over the 16 k-steps of this half: Q's and K's boxes 4·cw .. 4·cw
    // + 3, 32 bytes a k-step within a box
    float sc[kWwBK / 2];
    mbar_wait(full_k, par);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) {
      const int c = 4 * cw + ks / 4;
      wgmma_ss_n64<0, 0>(sc, wg_desc(sQ + c * kWwQBox) + 2 * (ks % 4),
                         wg_desc(sK + c * kWwKBox) + 2 * (ks % 4), ks);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_k);   // this warp is done with K

    // the exchange: my partial out, the other's in, S = S_0 + S_1
    if (t > 0) named_sync(2, 256);          // the other consumer has read my last partial
#pragma unroll
    for (int e = 0; e < kWwBK / 2; ++e)
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(xw + (e * 128 + tid) * 4), "f"(sc[e])
                   : "memory");
    named_sync(1, 256);
#pragma unroll
    for (int e = 0; e < kWwBK / 2; ++e) {
      float x;
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(xr + (e * 128 + tid) * 4)
                   : "memory");
      sc[e] += x;
    }

    // the online softmax of the tile: log2 units, the key mask, the row max
    // over the quad, α = 2^(m_old - m_new), P = 2^(S - m) summed unrounded
    // and packed to bf16 as the A fragments of the BK/16 k-steps of P·V
    const int nk = Sk - t * kWwBK;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int c = 0; c < kWwBK / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * c + e] * sl2;
        if (8 * c + 2 * tg + (e & 1) >= nk) x = kNegInf;
        sc[4 * c + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = ex2_ftz(m0 - mx0), alpha1 = ex2_ftz(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
    uint32_t pa[kWwBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWwBK / 16; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = 2 * kk + hf;
        const float p0 = ex2_ftz(sc[4 * c] - m0), p1 = ex2_ftz(sc[4 * c + 1] - m0);
        const float p2 = ex2_ftz(sc[4 * c + 2] - m1), p3 = ex2_ftz(sc[4 * c + 3] - m1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        pa[kk][2 * hf] = pack_bf16(p0, p1);
        pa[kk][2 * hf + 1] = pack_bf16(p2, p3);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) wg_rescale(o[c], alpha0, alpha1);

    // O_w += P·V[:, 256·cw:]: V's boxes 4·cw .. 4·cw + 3, MN-major, 16 key
    // rows (2048 bytes) a k-step
    mbar_wait(full_v, par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWwBK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wgmma_m64n64k16_rs<1>(o[c], pa[kk], wg_desc(sV + (4 * cw + c) * kWwKBox) + 128 * kk);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < 4; ++c) fence_regs(o[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_v);
  }

  // epilogue: the sums over the quad (both consumers hold the whole row's),
  // divide (a zero sum replaced by 1), bf16 into this consumer's own Q
  // boxes, 128-byte swizzled as the output map reads them, then four TMA
  // stores that clip the rows past Sq
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t row = sQ + (4 * cw + c) * kWwQBox + (warp * 16 + g) * 128 + tg * 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t chunk = (uint32_t)((i ^ g) << 4);   // rows g and g + 8: the same pattern
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(row + chunk),
                   "r"(pack_bf16(o[c][4 * i] * inv0, o[c][4 * i + 1] * inv0)) : "memory");
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(row + 8 * 128 + chunk),
                   "r"(pack_bf16(o[c][4 * i + 2] * inv1, o[c][4 * i + 3] * inv1)) : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(3 + cw, 128);
  if (tid == 0) {
#pragma unroll 1
    for (int c = 0; c < 4; ++c)
      tma_store_4d_async(mo, sQ + (4 * cw + c) * kWwQBox, (4 * cw + c) * kWwBoxCols, h, q0, b);
    bulk_commit();
    bulk_wait_all();
  }
}

// The map of one [B, S, H·512] bf16 operand: dims {512, H, S, B}, boxes of
// 64 columns × `rows` rows of one head, 128-byte swizzled.
inline bool make_wide_wg_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)kWwD, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)kWwD * 2, (cuuint64_t)kWwD * 2 * H,
                                 (cuuint64_t)kWwD * 2 * H * S};
  const cuuint32_t box[4] = {(cuuint32_t)kWwBoxCols, 1, (cuuint32_t)rows, 1};
  return encode_wg_map(map, ptr, 4, dims, strides, box);
}

// Launch `kern` (a __global__ taking the four maps, Sq, Sk, H, the query
// tiles a (batch, head) and scale·log2(e)) for attn_wide_wgmma_tile on bf16
// q/k/v/out [B, S, H·512]. Refuses (cudaErrorInvalidValue) a pointer that
// is not 16-byte aligned, a map the driver does not encode, and a build
// whose launch registers would not cover the consumers' setmaxnreg.
template <typename Kern>
int launch_wide_wgmma(Kern kern, const void* q, const void* k, const void* v, void* out, int B,
                      int Sq, int Sk, int H, float scale, cudaStream_t stream) {
  if ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15) != 0 || B < 1 ||
      Sq < 1 || Sk < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  if (!make_wide_wg_map(&mq, q, B, Sq, H, kWwBQ) || !make_wide_wg_map(&mk, k, B, Sk, H, kWwBK) ||
      !make_wide_wg_map(&mv, v, B, Sk, H, kWwBK) || !make_wide_wg_map(&mo, out, B, Sq, H, kWwBQ))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs < kWgLaunchRegs) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kWwSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int nqt = (Sq + kWwBQ - 1) / kWwBQ;
  const unsigned blocks = (unsigned)((long)B * H * nqt);
  kern<<<blocks, kWwThreads, kWwSmemBytes, stream>>>(mq, mk, mv, mo, Sq, Sk, H, nqt,
                                                     scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace i360
