// The Hopper body of K1 at one key tile: bf16 storage, head dim 64, no bias,
// at most 128 keys and more than 32 queries, not both at most 64
// (kernels.xattn_route): the text and image-prompt cross-attention launches
// of the denoise loop, the SR engines and entry(), and their per-shard
// shapes, but the perspective stage-3 (16 queries) and stage-2 image-prompt
// (64 × 64) ones. It replaces, for those
// launches, the `mma.sync` body of attn_mma.cuh, and with it the TPU kernel
// imagine360_tpu/ops/pallas_attention.py:_tiny_packed_kernel (K1) at those
// sites; tiny_attention.cu instantiates it as
// tiny_attention_xattn_wgmma_kernel.
//
// What it computes is what i360::flash_tile_mma computes for one key tile
// without a bias: softmax(q·kᵀ·scale)·v per (batch, head), keys at or beyond
// Sk given the finite kNegInf, logits in log2 units, P = 2^(s - m) rounded
// once to bf16 while the row sum is taken over the unrounded P, the output
// divided by the sum at the end (a zero sum replaced by 1). With one key
// tile the row is whole, so the max needs no rescale: the result differs
// from the `mma.sync` body only in the order of the tensor-core sums.
//
// What bounds it on the H100: a query row of one head does 4·Sk·64
// operations (about 20 k at Sk = 77) against its 256 bytes of q and out, so
// about 77 operations a byte, far below the card's ~295 bf16 operations a
// byte: it is bound by bytes, 3.35 TB/s. K and V of a (batch, head), at
// most 128 keys × 64 × 2 × 2 = 32 KB, are read once for all its query rows.
// So the kernel has to keep the card's memory busy: query tiles in and
// output tiles out, back to back, with enough bytes in flight on every SM.
//
// What held the `mma.sync` body back, and what this design does about it:
// that body gives a block 64 query rows of one (batch, head) (51,200 short
// blocks at the perspective stage-0 site); each loads its Q and its one K/V
// tile, computes, and stores, with nothing overlapped but what other resident
// blocks supply. Here:
// - A persistent grid: one block an SM (kernels' SM count) walks a
//   contiguous run of work items (batch, head, 128-query tile), the query
//   tile fastest, so it loads a (batch, head)'s K and V once for all the
//   query tiles it takes of that pair, into a ring of kXaKVBufs K/V
//   buffers (the next pairs' K and V land while this one's tiles run: at
//   the sites of one query tile a pair, the K/V bytes are half the work).
// - A ring of kXaStages Q tiles (128 rows × 64, 16 KB each; two stages
//   measured 1-5% faster than three or four on an H100), filled by TMA
//   from one producer thread through the 4-D map {64, H, S, B}; the rows
//   past Sq are zero-filled. A consumer returns a stage as soon as its
//   S = Q·Kᵀ has completed, so the next tiles' loads fly under the softmax,
//   P·V and the epilogue.
// - Two consumer warpgroups, 64 query rows each of the item, on `wgmma`:
//   S = Q·Kᵀ as m64nNk16 with N the key count rounded up to 64, 80 or 128
//   (compile-time instantiations: Sk <= 64, <= 80, <= 128) over the 4
//   k-steps of D = 64, Q and K from shared memory (K-major); the whole row's
//   softmax in registers; O = P·V as N/16 k-steps of m64n64k16, P the A
//   operand from registers (the S accumulator's layout packed to bf16
//   pairs), V read MN-major through the transpose bit. Keys past Sk are
//   zero-filled by the copy and masked to kNegInf in registers.
// - The epilogue by TMA store: the bf16 output tile goes, 128-byte
//   swizzled, into one of the consumer's two staging buffers and leaves by
//   one bulk tensor store (cp.async.bulk.tensor ... bulk_group), waited for
//   (wait_group.read) only before that buffer is written again two stores
//   later, so a tile's store overlaps the next tile's loads and products.
//   The store clips the rows past Sq; a consumer whose 64 rows all lie past
//   Sq (the second one of a last query tile, where Sq % 128 is 1..64)
//   stores nothing, and its staging buffers keep their turn.
// `setmaxnreg` moves registers from the producer warpgroup (40) to the
// consumers (232), as attn_wgmma.cuh does.
//
// Budget: shared memory kXaStages × 16 KB of Q, kXaKVBufs K/V buffers of
// 2 × 16 KB (sized for N = 128), 2 × 2 × 8 KB of output staging, the
// barriers and 1 KB to align the tiles to the 1024 bytes of the swizzle
// pattern: 193 KB at two stages and four buffers. 384 threads and 168
// registers a thread at launch: one block an SM. The variants of
// scripts/torch_wgmma_variants.py edit kXaStages and kXaKVBufs in a copy of
// this header, or make the heads the walk's fastest axis (xa_item) or give
// every item a block of its own (PERF.md §6: the heads fastest won 2-14% at
// the pano sites, whose K and V stay in L2, and lost 6-25% at the
// perspective ones, whose K and V do not; a block an item lost about 2×).
#pragma once

#include "wgmma_ops.cuh"

namespace i360 {

constexpr int kXaBQ = 128;                  // query rows of a work item: two consumers of 64
constexpr int kXaStages = 2;                // stages of the Q ring
constexpr int kXaKVBufs = 4;                // K/V buffers: (batch, head) pairs in flight
constexpr int kXaMaxSk = 128;               // keys this body takes
constexpr int kXaThreads = 384;             // producer warpgroup + two consumer warpgroups
constexpr int kXaQBytes = kXaBQ * kWgD * 2;       // one Q stage
constexpr int kXaOBytes = 64 * kWgD * 2;          // one consumer's output tile
constexpr int kXaKVBytes = kXaMaxSk * kWgD * 2;   // one K or V buffer
// Q ring, the K/V buffers (K, V), two staging buffers a consumer, then the
// barriers: Q full and empty per stage, K/V full and empty per buffer
constexpr size_t kXaSmemBytes = 1024 + (size_t)kXaStages * kXaQBytes +
                                2 * (size_t)kXaKVBufs * kXaKVBytes + 2 * 2 * (size_t)kXaOBytes +
                                8 * (2 * kXaStages + 2 * kXaKVBufs);
static_assert(kXaSmemBytes <= (size_t)kWgSmemLimit, "the block's shared memory");

// d = a·b for one m64n80k16 step, both from shared memory, K-major;
// scale_d 0: d = a·b.
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (+)= Q·Kᵀ for one k-step at N keys (64, 80 or 128), K-major operands.
template <int N>
__device__ __forceinline__ void xa_qk(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 80) wgmma_ss_n80(d, da, db, scale_d);
  else wgmma_ss<N>(d, da, db, scale_d);
}

// The key count a launch's instantiation covers: Sk rounded up to 64, 80 or
// 128 (tiny_attention.cu picks it; kernels.xattn_keys says the same).
constexpr int xa_keys(int Sk) { return Sk <= 64 ? 64 : Sk <= 80 ? 80 : 128; }

// The work items [lo, hi) of block `blk` out of `grid`: (batch × head) ×
// query tiles, balanced to within one.
__device__ __forceinline__ void xa_range(long items, int blk, int grid, long& lo, long& hi) {
  lo = items * blk / grid;
  hi = items * (blk + 1) / grid;
}

// (batch, head, query tile) of item `it`, the query tile fastest.
__device__ __forceinline__ void xa_item(long it, int H, int nqt, int& b, int& h, int& qt) {
  const long bh = it / nqt;
  qt = (int)(it - bh * nqt);
  b = (int)(bh / H);
  h = (int)(bh - (long)b * H);
}

// The whole kernel: block blockIdx.x of gridDim.x walks its run of the
// B·H·nqt work items. Maps: q, k, v, out as launch_xattn_wgmma encodes them
// (boxes of 128 query rows, N key rows, 64 output rows). `sl2` is
// scale·log2(e). `smem` has kXaSmemBytes bytes.
template <int N>
__device__ __forceinline__ void attn_xattn_body(const CUtensorMap* mq, const CUtensorMap* mk,
                                                const CUtensorMap* mv, const CUtensorMap* mo,
                                                int B, int Sq, int Sk, int H, int nqt, float sl2,
                                                unsigned char* smem) {
  static_assert(N == 64 || N == 80 || N == 128, "the key counts of the instantiations");
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + kXaStages * kXaQBytes;
  const uint32_t sV = sK + kXaKVBufs * kXaKVBytes;
  const uint32_t sO = sV + kXaKVBufs * kXaKVBytes;
  const uint32_t bars = sO + 4 * kXaOBytes;
  auto full_q = [&](int s) { return bars + 8 * s; };
  auto empty_q = [&](int s) { return bars + 8 * (kXaStages + s); };
  auto full_kv = [&](int j) { return bars + 8 * (2 * kXaStages + j); };
  auto empty_kv = [&](int j) { return bars + 8 * (2 * kXaStages + kXaKVBufs + j); };

  long lo, hi;
  xa_range((long)B * H * nqt, blockIdx.x, gridDim.x, lo, hi);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kXaStages; ++s) {
      mbar_init(full_q(s), 1);
      mbar_init(empty_q(s), kXaBQ / 16);   // lane 0 of each consumer warp of the item
    }
    for (int j = 0; j < kXaKVBufs; ++j) {
      mbar_init(full_kv(j), 1);
      mbar_init(empty_kv(j), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread walks the items, a (batch, head)'s K and V
    // when the pair changes, each item's Q tile into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgProducerRegs));
    if (threadIdx.x == 0) {
      tma_prefetch(mq);
      tma_prefetch(mk);
      tma_prefetch(mv);
      tma_prefetch(mo);
      int pairs = 0, pb = -1, ph = -1;
      for (long it = lo; it < hi; ++it) {
        const int i = (int)(it - lo);
        int b, h, qt;
        xa_item(it, H, nqt, b, h, qt);
        if (b != pb || h != ph) {
          const int j = pairs % kXaKVBufs;
          if (pairs >= kXaKVBufs) mbar_wait(empty_kv(j), ((pairs / kXaKVBufs) - 1) & 1);
          mbar_expect_tx(full_kv(j), 2 * N * kWgD * 2);
          tma_load_4d(sK + j * kXaKVBytes, mk, full_kv(j), 0, h, 0, b);
          tma_load_4d(sV + j * kXaKVBytes, mv, full_kv(j), 0, h, 0, b);
          ++pairs;
          pb = b;
          ph = h;
        }
        const int s = i % kXaStages;
        if (i >= kXaStages) mbar_wait(empty_q(s), ((i / kXaStages) - 1) & 1);
        mbar_expect_tx(full_q(s), kXaQBytes);
        tma_load_4d(sQ + s * kXaQBytes, mq, full_q(s), 0, h, qt * kXaBQ, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
  // consumer cw takes rows 64·cw .. 64·cw + 63 of every item
  const int cw = wg - 1;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  int pairs = 0, pb = -1, ph = -1, j = 0, done = 0;
  for (long it = lo; it < hi; ++it) {
    const int i = (int)(it - lo);
    int b, h, qt;
    xa_item(it, H, nqt, b, h, qt);
    if (b != pb || h != ph) {
      // a new pair: its K and V in buffer j
      j = pairs % kXaKVBufs;
      mbar_wait(full_kv(j), (pairs / kXaKVBufs) & 1);
      ++pairs;
      pb = b;
      ph = h;
    }
    bool last_of_pair = it + 1 == hi;   // the buffer's last item: return it after P·V
    if (!last_of_pair) {
      int nb, nh, nq;
      xa_item(it + 1, H, nqt, nb, nh, nq);
      last_of_pair = nb != b || nh != h;
    }
    const int s = i % kXaStages;
    mbar_wait(full_q(s), (i / kXaStages) & 1);

    // S = Q·Kᵀ over the 4 k-steps of D = 64 (32 bytes a k-step)
    float sc[N / 2];
    const uint64_t dq = wg_desc(sQ + s * kXaQBytes + cw * kXaOBytes);
    const uint64_t dk = wg_desc(sK + j * kXaKVBytes);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kWgD / 16; ++ks) xa_qk<N>(sc, dq + 2 * ks, dk + 2 * ks, ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_q(s));   // this warp is done with the Q stage

    // the whole row's softmax: log2 units, the key mask, the max over the
    // quad, P = 2^(S - m) summed unrounded and packed to bf16 as the A
    // fragments of the N/16 k-steps of P·V
    float m0 = kNegInf, m1 = kNegInf;
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * c + e] * sl2;
        if (8 * c + 2 * tg + (e & 1) >= Sk) x = kNegInf;
        sc[4 * c + e] = x;
        if (e < 2) m0 = fmaxf(m0, x);
        else m1 = fmaxf(m1, x);
      }
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    float l0 = 0.f, l1 = 0.f;
    uint32_t pa[N / 16][4];
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
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

    // O = P·V: V MN-major, 16 key rows (2048 bytes) a k-step
    float o[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0.f;
    const uint64_t dv = wg_desc(sV + j * kXaKVBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) wgmma_m64n64k16_rs<1>(o, pa[kk], dv + 128 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (last_of_pair) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_kv(j));   // this warp is done with the pair's K and V
    }

    // epilogue: nothing where all this consumer's rows lie past Sq;
    // otherwise the sums over the quad, divide (a zero sum replaced by 1),
    // bf16 into this consumer's staging buffer `done` & 1, 128-byte
    // swizzled as the output map reads it, then one TMA store that clips
    // the rows past Sq. `done` counts the stores, so the buffer written
    // here is the one of the store two stores back.
    const int r0 = qt * kXaBQ + 64 * cw;
    if (r0 >= Sq) continue;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    const uint32_t buf = sO + (2 * cw + (done & 1)) * kXaOBytes;
    ++done;
    if (tid == 0) bulk_wait_read<1>();   // the store two stores back has read this buffer
    named_sync(1 + cw, 128);
    const uint32_t row = buf + (warp * 16 + g) * 128 + tg * 4;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t chunk = (uint32_t)((c ^ g) << 4);   // rows g and g + 8: the same pattern
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(row + chunk),
                   "r"(pack_bf16(o[4 * c] * inv0, o[4 * c + 1] * inv0)) : "memory");
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(row + 8 * 128 + chunk),
                   "r"(pack_bf16(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1)) : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1 + cw, 128);
    if (tid == 0) {
      tma_store_4d_async(mo, buf, 0, h, r0, b);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all();   // every store written before the block ends
}

// Launch `kern` (a __global__ taking the four maps, B, Sq, Sk, H, the query
// tiles a (batch, head) and scale·log2(e)) for attn_xattn_body<N> on bf16
// q/k/v/out [B, S, H·64]: a persistent grid of one block an SM (fewer
// where there are fewer items). Refuses (cudaErrorInvalidValue) a
// pointer that is not 16-byte aligned, more than N keys, a map the driver
// does not encode, and a build whose launch registers would not cover the
// consumers' setmaxnreg.
template <int N, typename Kern>
int launch_xattn_wgmma(Kern kern, const void* q, const void* k, const void* v, void* out, int B,
                       int Sq, int Sk, int H, float scale, cudaStream_t stream) {
  if ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15) != 0 || B < 1 ||
      Sq < 1 || Sk < 1 || Sk > N || H < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  if (!make_wg_map(&mq, q, B, Sq, H, kXaBQ) || !make_wg_map(&mk, k, B, Sk, H, N) ||
      !make_wg_map(&mv, v, B, Sk, H, N) || !make_wg_map(&mo, out, B, Sq, H, 64))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs < kWgLaunchRegs) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kXaSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  static int sm_count[64] = {};   // per device, read once
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0 &&
      (err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return (int)err;
  const int sms = sm_count[dev];
  const int nqt = (Sq + kXaBQ - 1) / kXaBQ;
  const long items = (long)B * H * nqt;
  const unsigned blocks = (unsigned)(items < sms ? items : sms);
  kern<<<blocks, kXaThreads, kXaSmemBytes, stream>>>(mq, mk, mv, mo, B, Sq, Sk, H, nqt,
                                                     scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace i360
