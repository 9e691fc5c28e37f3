// The Hopper body of K4 (frame_attention.cu): bf16 storage, exactly 16
// frames, a head dim D that is a multiple of 8 up to 160, 16-byte-aligned
// pointers (kernels.frame_route): every motion-module launch of the denoise
// loop, the training step, the SR stage and entry(), and their per-shard
// shapes. It replaces, for those launches, the `mma.sync` tile of
// frame_mma.cuh, and with it the TPU kernel
// imagine360_tpu/ops/pallas_attention.py:_striped_kernel (wrapper
// temporal_packed_attention); frame_attention.cu instantiates it as
// frame_attention_tma_kernel.
//
// What it computes is what the `mma.sync` tile computes at F = 16: for q, k,
// v [B, F, HW, C] with H heads of D = C / H, each (batch, location, head)
// problem attends over its own 16 frames: S = Q·Kᵀ by mma.sync.m16n8k16 in
// float32, scaled to log2 units, the exact softmax of the whole row in
// registers, P normalised and rounded once to bf16 (as the TPU kernel casts
// p / sum to v.dtype) into the A fragments of O = P·V, float32 sums, O
// rounded to bf16. The products run in the same order as the tile's, so the
// two bodies agree bit for bit.
//
// What bounds it on the H100: a problem does 4·16·16·D operations on
// 4·16·D bf16 elements moved (q, k, v read, out written), 8 operations a
// byte, far below the card's ~295: it is bound by bytes, 3.35 TB/s. So the
// body has to keep enough bytes in flight on every SM and let nothing else
// wait on them. The products are `mma.sync` with `ldmatrix`: at 8
// operations a byte they do not set the pace, and 16 frames would fill only
// a quarter of `wgmma`'s 64 rows.
//
// What held the `mma.sync` tile back, and what this design does about it:
// - The copies. There every thread issued `cp.async` copies, walking them
//   with per-copy index arithmetic, and a stage was refilled only after its
//   pack's products, its write-back and three block barriers. Here one
//   producer thread issues one TMA copy (cp.async.bulk.tensor) of each of q,
//   k and v a work item into a ring of `S` stages guarded by full and empty
//   mbarriers, so up to S items' loads fly while the consumers compute.
// - The grid. A persistent grid (`bps` blocks an SM, fewer where fewer fit)
//   walks work items blockIdx.x, blockIdx.x + gridDim.x, ...: an item is G
//   neighbouring locations × HG heads (H % HG == 0) of one batch row,
//   numbered head group fastest, then location pack, then batch row, so the
//   items in flight across the card read neighbouring bytes of the same
//   rows.
// - The consumers. `NW` consumer warps take the stream of problems of the
//   block's items in turn, one (location, head) problem a warp at a time
//   (problem qi of the stream to warp qi % NW), each waiting only for its
//   own item's stage by the parity of the item's turn on it. That parity is
//   unambiguous only if a warp waits for every turn of a stage it uses: it
//   takes a problem of every item (P >= NW), or of every (NW / P)-th item
//   with NW / P dividing S (ft_walk_ok). A warp returns its problem's share
//   of the stage (one
//   arrival on the stage's empty mbarrier, P = G·HG a phase) as soon as its
//   products are done, before its epilogue. No block-wide barrier after
//   the set-up.
// - The output. A warp writes its problem's O into one of its own two
//   staging buffers and one lane issues a TMA store of it (cp.async.bulk.
//   tensor shared → global, one bulk group a store), waited for
//   (wait_group.read) only before that buffer is written again two stores
//   later. A problem past HW (a ragged last pack; TMA zero-fills its loads)
//   is neither computed nor stored, and its buffer keeps its turn.
//
// Layout. TMA lands a box densely, so a pack's rows would fall into the
// same banks. The maps therefore split each head's D columns into
// chunks of CW = 8·(the odd part of D / 8) columns (40 at D = 40, 80 and
// 160) and put the frames right after a chunk's columns: a 4-D map
// {CW, B·F, C / CW, HW} with byte strides {HW·C·2, CW·2, C·2} (the batch
// and frame axes merge: a batch row's stride is F frames'), boxes
// {CW, 16, HG·D / CW, G} for q, k and v and {CW, 16, D / CW, 1} (one
// problem) for the output. In shared memory a problem is then D / CW tiles
// of [16 frames][CW] with rows of CW·2 bytes, an odd number of 16-byte
// units, so the eight rows an ldmatrix phase reads lie in distinct banks.
// An 8-column group gr of a head lies in chunk gr / (CW / 8) at column
// (gr % (CW / 8))·8. Where D / 8 is odd (D = 40: the third k-step covers
// columns 32-47), the last k-step's second half reads the last group again
// and its A fragment (Q) is zeroed, so it adds 0 to S; the P·V column tile
// past D is computed on that group and never stored.
//
// Budget: S stages of 3 boxes of G·HG·16·D bf16, NW × 2 staging tiles of
// 16·D bf16, 2·S mbarriers; kernels.frame_tma_plan picks G, HG, S, NW and
// the blocks an SM (the forms it measured: PERF.md §6,
// scripts/torch_frame_variants.py). The tensor maps are encoded on the host
// per call (encode_map) and passed as __grid_constant__ parameters.
#pragma once

#include "wgmma_ops.cuh"

namespace i360 {

constexpr int kFtF = 16;                      // the frames this body takes
constexpr int kFtMaxNW = 8;                   // consumer warps a block at most
constexpr int kFtMaxStages = 8;               // stages of the ring at most
constexpr int kFtThreads = 32 * (1 + kFtMaxNW);   // a producer warp and the consumers

// the odd part of n (n >= 1)
__host__ __device__ constexpr int ft_odd(int n) { return n % 2 ? n : ft_odd(n / 2); }

// Whether NW consumer warps may take the problems of items of P problems in
// turn on a ring of S stages: each warp then waits for every turn of each
// stage it uses (every item where P >= NW; else every (NW / P)-th, the same
// stage every S / (NW / P) of its items), so a wait by parity never passes
// on an earlier turn of the stage.
__host__ __device__ constexpr bool ft_walk_ok(int P, int S, int NW) {
  return P >= NW || (NW % P == 0 && S % (NW / P) == 0);
}

// Bytes of dynamic shared memory a block takes: the barriers' 128 bytes,
// the ring, the staging tiles and 128 bytes to align them.
inline size_t frame_tma_smem(int D, int P, int S, int NW) {
  return 256 + (size_t)S * 3 * P * kFtF * D * 2 + (size_t)NW * 2 * kFtF * D * 2;
}

// The whole kernel for head dim D = 8·NG: block blockIdx.x of gridDim.x
// walks its items. Maps: q, k, v (boxes of one item) and out (boxes of one
// problem) as launch_frame_tma encodes them. `sl2` is scale·log2(e).
//
// PACKED (L3, motion_diag.cu): the block walks packs of GP neighbouring
// locations of one batch row instead (GP a multiple of G dividing HW),
// packs blockIdx.x, blockIdx.x + gridDim.x, ..., each pack streamed through
// the ring as its GP / G items of G locations × HG heads, head group
// fastest: block-local item i is the global item packed_it(i) of the walk
// above. The arithmetic of a problem is the same.
template <int NG, bool PACKED = false>
__device__ __forceinline__ void frame_tma_body(const CUtensorMap* mq, const CUtensorMap* mk,
                                               const CUtensorMap* mv, const CUtensorMap* mo,
                                               int B, int HW, int H, int G, int HG, int S,
                                               int NW, float sl2, unsigned char* smem,
                                               int GP = 1) {
  constexpr int D = 8 * NG;
  constexpr int CWG = ft_odd(NG);              // 8-column groups of a chunk
  constexpr int CW = 8 * CWG;                  // columns of a chunk
  constexpr int M = NG / CWG;                  // chunks of a head
  constexpr int KS = (NG + 1) / 2;             // k-steps of Q·Kᵀ
  constexpr int TILE = kFtF * D;               // elements of a problem's tile
  // element offset of 8-column group gr's first column in a problem's tile
  auto goff = [](int gr) { return (gr / CWG) * kFtF * CW + (gr % CWG) * 8; };

  const int P = G * HG;                        // problems of an item
  const uint32_t box = (uint32_t)P * TILE * 2;  // bytes of one tensor's box
  const uint32_t bars = (smem_u32(smem) + 127u) & ~127u;
  const uint32_t ring = bars + 128;
  const uint32_t stagebuf = ring + (uint32_t)S * 3 * box;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kFtMaxStages + s); };

  const int nhg = H / HG, nlp = (HW + G - 1) / G;
  const long items = (long)B * nlp * nhg;
  const long first = blockIdx.x, step = gridDim.x;
  // PACKED: the items of a pack, the packs of a batch row and of the block,
  // and the global item of the block's i-th
  const int ipp = GP / G * nhg, npk = HW / GP;
  const long pk_n = first < (long)B * npk ? ((long)B * npk - first + step - 1) / step : 0;
  auto packed_it = [&](long i) {
    const long pk = first + (i / ipp) * step;
    const int ii = (int)(i % ipp);
    return ((pk / npk) * nlp + (pk % npk) * (GP / G) + ii / nhg) * nhg + ii % nhg;
  };
  const long n_items = PACKED ? pk_n * ipp
                              : first < items ? (items - first + step - 1) / step : 0;
  // (batch row, location pack, head group) of the block's i-th item
  auto item = [&](long i, int& b, int& lp, int& hg) {
    const long it = PACKED ? packed_it(i) : first + i * step;
    hg = (int)(it % nhg);
    const long t = it / nhg;
    lp = (int)(t % nlp);
    b = (int)(t / nlp);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), P);                  // one arrival a problem
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // the producer: one thread loads each item's q, k and v boxes
    if (lane == 0) {
      tma_prefetch(mq);
      tma_prefetch(mk);
      tma_prefetch(mv);
      tma_prefetch(mo);
      for (long i = 0; i < n_items; ++i) {
        const int s = (int)(i % S);
        if (i >= S) mbar_wait(empty(s), (uint32_t)((i / S) - 1) & 1u);
        int b, lp, hg;
        item(i, b, lp, hg);
        const uint32_t dst = ring + (uint32_t)s * 3 * box;
        mbar_expect_tx(full(s), 3 * box);
        tma_load_4d(dst, mq, full(s), 0, b * kFtF, hg * HG * M, lp * G);
        tma_load_4d(dst + box, mk, full(s), 0, b * kFtF, hg * HG * M, lp * G);
        tma_load_4d(dst + 2 * box, mv, full(s), 0, b * kFtF, hg * HG * M, lp * G);
      }
    }
    return;
  }

  // consumer warp w takes problems w, w + NW, ... of the block's stream
  const int w = warp - 1;
  const int g8 = lane >> 2, tg = lane & 3;
  const uint32_t mybuf = stagebuf + (uint32_t)w * 2 * TILE * 2;
  // byte offsets of this lane's ldmatrix rows: Q's A rows and V's rows
  // (lane & 15), K's B rows ((lane & 7) + 8·(lane >> 4))
  const uint32_t rowa = (uint32_t)(lane & 15) * CW * 2;
  const uint32_t rowb = (uint32_t)((lane & 7) + ((lane >> 4) << 3)) * CW * 2;
  const bool hia = lane >= 16, hib = (lane >> 3) & 1;
  int stores = 0;
  const long nq = n_items * P;
  for (long qi = w; qi < nq; qi += NW) {
    const long i = qi / P;
    const int p = (int)(qi - i * P);
    const int s = (int)(i % S);
    mbar_wait(full(s), (uint32_t)(i / S) & 1u);
    int b, lp, hg;
    item(i, b, lp, hg);
    const int g = p / HG, j = p - g * HG;
    const int loc = lp * G + g;
    if (loc >= HW) {                           // past a ragged last pack: nothing to do
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
      continue;
    }
    const uint32_t sQ = ring + (uint32_t)s * 3 * box + (uint32_t)p * TILE * 2;
    const uint32_t sK = sQ + box, sV = sQ + 2 * box;

    // S = Q·Kᵀ over the 16 keys (two 8-key tiles)
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      constexpr int last = NG - 1;
      const int o0 = goff(2 * ks), o1 = goff(2 * ks + 1 < NG ? 2 * ks + 1 : last);
      uint32_t a[4], kb[4];
      ldsm_x4(a, sQ + rowa + (uint32_t)(hia ? o1 : o0) * 2);
      if (2 * ks + 1 >= NG) a[2] = a[3] = 0u;  // columns past D add nothing
      ldsm_x4(kb, sK + rowb + (uint32_t)(hib ? o1 : o0) * 2);
      mma_bf16(sc[0], a, kb[0], kb[1]);
      mma_bf16(sc[1], a, kb[2], kb[3]);
    }
    // the exact softmax of rows g8 and g8 + 8 over the quad, log2 units
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] *= sl2;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    }
    float sum[2] = {0.f, 0.f}, inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = exp2f(sc[n][e] - mx[e >> 1]);
        sum[e >> 1] += sc[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      inv[r] = 1.f / sum[r];
    }
    // O = P·V, P normalised and rounded once to bf16 as the A fragment
    uint32_t ph[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      ph[2 * n] = pack_bf16(sc[n][0] * inv[0], sc[n][1] * inv[0]);
      ph[2 * n + 1] = pack_bf16(sc[n][2] * inv[1], sc[n][3] * inv[1]);
    }
    float o[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
    for (int n2 = 0; n2 < KS; ++n2) {
      constexpr int last = NG - 1;
      const int o0 = goff(2 * n2), o1 = goff(2 * n2 + 1 < NG ? 2 * n2 + 1 : last);
      uint32_t vb[4];
      ldsm_x4_trans(vb, sV + rowa + (uint32_t)(hia ? o1 : o0) * 2);
      mma_bf16(o[2 * n2], ph, vb[0], vb[1]);
      if (2 * n2 + 1 < NG) mma_bf16(o[2 * n2 + 1], ph, vb[2], vb[3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));      // this problem's share of the stage

    // epilogue: O into staging buffer `stores` & 1, then one TMA store of
    // the problem's [16][D] (D / CW boxes' worth of chunks)
    const uint32_t buf = mybuf + (uint32_t)(stores & 1) * TILE * 2;
    ++stores;
    if (lane == 0) bulk_wait_read<1>();       // the store two stores back has read it
    __syncwarp();
#pragma unroll
    for (int n = 0; n < NG; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t at = buf + (uint32_t)(goff(n) + (g8 + 8 * r) * CW + tg * 2) * 2;
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at),
                     "r"(pack_bf16(o[n][2 * r], o[n][2 * r + 1])) : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      tma_store_4d_async(mo, buf, 0, b * kFtF, (hg * HG + j) * M, loc);
      bulk_commit();
    }
  }
  if (lane == 0) bulk_wait_all();              // every store written before the block ends
}

// The map of one [B, 16, HW, C] bf16 tensor for this body: dims
// {CW, B·16, C / CW, HW}, byte strides {HW·C·2, CW·2, C·2}, boxes
// {CW, 16, nc, ng}; no swizzle, zero fill past HW.
inline bool make_ft_map(CUtensorMap* map, const void* ptr, int B, int HW, int C, int CW, int nc,
                        int ng) {
  const cuuint64_t dims[4] = {(cuuint64_t)CW, (cuuint64_t)B * kFtF, (cuuint64_t)(C / CW),
                              (cuuint64_t)HW};
  const cuuint64_t strides[3] = {(cuuint64_t)HW * C * 2, (cuuint64_t)CW * 2, (cuuint64_t)C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)CW, (cuuint32_t)kFtF, (cuuint32_t)nc, (cuuint32_t)ng};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 4, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The units a persistent grid of launch_frame_tma shares out: K4's work
// items, or (PACKED, L3) the packs of GP locations.
inline long frame_tma_units(int B, int HW, int H, int G, int HG) {
  return (long)B * ((HW + G - 1) / G) * (H / HG);
}
inline long frame_tma_units(int B, int HW, int, int, int, int GP) { return (long)B * (HW / GP); }

// Launch `kern` (a __global__ taking the four maps, B, HW, H, G, HG, S, NW,
// scale·log2(e) and `extra`: for PACKED the pack GP) for frame_tma_body<NG>
// on bf16 q/k/v/out [B, 16, HW, H·8·NG]: a persistent grid of `bps` blocks
// an SM (fewer where the registers or shared memory allow fewer, or there
// are fewer units, frame_tma_units) of a producer warp and NW consumer
// warps. Refuses (cudaErrorInvalidValue) a
// pointer that is not 16-byte aligned, a head group that does not divide
// H, a box dimension past 256, NW or S out of range, a walk of the
// consumers whose parity waits could pass on an earlier turn of a stage
// (ft_walk_ok), more shared memory than a block may have, and a map the driver does not
// encode.
template <int NG, typename Kern, typename... Extra>
int launch_frame_tma(Kern kern, const void* q, const void* k, const void* v, void* out, int B,
                     int HW, int H, int G, int HG, int S, int NW, int bps, float scale,
                     cudaStream_t stream, Extra... extra) {
  constexpr int D = 8 * NG, CW = 8 * ft_odd(NG), M = NG / ft_odd(NG);
  const int P = G * HG;
  if ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15) != 0 || B < 1 ||
      HW < 1 || H < 1 || G < 1 || G > 256 || HG < 1 || H % HG != 0 || HG * M > 256 || NW < 1 ||
      NW > kFtMaxNW || S < 1 || S > kFtMaxStages || bps < 1 || !ft_walk_ok(P, S, NW))
    return (int)cudaErrorInvalidValue;
  const size_t smem = frame_tma_smem(D, P, S, NW);
  if (smem > (size_t)kWgSmemLimit) return (int)cudaErrorInvalidValue;
  const int C = H * D;
  CUtensorMap mq, mk, mv, mo;
  if (!make_ft_map(&mq, q, B, HW, C, CW, HG * M, G) || !make_ft_map(&mk, k, B, HW, C, CW, HG * M, G) ||
      !make_ft_map(&mv, v, B, HW, C, CW, HG * M, G) || !make_ft_map(&mo, out, B, HW, C, CW, M, 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * (1 + NW);
  int dev = 0, fit = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  static int sm_count[64] = {};   // per device, read once
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0 &&
      (err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kern, threads, smem)) !=
      cudaSuccess)
    return (int)err;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  const long items = frame_tma_units(B, HW, H, G, HG, extra...);
  const long slots = (long)sm_count[dev] * (bps < fit ? bps : fit);
  const unsigned blocks = (unsigned)(items < slots ? items : slots);
  kern<<<blocks, threads, smem, stream>>>(mq, mk, mv, mo, B, HW, H, G, HG, S, NW,
                                          scale * kLog2e, extra...);
  return (int)cudaGetLastError();
}

}  // namespace i360
