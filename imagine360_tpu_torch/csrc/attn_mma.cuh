// The tensor-core attention body of K1 (tiny_attention.cu), K2
// (mh_flash.cu), K3 (shared_bias.cu), K5a (flash_lse.cu), K6a (flash_t.cu)
// and K6b (shared_bias_folded.cu) for bf16 storage and head dims 1..160:
// what i360::flash_tile computes, with Q·Kᵀ and P·V on
// `mma.sync.m16n8k16` bf16 fragments and float32 accumulators. The backward
// tile of K5c is attn_mma_bwd.cuh; the tile of the wide K1 and K2 (head dims
// 161..512) is attn_mma_wide.cuh.
//
// What bounds these kernels on the H100: at their production sites (Sq and
// Sk of 1024 and 8192, D = 64; the WarpAttn sites of K3 at D = 32) each
// (batch, head) problem does 4·Sq·Sk·D operations on (2·Sq + 2·Sk)·D·2
// bytes, hundreds of operations a byte, above the card's ~295 bf16
// operations a byte of HBM: they are bound by operations, at 989 TFLOP/s
// bf16 on the tensor cores. The CUDA-core body (flash_tile, float tiles in
// shared memory) stays at 3-8 TFLOP/s, because every multiply-add there
// loads two floats from shared memory. K3's shared [Sq, Sk] float32 bias is
// the exception: at D = 32 each 4-byte bias element carries 128 operations,
// so K3 shares each staged bias tile between G (batch, head) problems
// (shared_bias.cu).
//
// Why `mma.sync` and not `wgmma`: `mma.sync` is one warp's instruction on
// register fragments, so the online softmax, the bias and the ragged masks
// stay plain per-thread code on the accumulator registers, and one body
// serves 16-, 32- and 64-row query tiles. `wgmma` (a warpgroup, operands in
// shared memory under a swizzled descriptor, asynchronous, best fed by TMA
// and mbarriers) is the next step for these kernels; it needs a layout and
// a pipeline of its own and is left to a later change.
//
// Layout: a group of NW warps owns BQ = 16·NW query rows of one (batch,
// head) problem in the natural [B, S, H·D] layout; each warp owns 16 rows.
// A block is one group (K1, K2, K5a) or G groups that share the bias tile
// (K3). The Q tile is staged once in shared memory and kept as A fragments
// in registers (ldmatrix). K and V tiles of 64 keys × DP (D padded with
// zero columns to the bucket DP, a multiple of 16) are staged as bf16 with
// 16-byte cp.async copies in two stages: the next tile's copies are in
// flight while the current one is computed. Shared-memory rows are DP + 8
// bf16 long, so the eight 16-byte rows of an ldmatrix fall into distinct
// banks. The optional float32 bias ([BQ, 64] of each key tile, rows 72
// floats long so that the 8-byte reads of four rows fall into distinct
// banks) rides in the same two stages, staged by every thread of the block
// with 16-byte copies where Sk % 4 == 0 and the pointer is 16-byte aligned,
// else 4-byte copies (the CLIP site has Sk = 77); rows past the query tail
// and keys past Sk are zero-filled. Per key tile a warp computes S = Q·Kᵀ
// (K fragments by ldmatrix), scales it by scale·log2(e), adds the bias ×
// log2(e), gives keys at or beyond Sk the finite kNegInf, keeps the running
// max (log2 units) and sum of its rows in registers (a row's max reduces
// over the four lanes of a quad with __shfl_xor_sync), and turns P =
// 2^(S - m) into the A operand of P·V in registers (V fragments by
// ldmatrix.trans), after rescaling the float32 O accumulators by α. P is
// either rounded to bf16 (K1, K2, K3: the plain versions cast the
// probabilities to v.dtype) or, with SPLIT_P (K5a: its plain version keeps
// them float32), split exactly into hi = bf16(p) and lo = bf16(p - hi),
// two products per k-step, about 16 significant bits instead of 8. The sum
// of a row is taken over the unrounded probabilities, as flash_tile does.
// The epilogue divides by the sum (a zero sum replaced by 1), writes the
// optional lse (m + log2 l)·ln 2 in natural units (kNegInf for a row whose
// max never rose above kNegInf, as kernels._softmax_stats floors it), stages
// the bf16 rows in the warp's own Q rows and writes them with 16-byte
// stores, masking the ragged query tail. Where D is no multiple of 8 or a
// pointer is not 16-byte aligned (`vec` false), the tiles are staged and
// written with 2-byte accesses instead; nothing reroutes to another kernel.
//
// Sequence-minor inputs (SEQ_MINOR, K6a: q [D, Sq] and k/v [D, Sk] of one
// problem) are staged as they lie, [DP][BQ + 8] and [DP][64 + 8] tiles of
// D rows (rows D..DP-1 zero) by 16-byte copies along the sequence, and only
// the fragment loads change: the transposition of each ldmatrix flips (Q's
// A fragments and K's B fragments by ldmatrix.trans, V's B fragments by
// plain ldmatrix, since the [D][key] tile is Vᵀ row-major). Rows of 72 bf16
// keep the eight rows of an ldmatrix in distinct banks. No transposed copy
// is made; the output rows are written as in the natural layout, staged in
// the K stages.
//
// Budget at DP = 64, 64-row tile (4 warps, 128 threads): Q staging 64 × 72
// bf16 = 9,216 bytes, two stages of K and V 4 × 64 × 72 bf16 = 36,864 bytes,
// 46,080 in all, so four blocks (16 warps) an SM by shared memory; a bias
// adds two stages of 64 × 72 floats, 36,864 bytes. Per thread the Q
// fragments take 16 registers, S 32, O 32, P 4 (8 split) per k-step. At
// DP = 160 a group takes 107,520 bytes and a thread 40 + 32 + 80 registers
// of operands. The ptxas report that build_library() keeps beside the
// library gives each instantiation's registers and spills.
//
// Raw PTX (cp.async, ldmatrix, mma.sync), no CUTLASS or CuTe header.
#pragma once

#include "attn_common.cuh"

namespace i360 {

using bf16 = __nv_bfloat16;

constexpr int kMmaBK = 64;                    // keys a tile
constexpr int kBiasLd = kMmaBK + 8;           // floats a staged bias row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// `valid` is false (src-size 0 reads nothing; src stays a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

// The same for 4 bytes (through L1: .cg takes 16-byte copies only).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a · b for one 16×8 tile: a the 16×16 A fragment (row-major), b0/b1
// the 16×8 B fragment (column-major), c four float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one register, `lo` in the low half (the
// lower column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// What pack_bf16(a, b) left out, rounded to bf16 in the same layout: a - hi
// is exact in float, so hi + lo carries about 16 significant bits.
__device__ __forceinline__ uint32_t pack_bf16_rest(float a, float b, uint32_t packed) {
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed));
  return pack_bf16(a - hi.x, b - hi.y);
}

// Stage `rows` rows of a [*, ld] bf16 matrix into a [rows][DP + 8] tile:
// rows at or beyond `nvalid` and columns in [D, DP) become 0. `tid` runs
// over NT threads. With `vec`, 16-byte cp.async copies (the caller commits
// and waits); else 2-byte loads and stores, done when the call returns.
template <int DP, int NT>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long ld, int rows,
                                           int nvalid, int D, bool vec, int tid) {
  constexpr int LDS = DP + 8;
  if (vec) {
    constexpr int CPR = DP / 8;   // 16-byte chunks a row
    for (int idx = tid; idx < rows * CPR; idx += NT) {
      const int r = idx / CPR, c = idx - r * CPR;
      const bool ok = r < nvalid && c * 8 < D;
      cp_async16(smem_u32(dst + r * LDS + c * 8), ok ? src + (long)r * ld + c * 8 : src, ok);
    }
  } else {
    for (int idx = tid; idx < rows * DP; idx += NT) {
      const int r = idx / DP, c = idx - r * DP;
      dst[r * LDS + c] =
          (r < nvalid && c < D) ? src[(long)r * ld + c] : __float2bfloat16(0.f);
    }
  }
}

// Stage columns [0, COLS) of a sequence-minor [D, ld] bf16 matrix (src at
// the tile's first column) into a [DP][COLS + 8] tile: columns at or beyond
// `nvalid` and rows in [D, DP) become 0. `tid` runs over NT threads. With
// `vec` (ld and nvalid multiples of 8, src 16-byte aligned), 16-byte
// cp.async copies along the sequence (the caller commits and waits); else
// 2-byte loads and stores, done when the call returns.
template <int DP, int NT, int COLS>
__device__ __forceinline__ void stage_cols(bf16* dst, const bf16* src, long ld, int nvalid,
                                           int D, bool vec, int tid) {
  constexpr int LDT = COLS + 8;
  if (vec) {
    constexpr int CPR = COLS / 8;   // 16-byte chunks a row
    for (int idx = tid; idx < DP * CPR; idx += NT) {
      const int r = idx / CPR, c = idx - r * CPR;
      const bool ok = r < D && c * 8 < nvalid;
      cp_async16(smem_u32(dst + r * LDT + c * 8), ok ? src + (long)r * ld + c * 8 : src, ok);
    }
  } else {
    for (int idx = tid; idx < DP * COLS; idx += NT) {
      const int r = idx / COLS, c = idx - r * COLS;
      dst[r * LDT + c] =
          (r < D && c < nvalid) ? src[(long)r * ld + c] : __float2bfloat16(0.f);
    }
  }
}

// Stage the [rows, 64] float bias of one key tile into a [rows][LDB] tile
// with cp.async, every thread of the block taking part: rows at or beyond
// `nq` and keys at or beyond `nk` become 0. `vec`: 16-byte copies (Sk % 4
// == 0 and a 16-byte-aligned pointer), else 4-byte copies. LDB: kBiasLd for
// the forward's reads of two keys of a row; the backward, which reads the
// tile transposed, takes its own (attn_mma_bwd.cuh).
template <int LDB = kBiasLd>
__device__ __forceinline__ void stage_bias(float* dst, const float* src, int Sk, int rows,
                                           int nq, int nk, bool vec) {
  if (vec) {
    constexpr int CPR = kMmaBK / 4;
    for (int idx = threadIdx.x; idx < rows * CPR; idx += blockDim.x) {
      const int r = idx / CPR, c = idx - r * CPR;
      const bool ok = r < nq && c * 4 < nk;
      cp_async16(smem_u32(dst + r * LDB + c * 4), ok ? src + (long)r * Sk + c * 4 : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * kMmaBK; idx += blockDim.x) {
      const int r = idx / kMmaBK, c = idx - r * kMmaBK;
      const bool ok = r < nq && c < nk;
      cp_async4(smem_u32(dst + r * LDB + c), ok ? src + (long)r * Sk + c : src, ok);
    }
  }
}

// The same for a bf16 bias (K6b), staged as it lies: `vec` 16-byte copies
// (Sk % 8 == 0 and a 16-byte-aligned pointer), else 2-byte loads and stores,
// done when the call returns. A row of kBiasLd bf16 keeps the 4-byte reads
// of two keys by the eight rows of a quad column in distinct banks.
template <int LDB = kBiasLd>
__device__ __forceinline__ void stage_bias(bf16* dst, const bf16* src, int Sk, int rows,
                                           int nq, int nk, bool vec) {
  if (vec) {
    constexpr int CPR = kMmaBK / 8;
    for (int idx = threadIdx.x; idx < rows * CPR; idx += blockDim.x) {
      const int r = idx / CPR, c = idx - r * CPR;
      const bool ok = r < nq && c * 8 < nk;
      cp_async16(smem_u32(dst + r * LDB + c * 8), ok ? src + (long)r * Sk + c * 8 : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * kMmaBK; idx += blockDim.x) {
      const int r = idx / kMmaBK, c = idx - r * kMmaBK;
      dst[r * LDB + c] = (r < nq && c < nk) ? src[(long)r * Sk + c] : __float2bfloat16(0.f);
    }
  }
}

// Two neighbouring keys of one staged bias row, as floats.
__device__ __forceinline__ float2 bias_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 bias_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Shared memory of one group: the Q tile and two stages of K and V tiles of
// `kt_rows` rows each.
template <int DP>
inline size_t attn_mma_smem_bytes(int bq, int kt_rows) {
  return sizeof(bf16) * (size_t)(bq + 4 * kt_rows) * (DP + 8);
}

// The same for sequence-minor inputs: the [DP][bq + 8] Q tile and two
// stages of [DP][64 + 8] K and V tiles.
template <int DP>
inline size_t attn_mma_t_smem_bytes(int bq) {
  return sizeof(bf16) * (size_t)DP * ((bq + 8) + 4 * (kMmaBK + 8));
}

// Shared memory of the two stages of a [bq, 64] float bias tile, placed
// before the groups' tiles.
__host__ __device__ inline size_t attn_mma_bias_bytes(int bq) { return sizeof(float) * 2 * (size_t)bq * kBiasLd; }

// Rows a staged key tile holds: 64, or Sk rounded up to 16 when it is
// shorter (the K1 sites of 16 and 64 keys stage no zero rows beyond that).
inline int attn_mma_kt_rows(int Sk) { return Sk >= kMmaBK ? kMmaBK : (Sk + 15) / 16 * 16; }

// 16-byte staging needs D % 8 == 0 (rows of H·D elements and head offsets
// h·D then stay 16-byte aligned) and 16-byte-aligned base pointers.
inline bool attn_mma_vec(int D, const void* a, const void* b, const void* c, const void* d) {
  return D % 8 == 0 &&
         (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d) & 15) == 0;
}

// 16-byte bias staging: rows of Sk floats stay 16-byte aligned (every row,
// batch and head offset is a multiple of Sk) from an aligned base.
inline bool attn_mma_bias_vec(int Sk, const float* bias) {
  return bias != nullptr && Sk % 4 == 0 && ((uintptr_t)bias & 15) == 0;
}

// The same for a bf16 bias: rows of Sk bf16 stay 16-byte aligned.
inline bool attn_mma_bias_vec(int Sk, const bf16* bias) {
  return bias != nullptr && Sk % 8 == 0 && ((uintptr_t)bias & 15) == 0;
}

// A template argument named, never deduced (flash_tile_mma's bias type:
// callers without a bias pass nullptr).
template <typename T> struct named { using type = T; };

// Streaming attention of one query tile of one (batch, head) problem on the
// tensor cores: BQ = 16·NW rows, a group of NW warps (threads
// [g·32·NW, (g + 1)·32·NW) of the block for group g). q/k/v/out point at
// element (row 0, head h) of their [*, S, H·D] rows, row stride `ld`;
// `out` null: nothing is written (a ragged last group of K3). `lse`, when
// not null, points at row 0 of this tile's float log-sum-exp rows. `bias`,
// when not null, points at row q0 of a [Sq, Sk] float matrix with row
// stride Sk (TB float, or bf16 for K6b, staged and read as it lies); every
// group of the block passes the same one, and `sbias` holds
// attn_mma_bias_bytes(BQ) bytes for its stages (half of them for bf16).
// `kt_rows` (attn_mma_kt_rows) rows of each key tile are staged; `smem` has
// attn_mma_smem_bytes<DP>(BQ, kt_rows) bytes, 16-byte aligned. SPLIT_P:
// P·V on the exact bf16 hi + lo split of the probabilities. SEQ_MINOR: q
// points at query 0 of a [D, ldq] matrix and k/v at key 0 of [D, ldk]
// matrices, `ld` is the row stride of `out` alone, `kt_rows` is not read
// and `smem` has attn_mma_t_smem_bytes<DP>(BQ) bytes; `vec` then also
// vouches for ldq, ldk and D being multiples of 8.
template <int DP, int NW, bool SPLIT_P = false, bool SEQ_MINOR = false, typename TB = float>
__device__ __forceinline__ void flash_tile_mma(const bf16* q, const bf16* k, const bf16* v,
                                               bf16* out, float* lse,
                                               const typename named<TB>::type* bias,
                                               bool bias_vec, long ld, int nq, int Sk, int D,
                                               float scale, bool vec, int kt_rows, bf16* smem,
                                               typename named<TB>::type* sbias, long ldq = 0,
                                               long ldk = 0) {
  constexpr int BQ = 16 * NW, NT = 32 * NW, LDS = DP + 8;
  constexpr int LDQ = BQ + 8, LDK = kMmaBK + 8;   // rows of the sequence-minor tiles
  constexpr int KS = DP / 16;     // k-steps of Q·Kᵀ
  constexpr int NO = DP / 8;      // 8-column tiles of O
  static_assert(DP % 16 == 0, "head-dim buckets are multiples of 16");
  const int tid = threadIdx.x % NT;         // thread within the group
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;   // row in an 8-row group; pair of columns
  bf16* sQ = smem;                          // [BQ][LDS], or [DP][LDQ]
  bf16* sK = sQ + (SEQ_MINOR ? DP * LDQ : BQ * LDS);   // 2 stages
  const int stage = SEQ_MINOR ? DP * LDK : kt_rows * LDS;
  bf16* sV = sK + 2 * stage;                // 2 stages
  const float sl2 = scale * kLog2e;
  const int ntiles = (Sk + kMmaBK - 1) / kMmaBK;

  // K and V of the key tile at k1 into stage offset st
  auto stage_kv = [&](int st, int k1) {
    const int n = min(kMmaBK, Sk - k1);
    if (SEQ_MINOR) {
      stage_cols<DP, NT, kMmaBK>(sK + st, k + k1, ldk, n, D, vec, tid);
      stage_cols<DP, NT, kMmaBK>(sV + st, v + k1, ldk, n, D, vec, tid);
    } else {
      stage_rows<DP, NT>(sK + st, k + (long)k1 * ld, ld, kt_rows, n, D, vec, tid);
      stage_rows<DP, NT>(sV + st, v + (long)k1 * ld, ld, kt_rows, n, D, vec, tid);
    }
  };
  if (SEQ_MINOR) stage_cols<DP, NT, BQ>(sQ, q, ldq, nq, D, vec, tid);
  else stage_rows<DP, NT>(sQ, q, ld, BQ, nq, D, vec, tid);
  stage_kv(0, 0);
  if (bias != nullptr) stage_bias(sbias, bias, Sk, BQ, nq, min(kMmaBK, Sk), bias_vec);
  cp_async_commit();

  uint32_t qf[KS][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // running max of rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};           // this lane's part of their running sums

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kMmaBK;
    const int nk = min(kMmaBK, Sk - k0);
    if (t + 1 < ntiles) {             // the next tile's copies fly during this one
      const int k1 = k0 + kMmaBK;
      const int nk1 = min(kMmaBK, Sk - k1);
      stage_kv(((t + 1) & 1) * stage, k1);
      if (bias != nullptr)
        stage_bias(sbias + ((t + 1) & 1) * BQ * kBiasLd, bias + k1, Sk, BQ, nq, nk1, bias_vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (SEQ_MINOR)   // the [d][query] tile read transposed
          ldsm_x4_trans(qf[ks], smem_u32(sQ + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDQ +
                                         warp * 16 + ((lane >> 3) & 1) * 8));
        else
          ldsm_x4(qf[ks], smem_u32(sQ + (warp * 16 + (lane & 15)) * LDS + ks * 16 +
                                   (lane >> 4) * 8));
      }
    }
    const bf16* cK = sK + (t & 1) * stage;
    const bf16* cV = sV + (t & 1) * stage;

    // S = Q·Kᵀ, 16 keys (two 8-key tiles) at a time; tiles past the last
    // key are skipped (nk is the same for the whole block)
    float s[8][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[2 * p][j] = s[2 * p + 1][j] = 0.f;
      if (p * 16 < nk) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t b[4];
          if (SEQ_MINOR)   // the [d][key] tile read transposed
            ldsm_x4_trans(b, smem_u32(cK + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDK +
                                      p * 16 + (lane >> 4) * 8));
          else
            ldsm_x4(b, smem_u32(cK + (p * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                                ks * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(s[2 * p], qf[ks], b[0], b[1]);
          mma_bf16(s[2 * p + 1], qf[ks], b[2], b[3]);
        }
      }
    }

    // scale, bias (two neighbouring keys of one row in one 8-byte read),
    // key mask, row max over the quad
    const TB* cB = sbias + (t & 1) * BQ * kBiasLd + (warp * 16 + g) * kBiasLd + tg * 2;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {      // rows g and g + 8
        float2 bv = make_float2(0.f, 0.f);
        if (bias != nullptr) bv = bias_pair(cB + hr * 8 * kBiasLd + n * 8);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = hr * 2 + c;
          const int key = n * 8 + tg * 2 + c;
          float x = fmaf(c ? bv.y : bv.x, kLog2e, s[n][j] * sl2);
          if (key >= nk) x = kNegInf;
          s[n][j] = x;
          mx[hr] = fmaxf(mx[hr], x);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // P = 2^(S - m), 16 keys at a time: summed unrounded, packed as the A
    // fragment of that k-step of P·V (the 8-key tiles 2kk and 2kk + 1), and
    // O += P·V, 16 columns (two 8-column tiles) at a time
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 2 * kk + h;
        const float p0 = exp2f(s[n][0] - m[0]), p1 = exp2f(s[n][1] - m[0]);
        const float p2 = exp2f(s[n][2] - m[1]), p3 = exp2f(s[n][3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        ph[h * 2] = pack_bf16(p0, p1);
        ph[h * 2 + 1] = pack_bf16(p2, p3);
        if (SPLIT_P) {
          pl[h * 2] = pack_bf16_rest(p0, p1, ph[h * 2]);
          pl[h * 2 + 1] = pack_bf16_rest(p2, p3, ph[h * 2 + 1]);
        }
      }
      if (kk * 16 < nk) {
#pragma unroll
        for (int n2 = 0; n2 < NO / 2; ++n2) {
          uint32_t b[4];
          if (SEQ_MINOR)   // the [d][key] tile is Vᵀ row-major
            ldsm_x4(b, smem_u32(cV + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LDK + kk * 16 +
                                ((lane >> 3) & 1) * 8));
          else
            ldsm_x4_trans(b, smem_u32(cV + (kk * 16 + (lane & 15)) * LDS + n2 * 16 +
                                      (lane >> 4) * 8));
          if (SPLIT_P) {
            mma_bf16(o[2 * n2], pl, b[0], b[1]);
            mma_bf16(o[2 * n2 + 1], pl, b[2], b[3]);
          }
          mma_bf16(o[2 * n2], ph, b[0], b[1]);
          mma_bf16(o[2 * n2 + 1], ph, b[2], b[3]);
        }
      }
    }
    __syncthreads();   // this stage is refilled two tiles on
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = l[r] == 0.f ? 1.f : l[r];
    inv[r] = 1.f / l[r];
  }
  const int r0 = warp * 16;
  const int rows = min(16, nq - r0);   // this warp's rows inside the tile
  if (rows <= 0 || out == nullptr) return;
  if (lse != nullptr && tg == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (g + r * 8 < rows)
        lse[r0 + g + r * 8] = m[r] == kNegInf ? kNegInf : (m[r] + log2f(l[r])) * kLn2;
  }
  if (vec) {
    // through the warp's own Q rows (read into registers at the first tile),
    // or with sequence-minor tiles 16 rows of the K stages, which no warp
    // reads after the last tile's barrier
    bf16* sO = (SEQ_MINOR ? sK : sQ) + r0 * LDS;
    __syncwarp();
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + tg * 2;
      *reinterpret_cast<__nv_bfloat162*>(sO + g * LDS + c) =
          __floats2bfloat162_rn(o[n][0] * inv[0], o[n][1] * inv[0]);
      *reinterpret_cast<__nv_bfloat162*>(sO + (g + 8) * LDS + c) =
          __floats2bfloat162_rn(o[n][2] * inv[1], o[n][3] * inv[1]);
    }
    __syncwarp();
    const int cpr = D / 8;
    for (int idx = lane; idx < rows * cpr; idx += 32) {
      const int r = idx / cpr, c = idx - r * cpr;
      *reinterpret_cast<uint4*>(out + (long)(r0 + r) * ld + c * 8) =
          *reinterpret_cast<const uint4*>(sO + r * LDS + c * 8);
    }
  } else {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = g + (j >> 1) * 8, c = n * 8 + tg * 2 + (j & 1);
        if (r < rows && c < D)
          out[(long)(r0 + r) * ld + c] = __float2bfloat16(o[n][j] * inv[j >> 1]);
      }
    }
  }
}

}  // namespace i360
