"""Time variants of the `wgmma` attention bodies (csrc/attn_wgmma.cuh,
csrc/attn_wgmma_bias.cuh, csrc/attn_wgmma_bwd.cuh,
csrc/attn_wgmma_bwd_bias.cuh) and of K7's `wgmma`
GEMM (csrc/dense_matmul.cu) on an NVIDIA GPU, for the checkout this script
lies in.

    python scripts/torch_wgmma_variants.py [--variants A,B] [--iters N] [--out FILE]

Each variant is one instantiation of `attn_wgmma_tile<LSE, SPLIT_P,
SEQ_MINOR>` from a copy of the committed header, some with fixed text
changes to the copy (the header itself builds one form: 128-key tiles, a
tile's softmax under the previous tile's P·V inside a warpgroup, three
stages, ex2.approx.ftz). The changes: `stages2`, `stages4`, the K/V ring
at two or four stages; `exp2f`, 2^x by exp2f (three more instructions a
logit, for subnormal results) instead of ex2.approx.ftz; `serial`, one
tile at a time (Q·Kᵀ, wait, softmax, O rescaled, P·V, wait) in place of
the overlapped key loop; `bk64`, 64-key tiles (kWgBK 64, six stages so the
ring holds as many bytes, and an m64n64k16 Q·Kᵀ step added). Three
families, each timed at its own kernel's sites:

- K2 (`mh_flash_attention`'s sites, P rounded once, the natural layout):
  `final`, the header as it is; `stages2`, `stages4`, `exp2f`;
  `serial_exp2f`, serial and exp2f at three stages; `serial_exp2f_stages2`
  at two, the first form of the body.
- K5a (`flash_attention_lse`'s training sites, with the lse): `lse_a`, P
  split into bf16 hi + lo on 64-key tiles with the overlap (form a);
  `lse_b`, P split on 128-key tiles one at a time (form b); `lse_c`, the
  header as it is (form c: P split on 128-key tiles with the overlap, P
  hi + lo of two tiles beside S and O); and `lse_a_unsplit`,
  `lse_b_unsplit`, forms a and b with P rounded once, as K2 does: what the
  split costs (they miss chip_smoke.K5A_MATCH).
- K6a (`flash_attention_t`'s pano sites, sequence-minor tiles): `t_a`,
  `t_b`, `t_c`, forms a, b and c with P split, and `t_a_unsplit`.
- K6b (`shared_bias_attention_folded`'s WarpAttn sites, from a copy of
  csrc/attn_wgmma_bias.cuh, instantiated for the site's bias dtype):
  `fb_final`, the header as it is (kFbT = 4 folded rows a block, 64-key
  tiles, a tile's bias pairs read into registers once for the 4 rows, a
  row's softmax under the previous row's P·V); `fb_t2`, two rows;
  `fb_t2_bk128`, two rows under 128-key tiles (m64n128k16 for S);
  `fb_serial`, one row at a time (S, wait, softmax, P·V left in flight
  into the next row's S); `fb_smem_bias`, the bias pairs read from shared
  memory again for each row. Four rows under
  128-key tiles leave room for one stage only (the header's static_assert
  refuses it), and an odd number of rows breaks the alternation of the
  two P register sets.
- K7 (`dense_matmul`'s sites, from a copy of csrc/dense_matmul.cu and its C
  entry `i360_dense_matmul_wgmma`): `k7_final`, the source as it is
  (128 x 160 output tiles); `k7_bm256`, 128 x 256 tiles (K7W_BM 256, one
  m64n256k16 step a k-step, whose PTX wrapper the script adds; three
  stages fit), each on a grid of one block an SM, no more than its tiles.
- K5b and K5c (`flash_bwd_dq`'s and `flash_bwd_dkv`'s training sites, from
  a copy of csrc/attn_wgmma_bwd.cuh, on the plain forward's lse and
  delta): `bq_final` and `bk_final`, the header as it is (K5b on 64-key
  tiles; each tile's last product, dS·K or dSᵀ·Q, left in flight under the
  next tile's S and dP); `bq_serial` and `bk_serial`, that product waited
  for at once; `bq_bk128`, K5b on 128-key tiles (m64n128k16 for S and dP,
  two stages so the ring holds as many bytes).
- K5b and K5c at the WarpAttn sites (D = 32 under the shared float32 bias,
  from a copy of csrc/attn_wgmma_bwd_bias.cuh, on the plain forward's lse
  and delta under that bias): `bqb_final` and `bkb_final`, the header as
  it is (K5b four (batch, head) row slots a block under each bias tile,
  each slot's dS·K left in flight under the next slot's S and dP, the
  tile's last waited for before the next tile; K5c two slots, each dSᵀ·Q
  waited for at once); `bqb_overlap`, the tile's last left in flight too,
  across the key loop's back edge (ptxas serialises the loop: C7515);
  `bqb_serial`, every dS·K waited for at once; `bkb_tile_overlap` and
  `bkb_overlap`, K5c's dSᵀ·Q left in flight within a tile, and across
  tiles too; `bqb_t2`, `bqb_t1`, `bkb_t1`, `bkb_t4`, other row slots a
  block (kBqbT, kBkbT: the stages that fit follow; K5c's dk and dv take 32
  registers a slot, so four spill); `bqb_smem_bias`, `bkb_smem_bias`, the
  bias values read from shared memory again for each slot instead of once
  a tile.

Every variant of a family computes the same arithmetic but for the
roundings its form moves (ftz moves only results below 2^-126; the key tile
moves where the running max rescales; the unsplit ones round P once). Each
is compiled alone (one kernel and a C entry, or K7's source with its C
entries, `nvcc` in parallel) into
imagine360_tpu_torch/_build/wgmma_variants/, its ptxas lines (registers,
spills, C7513 and other warnings) printed; then at every site of a family
its variants run in turns (all, then all again; CUDA events, N calls each
after a warm-up): ms and TFLOP/s of each, its error against the plain
version on the first batch row (chip_smoke.py's phase-2 limit), for K5a and
K6a the share of those outputs equal to the plain version's bit for bit
(`match`, against chip_smoke.K5A_MATCH) and K5a's lse error, and whether
its output equals the family's first variant's bit for bit. One JSON line a
site.

Needs nvcc and a card; imports no JAX.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from imagine360_tpu_torch.ops import kernels  # noqa: E402

HEADER = kernels.CSRC / "attn_wgmma.cuh"
FB_HEADER = kernels.CSRC / "attn_wgmma_bias.cuh"
K7_SOURCE = kernels.CSRC / "dense_matmul.cu"
OUT_DIR = kernels.BUILD_DIR / "wgmma_variants"
# name: (family, (LSE, SPLIT_P, SEQ_MINOR), text changes of the header)
VARIANTS = {
    "final": ("k2", (0, 0, 0), ()),
    "stages2": ("k2", (0, 0, 0), ("stages2",)),
    "stages4": ("k2", (0, 0, 0), ("stages4",)),
    "exp2f": ("k2", (0, 0, 0), ("exp2f",)),
    "serial_exp2f": ("k2", (0, 0, 0), ("serial", "exp2f")),
    "serial_exp2f_stages2": ("k2", (0, 0, 0), ("serial", "exp2f", "stages2")),
    "lse_a": ("k5a", (1, 1, 0), ("bk64",)),
    "lse_b": ("k5a", (1, 1, 0), ("serial",)),
    "lse_c": ("k5a", (1, 1, 0), ()),
    "lse_a_unsplit": ("k5a", (1, 0, 0), ("bk64",)),
    "lse_b_unsplit": ("k5a", (1, 0, 0), ("serial",)),
    "t_a": ("k6a", (0, 1, 1), ("bk64",)),
    "t_b": ("k6a", (0, 1, 1), ("serial",)),
    "t_c": ("k6a", (0, 1, 1), ()),
    "t_a_unsplit": ("k6a", (0, 0, 1), ("bk64",)),
    "fb_final": ("k6b", (), ()),
    "fb_t2": ("k6b", (), ("t2",)),
    "fb_t2_bk128": ("k6b", (), ("t2", "fbk128")),
    "fb_serial": ("k6b", (), ("fb_serial",)),
    "fb_smem_bias": ("k6b", (), ("fb_smem_bias",)),
    "bq_final": ("k5b", (), ()),
    "bq_serial": ("k5b", (), ("bq_serial",)),
    "bq_bk128": ("k5b", (), ("bq_bk128",)),
    "bk_final": ("k5c", (), ()),
    "bk_serial": ("k5c", (), ("bk_serial",)),
    "bqb_final": ("k5b_bias", (), ()),
    "bqb_overlap": ("k5b_bias", (), ("bqb_overlap",)),
    "bqb_serial": ("k5b_bias", (), ("bqb_serial",)),
    "bqb_t2": ("k5b_bias", (), ("bqb_t2",)),
    "bqb_t1": ("k5b_bias", (), ("bqb_t1",)),
    "bqb_smem_bias": ("k5b_bias", (), ("bqb_smem_bias",)),
    "bkb_final": ("k5c_bias", (), ()),
    "bkb_tile_overlap": ("k5c_bias", (), ("bkb_tile_overlap",)),
    "bkb_overlap": ("k5c_bias", (), ("bkb_overlap",)),
    "bkb_t1": ("k5c_bias", (), ("bkb_t1",)),
    "bkb_t4": ("k5c_bias", (), ("bkb_t4",)),
    "bkb_smem_bias": ("k5c_bias", (), ("bkb_smem_bias",)),
    "k7_final": ("k7", (160,), ()),
    "k7_bm256": ("k7", (256,), ("bm256",)),
}
# (family, wrapper, (B, Sq, Sk, H, D)): the sites of K1, K2, K5a and K6a on
# the wgmma body
SITES = [("k2", "mh_flash_attention", (32, 8192, 8192, 5, 64)),
         ("k2", "mh_flash_attention", (32, 2048, 2048, 10, 64)),
         ("k2", "mh_flash_attention", (16, 8448, 8448, 10, 64)),
         ("k2", "tiny_attention", (640, 1024, 1024, 5, 64)),
         ("k2", "tiny_attention", (32, 512, 512, 20, 64)),
         ("k2", "tiny_attention", (64, 333, 1000, 5, 64)),
         ("k2", "mh_flash_attention", (4, 1000, 3001, 5, 64)),
         ("k5a", "flash_attention_lse", (16, 8192, 8192, 5, 64)),
         ("k5a", "flash_attention_lse", (16, 2048, 2048, 10, 64)),
         ("k5a", "flash_attention_lse", (16, 4096, 8192, 5, 64)),
         ("k6a", "flash_attention_t", (32, 8192, 8192, 5, 64)),
         ("k6a", "flash_attention_t", (32, 2048, 2048, 10, 64)),
         # K6b (BH, Sq, Sk, D) and its bias dtype
         ("k6b", "shared_bias_attention_folded", (320, 2048, 5120, 32, "float32")),
         ("k6b", "shared_bias_attention_folded", (320, 5120, 2048, 32, "float32")),
         ("k6b", "shared_bias_attention_folded", (320, 2048, 5120, 32, "bfloat16")),
         ("k6b", "shared_bias_attention_folded", (1280, 128, 320, 32, "float32")),
         # K7 (N, K, M): the four sites of the most time, pano s1 and pers s2, then
         # the s3 ones (a last wave of few tiles)
         # K5b and K5c: the training step's pano sites, and a rank's pano rows of 2
         ("k5b", "flash_bwd_dq", (16, 8192, 8192, 5, 64)),
         ("k5b", "flash_bwd_dq", (16, 2048, 2048, 10, 64)),
         ("k5b", "flash_bwd_dq", (16, 4096, 8192, 5, 64)),
         ("k5c", "flash_bwd_dkv", (16, 8192, 8192, 5, 64)),
         ("k5c", "flash_bwd_dkv", (16, 2048, 2048, 10, 64)),
         ("k5c", "flash_bwd_dkv", (16, 4096, 8192, 5, 64)),
         # K5b and K5c at the WarpAttn sites of a training step: r2 both ways,
         # r4 at 40 heads, r8
         ("k5b_bias", "flash_bwd_dq", (16, 2048, 5120, 10, 32)),
         ("k5b_bias", "flash_bwd_dq", (16, 5120, 2048, 10, 32)),
         ("k5b_bias", "flash_bwd_dq", (16, 512, 1280, 40, 32)),
         ("k5b_bias", "flash_bwd_dq", (16, 128, 320, 40, 32)),
         ("k5c_bias", "flash_bwd_dkv", (16, 2048, 5120, 10, 32)),
         ("k5c_bias", "flash_bwd_dkv", (16, 5120, 2048, 10, 32)),
         ("k5c_bias", "flash_bwd_dkv", (16, 512, 1280, 40, 32)),
         ("k5c_bias", "flash_bwd_dkv", (16, 128, 320, 40, 32)),
         ("k7", "dense_matmul", (655360, 320, 320)),
         ("k7", "dense_matmul", (262144, 320, 320)),
         ("k7", "dense_matmul", (163840, 640, 640)),
         ("k7", "dense_matmul", (16384, 1280, 1280)),
         ("k7", "dense_matmul", (65536, 640, 640)),
         ("k7", "dense_matmul", (40960, 1280, 1280)),
         ("k7", "dense_matmul", (10240, 1280, 1280)),
         ("k7", "dense_matmul", (4096, 1280, 1280))]

STAGES = "constexpr int kWgStages = 3;"
BK = "constexpr int kWgBK = 128;"
# the overlapped key loop of a consumer, from tile 0's Q·Kᵀ to the last P·V
LOOP_START = "    // tile 0: S, then its softmax (O is 0: its rescale is a no-op)\n"
LOOP_END = "    // epilogue:"
SERIAL_LOOP = """    // one tile at a time: S, its softmax, O rescaled, P·V, each waited for
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kWgStages;
      const uint32_t parity = (t / kWgStages) & 1;
      mbar_wait(full_k(s), parity);
      wgmma_fence();
      qk(s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      float alpha0, alpha1;
      wg_softmax(sc, sl2, min(kWgBK, Sk - t * kWgBK), tg, m0, m1, l0, l1, alpha0, alpha1, pa);
      wg_rescale(o, alpha0, alpha1);
      mbar_wait(full_v(s), parity);
      const uint64_t dv = wg_desc(sV + s * kWgKVBytes);
      fence_regs(o);
      wgmma_fence();
      pv(dv, pa);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

"""
# the Q·Kᵀ step of a 64-key tile, inserted before the P·V step
RS_STEP = "// d += a·b for one m64n64k16 step: a the bf16 A fragment"
QK64 = """// d (+)= a·b for one m64n64k16 step (64-key tiles), as wgmma_qk.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\\n"
      ".reg .pred p;\\n"
      "setp.ne.b32 p, %34, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\\n"
      "}\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

"""
KERNEL = """#include "{header}"
namespace i360 {{
__global__ void __launch_bounds__(kWgThreads, 1)
wgmma_variant_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
                     float* lse, int Sq, int Sk, int H, int nqt, float sl2) {{
  extern __shared__ __align__(1024) unsigned char variant_smem[];
  attn_wgmma_tile<{lse}, {split}, {seq}>(&mq, &mk, &mv, &mo, lse, Sq, Sk, H, nqt, sl2,
                                         variant_smem);
}}
}}  // namespace i360
extern "C" int wgmma_variant(const void* q, const void* k, const void* v, void* out, void* lse,
                             int B, int Sq, int Sk, int H, float scale, void* stream) {{
  return i360::launch_attn_wgmma<{seq}>(i360::wgmma_variant_kernel, q, k, v, out, B, Sq, Sk, H,
                                        scale, (cudaStream_t)stream, (float*)lse);
}}
"""


FB_T = "constexpr int kFbT = 4;"
# the bias pairs read once a tile, and the softmax's head, as `fb_smem_bias`
# finds and changes them
FB_BIAS_ONCE = """      float2 bq[kFbBK / 8][2];
#pragma unroll
      for (int i = 0; i < kFbBK / 8; ++i) {
        bq[i][0] = fb_bias<TB>(sb, r, i, tg);
        bq[i][1] = fb_bias<TB>(sb, r + 8, i, tg);
      }
"""
FB_SOFTMAX_HEAD = """template <bool MASK>
__device__ __forceinline__ void fb_softmax(float (&sc)[kFbBK / 2],
                                           const float2 (&bq)[kFbBK / 8][2],
                                           int tg,"""
FB_SOFTMAX_HEAD_SMEM = """template <typename TB, bool MASK>
__device__ __forceinline__ void fb_softmax(float (&sc)[kFbBK / 2],
                                           const unsigned char* sb, int r,
                                           int tg,"""
# the overlapped key loop of a K6b consumer, and what `fb_serial` puts there
FB_LOOP_START = "    // the key loop: item (t, j) issues"
FB_LOOP_END = "    // epilogue, each folded row:"
FB_SERIAL_LOOP = """    // one row at a time: S_j, its wait (which also completes the P·V
    // before it), softmax, O_j rescaled, P·V issued
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % B::kStages;
      mbar_wait(full(s), (t / B::kStages) & 1);
      const int nk = min(kFbBK, Sk - t * kFbBK);
      const unsigned char* sb = gbase + (stage(s) - base);
      float2 bq[kFbBK / 8][2];
#pragma unroll
      for (int i = 0; i < kFbBK / 8; ++i) {
        bq[i][0] = fb_bias<TB>(sb, r, i, tg);
        bq[i][1] = fb_bias<TB>(sb, r + 8, i, tg);
      }
#pragma unroll
      for (int j = 0; j < kFbT; ++j) {
        wgmma_fence();
        qk(s, j);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_o();
        if (j == 0 && t > 0) release((t - 1) % B::kStages);
        float a0, a1;
        if (nk < kFbBK) fb_softmax<true>(sc, bq, tg, scale, nk, m[j], l[j], a0, a1, pa[0]);
        else fb_softmax<false>(sc, bq, tg, scale, nk, m[j], l[j], a0, a1, pa[0]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[j][4 * i] *= a0;
          o[j][4 * i + 1] *= a0;
          o[j][4 * i + 2] *= a1;
          o[j][4 * i + 3] *= a1;
        }
        wgmma_fence();
        pv(o[j], pa[0], kt_of(s, j) + kFbKVBytes);
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    fence_o();
    release((ntiles - 1) % B::kStages);

"""
FB_BK = "constexpr int kFbBK = 64;"
FB_KERNEL = """#include "{header}"
namespace i360 {{
template <typename TB>
__global__ void __launch_bounds__(kWgThreads, 1)
fb_variant_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
                  const __grid_constant__ CUtensorMap mb, float* lse, int BH, int Sq, int Sk,
                  int nrg, float scale) {{
  extern __shared__ __align__(1024) unsigned char variant_smem[];
  attn_wgmma_bias_tile<TB>(&mq, &mk, &mv, &mo, &mb, lse, BH, Sq, Sk, nrg, scale, variant_smem);
}}
}}  // namespace i360
extern "C" int fb_variant(const void* q, const void* k, const void* v, const void* bias,
                          void* out, void* lse, int BH, int Sq, int Sk, float scale,
                          int bias_dtype, void* stream) {{
  using bf16 = __nv_bfloat16;
  if (bias_dtype == 1)
    return i360::launch_attn_wgmma_bias<bf16>(i360::fb_variant_kernel<bf16>, q, k, v, bias, out,
                                              (float*)lse, BH, Sq, Sk, scale, (cudaStream_t)stream);
  return i360::launch_attn_wgmma_bias<float>(i360::fb_variant_kernel<float>, q, k, v, bias, out,
                                             (float*)lse, BH, Sq, Sk, scale, (cudaStream_t)stream);
}}
"""


BW_HEADER = kernels.CSRC / "attn_wgmma_bwd.cuh"
BQ_BK = "constexpr int kBqBK = 64;"
BQ_STAGES = "constexpr int kBqStages = 4;"
# each tile's last product, left in flight into the next tile
BQ_LAST = "      bw_rs<kBqBK>(acc, dh, dl, wg_desc(sKs));\n      wgmma_commit();\n"
BK_LAST = "      bw_rs<64>(dka, dh, dl, wg_desc(sQs));\n      wgmma_commit();\n"
BW_KERNEL = """#include "{header}"
namespace i360 {{
__global__ void __launch_bounds__(kWgThreads, 1)
bq_variant_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
                  const __grid_constant__ CUtensorMap mdq, const float* lse, const float* delta,
                  int Sq, int Sk, int H, int nqt, float sl2, float scale) {{
  extern __shared__ __align__(1024) unsigned char variant_smem[];
  attn_wgmma_bwd_dq_tile(&mq, &mk, &mv, &mg, &mdq, lse, delta, Sq, Sk, H, nqt, sl2, scale,
                         variant_smem);
}}
__global__ void __launch_bounds__(kWgThreads, 1)
bk_variant_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
                  const __grid_constant__ CUtensorMap ml, const __grid_constant__ CUtensorMap md,
                  const __grid_constant__ CUtensorMap mdk, const __grid_constant__ CUtensorMap mdv,
                  int Sq, int Sk, int H, int nkt, float sl2, float scale) {{
  extern __shared__ __align__(1024) unsigned char variant_smem[];
  attn_wgmma_bwd_dkv_tile(&mq, &mk, &mv, &mg, &ml, &md, &mdk, &mdv, Sq, Sk, H, nkt, sl2, scale,
                          variant_smem);
}}
}}  // namespace i360
extern "C" int bw_variant(const void* q, const void* k, const void* v, const void* g,
                          const void* lse, const void* delta, void* o0, void* o1, int B, int Sq,
                          int Sk, int H, float scale, void* stream) {{
  if ({dq})
    return i360::launch_bwd_dq_wgmma(i360::bq_variant_kernel, q, k, v, g, (const float*)lse,
                                     (const float*)delta, o0, B, Sq, Sk, H, scale,
                                     (cudaStream_t)stream);
  return i360::launch_bwd_dkv_wgmma(i360::bk_variant_kernel, q, k, v, g, (const float*)lse,
                                    (const float*)delta, o0, o1, B, Sq, Sk, H, scale,
                                    (cudaStream_t)stream);
}}
"""


BWB_HEADER = kernels.CSRC / "attn_wgmma_bwd_bias.cuh"
BQB_T = "constexpr int kBqbT = 4;"
BKB_T = "constexpr int kBkbT = 2;"
# where the header waits for K5b's tile's last dS·K and K5c's every dSᵀ·Q,
# and where the first wait of an item stands (the overlap forms return the
# previous stage there, as PR 21's bodies do)
BQB_TILE_END = """        if (j == T - 1) {
          wgmma_wait<0>();
          fence_regs(acc[j]);
          release(s);
        }
"""
BQB_S_WAIT = "        wgmma_wait<1>();                  // S_j, and the previous slot's dS·K before it\n"
BKB_ITEM_END = """        wgmma_wait<0>();
        fence_regs(dka[j]);
        if (j == T - 1) release(s);
"""
BKB_S_WAIT = "        wgmma_wait<1>();                  // Sᵀ_j\n"
RELEASE_LAST = "        if (j == 0 && t > 0) release((t - 1) % P::kStages);\n"
# the bias values read into registers once a tile, and where the
# smem_bias forms read them again for each row slot instead
BQB_BIAS_ONCE = """      float2 bq[kFbBK / 8][2];
#pragma unroll
      for (int i = 0; i < kFbBK / 8; ++i) {
        bq[i][0] = fb_bias<float>(sb, r, i, tg);
        bq[i][1] = fb_bias<float>(sb, r + 8, i, tg);
      }
"""
BQB_BIAS_USE = "const float2 b = bq[i][e >> 1];"
BKB_BIAS_ONCE = """      float bt[32];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bt[4 * i + e] = bkb_bias(sb, 8 * i + 2 * tg + (e & 1), kr + 8 * (e >> 1));
"""
BKB_BIAS_USE = "fmaf(st[4 * i + e], scale, bt[4 * i + e])"
BWB_KERNEL = """#include "{header}"
namespace i360 {{
__global__ void __launch_bounds__(kWgThreads, 1)
bqb_variant_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
                   const __grid_constant__ CUtensorMap mdq, const __grid_constant__ CUtensorMap mb,
                   const float* lse, const float* delta, int BH, int Sq, int Sk, int H, int nrg,
                   float scale) {{
  extern __shared__ __align__(1024) unsigned char variant_smem[];
  attn_wgmma_bwd_dq_bias_tile<kBqbT>(&mq, &mk, &mv, &mg, &mdq, &mb, lse, delta, BH, Sq, Sk, H,
                                     nrg, scale, variant_smem);
}}
__global__ void __launch_bounds__(kWgThreads, 1)
bkb_variant_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
                   const __grid_constant__ CUtensorMap ml, const __grid_constant__ CUtensorMap md,
                   const __grid_constant__ CUtensorMap mdk, const __grid_constant__ CUtensorMap mdv,
                   const __grid_constant__ CUtensorMap mb, int BH, int Sq, int Sk, int H, int nrg,
                   float scale) {{
  extern __shared__ __align__(1024) unsigned char variant_smem[];
  attn_wgmma_bwd_dkv_bias_tile<kBkbT>(&mq, &mk, &mv, &mg, &ml, &md, &mdk, &mdv, &mb, BH, Sq, Sk,
                                      H, nrg, scale, variant_smem);
}}
}}  // namespace i360
extern "C" int bwb_variant(const void* q, const void* k, const void* v, const void* g,
                           const void* bias, const void* lse, const void* delta, void* o0,
                           void* o1, int B, int Sq, int Sk, int H, float scale, void* stream) {{
  if ({dq})
    return i360::launch_bwd_dq_bias_wgmma<i360::kBqbT>(
        i360::bqb_variant_kernel, q, k, v, g, (const float*)bias, (const float*)lse,
        (const float*)delta, o0, B, Sq, Sk, H, scale, (cudaStream_t)stream);
  return i360::launch_bwd_dkv_bias_wgmma<i360::kBkbT>(
      i360::bkb_variant_kernel, q, k, v, g, (const float*)bias, (const float*)lse,
      (const float*)delta, o0, o1, B, Sq, Sk, H, scale, (cudaStream_t)stream);
}}
"""


K7_BM = "constexpr int K7W_BM = 160;"
K7_STEP = "wgmma_ss<K7W_BM>(acc,"
K7_CONSTANTS = "constexpr int K7W_BN = 128;"


def ss_step(n):
    """The PTX wrapper of one m64nNk16 step, both operands from shared memory
    K-major, named wgmma_ss_nN, as csrc/wgmma_ops.cuh writes those of the
    widths its kernels take."""
    regs = ", ".join(f"%{i}" for i in range(n // 2))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(n // 2))
    return f"""__device__ __forceinline__ void wgmma_ss_n{n}(float (&d)[{n // 2}], uint64_t da,
                                              uint64_t db, int scale_d) {{
  asm volatile(
      "{{\\n"
      ".reg .pred p;\\n"
      "setp.ne.b32 p, %{n // 2 + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{regs}}}, "
      "%{n // 2}, %{n // 2 + 1}, p, 1, 1, 0, 0;\\n"
      "}}\\n"
      : {outs}
      : "l"(da), "l"(db), "r"(scale_d));
}}

"""


def replace_once(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f"the header no longer has exactly one {old[:60]!r}")
    return text.replace(old, new)


def variant_header(name):
    """The committed header with the variant's text changes."""
    family = VARIANTS[name][0]
    text = {"k6b": FB_HEADER, "k7": K7_SOURCE, "k5b": BW_HEADER, "k5c": BW_HEADER,
            "k5b_bias": BWB_HEADER, "k5c_bias": BWB_HEADER}.get(family, HEADER).read_text()
    for change in VARIANTS[name][2]:
        if change in ("bqb_t2", "bqb_t1"):
            text = replace_once(text, BQB_T, f"constexpr int kBqbT = {change[-1]};")
        elif change in ("bkb_t1", "bkb_t4"):
            text = replace_once(text, BKB_T, f"constexpr int kBkbT = {change[-1]};")
        elif change == "bqb_smem_bias":
            text = replace_once(text, BQB_BIAS_ONCE, "")
            text = replace_once(text, BQB_BIAS_USE,
                                "const float2 b = fb_bias<float>(sb, r + 8 * (e >> 1), i, tg);")
        elif change == "bkb_smem_bias":
            text = replace_once(text, BKB_BIAS_ONCE, "")
            text = replace_once(text, BKB_BIAS_USE, "fmaf(st[4 * i + e], scale, bkb_bias(sb, "
                                "8 * i + 2 * tg + (e & 1), kr + 8 * (e >> 1)))")
        elif change == "bqb_overlap":
            text = replace_once(text, BQB_TILE_END, "")
            text = replace_once(text, BQB_S_WAIT, BQB_S_WAIT + RELEASE_LAST)
        elif change == "bqb_serial":
            text = replace_once(text, BQB_TILE_END, "        wgmma_wait<0>();\n"
                                "        fence_regs(acc[j]);\n        if (j == T - 1) release(s);\n")
        elif change == "bkb_tile_overlap":
            text = replace_once(text, BKB_ITEM_END, "        if (j == T - 1) {\n"
                                "          wgmma_wait<0>();\n          fence_regs(dka[j]);\n"
                                "          release(s);\n        }\n")
        elif change == "bkb_overlap":
            text = replace_once(text, BKB_ITEM_END, "")
            text = replace_once(text, BKB_S_WAIT, BKB_S_WAIT + RELEASE_LAST)
        elif change == "bq_serial":
            text = replace_once(text, BQ_LAST, BQ_LAST + "      wgmma_wait<0>();\n"
                                "      fence_regs(acc);\n")
        elif change == "bk_serial":
            text = replace_once(text, BK_LAST, BK_LAST + "      wgmma_wait<0>();\n"
                                "      fence_regs(dka);\n      fence_regs(dva);\n")
        elif change == "bq_bk128":
            text = replace_once(text, BQ_BK, "constexpr int kBqBK = 128;")
            text = replace_once(text, BQ_STAGES, "constexpr int kBqStages = 2;")
        elif change == "bm256":
            text = replace_once(text, K7_BM, "constexpr int K7W_BM = 256;")
            text = replace_once(text, K7_STEP, "wgmma_ss_n256(acc,")
            text = replace_once(text, K7_CONSTANTS, ss_step(256) + K7_CONSTANTS)
        elif change == "t2":
            text = replace_once(text, FB_T, "constexpr int kFbT = 2;")
        elif change == "fb_smem_bias":
            text = replace_once(text, FB_BIAS_ONCE, "")
            text = replace_once(text, "const float2 b0 = bq[i][0], b1 = bq[i][1];",
                                "const float2 b0 = fb_bias<TB>(sb, r, i, tg), "
                                "b1 = fb_bias<TB>(sb, r + 8, i, tg);")
            text = replace_once(text, FB_SOFTMAX_HEAD, FB_SOFTMAX_HEAD_SMEM)
            for mask in ("true", "false"):
                call = f"fb_softmax<{mask}>(sc, bq, tg,"
                if text.count(call) != 2:
                    raise SystemExit("the K6b header's softmax calls moved")
                text = text.replace(call, f"fb_softmax<TB, {mask}>(sc, sb, r, tg,")
        elif change == "fb_serial":
            if text.count(FB_LOOP_START) != 1 or text.count(FB_LOOP_END) != 1:
                raise SystemExit("the K6b header's key loop no longer has its two markers")
            start, end = text.index(FB_LOOP_START), text.index(FB_LOOP_END)
            text = text[:start] + FB_SERIAL_LOOP + text[end:]
        elif change == "fbk128":
            text = replace_once(text, FB_BK, "constexpr int kFbBK = 128;")
        elif change.startswith("stages"):
            text = replace_once(text, STAGES, f"constexpr int kWgStages = {change[-1]};")
        elif change == "exp2f":
            start = text.index("__device__ __forceinline__ void wg_softmax(")
            end = text.index("// O's rows g")
            text = text[:start] + text[start:end].replace("ex2_ftz(", "exp2f(") + text[end:]
        elif change == "serial":
            if text.count(LOOP_START) != 1 or text.count(LOOP_END) != 1:
                raise SystemExit("the header's key loop no longer has its two markers")
            start, end = text.index(LOOP_START), text.index(LOOP_END)
            text = text[:start] + SERIAL_LOOP + text[end:]
        elif change == "bk64":
            text = replace_once(text, BK, "constexpr int kWgBK = 64;")
            text = replace_once(text, STAGES, "constexpr int kWgStages = 6;")
            text = replace_once(text, RS_STEP, QK64 + RS_STEP)
    return text


def build(names):
    """{variant: ctypes function}, each compiled alone and in parallel. A
    variant that fails to compile is reported and left out."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, procs = kernels.find_nvcc(), {}
    for name in names:
        if VARIANTS[name][0] == "k7":
            (OUT_DIR / f"{name}.cu").write_text(variant_header(name))
        elif VARIANTS[name][0] == "k6b":
            (OUT_DIR / f"{name}.cuh").write_text(variant_header(name))
            (OUT_DIR / f"{name}.cu").write_text(FB_KERNEL.format(header=f"{name}.cuh"))
        elif VARIANTS[name][0] in ("k5b", "k5c"):
            (OUT_DIR / f"{name}.cuh").write_text(variant_header(name))
            (OUT_DIR / f"{name}.cu").write_text(BW_KERNEL.format(
                header=f"{name}.cuh", dq="true" if VARIANTS[name][0] == "k5b" else "false"))
        elif VARIANTS[name][0] in ("k5b_bias", "k5c_bias"):
            (OUT_DIR / f"{name}.cuh").write_text(variant_header(name))
            (OUT_DIR / f"{name}.cu").write_text(BWB_KERNEL.format(
                header=f"{name}.cuh", dq="true" if VARIANTS[name][0] == "k5b_bias" else "false"))
        else:
            (OUT_DIR / f"{name}.cuh").write_text(variant_header(name))
            lse, split, seq = VARIANTS[name][1]
            (OUT_DIR / f"{name}.cu").write_text(KERNEL.format(
                header=f"{name}.cuh", lse=str(bool(lse)).lower(),
                split=str(bool(split)).lower(), seq=str(bool(seq)).lower()))
        log = open(OUT_DIR / f"{name}.log", "w")
        procs[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-I", str(kernels.CSRC), "-o",
             str(OUT_DIR / f"lib_{name}.so"), str(OUT_DIR / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        code = proc.wait()
        report = (OUT_DIR / f"{name}.log").read_text()
        if code != 0:
            print(json.dumps(dict(variant=name, nvcc_failed=report[-4000:])), flush=True)
            continue
        notes = [line.replace("ptxas info    :", "").strip() for line in report.splitlines()
                 if "Used" in line or "spill" in line or "C75" in line or "warning" in line]
        print(json.dumps(dict(variant=name, ptxas=notes)), flush=True)
        lib = ctypes.CDLL(str(OUT_DIR / f"lib_{name}.so"))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if VARIANTS[name][0] == "k7":
            fn = lib.i360_dense_matmul_wgmma
            fn.argtypes = [P, P, P, I, I, I, I, P]
        elif VARIANTS[name][0] == "k6b":
            fn = lib.fb_variant
            fn.argtypes = [P, P, P, P, P, P, I, I, I, F, I, P]
        elif VARIANTS[name][0] in ("k5b", "k5c"):
            fn = lib.bw_variant
            fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, F, P]
        elif VARIANTS[name][0] in ("k5b_bias", "k5c_bias"):
            fn = lib.bwb_variant
            fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, F, P]
        else:
            fn = lib.wgmma_variant
            fn.argtypes = [P, P, P, P, P, I, I, I, I, F, P]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def site_inputs(wrapper, shape, gen, dev):
    """q, k, v of one site in its wrapper's layout, the plain version's
    (out, lse or None) on the first batch row, and (out, lse) buffers."""
    B, Sq, Sk, H, D = shape
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).bfloat16()
    scale = D ** -0.5
    if wrapper == "flash_attention_t":
        q, k, v = rnd(B, H, D, Sq), rnd(B, H, D, Sk), rnd(B, H, D, Sk)
        plain = (kernels.flash_attention_t_plain(q[:1], k[:1], v[:1], scale=scale), None)
        out = lambda: torch.empty(B, H, Sq, D, device=dev, dtype=torch.bfloat16)
    elif wrapper == "flash_attention_lse":
        q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D)
        plain = kernels.flash_attention_lse_plain(q[:1], k[:1], v[:1], scale=scale)
        out = lambda: torch.empty_like(q)
    else:
        q, k, v = rnd(B, Sq, H * D), rnd(B, Sk, H * D), rnd(B, Sk, H * D)
        plain = (kernels.mh_flash_attention_plain(q[:1], k[:1], v[:1], scale=scale, heads=H),
                 None)
        out = lambda: torch.empty_like(q)
    lse = lambda: torch.empty(B, H, Sq, device=dev, dtype=torch.float32)
    return (q, k, v), plain, out, lse


def fb_site(shape, mine, fns, gen, dev, iters, card):
    """The K6b variants at one site: the first T_ROWS folded rows against the
    plain version (error, `match`), times in turns."""
    BH, Sq, Sk, D, bias_name = shape
    bias_dtype = getattr(torch, bias_name)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).bfloat16()
    q, k, v = rnd(BH, Sq, D), rnd(BH, Sk, D), rnd(BH, Sk, D)
    bias = (torch.rand(Sq, Sk, generator=gen, device=dev) * 2 - 1).to(bias_dtype)
    scale = D ** -0.5
    plain = kernels.shared_bias_attention_folded_plain(q[:4], k[:4], v[:4], bias, scale=scale)
    outs = {n: torch.empty_like(q) for n in mine}

    def run(n):
        err = fns[n](q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                     outs[n].data_ptr(), None, BH, Sq, Sk, scale,
                     int(bias_dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"FAIL: variant {n} launch error {err}")

    for n in mine:
        run(n)
    torch.cuda.synchronize()
    tol = chip_smoke.bf16_tol("shared_bias_attention_folded", plain.float().abs().max().item())
    times = {n: [] for n in mine}
    for _ in range(2):
        for n in mine:
            times[n].append(chip_smoke.cuda_ms(lambda: run(n), iters))
    ops = 4.0 * BH * Sq * Sk * D
    rec = dict(kernel="shared_bias_attention_folded", shape=[BH, Sq, Sk, D],
               bias_dtype=bias_name, tol=tol, card=card, variants={})
    for n in mine:
        ms = sum(times[n]) / 2
        first = outs[n][:4]
        rec["variants"][n] = dict(ms=ms, runs=times[n], tflops=ops / (ms * 1e-3) / 1e12,
                                  max_abs_err=(first.float() - plain.float()).abs().max().item(),
                                  match=(first == plain).float().mean().item(),
                                  equals_first=bool(torch.equal(outs[n], outs[mine[0]])))
    return rec


def bw_site(family, shape, mine, fns, gen, dev, iters, card):
    """The K5b or K5c variants at one site, on the plain forward's lse and
    delta (the `_bias` families under a seeded uniform [-1, 1) float32 bias,
    as chip_smoke.site_bias makes it): the first batch row against the
    plain version (phase 2's limit, 2**-7 x max|plain|, and for the `_bias`
    families the share of bits equal to it, `match`), times in turns."""
    B, Sq, Sk, H, D = shape
    name = "flash_bwd_dq" if family.startswith("k5b") else "flash_bwd_dkv"
    bias = chip_smoke.site_bias(Sq, Sk, gen, dev)[None, None] if family.endswith("_bias") \
        else None
    q, k, v, do, lse, delta = chip_smoke.bwd_inputs(kernels, shape, gen, dev, bias)
    scale = D ** -0.5
    plain = getattr(kernels, name + "_plain")(q[:1], k[:1], v[:1], bias, do[:1], lse[:1],
                                              delta[:1], scale=scale)
    plain = plain if isinstance(plain, tuple) else (plain,)
    outs = {n: (torch.empty_like(q), None) if name == "flash_bwd_dq"
            else (torch.empty_like(k), torch.empty_like(v)) for n in mine}

    def run(n):
        o0, o1 = outs[n]
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr()]
        if bias is not None:
            ptrs.append(bias.data_ptr())
        err = fns[n](*ptrs, lse.data_ptr(), delta.data_ptr(), o0.data_ptr(),
                     None if o1 is None else o1.data_ptr(), B, Sq, Sk, H, scale,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"FAIL: variant {n} launch error {err}")

    for n in mine:
        run(n)
    torch.cuda.synchronize()
    tol = chip_smoke.bf16_tol(name, max(p.float().abs().max().item() for p in plain))
    times = {n: [] for n in mine}
    for _ in range(2):
        for n in mine:
            times[n].append(chip_smoke.cuda_ms(lambda: run(n), iters))
    ops = chip_smoke.site_ops(name, shape)
    rec = dict(kernel=name, shape=list(shape), tol=tol, card=card, variants={})
    for n in mine:
        ms = sum(times[n]) / 2
        got = [o for o in outs[n] if o is not None]
        rec["variants"][n] = dict(
            ms=ms, runs=times[n], tflops=ops / (ms * 1e-3) / 1e12,
            max_abs_err=max((o[:1].float() - p.float()).abs().max().item()
                            for o, p in zip(got, plain)),
            equals_first=all(bool(torch.equal(o, f)) for o, f in zip(got, outs[mine[0]])))
        if bias is not None:
            rec["variants"][n]["match"] = chip_smoke.match_share(
                name, tuple(o[:1] for o in got), plain)
    return rec


def k7_site(shape, mine, fns, gen, dev, iters, card):
    """The K7 variants at one site, on a grid of one block an SM (no more
    than the variant's tiles): error against the plain version, times in
    turns."""
    N, K, M = shape
    x = torch.randn(N, K, generator=gen, device=dev).bfloat16()
    w = torch.randn(M, K, generator=gen, device=dev).bfloat16()
    plain = kernels.dense_matmul_plain(x, w, linear_layout=True)
    outs = {n: torch.empty(N, M, device=dev, dtype=torch.bfloat16) for n in mine}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grids = {n: min(sms, -(-N // kernels.DENSE_WGMMA_BN) * -(-M // VARIANTS[n][1][0]))
             for n in mine}

    def run(n):
        err = fns[n](x.data_ptr(), w.data_ptr(), outs[n].data_ptr(), N, K, M, grids[n],
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"FAIL: variant {n} launch error {err}")

    for n in mine:
        run(n)
    torch.cuda.synchronize()
    tol = chip_smoke.bf16_tol("dense_matmul", plain.float().abs().max().item())
    times = {n: [] for n in mine}
    for _ in range(2):
        for n in mine:
            times[n].append(chip_smoke.cuda_ms(lambda: run(n), iters))
    rec = dict(kernel="dense_matmul", shape=[N, K, M], tol=tol, card=card, variants={})
    for n in mine:
        ms = sum(times[n]) / 2
        rec["variants"][n] = dict(ms=ms, runs=times[n], bm=VARIANTS[n][1][0], grid=grids[n],
                                  tflops=2.0 * N * K * M / (ms * 1e-3) / 1e12,
                                  max_abs_err=(outs[n].float() - plain.float()).abs().max().item(),
                                  equals_first=bool(torch.equal(outs[n], outs[mine[0]])))
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    names = args.variants.split(",")
    if any(n not in VARIANTS for n in names):
        raise SystemExit(f"--variants: any of {list(VARIANTS)}")
    card = chip_smoke.smi_line()
    print(f"card: {card}", flush=True)
    t0 = time.time()
    fns = build(names)
    print(f"built {len(fns)} of {len(names)} variants in {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    recs, failed = [], len(fns) < len(names)
    for family, wrapper, shape in SITES:
        mine = [n for n in fns if VARIANTS[n][0] == family]
        if not mine:
            continue
        if family in ("k6b", "k7", "k5b", "k5c", "k5b_bias", "k5c_bias"):
            if family.startswith(("k5b", "k5c")):
                rec = bw_site(family, shape, mine, fns, gen, dev, args.iters, card)
            else:
                site = fb_site if family == "k6b" else k7_site
                rec = site(shape, mine, fns, gen, dev, args.iters, card)
            print(json.dumps(rec), flush=True)
            if any(r["max_abs_err"] > rec["tol"] or r.get("match", 1) < chip_smoke.K5A_MATCH
                   for r in rec["variants"].values()):
                print(f"FAIL: a variant past the limit at {rec['shape']}", flush=True)
                failed = True
            recs.append(rec)
            torch.cuda.empty_cache()
            continue
        B, Sq, Sk, H, D = shape
        (q, k, v), (plain, plain_lse), new_out, new_lse = site_inputs(wrapper, (B, Sq, Sk, H, D),
                                                                      gen, dev)
        outs = {n: new_out() for n in mine}
        lses = {n: new_lse() for n in mine}

        def run(n):
            err = fns[n](q.data_ptr(), k.data_ptr(), v.data_ptr(), outs[n].data_ptr(),
                         lses[n].data_ptr(), B, Sq, Sk, H, D ** -0.5,
                         torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise SystemExit(f"FAIL: variant {n} launch error {err}")

        for n in mine:
            run(n)
        torch.cuda.synchronize()
        tol = chip_smoke.bf16_tol(wrapper, plain.float().abs().max().item())
        times = {n: [] for n in mine}
        for _ in range(2):
            for n in mine:
                times[n].append(chip_smoke.cuda_ms(lambda: run(n), args.iters))
        ops = 4.0 * B * Sq * Sk * H * D
        rec = dict(kernel=wrapper, shape=[B, Sq, Sk, H, D], tol=tol, card=card, variants={})
        for n in mine:
            ms = sum(times[n]) / 2
            first = outs[n][:1]
            r = dict(ms=ms, runs=times[n], tflops=ops / (ms * 1e-3) / 1e12,
                     max_abs_err=(first.float() - plain.float()).abs().max().item(),
                     equals_first=bool(torch.equal(outs[n], outs[mine[0]])))
            if family != "k2":
                r["match"] = (first == plain).float().mean().item()
            if plain_lse is not None:
                r["lse_max_abs_err"] = (lses[n][:1] - plain_lse).abs().max().item()
            rec["variants"][n] = r
        print(json.dumps(rec), flush=True)
        if any(r["max_abs_err"] > tol or r.get("lse_max_abs_err", 0) > chip_smoke.LSE_TOL
               for r in rec["variants"].values()):
            print(f"FAIL: a variant past the limit at {rec['shape']}", flush=True)
            failed = True
        recs.append(rec)
        del q, k, v, outs, lses
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in recs))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
