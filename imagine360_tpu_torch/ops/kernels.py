"""The hand-written Hopper kernels, their plain PyTorch versions, and the
build that turns `csrc/*.cu` into one shared library.

| wrapper                        | CUDA sources                               | replaces (JAX package)                        |
|--------------------------------|--------------------------------------------|-----------------------------------------------|
| `tiny_attention`               | csrc/tiny_attention.cu, _wide.cu (D > 160) | ops/pallas_attention.py:_tiny_packed_kernel   |
|                                | (+ csrc/attn_wgmma.cuh, `wgmma_route`;     |                                               |
|                                | csrc/attn_wgmma_xattn.cuh, `xattn_route`;  |                                               |
|                                | csrc/attn_wgmma_wide.cuh,                  |                                               |
|                                | `wide_wgmma_route`)                        |                                               |
| `mh_flash_attention`           | csrc/mh_flash.cu, _wide.cu (D > 160)       | ops/pallas_attention.py:_mh_flash_kernel      |
|                                | (+ csrc/attn_wgmma.cuh, `wgmma_route`;     |                                               |
|                                | csrc/attn_wgmma_wide.cuh,                  |                                               |
|                                | `wide_wgmma_route`)                        |                                               |
| `shared_bias_attention`        | csrc/shared_bias.cu (lse output optional)  | ops/pallas_attention.py:_shared_bias_kernel_t |
|                                | (+ csrc/attn_wgmma_bias.cuh)               |                                               |
| `frame_attention`              | csrc/frame_attention.cu                    | ops/pallas_attention.py:_striped_kernel       |
|                                | (+ csrc/frame_tma.cuh, `frame_route`)      |                                               |
| `flash_attention_lse`          | csrc/flash_lse.cu                          | ops/pallas_attention.py:_flash_kernel         |
|                                | (+ csrc/attn_wgmma.cuh, `wgmma_route`)     |                                               |
| `flash_bwd_dq`                 | csrc/flash_bwd_dq.cu                       | ops/pallas_attention.py:_flash_bwd_dq_kernel  |
|                                | (+ csrc/attn_wgmma_bwd.cuh, `wgmma_route`; |                                               |
|                                | csrc/attn_wgmma_bwd_bias.cuh)              |                                               |
| `flash_bwd_dkv`                | csrc/flash_bwd_dkv.cu                      | ops/pallas_attention.py:_flash_bwd_dkv_kernel |
|                                | (+ csrc/attn_wgmma_bwd.cuh, `wgmma_route`; |                                               |
|                                | csrc/attn_wgmma_bwd_bias.cuh)              |                                               |
| `flash_attention_t`            | csrc/flash_t.cu                            | ops/pallas_attention.py:_flash_kernel_t       |
|                                | (+ csrc/attn_wgmma.cuh, `wgmma_route`;     |                                               |
|                                | csrc/attn_wgmma_bias.cuh)                  |                                               |
| `shared_bias_attention_folded` | csrc/shared_bias_folded.cu                 | ops/pallas_attention.py:_shared_bias_kernel   |
|                                | (+ csrc/attn_wgmma_bias.cuh)               |                                               |
| `dense_matmul`                 | csrc/dense_matmul.cu                       | ops/pallas_dense.py:_matmul_kernel            |
|                                | (wgmma GEMM, `dense_wgmma_route`)          |                                               |
| `striped_v2_attention`         | csrc/frame_attention_v2.cu                 | scripts/kernel_lab.py:_striped_v2_kernel      |
| `fused_motion_attention`       | csrc/motion_fused.cu                       | scripts/exp_motion_kernels.py:_fused_kernel   |
|                                | (+ csrc/motion_wgmma.cuh,                  |                                               |
|                                | `fused_wgmma_route`)                       |                                               |
| `diag_motion_attention`        | csrc/motion_diag.cu                        | scripts/exp_motion_kernels.py:_diag_kernel    |
|                                | (+ csrc/frame_tma.cuh, `diag_route`)       |                                               |

K1-K4 are the forward kernels of inference. Under grad the long-sequence
sites take K5a (`flash_attention_lse`) or K3 with its lse output forward
and K5b + K5c (`flash_bwd_dq`, `flash_bwd_dkv`) backward
(ops/attention.py). K6a (`flash_attention_t`) and K7 (`dense_matmul`) are
opt-in, behind the `attn_v2` and `pallas_dense` switches of ops/dispatch.py;
K6b (`shared_bias_attention_folded`) has its own entry point and no caller
in the models, as in the JAX package. L1-L3 (`striped_v2_attention`,
`fused_motion_attention`, `diag_motion_attention`) are the lab variants of
K4: no model calls them, ops/motion_lab.py:run_lab holds them against K4 and
times them. Each source file says what bounds its kernel on the H100 and
what the design does about it.

Every wrapper takes float32 or bfloat16. K1, K2, K5a and K6a in bfloat16 at
head dim 64 without a bias with 16-byte-aligned pointers (K1 above 32 query
rows and 128 keys; K6a with Sq and Sk multiples of 8), every self-attention
launch of K1 and K2 in the models and every pano launch of K5a (training)
and K6a (`attn_v2`), run the Hopper body of attn_wgmma.cuh
(`tiny_attention_wgmma_kernel`, `mh_flash_wgmma_kernel`,
`flash_lse_wgmma_kernel` with the lse and P split into two bfloat16 parts,
`flash_t_wgmma_kernel` with P split on sequence-minor tiles): TMA copies
into an mbarrier ring, one producer warpgroup and two consumer warpgroups
on `wgmma` (`wgmma_route` says which launches; a fixed rule, no switch).
K1 by the same rule but at most 128 keys (one key tile: every text and
image-prompt cross-attention launch with more than 32 queries, but where
queries and keys are both at most 64; `xattn_route`) runs the persistent streaming body of attn_wgmma_xattn.cuh
(`tiny_attention_xattn_wgmma_kernel`, one instantiation for 64, 80 and 128
keys: one block an SM walks work items of 128 query rows of one (batch,
head), a TMA ring of Q tiles, a ring of K/V buffers reloaded only when the
pair changes, S = Q·Kᵀ, the whole row's softmax and P·V on `wgmma`, the
output by TMA store). K4 in bfloat16 at 16 frames with a head dim that is
a multiple of 8 up to 160 and 16-byte-aligned pointers (`frame_route`:
every motion-module launch) runs its Hopper body, csrc/frame_tma.cuh
(`frame_attention_tma_kernel`: a persistent grid walks work items of G
locations x HG heads, `frame_tma_plan`; one producer thread loads each
item's q, k and v by TMA into a ring of stages, consumer warps take one
(location, head) problem at a time on `mma.sync`, each problem's output
leaves by TMA store). L3 in bfloat16 at 16 frames with D % 8 == 0 and
16-byte-aligned pointers (`diag_route`: every bf16 launch of the lab) runs
the same Hopper body under its own ownership (csrc/motion_diag.cu
`diag_motion_tma_kernel`: a persistent block takes packs of G locations and
streams each through the ring as items of SG locations x HG heads,
`diag_tma_plan`). L2 in bfloat16 at head dims 40, 80 and 160 without
exp_bf16, F dividing 64, G*F a multiple of 128 and 16-byte-aligned pointers
(`fused_wgmma_route`: every such launch of the lab) runs
csrc/motion_wgmma.cuh (`fused_motion_wgmma_kernel`: a producer warpgroup
loads, per 64-key tile, one [128, 64] bias tile by TMA under the K and V
tiles of T = 4, 2 or 1 (pack, head) row slots, tiles in packed row order
through 5-D tensor maps; two consumer warpgroups on `wgmma`). K1 and K2 in
bfloat16 at head dim 512 without a
bias, with 16-byte-aligned pointers (`wide_wgmma_route`: every VAE
mid-block launch) run the wide body of attn_wgmma_wide.cuh
(`tiny_attention_wide_wgmma_kernel`, `mh_flash_wide_wgmma_kernel`: 64
query rows, a producer and two consumer warpgroups each owning half the
head dim, the partial logits exchanged through shared memory). K5b and K5c
by the same rule (K5c also with Sq a multiple of 4), every
pano launch of the training step's backward, run the Hopper backward bodies
of attn_wgmma_bwd.cuh (`flash_bwd_dq_wgmma_kernel`: 128 queries a block, a
ring of 64-key K/V tiles; `flash_bwd_dkv_wgmma_kernel`: 128 keys a block, a
ring of 64-query Q/dO tiles with their lse and delta rows; the same
producer and two consumers, dS and P split into two bfloat16 parts, no
atomics). K5b and K5c in bfloat16 at head dim 32 under a float32 bias
shared by every batch row and head, its rows multiples of 16 bytes (K5c
also Sq a multiple of 4), with 16-byte-aligned pointers
(`bwd_bias_wgmma_route`: every WarpAttn launch of the training step, a
rank's row block of the bias included), run the biased D = 32 backward
bodies of attn_wgmma_bwd_bias.cuh (`flash_bwd_dq_bias_wgmma_kernel`: 128
queries of four (batch, head) row slots a block under each [128, 64] bias
tile; `flash_bwd_dkv_bias_wgmma_kernel`: 128 keys of two row slots under
each [64, 128] bias tile, read transposed; the same producer and two
consumers, [B, S, H, 32] rows through the 4-D maps of K3's layout). K3,
K6a and K6b in bfloat16 at head dim 32 under one bias shared
by every row, its rows multiples of 16 bytes, with 16-byte-aligned
pointers, run the biased D = 32 body of attn_wgmma_bias.cuh (one bias tile
by TMA under the K and V tiles of four rows, two consumer warpgroups on
`wgmma`; P split for K6a and K6b, rounded once for K3 as its TPU kernel
rounds it), each in its own row layout: K6b
(`folded_wgmma_route`: every launch at a WarpAttn mask) on folded rows
(`shared_bias_folded_wgmma_kernel`), K3 (`shared_bias_wgmma_route`: every
WarpAttn launch, the per-shard row blocks of the bias included) on
[B, S, H, 32] rows through 4-D tensor maps (`shared_bias_wgmma_kernel`),
K6a (`flash_t_bias_wgmma_route`: a bias broadcast over batch and heads, Sq
and Sk multiples of 8; its WarpAttn sites) on sequence-minor tiles
(`flash_t_bias_wgmma_kernel`). K7 in bfloat16 with an [M, K] weight, K and
M multiples of 8 and 16-byte-aligned pointers (`dense_wgmma_route`: every
MMDense launch) runs the persistent GEMM of dense_matmul.cu
(`dense_matmul_wgmma_kernel`: TMA ring across 128 x 160 output tiles,
`dense_wgmma_plan`). Both share the primitives of csrc/wgmma_ops.cuh.
Their other bfloat16 launches run
with a head dim up to 160 on the tensor cores, through the
`mma.sync` body of attn_mma.cuh (K3 with two (batch, head) problems a block
under one staged bias tile up to D = 64: the CLIP causal mask; K6b with up
to two folded rows under one float32 or bfloat16 bias tile; K5a, K6a and
K6b with their probabilities split exactly into two bfloat16 parts; K6a on
its sequence-minor tiles as they lie, a per-batch or per-head bias
included), K4 off `frame_route` through its own `mma.sync` tile
(frame_mma.cuh: packs of neighbouring locations staged with `cp.async`, one
(location, head) problem a warp, `frame_attention_plan`), L3 on the same
tile under its own ownership (a block owns G locations and walks their
heads in one stage, `diag_motion_mma_plan`), L1 on it too (a block walks R
packs of G locations with all their heads in one stage,
`striped_v2_mma_plan`), L2 through the streaming body
of attn_mma.cuh with the pack's rows gathered (motion_fused.cu: HB heads a
block under one bias tile, `fused_motion_mma_plan`),
K5b and K5c (a per-batch or per-head bias, or another head dim than 32
or 64) through the `mma.sync` backward tiles of attn_mma_bwd.cuh (dS, and
P for K5c, split the same way), K7 through its own `mma.sync` GEMM tile
(dense_matmul.cu), and float32 on the CUDA cores (attn_common.cuh,
flash_bwd.cuh, dense_matmul.cu, frame_attention.cu, shared_bias_folded.cu,
and L1-L3 in frame_attention_v2.cu, motion_fused.cu, motion_diag.cu).
K1 and K2 take a head dim D from 1 to 512: above 160 through their wide
kernels, in bfloat16 off `wide_wgmma_route` (D 161..511, K1 under a bias,
unaligned views) on the wide `mma.sync` tile of attn_mma_wide.cuh (16 warps
on 64 query rows, Q·Kᵀ split over the keys, P·V over the head dim), in
float32 on the CUDA cores (attn_wide.cuh). K3, K4,
K5a-c, K6a, K6b and L1-L3 take D up to 160; K7 takes any N, K, M >= 1.
L1 and L3 (both dtypes) and L2 in float32 raise for a pack that does not
fit a block's shared memory and never shrink it. For a tensor on the CPU a
wrapper runs its plain version (einsum + softmax, batch-chunked) and counts
one `plain_calls`; for a CUDA tensor it launches its kernel or raises.
There is no fallback from a CUDA tensor to the plain version. A launch
counts one in the wrapper's `launches`, one under its shape in
`shape_launches`, one in `wide_launches` when it took the wide kernel, one
in `tc_launches` when it took the tensor cores (K1 and K2 in bfloat16 with
D <= 512, the wide ones too; K3, K4, K5a, K5b, K5c, K6a, K6b and L1-L3 in
bfloat16 with D <= 160; K7 in bfloat16), one in `wgmma_launches` when K1,
K2, K3, K5a, K5b, K5c, K6a, K6b or K7 took a `wgmma` body, one in
`lse_launches` when K3 or K6b also wrote its lse, and for K1, K2, K4, L2
and L3 one under the body it took in `body_launches` (`body_counts` for K1
and K2, `frame_body_counts` for K4, L2 and L3).

The library is compiled on first use with `nvcc -gencode
arch=compute_90a,code=sm_90a` into `imagine360_tpu_torch/_build/` (listed in
.gitignore), bound with ctypes, and launched on PyTorch's current stream.
The `wgmma` body's tensor maps are encoded per call by the driver's
cuTensorMapEncodeTiled, which the library fetches at run time
(cudaGetDriverEntryPointByVersion): the link step adds no library.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import signal
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# no plain version materialises more than this many bytes of f32 logits
LOGITS_BYTES_LIMIT = 128 * 1024 * 1024
MAX_HEAD_DIM = 160      # csrc/attn_common.cuh: the largest head-dim bucket (K1-K4)
WIDE_MAX_HEAD_DIM = 512  # csrc/attn_wide.cuh WIDE_MAX_D, attn_mma_wide.cuh kWideMaxD (K1, K2)
TINY_MAX_SK = 1024      # csrc/tiny_attention.cu K1_MAX_SK
WGMMA_HEAD_DIM = 64     # csrc/attn_wgmma.cuh kWgD: the one head dim of the wgmma body
WGMMA_TINY_MIN_SQ = 33  # K1 takes the wgmma body from this many query rows: at 16 and 32 its
                        # 16- and 32-row mma.sync tiles waste no rows (128-row tiles would)
WGMMA_TINY_MIN_SK = 129  # ... and from two 128-key tiles on; at one key tile (the cross-attention
                         # sites, 13, 64 and 77 keys, bound by bytes) K1 takes the persistent
                         # streaming body of csrc/attn_wgmma_xattn.cuh instead (`xattn_route`)
XATTN_MAX_SK = 128      # csrc/attn_wgmma_xattn.cuh kXaMaxSk: the keys of its one key tile
XATTN_KEYS = (64, 80, 128)  # its instantiations' key counts (S = Q·Kᵀ as m64nNk16)
XATTN_MMA_TILE = 64     # at most this many queries and keys, one query tile and one key tile of
                        # the mma.sync body, K1 stays there: faster at the perspective stage-2
                        # image-prompt site on an H100 (PERF.md §6)
WIDE_WGMMA_HEAD_DIM = 512  # csrc/attn_wgmma_wide.cuh kWwD: the head dim of the wide wgmma body
WGMMA_ALIGN = 16        # bytes: TMA's alignment of a tensor map's base and row strides
WGMMA_SEQ_MULTIPLE = 8  # K6a: Sq and Sk multiples of this, so the sequence-minor rows of
                        # S*2 bytes are multiples of WGMMA_ALIGN
WGMMA_ROW_MULTIPLE = 4  # K5c: Sq a multiple of this, so the float32 lse and delta rows of
                        # Sq*4 bytes (csrc/attn_wgmma_bwd.cuh kBwRowMultiple) are too
FRAME_MAX_F = 64        # csrc/frame_attention.cu K4_MAX_F
DIAG_MAX_F = 32         # csrc/motion_diag.cu L3_MAX_F: a lane owns one logit of a row (f32)
DIAG_MAX_WARPS = 8      # csrc/motion_diag.cu L3_MAX_WARPS (f32)
FUSED_Q_ROWS = 16       # csrc/motion_fused.cu L2_BQ: query rows of one logit tile (f32)
FUSED_THREADS = 512     # csrc/motion_fused.cu L2_NT (f32)
FUSED_MMA_ROWS = 64     # csrc/motion_fused.cu L2_MMA_BQ, kMmaBK: query rows of a block, keys
                        # of a tile (bf16)
FUSED_MMA_GROUP = 128   # csrc/motion_fused.cu L2_MMA_GT: threads of one head's group (bf16)
FUSED_MMA_MAX_HEADS = 2  # csrc/motion_fused.cu L2_MMA_MAX_HB: heads (groups) of a block (bf16)
FUSED_MMA_DP = (16, 32, 48, 64, 80, 96, 128, 160)   # its head-dim buckets
SMEM_LIMIT = 232448     # bytes of shared memory one block may have on sm_90 (227 KB)
FOLDED_T_ROWS = 2       # K6b: folded rows a block takes under one bias tile (bf16: 2 beats 1
                        # at the WarpAttn sites on an H100, scripts/torch_frame_folded_check.py)
                        # on the mma.sync and float32 bodies; the wgmma body takes its own four
BIAS_WGMMA_HEAD_DIM = 32  # csrc/attn_wgmma_bias.cuh kFbD: the head dim of the biased wgmma body
BWD_BIAS_DQ_ROWS = 4    # csrc/attn_wgmma_bwd_bias.cuh kBqbT: K5b's (batch, head) row slots a
                        # block under one bias tile (two stages fit)
BWD_BIAS_DKV_ROWS = 2   # csrc/attn_wgmma_bwd_bias.cuh kBkbT: K5c's (its dk and dv take 32
                        # registers a slot: four spill)
DENSE_WGMMA_BN = 128    # csrc/dense_matmul.cu K7W_BN: rows of x an output tile of the wgmma GEMM
DENSE_WGMMA_BM = 160    # csrc/dense_matmul.cu K7W_BM: its output columns a tile (divides M at
                        # every model site; 256 measured no faster, PERF.md §6)
SM_SHARED_BYTES = 233472  # shared memory of one SM on sm_90 (228 KB), 1 KB of it per block
FRAME_STAGE_BYTES = 40 * 1024  # K4 bf16: most bytes of q, k and v tiles in one of a block's
                               # two stages: two or three blocks an SM (at the motion sites
                               # three, which csrc/frame_attention.cu's launch bounds assume)
FRAME_WAVES = 4         # K4 bf16: blocks a resident block slot takes in turn (sets R)
FRAME_TMA_F = 16        # csrc/frame_tma.cuh kFtF: the frames of K4's Hopper body
FRAME_TMA_ITEM_BYTES = 10 * 1024  # K4 Hopper body: most bytes of one tensor's box of a work
                                  # item (G locations x HG heads x 16 frames x D, bf16)
FRAME_TMA_STAGES = 4    # K4 Hopper body: stages of the q/k/v ring (csrc/frame_tma.cuh, at
                        # most kFtMaxStages = 8)
FRAME_TMA_WARPS = 8     # K4 Hopper body: consumer warps a block (kFtMaxNW = 8)
FRAME_TMA_BLOCKS = 1    # K4 Hopper body: blocks an SM the persistent grid asks for
FRAME_TMA_MIN_ITEMS = 4  # K4 Hopper body: work items each block slot gets at least, where
                         # smaller items allow it
FUSED_WGMMA_HEAD_DIMS = (40, 80, 160)  # csrc/motion_wgmma.cuh: L2's Hopper body's head dims
FUSED_WGMMA_ROWS = 128  # csrc/motion_wgmma.cuh kMwBQ: query rows of a block (S a multiple)
FUSED_WGMMA_KEYS = 64   # csrc/motion_wgmma.cuh kMwBK: keys a tile (F divides it)
DIAG_STAGE_BYTES = SM_SHARED_BYTES // 3 - 1024  # L3 bf16: most bytes of one stage of q, k
                                                # and v tiles: three blocks an SM

# K1, K2 and K4 take their grid's block count and their (batch x head) and
# (batch x location x head) indices in 32 bits (offsets are 64-bit)
INDEX_LIMIT = 2 ** 31

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"   # the CUDA toolkit's default prefix


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def find_nvcc() -> str:
    """Path of nvcc: on PATH, under $CUDA_HOME, or the toolkit's default
    install prefix. Raises when there is none."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
                       " the attention kernels cannot be built")


def _sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile csrc/*.cu into one shared library (once per source digest)
    and return its path. The sources compile in parallel, one nvcc process
    each, then link. The compiler's register/shared-memory report is kept
    beside the library as `<lib>.ptxas.txt`."""
    lib = BUILD_DIR / f"libi360_attn_{_sources_digest()}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    work = BUILD_DIR / f"{lib.stem}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for src in sorted(CSRC.glob("*.cu")):
            obj, log = work / f"{src.stem}.o", work / f"{src.stem}.log"
            with open(log, "w") as f:
                jobs.append((src, obj, log, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=f, stderr=subprocess.STDOUT, start_new_session=True)))
        for src, _, log, proc in jobs:
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n"
                                   f"{log.read_text()[-8000:]}")
    finally:
        for *_, proc in jobs:      # on failure: stop nvcc and its cicc/ptxas
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    tmp = work / lib.name
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(j[1]) for j in jobs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-8000:]}")
    lib.with_suffix(".ptxas.txt").write_text("".join(j[2].read_text() for j in jobs))
    os.replace(tmp, lib)
    shutil.rmtree(work)
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
    sigs = {
        "i360_tiny_attention": [P, P, P, P, P, I, I, I, I, I, F, I, P],
        "i360_mh_flash_attention": [P, P, P, P, I, I, I, I, I, F, I, P],
        "i360_tiny_attention_wgmma": [P, P, P, P, I, I, I, I, I, F, P],
        "i360_tiny_attention_xattn": [P, P, P, P, I, I, I, I, I, F, P],
        "i360_tiny_attention_wide_wgmma": [P, P, P, P, I, I, I, I, I, F, P],
        "i360_mh_flash_attention_wide_wgmma": [P, P, P, P, I, I, I, I, I, F, P],
        "i360_mh_flash_attention_wgmma": [P, P, P, P, I, I, I, I, I, F, P],
        "i360_flash_attention_lse_wgmma": [P, P, P, P, P, I, I, I, I, I, F, P],
        "i360_flash_attention_t_wgmma": [P, P, P, P, I, I, I, I, I, F, P],
        "i360_flash_bwd_dq_wgmma": [P, P, P, P, P, P, P, I, I, I, I, I, F, P],
        "i360_flash_bwd_dkv_wgmma": [P, P, P, P, P, P, P, P, I, I, I, I, I, F, P],
        "i360_flash_bwd_dq_bias_wgmma": [P, P, P, P, P, P, P, P, I, I, I, I, I, F, P],
        "i360_flash_bwd_dkv_bias_wgmma": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, P],
        "i360_shared_bias_attention_folded_wgmma": [P, P, P, P, P, P, I, I, I, I, F, I, P],
        "i360_shared_bias_attention_wgmma": [P, P, P, P, P, P, I, I, I, I, I, F, P],
        "i360_flash_attention_t_bias_wgmma": [P, P, P, P, P, I, I, I, I, I, F, P],
        "i360_dense_matmul_wgmma": [P, P, P, I, I, I, I, P],
        "i360_tiny_attention_wide": [P, P, P, P, P, I, I, I, I, I, F, I, P],
        "i360_mh_flash_attention_wide": [P, P, P, P, I, I, I, I, I, F, I, P],
        "i360_shared_bias_attention": [P, P, P, P, P, P, I, I, I, I, I, F, I, P],
        "i360_frame_attention": [P, P, P, P, I, I, I, I, I, F, I, I, I, I, P],
        "i360_frame_attention_tma": [P, P, P, P, I, I, I, I, I, F, I, I, I, I, I, P],
        "i360_flash_attention_lse": [P, P, P, P, P, P, I, I, I, I, I, L, L, F, I, P],
        "i360_flash_bwd_dq": [P, P, P, P, P, P, P, P, I, I, I, I, I, L, L, F, I, P],
        "i360_flash_bwd_dkv": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, L, L, F, I, P],
        "i360_flash_attention_t": [P, P, P, P, P, I, I, I, I, I, L, L, F, I, P],
        "i360_shared_bias_attention_folded": [P, P, P, P, P, P, I, I, I, I, I, F, I, I, P],
        "i360_dense_matmul": [P, P, P, I, I, I, L, L, I, P],
        "i360_striped_v2_attention": [P, P, P, P, I, I, I, I, I, I, I, I, F, I, P],
        "i360_fused_motion_attention": [P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, I, I, P],
        "i360_fused_motion_attention_wgmma": [P, P, P, P, P, I, I, I, I, I, I, F, I, P],
        "i360_diag_motion_attention": [P, P, P, P, I, I, I, I, I, I, I, I, I, F, I, P],
        "i360_diag_motion_attention_tma": [P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, F, P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, *tensors: torch.Tensor) -> int:
    """Validate the kernel's inputs; return the dtype code."""
    t0 = tensors[0]
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: kernel needs CUDA tensors, got {t.device}")
        if t.device != t0.device:
            raise ValueError(f"{name}: tensors on {t.device} and {t0.device}")
        if t.dtype != t0.dtype:
            raise ValueError(f"{name}: mixed dtypes {t.dtype} and {t0.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel needs contiguous tensors")
    if t0.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {t0.dtype} not supported "
                         "(float32 or bfloat16)")
    return _DTYPE_CODE[t0.dtype]


def _check_bias(name: str, bias: torch.Tensor, q: torch.Tensor, Sq: int, Sk: int):
    if (bias.device != q.device or bias.dtype != torch.float32
            or tuple(bias.shape) != (Sq, Sk) or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be a contiguous float32 [{Sq}, {Sk}] "
                         f"tensor on {q.device}, got {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}")


def check_index_range(name: str, **products: int) -> None:
    """Raise where a product a kernel holds in 32 bits reaches INDEX_LIMIT:
    B*H*Sq bounds K1's and K2's block counts and (batch, head) index,
    B*HW*H K4's."""
    over = {k: v for k, v in products.items() if v >= INDEX_LIMIT}
    if over:
        raise ValueError(f"{name}: {over} reach 2**31, past the kernel's 32-bit indices")


def _check_head_dim(name: str, D: int, max_dim: int = MAX_HEAD_DIM):
    if not 1 <= D <= max_dim:
        raise ValueError(f"{name}: head dim {D} outside 1..{max_dim}")


def _launch(wrapper, fn, q: torch.Tensor, *args, shape: tuple, wide: bool = False,
            tc: bool = False, lse: bool = False, wgmma: bool = False,
            body: str | None = None) -> None:
    """Launch `fn` on q's device and current stream, raise on a launch
    error, and count the launch on `wrapper`: in `launches`, under `shape`
    in `shape_launches`, in `wide_launches` too when `wide`, in
    `tc_launches` too when `tc`, in `lse_launches` too when `lse`, in
    `wgmma_launches` too when `wgmma`, and under `body` in `body_launches`
    (K1, K2 and K4 name the body each launch took)."""
    if q.numel() == 0:
        return          # nothing to compute; a zero-block grid is a launch error
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__}: kernel launch failed with cudaError {err}")
    wrapper.launches += 1
    wrapper.shape_launches[shape] += 1
    wrapper.wide_launches += wide
    wrapper.tc_launches += tc
    wrapper.lse_launches += lse
    wrapper.wgmma_launches += wgmma
    if body is not None:
        wrapper.body_launches[body] += 1


def wgmma_route(name: str, dtype: torch.dtype, Sq: int, Sk: int, H: int, D: int,
                bias: bool = False, ptrs: tuple = (0,)) -> bool:
    """Whether a K1 (`tiny_attention`), K2 (`mh_flash_attention`), K5a
    (`flash_attention_lse`) or K6a (`flash_attention_t`) launch takes the
    Hopper body of csrc/attn_wgmma.cuh, or a K5b (`flash_bwd_dq`) or K5c
    (`flash_bwd_dkv`) launch the one of csrc/attn_wgmma_bwd.cuh: bfloat16,
    head dim 64, no bias, every pointer a tensor map reads (`ptrs`: q, k, v,
    out; K5b q, k, v, g, dq; K5c also lse, delta, dk, dv; not K5a's lse,
    which leaves by scalar stores, nor K5b's lse and delta, read by scalar
    loads) 16-byte aligned, and TMA's row strides multiples of 16 bytes:
    H*D*2 for the [B, S, H, D] layouts, Sq*2 and Sk*2 for K6a's
    sequence-minor ones (Sq and Sk multiples of 8), Sq*4 for K5c's float32
    lse and delta rows (Sq a multiple of 4); for K1 also more than 32 query
    rows and more than 128 keys (at one key tile K1 takes `xattn_route`'s
    body). Every other launch stays on the `mma.sync` body of
    csrc/attn_mma.cuh or csrc/attn_mma_bwd.cuh (or, above D = 160, the wide
    kernels of K1 and K2: `wide_wgmma_route`). A fixed rule on the call's
    shape and pointers, no switch."""
    if not (dtype == torch.bfloat16 and D == WGMMA_HEAD_DIM and not bias
            and all(p % WGMMA_ALIGN == 0 for p in ptrs)):
        return False
    if name == "flash_attention_t":
        return Sq % WGMMA_SEQ_MULTIPLE == 0 and Sk % WGMMA_SEQ_MULTIPLE == 0
    if name == "flash_bwd_dkv" and Sq % WGMMA_ROW_MULTIPLE:
        return False
    return (H * D * 2 % WGMMA_ALIGN == 0
            and (name != "tiny_attention"
                 or (Sq >= WGMMA_TINY_MIN_SQ and Sk >= WGMMA_TINY_MIN_SK)))


def xattn_route(dtype: torch.dtype, Sq: int, Sk: int, H: int, D: int, bias: bool = False,
                ptrs: tuple = (0,)) -> bool:
    """Whether a K1 (`tiny_attention`) launch takes the persistent
    one-key-tile body of csrc/attn_wgmma_xattn.cuh: bfloat16, head dim 64,
    no bias, at most XATTN_MAX_SK keys (one key tile: the text and
    image-prompt cross-attention sites), more than 32 query rows (at 16 and
    32 the `mma.sync` body's 16- and 32-row tiles waste no rows) and not
    both at most XATTN_MMA_TILE queries and keys (one tile each of the
    `mma.sync` body, where it measured faster), every pointer a tensor map
    reads (`ptrs`: q, k, v, out) 16-byte aligned and the row stride H*D*2 a
    multiple of 16 bytes. K1 with more keys is `wgmma_route`'s; a bias,
    Sq <= 32, Sq and Sk <= 64, other head dims and unaligned views stay on
    the `mma.sync` body of csrc/attn_mma.cuh. A fixed rule on the call's
    shape and pointers, no switch."""
    return (dtype == torch.bfloat16 and D == WGMMA_HEAD_DIM and not bias
            and 1 <= Sk <= XATTN_MAX_SK and Sq >= WGMMA_TINY_MIN_SQ
            and (Sq > XATTN_MMA_TILE or Sk > XATTN_MMA_TILE)
            and H * D * 2 % WGMMA_ALIGN == 0
            and all(p % WGMMA_ALIGN == 0 for p in ptrs))


def xattn_keys(Sk: int) -> int:
    """The key count N of the one-key-tile body's instantiation that takes
    Sk keys: Sk rounded up to 64, 80 or 128 (csrc/attn_wgmma_xattn.cuh
    xa_keys); keys past Sk are masked."""
    return next(n for n in XATTN_KEYS if Sk <= n)


def wide_wgmma_route(dtype: torch.dtype, D: int, bias: bool = False, ptrs: tuple = (0,)) -> bool:
    """Whether a wide K1 (`tiny_attention`) or K2 (`mh_flash_attention`)
    launch takes the Hopper body of csrc/attn_wgmma_wide.cuh: bfloat16,
    head dim 512 (the VAE's one head), no bias, every pointer a tensor map
    reads (`ptrs`: q, k, v, out) 16-byte aligned (the row stride H*512*2 is
    a multiple of 16 at every H). Head dims 161..511, K1 with a bias and
    unaligned views stay on the `mma.sync` tile of csrc/attn_mma_wide.cuh;
    float32 on the CUDA cores. A fixed rule on the call's shape and
    pointers, no switch."""
    return (dtype == torch.bfloat16 and D == WIDE_WGMMA_HEAD_DIM and not bias
            and all(p % WGMMA_ALIGN == 0 for p in ptrs))


# the bodies of K1 and K2, as `attention_body` names them and `body_counts`
# counts them, and the C entry of each `wgmma` one
ATTENTION_BODIES = ("wgmma_xattn", "wgmma", "wgmma_wide", "mma_sync", "wide_mma_sync",
                    "cuda_cores")
WGMMA_ENTRIES = {
    "tiny_attention": {"wgmma_xattn": "i360_tiny_attention_xattn",
                       "wgmma": "i360_tiny_attention_wgmma",
                       "wgmma_wide": "i360_tiny_attention_wide_wgmma"},
    "mh_flash_attention": {"wgmma": "i360_mh_flash_attention_wgmma",
                           "wgmma_wide": "i360_mh_flash_attention_wide_wgmma"},
}


def attention_body(name: str, dtype: torch.dtype, Sq: int, Sk: int, H: int, D: int,
                   bias: bool = False, ptrs: tuple = (0,)) -> str:
    """The body a K1 (`tiny_attention`) or K2 (`mh_flash_attention`) launch
    takes, which its wrapper dispatches on: `wgmma_xattn` where
    `xattn_route` holds (K1 only: csrc/attn_wgmma_xattn.cuh), `wgmma` where
    `wgmma_route` does (csrc/attn_wgmma.cuh), `wgmma_wide` where
    `wide_wgmma_route` does (csrc/attn_wgmma_wide.cuh); else in bfloat16
    `mma_sync` (csrc/attn_mma.cuh) or above D = 160 `wide_mma_sync`
    (csrc/attn_mma_wide.cuh), and in float32 `cuda_cores`. A fixed rule on
    the call's dtype, shape and pointers, no switch."""
    if name == "tiny_attention" and xattn_route(dtype, Sq, Sk, H, D, bias, ptrs):
        return "wgmma_xattn"
    if wgmma_route(name, dtype, Sq, Sk, H, D, bias, ptrs):
        return "wgmma"
    if wide_wgmma_route(dtype, D, bias, ptrs):
        return "wgmma_wide"
    if dtype != torch.bfloat16:
        return "cuda_cores"
    return "wide_mma_sync" if D > MAX_HEAD_DIM else "mma_sync"


def folded_wgmma_route(dtype: torch.dtype, Sk: int, D: int, bias_dtype: torch.dtype,
                       ptrs: tuple = (0,)) -> bool:
    """Whether a K6b (`shared_bias_attention_folded`) launch takes the
    biased D = 32 body of csrc/attn_wgmma_bias.cuh: bfloat16 q/k/v, head dim
    32, a float32 or bfloat16 bias whose row of Sk elements is a multiple
    of 16 bytes (the tensor map's row stride), every pointer a tensor map
    reads (`ptrs`: q, k, v, out, bias; not the lse) 16-byte aligned. Every
    other launch stays on the `mma.sync` body (bfloat16) or the CUDA cores
    (float32). A fixed rule on the call's shape and pointers, no switch:
    the caller's t_rows does not choose the body."""
    return (dtype == torch.bfloat16 and D == BIAS_WGMMA_HEAD_DIM
            and bias_dtype in (torch.float32, torch.bfloat16)
            and Sk * bias_dtype.itemsize % WGMMA_ALIGN == 0
            and all(p % WGMMA_ALIGN == 0 for p in ptrs))


def shared_bias_wgmma_route(dtype: torch.dtype, Sk: int, D: int, ptrs: tuple = (0,)) -> bool:
    """Whether a K3 (`shared_bias_attention`) launch takes the biased D = 32
    body of csrc/attn_wgmma_bias.cuh in its natural layout: bfloat16 q/k/v,
    head dim 32, the float32 bias row of Sk elements a multiple of 16 bytes
    (its tensor map's row stride; Sk a multiple of 4), every pointer a
    tensor map reads (`ptrs`: q, k, v, out, bias; not the lse, which leaves
    by scalar stores) 16-byte aligned. That is every WarpAttn launch, the
    training form with the lse and a rank's row block of the bias (a view
    whose rows stay Sk apart) included. Every other launch stays on the
    `mma.sync` body (bfloat16: the CLIP causal mask at D = 64) or the CUDA
    cores (float32). A fixed rule on the call's shape and pointers, no
    switch."""
    return folded_wgmma_route(dtype, Sk, D, torch.float32, ptrs)


def flash_t_bias_wgmma_route(dtype: torch.dtype, Sq: int, Sk: int, D: int, shared_bias: bool,
                             ptrs: tuple = (0,)) -> bool:
    """Whether a K6a (`flash_attention_t`) launch takes the biased D = 32
    body of csrc/attn_wgmma_bias.cuh on sequence-minor tiles: bfloat16
    q/k/v, head dim 32, a float32 bias that broadcasts over batch rows and
    heads (`shared_bias`: `_bias_strides` gives 0, 0; the model's WarpAttn
    sites), Sq and Sk multiples of 8 (TMA's row strides of S*2 bytes; the
    bias rows of Sk*4 bytes follow), every pointer a tensor map reads
    (`ptrs`: q, k, v, out, bias) 16-byte aligned. A per-batch or per-head
    bias, no bias at D = 32, ragged or unaligned inputs stay on the
    `mma.sync` body; D = 64 without a bias is `wgmma_route`'s. A fixed rule
    on the call's shape and pointers, no switch."""
    return (dtype == torch.bfloat16 and D == BIAS_WGMMA_HEAD_DIM and shared_bias
            and Sq % WGMMA_SEQ_MULTIPLE == 0 and Sk % WGMMA_SEQ_MULTIPLE == 0
            and all(p % WGMMA_ALIGN == 0 for p in ptrs))


def bwd_bias_wgmma_route(name: str, dtype: torch.dtype, Sq: int, Sk: int, D: int,
                         bias_strides: tuple | None, ptrs: tuple = (0,)) -> bool:
    """Whether a K5b (`flash_bwd_dq`) or K5c (`flash_bwd_dkv`) launch takes
    the biased D = 32 backward body of csrc/attn_wgmma_bwd_bias.cuh:
    bfloat16, head dim 32, a float32 bias broadcast over batch rows and
    heads (`bias_strides`, the batch and head strides `_bias_strides` gives:
    (0, 0); None for no bias), its row of Sk elements a multiple of 16
    bytes (Sk a multiple of 4: the tensor map's row stride), for K5c also Sq
    a multiple of WGMMA_ROW_MULTIPLE (its float32 lse and delta rows go by
    tensor maps too), and every pointer a tensor map reads (`ptrs`: K5b q,
    k, v, dO, the bias, dq; K5c also lse, delta, dk, dv; not K5b's lse and
    delta, read by scalar loads) 16-byte aligned. That is every WarpAttn
    launch of the training step, a rank's row block of the bias (a view
    whose rows stay Sk apart) included. A per-batch or per-head bias, no
    bias at D = 32, float32, ragged or unaligned inputs stay on the
    `mma.sync` tiles (bfloat16) or the CUDA cores (float32); D = 64 without
    a bias is `wgmma_route`'s. The heads do not enter: the 4-D maps' row
    stride, H·64 bytes, is a multiple of 16 at every H. A fixed rule on the
    call's shape and pointers, no switch."""
    return (dtype == torch.bfloat16 and D == BIAS_WGMMA_HEAD_DIM and bias_strides == (0, 0)
            and Sk * 4 % WGMMA_ALIGN == 0
            and (name != "flash_bwd_dkv" or Sq % WGMMA_ROW_MULTIPLE == 0)
            and all(p % WGMMA_ALIGN == 0 for p in ptrs))


def dense_wgmma_route(dtype: torch.dtype, K: int, M: int, linear_layout: bool,
                      ptrs: tuple = (0,)) -> bool:
    """Whether a K7 (`dense_matmul`) launch takes the persistent `wgmma`
    GEMM of csrc/dense_matmul.cu: bfloat16, the [M, K] weight that
    nn.Linear stores (`linear_layout`), K and M multiples of 8 (the row
    strides of x, w and out in its tensor maps are multiples of 16 bytes),
    and x, w and out (`ptrs`) 16-byte aligned. Every other launch (the
    ragged K = 77 site, a [K, M] weight, unaligned pointers) stays on the
    `mma.sync` tile (bfloat16) or the CUDA cores (float32). A fixed rule,
    no switch."""
    return (dtype == torch.bfloat16 and linear_layout and K % 8 == 0 and M % 8 == 0
            and all(p % WGMMA_ALIGN == 0 for p in ptrs))


def dense_wgmma_plan(N: int, K: int, M: int, sms: int) -> dict:
    """The tiles of K7's wgmma GEMM at (N, K, M) on a card of `sms` SMs:
    `row_tiles` of DENSE_WGMMA_BN rows, `col_tiles` of DENSE_WGMMA_BM
    columns (no column tile is padded at a model site), and a persistent
    `grid` of one block an SM (no more blocks than tiles). Tile t is row tile t // col_tiles,
    column tile t % col_tiles; block b takes tiles b, b + grid, ...
    (`dense_wgmma_walk`). K is walked inside a tile, in slabs of 64."""
    row_tiles, col_tiles = -(-N // DENSE_WGMMA_BN), -(-M // DENSE_WGMMA_BM)
    tiles = row_tiles * col_tiles
    return dict(row_tiles=row_tiles, col_tiles=col_tiles, tiles=tiles,
                grid=max(1, min(tiles, sms)))


def dense_wgmma_walk(plan: dict, block: int) -> list:
    """[(row tile, column tile)] that `block` of the plan's grid takes, in
    order: the loop of csrc/dense_matmul.cu dense_matmul_wgmma_kernel."""
    return [(t // plan["col_tiles"], t % plan["col_tiles"])
            for t in range(block, plan["tiles"], plan["grid"])]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _on_tensor_cores(q: torch.Tensor) -> bool:
    """The kernels with a tensor-core path take it for every bfloat16 input
    they accept: K1 and K2 up to head dim 512 (csrc/attn_mma.cuh to 160,
    above it their wide kernels on csrc/attn_mma_wide.cuh, or the `wgmma`
    bodies their rules name), K3, K5a, K5b,
    K5c, K6a and K6b up to 160 (csrc/attn_mma.cuh, csrc/attn_mma_bwd.cuh),
    K4 up to 160 (csrc/frame_tma.cuh where `frame_route` holds, else
    csrc/frame_mma.cuh), L1 and L3 up to 160 (csrc/frame_mma.cuh), L2 up to 160
    (csrc/motion_fused.cu), K7 (csrc/dense_matmul.cu) at every shape;
    float32 stays on the CUDA cores."""
    return q.dtype == torch.bfloat16


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _batch_chunks(B: int, H: int, Sq: int, Sk: int):
    """(start, end) batch ranges whose [b, H, Sq, Sk] float32 logits stay
    under LOGITS_BYTES_LIMIT."""
    chunk = max(1, LOGITS_BYTES_LIMIT // max(1, H * Sq * Sk * 4))
    return [(s, min(B, s + chunk)) for s in range(0, B, chunk)]


def _logits(q, k, bias, scale, s, e):
    """float32 logits [e - s, H, Sq, Sk] of batch rows s:e."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q[s:e].float() * scale, k[s:e].float())
    if bias is not None:
        logits = logits + (bias if bias.shape[0] == 1 else bias[s:e]).float()
    return logits


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def reference_attention(q, k, v, bias=None, scale=None):
    """softmax(q k^T * scale + bias) v for q [B, Sq, H, D], k/v
    [B, Sk, H, D], bias broadcastable to [B, H, Sq, Sk]. Logits and softmax
    in float32, probabilities cast to v.dtype before PV, output in q.dtype
    (imagine360_tpu/ops/attention.py:_reference_attention). The batch axis
    is chunked so no chunk holds more than LOGITS_BYTES_LIMIT of logits."""
    B, Sq, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    outs = []
    for s, e in _batch_chunks(B, H, Sq, k.shape[1]):
        probs = torch.softmax(_logits(q, k, bias, scale, s, e), dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, v[s:e]).to(q.dtype))
    return _cat(outs)


def reference_attention_vjp(q, k, v, bias, g, scale=None):
    """(dq, dk, dv) of `reference_attention` for the output cotangent g
    [B, Sq, H, D], recomputed from q, k, v in float32, batch-chunked like
    the forward: p = softmax(s), dv = p^T g, dp = g v^T,
    ds = p * (dp - rowsum(p * dp)), dq = ds k * scale, dk = ds^T q * scale.
    The bias is a constant and gets no gradient. This is the backward of
    the sites whose forward kernels (K1, K4) have no backward kernel in the
    JAX package either (its `_kernel_attention_bwd` differentiates the
    einsum reference)."""
    B, Sq, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    dqs, dks, dvs = [], [], []
    for s, e in _batch_chunks(B, H, Sq, k.shape[1]):
        p = torch.softmax(_logits(q, k, bias, scale, s, e), dim=-1)
        gf = g[s:e].float()
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, gf).to(v.dtype))
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, v[s:e].float())
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        dqs.append((torch.einsum("bhqk,bkhd->bqhd", ds, k[s:e].float()) * scale).to(q.dtype))
        dks.append((torch.einsum("bhqk,bqhd->bkhd", ds, q[s:e].float()) * scale).to(k.dtype))
    return _cat(dqs), _cat(dks), _cat(dvs)


def _softmax_stats(logits):
    """(p, denom, lse) of the streaming kernels for float32 logits: the max
    is floored at the kernels' finite -1e30, a zero denominator becomes 1
    before the divide and the log, lse = m + log(denom)."""
    m = logits.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    return p, denom, (m + torch.log(denom))[..., 0]


def flash_attention_lse_plain(q, k, v, bias=None, *, scale):
    """Plain K5a: (out [B, Sq, H, D] in q.dtype, lse [B, H, Sq] float32).
    Probabilities stay float32 through the PV product, as in the kernel."""
    B, Sq, H, D = q.shape
    outs, lses = [], []
    for s, e in _batch_chunks(B, H, Sq, k.shape[1]):
        p, denom, lse = _softmax_stats(_logits(q, k, bias, scale, s, e))
        out = torch.einsum("bhqk,bkhd->bhqd", p, v[s:e].float()) / denom
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype))
        lses.append(lse)
    return _cat(outs), _cat(lses)


def _bwd_scores(q, k, v, bias, g, lse, delta, scale, s, e):
    """(p, ds) [e - s, H, Sq, Sk] float32 of the streaming backward:
    p = exp(s - lse), dp = g v^T, ds = p * (dp - delta)."""
    p = torch.exp(_logits(q, k, bias, scale, s, e) - lse[s:e, :, :, None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g[s:e].float(), v[s:e].float())
    return p, p * (dp - delta[s:e, :, :, None])


def flash_bwd_dq_plain(q, k, v, bias, g, lse, delta, *, scale):
    """Plain K5b: dq = (sum_k ds k) * scale, [B, Sq, H, D] in q.dtype."""
    B, Sq, H, D = q.shape
    dqs = []
    for s, e in _batch_chunks(B, H, Sq, k.shape[1]):
        _, ds = _bwd_scores(q, k, v, bias, g, lse, delta, scale, s, e)
        dqs.append((torch.einsum("bhqk,bkhd->bqhd", ds, k[s:e].float()) * scale).to(q.dtype))
    return _cat(dqs)


def flash_bwd_dkv_plain(q, k, v, bias, g, lse, delta, *, scale):
    """Plain K5c: dk = (sum_q ds^T q) * scale and dv = sum_q p^T g, both
    [B, Sk, H, D] in the dtypes of k and v."""
    B, Sq, H, D = q.shape
    dks, dvs = [], []
    for s, e in _batch_chunks(B, H, Sq, k.shape[1]):
        p, ds = _bwd_scores(q, k, v, bias, g, lse, delta, scale, s, e)
        dks.append((torch.einsum("bhqk,bqhd->bkhd", ds, q[s:e].float()) * scale).to(k.dtype))
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, g[s:e].float()).to(v.dtype))
    return _cat(dks), _cat(dvs)


def flash_attention_t_plain(q, k, v, bias=None, *, scale):
    """Plain K6a: q [B, H, D, Sq], k/v [B, H, D, Sk], bias None or
    [1|B, 1|H, Sq, Sk]; returns [B, H, Sq, D] in q.dtype. Probabilities stay
    float32 through the PV product, as in the kernel."""
    out, _ = flash_attention_lse_plain(q.permute(0, 3, 1, 2), k.permute(0, 3, 1, 2),
                                       v.permute(0, 3, 1, 2), bias, scale=scale)
    return out.permute(0, 2, 1, 3).contiguous()


def shared_bias_attention_folded_plain(q, k, v, bias, *, scale, with_lse=False):
    """Plain K6b: q [BH, Sq, D], k/v [BH, Sk, D], bias [Sq, Sk] of any float
    dtype; returns [BH, Sq, D] in q.dtype and, with `with_lse`, the lse
    [BH, Sq] float32. Probabilities stay float32 through the PV product."""
    out, lse = flash_attention_lse_plain(q[:, :, None], k[:, :, None], v[:, :, None],
                                         bias[None, None], scale=scale)
    return (out[:, :, 0], lse[:, 0]) if with_lse else out[:, :, 0]


def dense_matmul_plain(x, w, *, linear_layout=False):
    """Plain K7: x [N, K] @ w ([K, M], or [M, K] with `linear_layout`) in
    float32, cast to x.dtype."""
    wf = w.float()
    return torch.matmul(x.float(), wf.t() if linear_layout else wf).to(x.dtype)


def attention_delta(g, out):
    """delta = rowsum(g * out) in float32, [B, H, Sq] (stock ops, as the JAX
    package leaves it to XLA)."""
    return (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def tiny_attention_plain(q, k, v, bias=None, *, scale, heads):
    B, Sq, C = q.shape
    Sk = k.shape[1]
    D = C // heads
    b = None if bias is None else bias[None, None]
    out = reference_attention(q.reshape(B, Sq, heads, D), k.reshape(B, Sk, heads, D),
                              v.reshape(B, Sk, heads, D), bias=b, scale=scale)
    return out.reshape(B, Sq, C)


def mh_flash_attention_plain(q, k, v, *, scale, heads):
    return tiny_attention_plain(q, k, v, None, scale=scale, heads=heads)


def shared_bias_attention_plain(q, k, v, bias, *, scale, with_lse=False):
    out = reference_attention(q, k, v, bias=bias[None, None], scale=scale)
    if not with_lse:
        return out
    B, Sq, H, D = q.shape
    return out, _cat([_softmax_stats(_logits(q, k, bias[None, None], scale, s, e))[2]
                      for s, e in _batch_chunks(B, H, Sq, k.shape[1])])


def frame_attention_plain(q, k, v, *, scale, heads):
    B, F, HW, C = q.shape
    D = C // heads

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(B * HW, F, heads, D)

    out = reference_attention(fold(q), fold(k), fold(v), scale=scale)
    return out.reshape(B, HW, F, C).permute(0, 2, 1, 3)


def striped_v2_attention_plain(q, k, v, *, scale, heads, G=1, R=1):
    """Plain L1: the pack sizes G and R only say how the kernel walks the
    locations; the function is K4's."""
    return frame_attention_plain(q, k, v, scale=scale, heads=heads)


def diag_motion_attention_plain(q, k, v, *, scale, heads, G=1):
    """Plain L3: the softmax over the diagonal [F, F] blocks alone is K4's
    per-location attention."""
    return frame_attention_plain(q, k, v, scale=scale, heads=heads)


def fused_motion_attention_plain(q, k, v, bias, *, scale, heads, G, exp_bf16=False):
    """Plain L2: q/k/v [B, F, HW, C]; each pack of G neighbouring locations
    becomes one sequence of G*F tokens in block order (row g*F + f) and
    every head takes one softmax over all G*F keys under `bias`
    [1, G*F, G*F] (any float dtype, widened to float32), whatever the bias
    holds. With `exp_bf16` the casts of the TPU kernel in their order: the
    exponent s - max rounded to bfloat16, its exponential taken in bfloat16
    and cast to v.dtype, the denominator summed in float32 over those
    probabilities, the division after P V. Batch-chunked under
    LOGITS_BYTES_LIMIT."""
    B, F, HW, C = q.shape
    D, T, S = C // heads, HW // G, G * F

    def pack(x):    # [B, F, T*G, C] -> [B*T, G*F, heads, D]
        return x.reshape(B, F, T, G, heads, D).permute(0, 2, 3, 1, 4, 5).reshape(
            B * T, S, heads, D)

    qp, kp, vp = pack(q), pack(k), pack(v)
    if not exp_bf16:
        out = reference_attention(qp, kp, vp, bias=bias[None], scale=scale)
    else:
        outs = []
        for s, e in _batch_chunks(B * T, heads, S, S):
            logits = _logits(qp, kp, bias[None], scale, s, e)
            m = logits.amax(dim=-1, keepdim=True)
            p = torch.exp((logits - m).bfloat16()).to(v.dtype)
            denom = p.float().sum(dim=-1, keepdim=True)
            o = torch.einsum("bhqk,bkhd->bhqd", p.float(), vp[s:e].float()) / denom
            outs.append(o.permute(0, 2, 1, 3).to(q.dtype))
        out = _cat(outs)
    return out.reshape(B, T, G, F, C).permute(0, 3, 1, 2, 4).reshape(B, F, HW, C)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def tiny_attention(q, k, v, bias=None, *, scale: float, heads: int):
    """K1. q [B, Sq, H*D], k/v [B, Sk, H*D] with Sk <= 1024 and D <= 512,
    optional bias [Sq, Sk] float32 shared by every row and head. Returns
    [B, Sq, H*D]. Above D = 160 the wide kernel (csrc/tiny_attention_wide.cu)
    runs, counted in `wide_launches`; where `attention_body` names a
    `wgmma` body (csrc/attn_wgmma_xattn.cuh, csrc/attn_wgmma.cuh,
    csrc/attn_wgmma_wide.cuh), that body, counted in `wgmma_launches`; in
    bfloat16 all are counted in `tc_launches`, and each under its body in
    `body_launches`."""
    if q.device.type == "cpu":
        tiny_attention.plain_calls += 1
        return tiny_attention_plain(q, k, v, bias, scale=scale, heads=heads)
    name = "tiny_attention"
    dt = _check_cuda(name, q, k, v)
    B, Sq, C = q.shape
    Sk = k.shape[1]
    D = C // heads
    _check_head_dim(name, D, WIDE_MAX_HEAD_DIM)
    if (C != heads * D or k.shape != (B, Sk, C) or v.shape != k.shape
            or not 1 <= Sk <= TINY_MAX_SK):
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} heads={heads} (Sk <= {TINY_MAX_SK})")
    if bias is not None:
        _check_bias(name, bias, q, Sq, Sk)
    check_index_range(name, rows=B * heads * Sq)
    out = torch.empty_like(q)
    lib = load_library()
    shape = (B, Sq, Sk, heads, D)
    ptrs = (_ptr(q), _ptr(k), _ptr(v), _ptr(out))
    wide = D > MAX_HEAD_DIM
    body = attention_body(name, q.dtype, Sq, Sk, heads, D, bias is not None, ptrs)
    if body in WGMMA_ENTRIES[name]:
        _launch(tiny_attention, getattr(lib, WGMMA_ENTRIES[name][body]), q, *ptrs, B, Sq, Sk,
                heads, D, float(scale), shape=shape, wide=wide, tc=True, wgmma=True, body=body)
        return out
    _launch(tiny_attention, lib.i360_tiny_attention_wide if wide else lib.i360_tiny_attention,
            q, _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(out), B, Sq, Sk, heads, D,
            float(scale), dt, shape=shape, wide=wide, tc=_on_tensor_cores(q), body=body)
    return out


def mh_flash_attention(q, k, v, *, scale: float, heads: int):
    """K2. q [B, Sq, H*D], k/v [B, Sk, H*D] with D <= 512, no bias. Returns
    [B, Sq, H*D]. Above D = 160 the wide kernel (csrc/mh_flash_wide.cu)
    runs, counted in `wide_launches`; where `attention_body` names a
    `wgmma` body (csrc/attn_wgmma.cuh, csrc/attn_wgmma_wide.cuh), that body,
    counted in `wgmma_launches`; in bfloat16 all are counted in
    `tc_launches`, and each under its body in `body_launches`."""
    if q.device.type == "cpu":
        mh_flash_attention.plain_calls += 1
        return mh_flash_attention_plain(q, k, v, scale=scale, heads=heads)
    name = "mh_flash_attention"
    dt = _check_cuda(name, q, k, v)
    B, Sq, C = q.shape
    Sk = k.shape[1]
    D = C // heads
    _check_head_dim(name, D, WIDE_MAX_HEAD_DIM)
    if C != heads * D or k.shape != (B, Sk, C) or v.shape != k.shape or Sk < 1:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} heads={heads}")
    check_index_range(name, rows=B * heads * Sq)
    out = torch.empty_like(q)
    lib = load_library()
    shape = (B, Sq, Sk, heads, D)
    ptrs = (_ptr(q), _ptr(k), _ptr(v), _ptr(out))
    wide = D > MAX_HEAD_DIM
    body = attention_body(name, q.dtype, Sq, Sk, heads, D, False, ptrs)
    if body in WGMMA_ENTRIES[name]:
        _launch(mh_flash_attention, getattr(lib, WGMMA_ENTRIES[name][body]), q, *ptrs, B, Sq,
                Sk, heads, D, float(scale), shape=shape, wide=wide, tc=True, wgmma=True,
                body=body)
        return out
    _launch(mh_flash_attention,
            lib.i360_mh_flash_attention_wide if wide else lib.i360_mh_flash_attention,
            q, _ptr(q), _ptr(k), _ptr(v), _ptr(out), B, Sq, Sk, heads, D, float(scale), dt,
            shape=shape, wide=wide, tc=_on_tensor_cores(q), body=body)
    return out


def shared_bias_attention(q, k, v, bias, *, scale: float, with_lse: bool = False):
    """K3. q [B, Sq, H, D], k/v [B, Sk, H, D], bias [Sq, Sk] float32 shared
    by every batch row and head. Returns [B, Sq, H, D], and with `with_lse`
    also the log-sum-exp of every query row, [B, H, Sq] float32. Where
    `shared_bias_wgmma_route` holds, the biased `wgmma` body
    (csrc/attn_wgmma_bias.cuh), counted in `wgmma_launches`."""
    if q.device.type == "cpu":
        shared_bias_attention.plain_calls += 1
        return shared_bias_attention_plain(q, k, v, bias, scale=scale, with_lse=with_lse)
    name = "shared_bias_attention"
    dt = _check_cuda(name, q, k, v)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    _check_head_dim(name, D)
    if k.shape != (B, Sk, H, D) or v.shape != k.shape or Sk < 1:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    _check_bias(name, bias, q, Sq, Sk)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, device=q.device, dtype=torch.float32) if with_lse else None
    lib, shape = load_library(), (B, Sq, Sk, H, D)
    if shared_bias_wgmma_route(q.dtype, Sk, D, (_ptr(q), _ptr(k), _ptr(v), _ptr(out),
                                                _ptr(bias))):
        _launch(shared_bias_attention, lib.i360_shared_bias_attention_wgmma, q, _ptr(q),
                _ptr(k), _ptr(v), _ptr(bias), _ptr(out), _ptr(lse), B, Sq, Sk, H, D,
                float(scale), shape=shape, tc=True, lse=with_lse, wgmma=True)
        return (out, lse) if with_lse else out
    _launch(shared_bias_attention, lib.i360_shared_bias_attention, q, _ptr(q), _ptr(k),
            _ptr(v), _ptr(bias), _ptr(out), _ptr(lse), B, Sq, Sk, H, D, float(scale), dt,
            shape=shape, tc=_on_tensor_cores(q), lse=with_lse)
    return (out, lse) if with_lse else out


def _check_flash(name, q, k, v, bias, *more):
    """Validate the inputs of K5a-c: q [B, Sq, H, D], k/v [B, Sk, H, D],
    `more` tensors shaped like q, bias None or float32 [1|B, 1|H, Sq, Sk].
    Returns (dtype code, B, Sq, Sk, H, D, bias batch stride, head stride)."""
    dt = _check_cuda(name, q, k, v, *more)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    _check_head_dim(name, D)
    if (k.shape != (B, Sk, H, D) or v.shape != k.shape or Sk < 1
            or any(t.shape != q.shape for t in more)):
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} {[tuple(t.shape) for t in more]}")
    return (dt, B, Sq, Sk, H, D, *_bias_strides(name, bias, q, B, H, Sq, Sk))


def _bias_strides(name, bias, q, B, H, Sq, Sk):
    """Validate a bias None or float32 [1|B, 1|H, Sq, Sk]; return its batch
    and head strides in elements, 0 for a broadcast axis."""
    if bias is None:
        return 0, 0
    if (bias.device != q.device or bias.dtype != torch.float32 or bias.dim() != 4
            or bias.shape[0] not in (1, B) or bias.shape[1] not in (1, H)
            or tuple(bias.shape[2:]) != (Sq, Sk) or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be a contiguous float32 [1|{B}, 1|{H}, {Sq}, "
                         f"{Sk}] tensor on {q.device}, got {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}")
    return (bias.stride(0) if bias.shape[0] > 1 else 0,
            bias.stride(1) if bias.shape[1] > 1 else 0)


def _check_rows(name, q, *rows):
    """lse / delta: contiguous float32 [B, H, Sq] on q's device."""
    B, Sq, H, _ = q.shape
    for t in rows:
        if (t.device != q.device or t.dtype != torch.float32 or tuple(t.shape) != (B, H, Sq)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: lse and delta must be contiguous float32 "
                             f"[{B}, {H}, {Sq}] tensors on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def flash_attention_lse(q, k, v, bias=None, *, scale: float):
    """K5a. q [B, Sq, H, D], k/v [B, Sk, H, D], bias None or float32
    [1|B, 1|H, Sq, Sk]. Returns (out [B, Sq, H, D] in q.dtype, lse
    [B, H, Sq] float32), the forward and the residual of the streaming
    backward. Where `wgmma_route` holds, the `wgmma` body
    (csrc/attn_wgmma.cuh), counted in `wgmma_launches`."""
    if q.device.type == "cpu":
        flash_attention_lse.plain_calls += 1
        return flash_attention_lse_plain(q, k, v, bias, scale=scale)
    dt, B, Sq, Sk, H, D, bs, hs = _check_flash("flash_attention_lse", q, k, v, bias)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, device=q.device, dtype=torch.float32)
    lib, shape = load_library(), (B, Sq, Sk, H, D)
    if wgmma_route("flash_attention_lse", q.dtype, Sq, Sk, H, D, bias is not None,
                   (_ptr(q), _ptr(k), _ptr(v), _ptr(out))):
        _launch(flash_attention_lse, lib.i360_flash_attention_lse_wgmma, q, _ptr(q), _ptr(k),
                _ptr(v), _ptr(out), _ptr(lse), B, Sq, Sk, H, D, float(scale), shape=shape,
                tc=True, wgmma=True)
        return out, lse
    _launch(flash_attention_lse, lib.i360_flash_attention_lse, q, _ptr(q), _ptr(k), _ptr(v),
            _ptr(bias), _ptr(out), _ptr(lse), B, Sq, Sk, H, D, bs, hs, float(scale), dt,
            shape=shape, tc=_on_tensor_cores(q))
    return out, lse


def flash_bwd_dq(q, k, v, bias, g, lse, delta, *, scale: float):
    """K5b. The query gradient of softmax(q k^T * scale + bias) v for the
    output cotangent g [B, Sq, H, D] (q's dtype), from the forward's lse
    and delta = rowsum(g * out), both [B, H, Sq] float32. Returns dq
    [B, Sq, H, D] in q.dtype. Where `wgmma_route` holds, the `wgmma` body
    (csrc/attn_wgmma_bwd.cuh), where `bwd_bias_wgmma_route` holds, the
    biased one (csrc/attn_wgmma_bwd_bias.cuh), both counted in
    `wgmma_launches`."""
    if q.device.type == "cpu":
        flash_bwd_dq.plain_calls += 1
        return flash_bwd_dq_plain(q, k, v, bias, g, lse, delta, scale=scale)
    name = "flash_bwd_dq"
    dt, B, Sq, Sk, H, D, bs, hs = _check_flash(name, q, k, v, bias, g)
    _check_rows(name, q, lse, delta)
    dq = torch.empty_like(q)
    lib, shape = load_library(), (B, Sq, Sk, H, D)
    if wgmma_route(name, q.dtype, Sq, Sk, H, D, bias is not None,
                   (_ptr(q), _ptr(k), _ptr(v), _ptr(g), _ptr(dq))):
        _launch(flash_bwd_dq, lib.i360_flash_bwd_dq_wgmma, q, _ptr(q), _ptr(k), _ptr(v),
                _ptr(g), _ptr(lse), _ptr(delta), _ptr(dq), B, Sq, Sk, H, D, float(scale),
                shape=shape, tc=True, wgmma=True)
        return dq
    if bwd_bias_wgmma_route(name, q.dtype, Sq, Sk, D, None if bias is None else (bs, hs),
                            (_ptr(q), _ptr(k), _ptr(v), _ptr(g), _ptr(bias), _ptr(dq))):
        _launch(flash_bwd_dq, lib.i360_flash_bwd_dq_bias_wgmma, q, _ptr(q), _ptr(k), _ptr(v),
                _ptr(g), _ptr(bias), _ptr(lse), _ptr(delta), _ptr(dq), B, Sq, Sk, H, D,
                float(scale), shape=shape, tc=True, wgmma=True)
        return dq
    _launch(flash_bwd_dq, lib.i360_flash_bwd_dq, q, _ptr(q), _ptr(k), _ptr(v), _ptr(bias),
            _ptr(g), _ptr(lse), _ptr(delta), _ptr(dq), B, Sq, Sk, H, D, bs, hs, float(scale),
            dt, shape=shape, tc=_on_tensor_cores(q))
    return dq


def flash_bwd_dkv(q, k, v, bias, g, lse, delta, *, scale: float):
    """K5c. The key and value gradients for the same inputs as
    `flash_bwd_dq`. Returns (dk, dv), [B, Sk, H, D] in the dtype of k.
    Where `wgmma_route` holds (Sq a multiple of 4 too), the `wgmma` body
    (csrc/attn_wgmma_bwd.cuh), where `bwd_bias_wgmma_route` holds, the
    biased one (csrc/attn_wgmma_bwd_bias.cuh), both counted in
    `wgmma_launches`."""
    if q.device.type == "cpu":
        flash_bwd_dkv.plain_calls += 1
        return flash_bwd_dkv_plain(q, k, v, bias, g, lse, delta, scale=scale)
    name = "flash_bwd_dkv"
    dt, B, Sq, Sk, H, D, bs, hs = _check_flash(name, q, k, v, bias, g)
    _check_rows(name, q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib, shape = load_library(), (B, Sq, Sk, H, D)
    if wgmma_route(name, q.dtype, Sq, Sk, H, D, bias is not None,
                   tuple(_ptr(t) for t in (q, k, v, g, lse, delta, dk, dv))):
        _launch(flash_bwd_dkv, lib.i360_flash_bwd_dkv_wgmma, q, _ptr(q), _ptr(k), _ptr(v),
                _ptr(g), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv), B, Sq, Sk, H, D,
                float(scale), shape=shape, tc=True, wgmma=True)
        return dk, dv
    if bwd_bias_wgmma_route(name, q.dtype, Sq, Sk, D, None if bias is None else (bs, hs),
                            tuple(_ptr(t) for t in (q, k, v, g, bias, lse, delta, dk, dv))):
        _launch(flash_bwd_dkv, lib.i360_flash_bwd_dkv_bias_wgmma, q, _ptr(q), _ptr(k),
                _ptr(v), _ptr(g), _ptr(bias), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv), B, Sq,
                Sk, H, D, float(scale), shape=shape, tc=True, wgmma=True)
        return dk, dv
    _launch(flash_bwd_dkv, lib.i360_flash_bwd_dkv, q, _ptr(q), _ptr(k), _ptr(v), _ptr(bias),
            _ptr(g), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv), B, Sq, Sk, H, D, bs, hs,
            float(scale), dt, shape=shape, tc=_on_tensor_cores(q))
    return dk, dv


def _frame_stage_bytes(F: int, D: int, G: int, HG: int) -> int:
    """Bytes of K4's q, k and v tiles in one stage of a bfloat16 block:
    frames padded to a multiple of 16, rows of G * HG heads padded to a
    multiple of 16 and 8 more (csrc/frame_attention.cu k4_row_stride)."""
    return 3 * (-(-F // 16) * 16) * (G * HG * (-(-D // 16) * 16) + 8) * 2


def frame_attention_walk(B: int, F: int, HW: int, heads: int, D: int, sms: int, G: int,
                         HG: int) -> int:
    """R, the packs of G locations x HG heads a bfloat16 K4 block walks: so
    many that each block slot the card holds (by shared memory, two stages a
    block) takes about FRAME_WAVES blocks in turn."""
    block_bytes = 2 * _frame_stage_bytes(F, D, G, HG)
    slots = sms * max(1, min(16, SM_SHARED_BYTES // (block_bytes + 1024)))
    packs = B * -(-HW // G) * (heads // HG)
    return max(1, -(-packs // (slots * FRAME_WAVES)))


def frame_attention_plan(B: int, F: int, HW: int, heads: int, D: int, sms: int):
    """(G, HG, R) of K4's bfloat16 kernel (csrc/frame_attention.cu) on a card
    with `sms` SMs: a pack is G neighbouring locations x HG of their heads
    (HG divides heads), and a block walks R packs (`frame_attention_walk`).
    The pack is the largest (G * HG problems; all heads before more
    locations, so that a frame's run stays one contiguous read) whose tiles
    stay within FRAME_STAGE_BYTES a stage; one location of one head if none
    does."""
    fits = [(G * HG, HG, G) for HG in range(1, heads + 1) if heads % HG == 0
            for G in (1, 2, 4, 8)
            if G <= max(1, HW) and _frame_stage_bytes(F, D, G, HG) <= FRAME_STAGE_BYTES]
    _, HG, G = max(fits) if fits else (1, 1, 1)
    return G, HG, frame_attention_walk(B, F, HW, heads, D, sms, G, HG)


def frame_route(dtype: torch.dtype, F: int, HW: int, H: int, D: int,
                ptrs: tuple = (0,)) -> bool:
    """Whether a K4 (`frame_attention`) launch takes the Hopper body of
    csrc/frame_tma.cuh: bfloat16, exactly FRAME_TMA_F frames, a head dim D
    that is a multiple of 8 up to MAX_HEAD_DIM (so the row stride H*D*2 and
    the chunk strides of its tensor maps are multiples of 16 bytes), every
    pointer a tensor map reads (`ptrs`: q, k, v, out) 16-byte aligned: every
    motion-module launch of the models. Other frame counts, other head
    dims and unaligned views stay on the `mma.sync` tile of
    csrc/frame_mma.cuh; float32 on the CUDA cores. A fixed rule on the
    call's dtype, shape and pointers, no switch."""
    return (dtype == torch.bfloat16 and F == FRAME_TMA_F and D % 8 == 0
            and 8 <= D <= MAX_HEAD_DIM and all(p % WGMMA_ALIGN == 0 for p in ptrs))


def frame_tma_smem_bytes(D: int, P: int, S: int, NW: int) -> int:
    """Dynamic shared memory of a block of K4's Hopper body: S stages of
    q, k and v boxes of P problems of 16 x D bf16, two staging tiles a
    consumer warp, the barriers and alignment (csrc/frame_tma.cuh
    frame_tma_smem)."""
    return 256 + S * 3 * P * FRAME_TMA_F * D * 2 + NW * 2 * FRAME_TMA_F * D * 2


def frame_tma_plan(B: int, F: int, HW: int, heads: int, D: int, sms: int) -> dict:
    """The work items and block of K4's Hopper body (csrc/frame_tma.cuh) on
    a card of `sms` SMs: an item is G neighbouring locations x HG heads (HG
    divides heads): all heads, or as many as keep one tensor's box within
    FRAME_TMA_ITEM_BYTES, then as many locations as fill it; where that
    leaves fewer than FRAME_TMA_MIN_ITEMS items a block slot, the item
    shrinks (locations first) down to one problem. `S` stages
    (FRAME_TMA_STAGES), `NW` consumer warps (the most up to FRAME_TMA_WARPS
    that `frame_tma_walk_ok` allows), `bps` blocks an SM
    asked for (the C entry takes fewer where fewer fit), `items` the work
    items and `grid` the blocks they run on where `bps` fit."""
    tile = FRAME_TMA_F * D * 2
    divs = [h for h in range(1, heads + 1) if heads % h == 0]
    HG = max([h for h in divs if h * tile <= FRAME_TMA_ITEM_BYTES] or [1])
    G = max(1, min(HW, FRAME_TMA_ITEM_BYTES // (HG * tile)))
    items = lambda G, HG: B * -(-HW // G) * (heads // HG)
    slots = sms * FRAME_TMA_BLOCKS
    while G * HG > 1 and items(G, HG) < FRAME_TMA_MIN_ITEMS * slots:
        if G > 1:
            G //= 2
        else:
            HG = max(h for h in divs if h < HG)
    P, S = G * HG, FRAME_TMA_STAGES
    NW = max(n for n in range(1, FRAME_TMA_WARPS + 1) if frame_tma_walk_ok(P, S, n))
    return dict(G=G, HG=HG, S=S, NW=NW, bps=FRAME_TMA_BLOCKS, items=items(G, HG),
                grid=min(items(G, HG), slots), smem=frame_tma_smem_bytes(D, P, S, NW))


def frame_tma_walk_ok(P: int, S: int, NW: int) -> bool:
    """Whether NW consumer warps may take the problems of items of P
    problems in turn on a ring of S stages (csrc/frame_tma.cuh ft_walk_ok):
    every warp takes a problem of every item (P >= NW), or of every
    (NW / P)-th item with NW / P dividing S, so that its wait on a stage's
    full barrier by parity never passes on an earlier turn of the stage."""
    return P >= NW or (NW % P == 0 and S % (NW // P) == 0)


# the bodies of K4, as `frame_body` names them and `frame_body_counts` counts them
FRAME_BODIES = ("tma", "mma_sync", "cuda_cores")


def frame_body(dtype: torch.dtype, F: int, HW: int, H: int, D: int, ptrs: tuple = (0,)) -> str:
    """The body a K4 (`frame_attention`) launch takes, which its wrapper
    dispatches on: `tma` where `frame_route` holds (csrc/frame_tma.cuh),
    else `mma_sync` in bfloat16 (csrc/frame_mma.cuh) and `cuda_cores` in
    float32."""
    if frame_route(dtype, F, HW, H, D, ptrs):
        return "tma"
    return "mma_sync" if dtype == torch.bfloat16 else "cuda_cores"


def fused_wgmma_slots(D: int) -> int:
    """T, the (pack, head) row slots a block of L2's Hopper body takes under
    one bias tile at head dim D (csrc/motion_wgmma.cuh mw_slots): O takes
    D / 2 floats of a consumer thread a slot, within 80."""
    return 4 if D <= 40 else 2 if D <= 80 else 1


def fused_wgmma_route(dtype: torch.dtype, F: int, G: int, H: int, D: int,
                      bias_dtype: torch.dtype, exp_bf16: bool, ptrs: tuple = (0,)) -> bool:
    """Whether an L2 (`fused_motion_attention`) launch takes the Hopper body
    of csrc/motion_wgmma.cuh: bfloat16, no exp_bf16, a head dim of
    FUSED_WGMMA_HEAD_DIMS (its instantiations: the motion modules' 40, 80,
    160), F dividing FUSED_WGMMA_KEYS (a key tile is whole locations),
    S = G*F a multiple of FUSED_WGMMA_ROWS (whole query tiles and an even
    count of key tiles; the bias rows then multiples of 16 bytes), a
    float32 or bfloat16 bias, every pointer a tensor map reads (`ptrs`: q,
    k, v, out, bias) 16-byte aligned: every such launch of the lab. exp_bf16
    and the other bfloat16 calls stay on the `mma.sync` body of
    csrc/motion_fused.cu, float32 on the CUDA cores. A fixed rule on the
    call's dtype, shape and pointers, no switch."""
    return (dtype == torch.bfloat16 and not exp_bf16 and D in FUSED_WGMMA_HEAD_DIMS
            and H >= 1 and bias_dtype in (torch.float32, torch.bfloat16)
            and FUSED_WGMMA_KEYS % F == 0 and (G * F) % FUSED_WGMMA_ROWS == 0
            and all(p % WGMMA_ALIGN == 0 for p in ptrs))


# the bodies of L2 and L3, as `fused_body` and `diag_body` name them and
# `frame_body_counts` counts them beside K4's
FUSED_BODIES = ("fused_wgmma", "fused_mma_sync", "fused_cuda_cores")
DIAG_BODIES = ("diag_tma", "diag_mma_sync", "diag_cuda_cores")


def fused_body(dtype: torch.dtype, F: int, G: int, H: int, D: int, bias_dtype: torch.dtype,
               exp_bf16: bool, ptrs: tuple = (0,)) -> str:
    """The body an L2 launch takes, which its wrapper dispatches on:
    `fused_wgmma` where `fused_wgmma_route` holds (csrc/motion_wgmma.cuh),
    else `fused_mma_sync` in bfloat16 (csrc/motion_fused.cu) and
    `fused_cuda_cores` in float32."""
    if fused_wgmma_route(dtype, F, G, H, D, bias_dtype, exp_bf16, ptrs):
        return "fused_wgmma"
    return "fused_mma_sync" if dtype == torch.bfloat16 else "fused_cuda_cores"


def diag_route(dtype: torch.dtype, F: int, HW: int, H: int, D: int, G: int,
               ptrs: tuple = (0,)) -> bool:
    """Whether an L3 (`diag_motion_attention`) launch takes K4's Hopper body
    under L3's ownership (csrc/motion_diag.cu diag_motion_tma_kernel on
    csrc/frame_tma.cuh): bfloat16, exactly FRAME_TMA_F frames, a head dim D
    that is a multiple of 8 up to MAX_HEAD_DIM (so C*2 and the maps' strides
    are multiples of 16 bytes), G dividing HW, every pointer a tensor map
    reads (`ptrs`: q, k, v, out) 16-byte aligned: every bf16 launch of the
    lab. Other frame counts (up to DIAG_MAX_F), head dims and unaligned
    views stay on the `mma.sync` tile of csrc/frame_mma.cuh; float32 on
    the CUDA cores. A fixed rule, no switch."""
    return (dtype == torch.bfloat16 and F == FRAME_TMA_F and D % 8 == 0
            and 8 <= D <= MAX_HEAD_DIM and G >= 1 and HW % G == 0
            and all(p % WGMMA_ALIGN == 0 for p in ptrs))


def diag_body(dtype: torch.dtype, F: int, HW: int, H: int, D: int, G: int,
              ptrs: tuple = (0,)) -> str:
    """The body an L3 launch takes, which its wrapper dispatches on:
    `diag_tma` where `diag_route` holds, else `diag_mma_sync` in bfloat16
    and `diag_cuda_cores` in float32."""
    if diag_route(dtype, F, HW, H, D, G, ptrs):
        return "diag_tma"
    return "diag_mma_sync" if dtype == torch.bfloat16 else "diag_cuda_cores"


def diag_tma_plan(B: int, F: int, HW: int, heads: int, D: int, G: int, sms: int) -> dict:
    """The walk of L3's Hopper body (csrc/motion_diag.cu on
    csrc/frame_tma.cuh) on a card of `sms` SMs: a persistent block takes
    packs of G locations (`packs` of them, on `grid` blocks where `bps`
    fit an SM) and streams each as items of SG locations x HG heads (HG
    divides heads): all heads, or as many as keep one tensor's box within
    FRAME_TMA_ITEM_BYTES, then as many of the pack's locations as fill it
    and divide G (G / SG items of a head group a pack). `S` stages
    (FRAME_TMA_STAGES), `NW` consumer warps (the most up to FRAME_TMA_WARPS
    that `frame_tma_walk_ok` allows)."""
    tile = FRAME_TMA_F * D * 2
    divs = [h for h in range(1, heads + 1) if heads % h == 0]
    HG = max([h for h in divs if h * tile <= FRAME_TMA_ITEM_BYTES] or [1])
    SG = max(g for g in range(1, G + 1) if G % g == 0
             and (g == 1 or g * HG * tile <= FRAME_TMA_ITEM_BYTES))
    P, S = SG * HG, FRAME_TMA_STAGES
    NW = max(n for n in range(1, FRAME_TMA_WARPS + 1) if frame_tma_walk_ok(P, S, n))
    packs = B * (HW // G)
    return dict(SG=SG, HG=HG, S=S, NW=NW, bps=FRAME_TMA_BLOCKS, packs=packs,
                grid=min(packs, sms * FRAME_TMA_BLOCKS), smem=frame_tma_smem_bytes(D, P, S, NW))


def frame_attention(q, k, v, *, scale: float, heads: int):
    """K4. q/k/v [B, F, HW, C] with F <= 64; each location attends over its
    own F frames with `heads` heads of C // heads. Returns [B, F, HW, C].
    Where `frame_route` holds, the Hopper body (csrc/frame_tma.cuh, items
    of `frame_tma_plan`); other bfloat16 calls take the `mma.sync` tile in
    packs of `frame_attention_plan`; all bfloat16 launches are counted in
    `tc_launches`, and each under its body in `body_launches`."""
    if q.device.type == "cpu":
        frame_attention.plain_calls += 1
        return frame_attention_plain(q, k, v, scale=scale, heads=heads)
    name = "frame_attention"
    dt = _check_cuda(name, q, k, v)
    B, F, HW, C = q.shape
    D = C // heads
    _check_head_dim(name, D)
    if C != heads * D or k.shape != q.shape or v.shape != q.shape \
            or not 1 <= F <= FRAME_MAX_F:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} heads={heads} (F <= {FRAME_MAX_F})")
    check_index_range(name, problems=B * HW * heads)
    out = torch.empty_like(q)
    tc = _on_tensor_cores(q)
    ptrs = (_ptr(q), _ptr(k), _ptr(v), _ptr(out))
    body = frame_body(q.dtype, F, HW, heads, D, ptrs)
    shape = (B, F, HW, C, heads)
    sms = _sm_count(q.device.index)
    if body == "tma":
        plan = frame_tma_plan(B, F, HW, heads, D, sms)
        _launch(frame_attention, load_library().i360_frame_attention_tma, q, *ptrs, B, F, HW,
                heads, D, float(scale), *(plan[k] for k in ("G", "HG", "S", "NW", "bps")),
                shape=shape, tc=True, body=body)
        return out
    plan = frame_attention_plan(B, F, HW, heads, D, sms) if tc else (1, 1, 1)
    _launch(frame_attention, load_library().i360_frame_attention, q, *ptrs, B, F, HW, heads, D,
            float(scale), dt, *plan, shape=shape, tc=tc, body=body)
    return out


def flash_attention_t(q, k, v, bias=None, *, scale: float):
    """K6a. Sequence-minor inputs: q [B, H, D, Sq], k/v [B, H, D, Sk], bias
    None or float32 [1|B, 1|H, Sq, Sk]. Returns [B, H, Sq, D] in q.dtype; no
    lse, no backward. Where `wgmma_route` holds, the `wgmma` body
    (csrc/attn_wgmma.cuh), where `flash_t_bias_wgmma_route` holds, the
    biased one (csrc/attn_wgmma_bias.cuh), both counted in
    `wgmma_launches`."""
    if q.device.type == "cpu":
        flash_attention_t.plain_calls += 1
        return flash_attention_t_plain(q, k, v, bias, scale=scale)
    name = "flash_attention_t"
    dt = _check_cuda(name, q, k, v)
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, H, D, Sq], got {tuple(q.shape)}")
    B, H, D, Sq = q.shape
    Sk = k.shape[-1]
    _check_head_dim(name, D)
    if k.shape != (B, H, D, Sk) or v.shape != k.shape or Sk < 1:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    bs, hs = _bias_strides(name, bias, q, B, H, Sq, Sk)
    out = torch.empty(B, H, Sq, D, device=q.device, dtype=q.dtype)
    lib, shape = load_library(), (B, Sq, Sk, H, D)
    if wgmma_route(name, q.dtype, Sq, Sk, H, D, bias is not None,
                   (_ptr(q), _ptr(k), _ptr(v), _ptr(out))):
        _launch(flash_attention_t, lib.i360_flash_attention_t_wgmma, q, _ptr(q), _ptr(k),
                _ptr(v), _ptr(out), B, Sq, Sk, H, D, float(scale), shape=shape, tc=True,
                wgmma=True)
        return out
    if flash_t_bias_wgmma_route(q.dtype, Sq, Sk, D, bias is not None and bs == hs == 0,
                                (_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(bias))):
        _launch(flash_attention_t, lib.i360_flash_attention_t_bias_wgmma, q, _ptr(q), _ptr(k),
                _ptr(v), _ptr(bias), _ptr(out), B, Sq, Sk, H, D, float(scale), shape=shape,
                tc=True, wgmma=True)
        return out
    _launch(flash_attention_t, lib.i360_flash_attention_t, q, _ptr(q), _ptr(k), _ptr(v),
            _ptr(bias), _ptr(out), B, Sq, Sk, H, D, bs, hs, float(scale), dt, shape=shape,
            tc=_on_tensor_cores(q))
    return out


def shared_bias_attention_folded(q, k, v, bias, *, scale: float, with_lse: bool = False,
                                 t_rows: int = FOLDED_T_ROWS):
    """K6b. Batch and head folded: q [BH, Sq, D], k/v [BH, Sk, D], one bias
    [Sq, Sk] in float32 or bfloat16 shared by all BH rows. A block loads
    each bias tile once and takes several folded rows under it: where
    `folded_wgmma_route` holds, the `wgmma` body, four
    (csrc/attn_wgmma_bias.cuh kFbT), counted in `wgmma_launches`; else up
    to `t_rows` (on the `mma.sync` body at most two,
    csrc/shared_bias_folded.cu K6B_MAX_G). The rows are independent, so
    t_rows moves no output.
    Returns [BH, Sq, D] in q.dtype, and with `with_lse` also the lse
    [BH, Sq] float32."""
    if q.device.type == "cpu":
        shared_bias_attention_folded.plain_calls += 1
        return shared_bias_attention_folded_plain(q, k, v, bias, scale=scale,
                                                  with_lse=with_lse)
    name = "shared_bias_attention_folded"
    dt = _check_cuda(name, q, k, v)
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be [BH, Sq, D], got {tuple(q.shape)}")
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    _check_head_dim(name, D)
    if k.shape != (BH, Sk, D) or v.shape != k.shape or Sk < 1 or t_rows < 1:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} t_rows={t_rows}")
    if (bias.device != q.device or bias.dtype not in _DTYPE_CODE
            or tuple(bias.shape) != (Sq, Sk) or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be a contiguous float32 or bfloat16 "
                         f"[{Sq}, {Sk}] tensor on {q.device}, got {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}")
    out = torch.empty_like(q)
    lse = torch.empty(BH, Sq, device=q.device, dtype=torch.float32) if with_lse else None
    if folded_wgmma_route(q.dtype, Sk, D, bias.dtype,
                          (_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(bias))):
        _launch(shared_bias_attention_folded,
                load_library().i360_shared_bias_attention_folded_wgmma, q, _ptr(q), _ptr(k),
                _ptr(v), _ptr(bias), _ptr(out), _ptr(lse), BH, Sq, Sk, D, float(scale),
                _DTYPE_CODE[bias.dtype], shape=(BH, Sq, Sk, D), tc=True, lse=with_lse,
                wgmma=True)
        return (out, lse) if with_lse else out
    _launch(shared_bias_attention_folded, load_library().i360_shared_bias_attention_folded, q,
            _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(out), _ptr(lse), BH, Sq, Sk, D,
            int(t_rows), float(scale), dt, _DTYPE_CODE[bias.dtype], shape=(BH, Sq, Sk, D),
            tc=_on_tensor_cores(q), lse=with_lse)
    return (out, lse) if with_lse else out


def dense_matmul(x, w, *, linear_layout: bool = False):
    """K7. x [N, K] @ w with float32 accumulation, cast to x.dtype: w is
    [K, M], or with `linear_layout` [M, K] as `nn.Linear` stores its weight
    (x @ w^T, no transposed copy). Any N, K, M >= 1. Returns [N, M]. Where
    `dense_wgmma_route` holds, the persistent `wgmma` GEMM on the tiles of
    `dense_wgmma_plan`, counted in `wgmma_launches`."""
    if x.device.type == "cpu":
        dense_matmul.plain_calls += 1
        return dense_matmul_plain(x, w, linear_layout=linear_layout)
    name = "dense_matmul"
    dt = _check_cuda(name, x, w)
    if x.dim() != 2 or w.dim() != 2 or w.shape[1 if linear_layout else 0] != x.shape[1] \
            or 0 in w.shape:
        raise ValueError(f"{name}: bad shapes x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"linear_layout={linear_layout}")
    N, K = x.shape
    M = w.shape[0 if linear_layout else 1]
    out = torch.empty(N, M, device=x.device, dtype=x.dtype)
    if dense_wgmma_route(x.dtype, K, M, linear_layout, (_ptr(x), _ptr(w), _ptr(out))):
        plan = dense_wgmma_plan(N, K, M, _sm_count(x.device.index))
        _launch(dense_matmul, load_library().i360_dense_matmul_wgmma, x, _ptr(x), _ptr(w),
                _ptr(out), N, K, M, plan["grid"], shape=(N, K, M), tc=True, wgmma=True)
        return out
    ws_k, ws_m = (1, K) if linear_layout else (M, 1)
    _launch(dense_matmul, load_library().i360_dense_matmul, x, _ptr(x), _ptr(w), _ptr(out),
            N, K, M, ws_k, ws_m, dt, shape=(N, K, M), tc=_on_tensor_cores(x))
    return out


def _padded_row(elems: int, itemsize: int) -> int:
    """Elements of a shared-memory row that holds `elems` values of
    `itemsize` bytes and is an odd number of 4-byte words long, so that rows
    read side by side by the lanes of a warp fall into different banks."""
    words = -(-elems * itemsize // 4) | 1
    return words * 4 // itemsize


def _check_motion(name: str, q, k, v, heads: int, G: int):
    """Shapes of the lab variants, on any device: q/k/v [B, F, HW, C] alike,
    C a multiple of heads, HW a multiple of the pack size G. Returns
    (B, F, HW, C, D)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or heads < 1 \
            or q.shape[3] % heads:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} heads={heads}")
    B, F, HW, C = q.shape
    if G < 1 or HW % G:
        raise ValueError(f"{name}: HW={HW} is not a multiple of the pack size G={G}")
    return B, F, HW, C, C // heads


def striped_v2_smem_bytes(G: int, F: int, C: int, heads: int, itemsize: int) -> int:
    """Shared memory of one float32 L1 block (the CUDA-core kernel; the
    tests also read it for `itemsize` 2, the bfloat16 rule before L1 took
    the tensor cores): q, k, v of a pack in the storage type and the float
    logits of its G * heads problems."""
    return 3 * F * _padded_row(G * C, itemsize) * itemsize + G * heads * F * (F + 1) * 4


def fused_motion_smem_bytes(G: int, F: int, D: int, itemsize: int) -> int:
    """Shared memory of one float32 L2 block (the CUDA-core kernel): K and V
    of a head and pack, a query tile, its float logits and denominators, and
    the partial sums of the key slices of P V (as many slices, up to 8, as
    give each of the block's 512 threads an item of 4 rows and one column,
    or two columns of an even head dim)."""
    S = G * F
    cols = D // 2 if D % 2 == 0 else D
    slices = max(1, min(8, S, FUSED_THREADS // (FUSED_Q_ROWS // 4 * cols)))
    return ((2 * S + FUSED_Q_ROWS) * _padded_row(D, itemsize) * itemsize
            + FUSED_Q_ROWS * (S + 2 + slices * D) * 4)


def fused_motion_mma_plan(D: int, heads: int, bias_itemsize: int = 4):
    """(heads a block, threads, shared-memory bytes) of one bfloat16 L2 block
    (csrc/motion_fused.cu on the tensor cores): one group of 4 warps for each
    of the block's heads, all under one staged bias tile, so as many heads
    (dividing `heads`, at most FUSED_MMA_MAX_HEADS) as a block's shared
    memory holds: two stages of the [64, 64] bias tile in its own dtype, and
    for each head the 64-row query tile and two stages of 64-key K and V
    tiles of D padded to its bucket and 8 more. The sequence length does not
    enter: the tile streams over the keys. (On an H100 two heads a block beat
    one, `scripts/torch_motion_lab.py --plans`; four, one block of 16 warps
    an SM, were slower than two blocks of two.)"""
    DP = next(b for b in FUSED_MMA_DP if D <= b)
    group = 2 * (FUSED_MMA_ROWS + 4 * FUSED_MMA_ROWS) * (DP + 8)
    bias = 2 * FUSED_MMA_ROWS * (FUSED_MMA_ROWS + 8) * bias_itemsize
    for hb in range(min(FUSED_MMA_MAX_HEADS, heads), 0, -1):
        if heads % hb == 0 and hb * group + bias <= SMEM_LIMIT:
            return hb, hb * FUSED_MMA_GROUP, hb * group + bias
    raise ValueError(f"fused_motion_attention: one head of {D} does not fit {SMEM_LIMIT} bytes "
                     "of shared memory")


def diag_motion_mma_plan(G: int, F: int, D: int, heads: int):
    """(heads staged at a time, shared-memory bytes) of one bfloat16 L3
    block (K4's tile, csrc/frame_mma.cuh, in one stage under L3's
    ownership: a block owns G locations and walks all their heads): the
    most heads (dividing `heads`) whose q, k and v tiles stay within
    DIAG_STAGE_BYTES, so that three blocks share an SM (two at head dims
    129-144, where csrc/motion_diag.cu's launch bounds allow two); one head
    where none does. Raises when one head does not fit a block."""
    fits = [hg for hg in range(1, heads + 1)
            if heads % hg == 0 and _frame_stage_bytes(F, D, G, hg) <= DIAG_STAGE_BYTES]
    hg = max(fits, default=1)
    stage = _frame_stage_bytes(F, D, G, hg)
    if stage <= SMEM_LIMIT:
        return hg, stage
    raise ValueError(f"diag_motion_attention: a pack of G={G} locations x F={F} frames of one "
                     f"head of {D} does not fit {SMEM_LIMIT} bytes of shared memory")


def diag_motion_plan(G: int, F: int, D: int, heads: int, itemsize: int):
    """(heads staged at a time, row stride in elements, warps, shared-memory
    bytes) of one float32 L3 block (the CUDA-core kernel): the most heads
    with which two blocks fit an SM, else the most with which one does.
    Raises when one head does not fit."""
    for limit in (SMEM_LIMIT // 2 - 1024, SMEM_LIMIT):
        for hg in range(heads, 0, -1):
            rs = _padded_row(hg * D, itemsize)
            warps = min(DIAG_MAX_WARPS, G * hg)
            smem = 3 * G * F * rs * itemsize + warps * F * F * 4
            if smem <= limit:
                return hg, rs, warps, smem
    raise ValueError(f"diag_motion_attention: a pack of G={G} locations x F={F} frames of one "
                     f"head of {D} does not fit {SMEM_LIMIT} bytes of shared memory")


def striped_v2_mma_plan(G: int, F: int, D: int, heads: int) -> int:
    """Shared-memory bytes of one bfloat16 L1 block (K4's tile,
    csrc/frame_mma.cuh, under L1's ownership: a block walks R packs of G
    locations with all their heads): one stage of a pack's q, k and v tiles
    (`_frame_stage_bytes` with every head). Two stages, the next pack's
    copies in flight, fit with as many blocks an SM only for single
    locations at C = 320 and were slower there on an H100 (PERF.md §6), so
    the kernel has one. Raises beyond FRAME_MAX_F frames or where the stage
    does not fit a block."""
    if not 1 <= F <= FRAME_MAX_F:
        raise ValueError(f"striped_v2_attention: F={F} frames outside 1..{FRAME_MAX_F} "
                         "(bfloat16)")
    stage = _frame_stage_bytes(F, D, G, heads)
    if stage > SMEM_LIMIT:
        raise ValueError(f"striped_v2_attention: a pack of G={G} locations x F={F} frames x "
                         f"{heads} heads of {D} needs {stage} bytes of shared memory, a "
                         f"block has {SMEM_LIMIT}")
    return stage


def striped_v2_attention(q, k, v, *, scale: float, heads: int, G: int, R: int):
    """L1. q/k/v [B, F, HW, C]; K4's function, with one block owning R packs
    of G neighbouring locations and all heads. HW % G == 0 and
    (HW / G) % R == 0. bfloat16 takes the tensor cores
    (`striped_v2_mma_plan`) and raises beyond F = 64 frames, as K4 does (no
    motion site has more than 16); both dtypes raise for a (G, C, F) whose
    pack does not fit a block's shared memory. Returns [B, F, HW, C]."""
    name = "striped_v2_attention"
    B, F, HW, C, D = _check_motion(name, q, k, v, heads, G)
    if R < 1 or (HW // G) % R:
        raise ValueError(f"{name}: {HW // G} packs are not a multiple of R={R}")
    if q.device.type == "cpu":
        striped_v2_attention.plain_calls += 1
        return striped_v2_attention_plain(q, k, v, scale=scale, heads=heads, G=G, R=R)
    dt = _check_cuda(name, q, k, v)
    _check_head_dim(name, D)
    tc = _on_tensor_cores(q)
    rs = 0
    if tc:
        striped_v2_mma_plan(G, F, D, heads)
    else:
        smem = striped_v2_smem_bytes(G, F, C, heads, q.element_size())
        if smem > SMEM_LIMIT:
            raise ValueError(f"{name}: a pack of G={G} x C={C} x F={F} needs {smem} bytes of "
                             f"shared memory, a block has {SMEM_LIMIT}")
        rs = _padded_row(G * C, q.element_size())
    out = torch.empty_like(q)
    _launch(striped_v2_attention, load_library().i360_striped_v2_attention, q, _ptr(q), _ptr(k),
            _ptr(v), _ptr(out), B, F, HW, heads, D, G, R, rs, float(scale), dt,
            shape=(B, F, HW, C, heads, G, R), tc=tc)
    return out


def fused_motion_attention(q, k, v, bias, *, scale: float, heads: int, G: int,
                           exp_bf16: bool = False):
    """L2. q/k/v [B, F, HW, C]; each pack of G neighbouring locations attends
    as one sequence of G*F tokens in block order (row g*F + f) under `bias`
    [1, G*F, G*F], float32 or bfloat16, read as an operand (-inf allowed, a
    fully masked row is not). `exp_bf16` takes the exponential in bfloat16
    and divides after P V. bfloat16 takes the tensor cores: where
    `fused_wgmma_route` holds the Hopper body (csrc/motion_wgmma.cuh), else
    the `mma.sync` body, HB heads a block (`fused_motion_mma_plan`), at any
    sequence length; float32 raises for a (G, F, D) that does not fit a
    block's shared memory. Each launch is counted under its body
    (`fused_body`) in `body_launches`. Returns [B, F, HW, C]."""
    name = "fused_motion_attention"
    B, F, HW, C, D = _check_motion(name, q, k, v, heads, G)
    S = G * F
    if (tuple(bias.shape) != (1, S, S) or bias.device != q.device
            or bias.dtype not in _DTYPE_CODE or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be a contiguous float32 or bfloat16 "
                         f"[1, {S}, {S}] tensor on {q.device}, got {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}")
    if q.device.type == "cpu":
        fused_motion_attention.plain_calls += 1
        return fused_motion_attention_plain(q, k, v, bias, scale=scale, heads=heads, G=G,
                                            exp_bf16=exp_bf16)
    dt = _check_cuda(name, q, k, v)
    _check_head_dim(name, D)
    tc = _on_tensor_cores(q)
    out = torch.empty_like(q)
    ptrs = (_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(bias))
    body = fused_body(q.dtype, F, G, heads, D, bias.dtype, exp_bf16, ptrs)
    shape = (B, F, HW, C, heads, G, bool(exp_bf16))
    if body == "fused_wgmma":
        _launch(fused_motion_attention, load_library().i360_fused_motion_attention_wgmma, q,
                _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(out), B, F, HW, heads, D, G,
                float(scale), _DTYPE_CODE[bias.dtype], shape=shape, tc=True, body=body)
        return out
    hb = 1
    if tc:
        hb = fused_motion_mma_plan(D, heads, bias.element_size())[0]
    else:
        smem = fused_motion_smem_bytes(G, F, D, q.element_size())
        if smem > SMEM_LIMIT:
            raise ValueError(f"{name}: K and V of G={G} x F={F} tokens of head dim {D} need "
                             f"{smem} bytes of shared memory, a block has {SMEM_LIMIT}")
    _launch(fused_motion_attention, load_library().i360_fused_motion_attention, q, _ptr(q),
            _ptr(k), _ptr(v), _ptr(bias), _ptr(out), B, F, HW, heads, D, G,
            _padded_row(D, q.element_size()), hb, float(scale), int(exp_bf16), dt,
            _DTYPE_CODE[bias.dtype], shape=shape, tc=tc, body=body)
    return out


def diag_motion_attention(q, k, v, *, scale: float, heads: int, G: int):
    """L3. q/k/v [B, F, HW, C] with F <= 32; K4's function with no bias and
    no masked logit, a block owning G neighbouring locations and walking
    their heads. bfloat16 where `diag_route` holds takes K4's Hopper body
    under that ownership (`diag_tma_plan`), other bfloat16 calls K4's
    tensor-core tile (`diag_motion_mma_plan`). Raises beyond F = 32 and for
    a pack that does not fit a block's shared memory. Each launch is
    counted under its body (`diag_body`) in `body_launches`. Returns
    [B, F, HW, C]."""
    name = "diag_motion_attention"
    B, F, HW, C, D = _check_motion(name, q, k, v, heads, G)
    if not 1 <= F <= DIAG_MAX_F:
        raise ValueError(f"{name}: F={F} frames outside 1..{DIAG_MAX_F}")
    if q.device.type == "cpu":
        diag_motion_attention.plain_calls += 1
        return diag_motion_attention_plain(q, k, v, scale=scale, heads=heads, G=G)
    dt = _check_cuda(name, q, k, v)
    _check_head_dim(name, D)
    tc = _on_tensor_cores(q)
    out = torch.empty_like(q)
    ptrs = (_ptr(q), _ptr(k), _ptr(v), _ptr(out))
    body = diag_body(q.dtype, F, HW, heads, D, G, ptrs)
    shape = (B, F, HW, C, heads, G)
    if body == "diag_tma":
        plan = diag_tma_plan(B, F, HW, heads, D, G, _sm_count(q.device.index))
        _launch(diag_motion_attention, load_library().i360_diag_motion_attention_tma, q, *ptrs,
                B, F, HW, heads, D, G, *(plan[x] for x in ("SG", "HG", "S", "NW", "bps")),
                float(scale), shape=shape, tc=True, body=body)
        return out
    if tc:
        (hg, _), rs, warps = diag_motion_mma_plan(G, F, D, heads), 0, 0
    else:
        hg, rs, warps, _ = diag_motion_plan(G, F, D, heads, q.element_size())
    _launch(diag_motion_attention, load_library().i360_diag_motion_attention, q, *ptrs, B, F,
            HW, heads, D, G, hg, rs, warps, float(scale), dt, shape=shape, tc=tc, body=body)
    return out


LAB_KERNELS = (striped_v2_attention, fused_motion_attention, diag_motion_attention)
KERNELS = (tiny_attention, mh_flash_attention, shared_bias_attention, frame_attention,
           flash_attention_lse, flash_bwd_dq, flash_bwd_dkv, flash_attention_t,
           shared_bias_attention_folded, dense_matmul, *LAB_KERNELS)


def reset_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.wide_launches = 0
        fn.tc_launches = 0
        fn.lse_launches = 0
        fn.wgmma_launches = 0
        fn.body_launches = collections.Counter()
        fn.shape_launches = collections.Counter()
        fn.plain_calls = 0


def counts() -> dict:
    """{wrapper name: {"launches": n, "plain_calls": n}}."""
    return {fn.__name__: {"launches": fn.launches, "plain_calls": fn.plain_calls}
            for fn in KERNELS}


def shape_counts() -> dict:
    """{(wrapper name, shape): launches}; shape is (B, Sq, Sk, H, D) for
    K1-K3, K5a-c and K6a, (B, F, HW, C, heads) for K4, (BH, Sq, Sk, D) for
    K6b, (N, K, M) for K7, and K4's shape followed by (G, R) for L1,
    (G, exp_bf16) for L2 and (G,) for L3."""
    return {(fn.__name__, shape): n for fn in KERNELS
            for shape, n in fn.shape_launches.items()}


def wide_counts() -> dict:
    """{wrapper name: launches of its wide (D > 160) kernel}, K1 and K2."""
    return {fn.__name__: fn.wide_launches for fn in (tiny_attention, mh_flash_attention)}


BODY_KERNELS = (tiny_attention, mh_flash_attention)


def body_counts() -> dict:
    """{wrapper name: {body: launches}} for K1 and K2, each launch counted
    where the wrapper launches it under the body `attention_body` named
    (ATTENTION_BODIES)."""
    return {fn.__name__: dict(fn.body_launches) for fn in BODY_KERNELS}


FRAME_BODY_KERNELS = (frame_attention, fused_motion_attention, diag_motion_attention)


def frame_body_counts() -> dict:
    """{body: launches} of K4, L2 and L3, each launch counted where the
    wrapper launches it under the body `frame_body`, `fused_body` or
    `diag_body` named (FRAME_BODIES, FUSED_BODIES, DIAG_BODIES: no name is
    in two of them)."""
    out = {}
    for fn in FRAME_BODY_KERNELS:
        out.update(fn.body_launches)
    return out


WGMMA_KERNELS = (tiny_attention, mh_flash_attention, flash_attention_lse, flash_attention_t,
                 shared_bias_attention_folded, dense_matmul, flash_bwd_dq, flash_bwd_dkv,
                 shared_bias_attention)


def wgmma_counts() -> dict:
    """{wrapper name: launches of its `wgmma` bodies}: K1, K2, K5a and K6a
    (csrc/attn_wgmma.cuh; K1 at one key tile csrc/attn_wgmma_xattn.cuh, K1
    and K2 at D = 512 csrc/attn_wgmma_wide.cuh), K3, K6a at D = 32 under a shared bias and K6b
    (csrc/attn_wgmma_bias.cuh), K7 (csrc/dense_matmul.cu
    dense_matmul_wgmma_kernel), K5b and K5c (csrc/attn_wgmma_bwd.cuh; at
    D = 32 under a shared bias csrc/attn_wgmma_bwd_bias.cuh)."""
    return {fn.__name__: fn.wgmma_launches for fn in WGMMA_KERNELS}


TC_KERNELS = (tiny_attention, mh_flash_attention, shared_bias_attention, frame_attention,
              flash_attention_lse, flash_bwd_dq, flash_bwd_dkv, flash_attention_t,
              shared_bias_attention_folded, dense_matmul, striped_v2_attention,
              fused_motion_attention, diag_motion_attention)


def tc_counts() -> dict:
    """{wrapper name: launches on the tensor cores (bfloat16)}, K1-K4, K5a,
    K5b, K5c, K6a, K6b, K7 and L1-L3."""
    return {fn.__name__: fn.tc_launches for fn in TC_KERNELS}


def lse_counts() -> dict:
    """{wrapper name: launches that also wrote the lse}, K3."""
    return {shared_bias_attention.__name__: shared_bias_attention.lse_launches}


reset_counts()
