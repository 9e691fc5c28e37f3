"""Drive the PyTorch/H100 port (imagine360_tpu_torch) once on one card.

    python3 chip_smoke.py [--out DIR]

Phases, each fatal on failure:
  0. card, power limit and versions;
  1. build the attention kernels from imagine360_tpu_torch/csrc with nvcc;
     every bf16 kernel of K1, K2, K3, K5a, K6a and K6b (the `mma_kernel`s on
     the body of csrc/attn_mma.cuh), of K4 (csrc/frame_attention.cu), of the
     wide K1 and K2 (on the tile of csrc/attn_mma_wide.cuh), of K5b and K5c
     (on the backward tiles of csrc/attn_mma_bwd.cuh) and of K7
     (csrc/dense_matmul.cu) has HMMA instructions in its SASS (cuobjdump) and
     0 spill bytes in the ptxas report;
  2. each kernel against its plain PyTorch version at the production shapes
     of the denoise loop, the VAE (one head of 512), the CLIP text encoder
     (causal -inf bias), the training step (K5a forward with lse, K5b dq,
     K5c dk/dv, K3 with its lse, at 16 frames) and the opt-in kernels (K6a
     on sequence-minor inputs, K6b on folded inputs with a float32 and a
     bfloat16 bias and with its lse, K7 at the projection sites and at one
     ragged shape) and of the motion-attention lab (L1 at two packs, L2 at
     G = 32 under the block-diagonal bias, under a seeded random bias in
     float32 and in bfloat16 and with exp_bf16, L3 at two pack sizes, all at
     the perspective stage-0 motion site), and K1 with a seeded random bias
     and K2 at ragged sequence lengths, both also at the wide head dims 200
     and 192: in bf16 on every batch row,
     max abs error <= min(2e-2, 2**-5 * max|plain|) per output (dq, dk, dv
     and K7's unnormalised sums: 2**-7 * max|plain|; a float32 lse: 1e-4);
     in f32 (TF32 off) on the first F32_ROWS batch rows (K7: DENSE_F32_ROWS
     rows), max abs error <= 1e-4 (K7: 1e-5 * max|plain|); with the kernel's time, the plain version's, the
     time of the one PyTorch call that computes the same function
     (F.scaled_dot_product_attention, and its backward through
     torch.autograd.grad for K5b/K5c; F.linear for K7: a yardstick the port
     never calls) and the site's bound on this card, and for K1-K4 (the
     wide ones too), K5a-c, K6a, K6b and K7 (bf16 on the tensor cores: every
     bf16 launch at the site counted in `tc_launches`) the TFLOP/s; K4 at
     all eight motion stages of a denoise step; the bf16 output of K5a, K6a
     and K6b equals its plain version's (float32 probabilities, one rounding
     to bf16) in at least K5A_MATCH of its elements (`match`), which a
     single bf16 rounding of the probabilities does not reach;
  3. tiny models, f32, TF32 off: CUDA through the kernels against the same
     weights on the CPU through the plain versions (DualUNet forward, the
     same forward under configure(attn_v2=True, pallas_dense=True), which
     must launch K6a and K7, and the gradient of a loss on its outputs for
     every parameter; VAE encode -> decode at two widths; CLIP text); no
     launch takes the tensor cores (float32), K5b, K5c, K6a and K7 included;
  4. the denoise loop alone: full_dual_config in bf16 with seeded random
     weights, compute_ip and 2 CFG DDIM steps on random conditioning;
  5. video in, 360-degree video out: Imagine360Pipeline.__call__ on
     examples/synthetic.npy (16 frames) at full width (full_dual_config,
     VAEConfig, CLIPTextConfig, SAMConfig, bf16, pano 512x1024, 20 views of
     256x256) with seeded random weights and 2 DDIM steps; the video is
     finite, in [0, 1] and of the right shape, every kernel launched, K1
     4 times and K2 5 times at D = 512 (PIPELINE_WIDE), no attention call on
     a plain path, and the outputs are written and read back;
  6. the training step: make_train_step on full_dual_config at full width
     and depth (bf16 modules, float32 master weights and AdamW moments,
     remat on, TRAIN_VIEWS views x TRAIN_FRAMES frames), seeded random
     weights, make_dual_batch at production shapes, 1 warm + 2 timed steps;
     the loss and the gradient norm are finite, every parameter got a
     gradient and moved, K3 (with lse), K5a, K5b, K5c, K1 and K4 launched,
     K2 did not, and no attention call took a plain path;
  7. the opt-in path: compute_ip and 2 CFG steps of the same loop with
     SamplerConfig(solver="dpmpp_2m") under configure(attn_v2=True,
     pallas_dense=True), full width and depth, bf16: the latents are finite,
     K6a and K7 launched, K2 did not, no call took a plain path, and the
     config is the default again after the block; then K6b through its own
     entry point on the loop's WarpAttn masks (bfloat16, r2, r4 and r8, both
     directions) against its plain version, every launch on the tensor
     cores;
  8. the motion-attention lab: ops/motion_lab.py:run_lab at the eight
     full-width motion sites of full_dual_config (every stage of both
     branches, 16 frames, 8 heads, bf16): K4 and every pack of L1, L2 and L3
     that fits a site, each against K4's plain version and the K4 kernel
     (the phase-2 limit; the exp_bf16 variant 5e-2) and timed beside K4, the
     library call and the site's bound; every variant launched, at least one
     of each kernel at every site, every K4 launch on the tensor cores, no
     call on a plain path.

In phases 2 and 4-7 every bf16 launch of K1-K4, K5a-c, K6a, K6b and K7 took
the tensor cores (`tc_launches` = launches: the wide K1 and K2 in phase 5,
K4's in phases 4-7, K5b's and K5c's in phase 6, K6a's, K6b's and K7's in
phase 7 included); in phase 3 (float32) none did, the wide ones included.

The last three lines are the JSON kernel list, the card's name and power
limit, and the contract line {"ok": true, "device": {...}}; none of them
is printed unless every phase passed. Without CUDA the script exits 1 at
once.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

# one card: the run uses cuda:0 only, and the contract line's count says so
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import torch  # noqa: E402

SCRIPT_DIR = os.path.dirname(os.path.abspath(__file__))
BF16_TOL = 2e-2          # abs, bf16 inputs of unit scale ...
BF16_REL = 2 ** -5       # ... and at most 8 bf16 ulps of the site's largest output
GRAD_BF16_REL = 2 ** -7  # dq, dk, dv in bf16: 2 bf16 ulps of the gradient's largest element
F32_TOL = 1e-4           # abs, f32: same arithmetic, another summation order
F32_ROWS = 4             # batch rows of the f32 check at each production shape
TINY_REL_TOL = 1e-3      # f32 CUDA vs CPU, relative to the output's max abs
# tiny latents: the pano's 32x64 = 2048 stage-0 tokens exceed K1's 1024-key
# limit, so the tiny forward reaches all four kernels, K2 included
TINY_PERS_HW, TINY_PANO_HW = (16, 16), (32, 64)
SLICE_STEPS = 2          # of the 50-step schedule, in phase 4
PIPELINE_STEPS = 2       # DDIM steps of the whole pipeline, in phase 5
GRAD_REL_TOL = 1e-3      # f32 CUDA vs CPU gradient, relative to the parameter's max |grad|
GRAD_FLOOR = 1e-3        # ... or to this share of the largest gradient of any parameter
# phase 6: what fits on one 80 GB card with remat (scripts/torch_train_memory.py);
# widths and depth are never cut, views and frames are batch
TRAIN_VIEWS, TRAIN_FRAMES = 20, 16
TRAIN_STEPS = 2          # timed steps after one warm step
LSE_TOL = 1e-4           # abs, the float32 lse of K5a, K3 and K6b
# share of K5a's bf16 outputs equal bit for bit to the plain version's at
# the training sites, on an H100: 99.1-99.7% with P split into bf16 hi + lo,
# 58.6-59.5% with P rounded once to bf16 (scripts/torch_attn_mma_variants.py;
# emulated on the CPU in tests/test_torch_flash_lse_split.py). K6a computes
# the same with the same split and is held to the same share at its sites:
# the CPU emulation gives 99.6-99.9% there, the biased D = 32 ones included
# (tests/test_torch_bwd_split.py). K6b, the same split on folded rows under a
# float32 or bfloat16 bias, gives 99.4-99.8% at its sites
# (scripts/torch_frame_folded_check.py; emulated in
# tests/test_torch_frame_folded_mma.py)
K5A_MATCH = 0.98
MATCH_KERNELS = ("flash_attention_lse", "flash_attention_t", "shared_bias_attention_folded")
# K7's outputs are unnormalised sums of K products (max |out| about 90 at
# K = 320), so both limits scale with the largest output: one bf16 ulp of it
# in bf16 (kernel and plain round the same float32 sum, summed in another
# order), 1e-5 of it in f32
DENSE_BF16_REL = 2 ** -7
DENSE_F32_REL = 1e-5
# NVIDIA H100 SXM data sheet, dense: the bound of a site is the larger of
# its operations over the tensor-core rate of its dtype and its bytes (each
# input read once, each output written once) over the memory rate
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

CLIP_SITE = "clip_text_causal"   # its bias is causal: -inf above the diagonal

# (kernel, site, shape): production shapes of the denoise loop, the VAE and
# the CLIP text encoder; (B, Sq, Sk, H, D) for K1-K3, (B, F, HW, C, heads)
# for K4
SITES = [
    ("tiny_attention", "pers_spatial_s0", (640, 1024, 1024, 5, 64)),
    ("tiny_attention", "pers_text_cross_s0", (640, 1024, 77, 5, 64)),
    ("tiny_attention", "pano_spatial_s2", (32, 512, 512, 20, 64)),
    ("tiny_attention", "pano_text_cross_s0", (32, 8192, 77, 5, 64)),
    ("tiny_attention", "temporal_proj_frames", (10240, 16, 16, 8, 64)),
    # a seeded uniform [-1, 1) bias, ragged query and key tails, D = 40
    ("tiny_attention", "ragged_bias", (64, 333, 1000, 5, 40)),
    ("tiny_attention", "vae_pers_encode", (80, 1024, 1024, 1, 512)),
    ("mh_flash_attention", "pano_spatial_s0", (32, 8192, 8192, 5, 64)),
    ("mh_flash_attention", "pano_spatial_s1", (32, 2048, 2048, 10, 64)),
    ("mh_flash_attention", "ragged", (4, 1000, 3001, 5, 64)),
    ("mh_flash_attention", "vae_pano_encode", (16, 8192, 8192, 1, 512)),
    ("mh_flash_attention", "vae_pano_decode", (4, 8704, 8704, 1, 512)),
    # the wide tile at head dims no multiple of 8 (2-byte staging) and of
    # the lower bucket, ragged query and key tails; K1 under a seeded bias
    ("tiny_attention", "wide_ragged_bias", (16, 333, 1000, 1, 200)),
    ("mh_flash_attention", "wide_ragged", (4, 1000, 3001, 1, 192)),
    ("shared_bias_attention", "warp_r2_pano_q", (32, 2048, 5120, 10, 32)),
    ("shared_bias_attention", "warp_r2_pers_q", (32, 5120, 2048, 10, 32)),
    ("shared_bias_attention", "warp_r4_pano_q", (32, 512, 1280, 20, 32)),
    ("shared_bias_attention", "warp_r8_pano_q", (32, 128, 320, 40, 32)),
    ("shared_bias_attention", CLIP_SITE, (2, 77, 77, 16, 64)),
    # K4 at every motion stage of both branches (all its launches of a step)
    ("frame_attention", "motion_pers_s0", (40, 16, 1024, 320, 8)),
    ("frame_attention", "motion_pano_s0", (2, 16, 8192, 320, 8)),
    ("frame_attention", "motion_pers_s2", (40, 16, 64, 1280, 8)),
    ("frame_attention", "motion_pers_s1", (40, 16, 256, 640, 8)),
    ("frame_attention", "motion_pers_s3", (40, 16, 16, 1280, 8)),
    ("frame_attention", "motion_pano_s1", (2, 16, 2048, 640, 8)),
    ("frame_attention", "motion_pano_s2", (2, 16, 512, 1280, 8)),
    ("frame_attention", "motion_pano_s3", (2, 16, 128, 1280, 8)),
    # the training step: 16 frames, no CFG doubling
    ("flash_attention_lse", "train_pano_spatial_s0", (16, 8192, 8192, 5, 64)),
    ("flash_attention_lse", "train_pano_spatial_s1", (16, 2048, 2048, 10, 64)),
    ("flash_bwd_dq", "train_pano_spatial_s0", (16, 8192, 8192, 5, 64)),
    ("flash_bwd_dq", "train_pano_spatial_s1", (16, 2048, 2048, 10, 64)),
    ("flash_bwd_dq", "train_warp_r2_pano_q", (16, 2048, 5120, 10, 32)),
    ("flash_bwd_dq", "train_warp_r2_pers_q", (16, 5120, 2048, 10, 32)),
    ("flash_bwd_dq", "train_warp_r8_pano_q", (16, 128, 320, 40, 32)),
    ("flash_bwd_dkv", "train_pano_spatial_s0", (16, 8192, 8192, 5, 64)),
    ("flash_bwd_dkv", "train_pano_spatial_s1", (16, 2048, 2048, 10, 64)),
    ("flash_bwd_dkv", "train_warp_r2_pano_q", (16, 2048, 5120, 10, 32)),
    ("flash_bwd_dkv", "train_warp_r2_pers_q", (16, 5120, 2048, 10, 32)),
    ("flash_bwd_dkv", "train_warp_r8_pano_q", (16, 128, 320, 40, 32)),
    ("shared_bias_attention_lse", "train_warp_r2_pano_q", (16, 2048, 5120, 10, 32)),
    ("shared_bias_attention_lse", "train_warp_r8_pano_q", (16, 128, 320, 40, 32)),
    # the opt-in kernels. K6a (B, Sq, Sk, H, D) on [B, H, D, S] inputs: the
    # sites that leave K2 and K3 under attn_v2
    ("flash_attention_t", "v2_pano_spatial_s0", (32, 8192, 8192, 5, 64)),
    ("flash_attention_t", "v2_pano_spatial_s1", (32, 2048, 2048, 10, 64)),
    ("flash_attention_t", "v2_warp_r2_pano_q", (32, 2048, 5120, 10, 32)),
    ("flash_attention_t", "v2_warp_r2_pers_q", (32, 5120, 2048, 10, 32)),
    ("flash_attention_t", "v2_warp_r4_pano_q", (32, 512, 1280, 20, 32)),
    # K6b (BH, Sq, Sk, D): the WarpAttn sites with batch and head folded
    ("shared_bias_attention_folded", "folded_warp_r2_pano_q", (320, 2048, 5120, 32)),
    ("shared_bias_attention_folded", "folded_warp_r2_pers_q", (320, 5120, 2048, 32)),
    ("shared_bias_attention_folded", "folded_warp_r2_pano_q_bf16_bias", (320, 2048, 5120, 32)),
    ("shared_bias_attention_folded", "folded_warp_r2_pano_q_lse", (320, 2048, 5120, 32)),
    ("shared_bias_attention_folded", "folded_warp_r8_pano_q", (1280, 128, 320, 32)),
    # K7 (N, K, M): proj_in / proj_out of the spatial transformers and motion
    # modules, N = batch x frames x tokens, and one ragged shape
    ("dense_matmul", "dense_pers_s0", (655360, 320, 320)),
    ("dense_matmul", "dense_pano_s0", (262144, 320, 320)),
    ("dense_matmul", "dense_pers_s1", (163840, 640, 640)),
    ("dense_matmul", "dense_pano_s2", (16384, 1280, 1280)),
    ("dense_matmul", "dense_ragged", (1000, 77, 321)),
    # the lab variants of K4 (B, F, HW, C, heads), packs in LAB_PARAMS
    ("striped_v2_attention", "lab_v2_G1_R1", (40, 16, 1024, 320, 8)),
    ("striped_v2_attention", "lab_v2_G2_R8", (40, 16, 1024, 320, 8)),
    ("fused_motion_attention", "lab_fused_G32", (40, 16, 1024, 320, 8)),
    ("fused_motion_attention", "lab_fused_G32_random_bias", (40, 16, 1024, 320, 8)),
    ("fused_motion_attention", "lab_fused_G32_random_bf16_bias", (40, 16, 1024, 320, 8)),
    ("fused_motion_attention", "lab_fused_G32_exp_bf16", (40, 16, 1024, 320, 8)),
    ("diag_motion_attention", "lab_diag_G16", (40, 16, 1024, 320, 8)),
    ("diag_motion_attention", "lab_diag_G4", (40, 16, 1024, 320, 8)),
]
# keyword arguments of the lab sites. `f32` replaces them in the float32
# check: two locations of 320 float32 channels x 16 frames exceed a block's
# shared memory, so L1's second site walks single locations there. `bias` is
# L2's operand: the block-diagonal mask, or seeded uniform values in [-1, 1)
LAB_PARAMS = {
    "lab_v2_G1_R1": dict(G=1, R=1),
    "lab_v2_G2_R8": dict(G=2, R=8, f32=dict(G=1, R=16)),
    "lab_fused_G32": dict(G=32, bias="block_diag"),
    "lab_fused_G32_random_bias": dict(G=32, bias="random"),
    "lab_fused_G32_random_bf16_bias": dict(G=32, bias="random_bf16"),
    "lab_fused_G32_exp_bf16": dict(G=32, bias="block_diag", exp_bf16=True),
    "lab_diag_G16": dict(G=16),
    "lab_diag_G4": dict(G=4),
}
# phase 8: every motion stage of both branches of full_dual_config
LAB_SITES = [
    ("motion_pers_s0", (40, 16, 1024, 320, 8)), ("motion_pers_s1", (40, 16, 256, 640, 8)),
    ("motion_pers_s2", (40, 16, 64, 1280, 8)), ("motion_pers_s3", (40, 16, 16, 1280, 8)),
    ("motion_pano_s0", (2, 16, 8192, 320, 8)), ("motion_pano_s1", (2, 16, 2048, 640, 8)),
    ("motion_pano_s2", (2, 16, 512, 1280, 8)), ("motion_pano_s3", (2, 16, 128, 1280, 8)),
]
LAB_ITERS = 10
# L2 with exp_bf16 against K4: every exponent s - max is rounded to bfloat16
# (2**-9 relative, so up to 2**-7 absolute four units below the max, the
# same relative error on that probability) and every probability again
EXP_BF16_TOL = 5e-2
REPLACES = {
    "tiny_attention": "imagine360_tpu/ops/pallas_attention.py:345",
    "mh_flash_attention": "imagine360_tpu/ops/pallas_attention.py:482",
    "shared_bias_attention": "imagine360_tpu/ops/pallas_attention.py:699",
    "frame_attention": "imagine360_tpu/ops/pallas_attention.py:406",
    "flash_attention_lse": "imagine360_tpu/ops/pallas_attention.py:42",
    "flash_bwd_dq": "imagine360_tpu/ops/pallas_attention.py:819",
    "flash_bwd_dkv": "imagine360_tpu/ops/pallas_attention.py:848",
    "shared_bias_attention_lse": "imagine360_tpu/ops/pallas_attention.py:699",
    "flash_attention_t": "imagine360_tpu/ops/pallas_attention.py:92",
    "shared_bias_attention_folded": "imagine360_tpu/ops/pallas_attention.py:587",
    "dense_matmul": "imagine360_tpu/ops/pallas_dense.py:36",
    "striped_v2_attention": "scripts/kernel_lab.py:60",
    "fused_motion_attention": "scripts/exp_motion_kernels.py:19",
    "diag_motion_attention": "scripts/exp_motion_kernels.py:80",
}
SOURCES = {
    "tiny_attention": "imagine360_tpu_torch/csrc/tiny_attention.cu",
    "mh_flash_attention": "imagine360_tpu_torch/csrc/mh_flash.cu",
    "shared_bias_attention": "imagine360_tpu_torch/csrc/shared_bias.cu",
    "frame_attention": "imagine360_tpu_torch/csrc/frame_attention.cu",
    "flash_attention_lse": "imagine360_tpu_torch/csrc/flash_lse.cu",
    "flash_bwd_dq": "imagine360_tpu_torch/csrc/flash_bwd_dq.cu",
    "flash_bwd_dkv": "imagine360_tpu_torch/csrc/flash_bwd_dkv.cu",
    "shared_bias_attention_lse": "imagine360_tpu_torch/csrc/shared_bias.cu",
    "flash_attention_t": "imagine360_tpu_torch/csrc/flash_t.cu",
    "shared_bias_attention_folded": "imagine360_tpu_torch/csrc/shared_bias_folded.cu",
    "dense_matmul": "imagine360_tpu_torch/csrc/dense_matmul.cu",
    "striped_v2_attention": "imagine360_tpu_torch/csrc/frame_attention_v2.cu",
    "fused_motion_attention": "imagine360_tpu_torch/csrc/motion_fused.cu",
    "diag_motion_attention": "imagine360_tpu_torch/csrc/motion_diag.cu",
}
INFERENCE_KERNELS = ("tiny_attention", "mh_flash_attention", "shared_bias_attention",
                     "frame_attention")     # K1-K4: every one runs without grad
# the kernels only the training step launches (K3 with its lse output is the
# same kernel as K3, called with a non-null lse pointer)
TRAIN_KERNELS = ("flash_attention_lse", "flash_bwd_dq", "flash_bwd_dkv",
                 "shared_bias_attention_lse")
# the kernels behind the opt-in switches (K6a, K7) and K6b, which has its own
# entry point; phase 7 drives them
OPT_IN_KERNELS = ("flash_attention_t", "shared_bias_attention_folded", "dense_matmul")
# the lab variants of K4: only phase 8 (ops/motion_lab.py:run_lab) launches them
LAB_KERNELS = ("striped_v2_attention", "fused_motion_attention", "diag_motion_attention")
OPT_IN_SWITCHES = dict(attn_v2=True, pallas_dense=True)
OPT_IN_SOLVER = "dpmpp_2m"
DENSE_F32_ROWS = 8192    # rows of x in the f32 check of K7
FOLDED_T_ROWS = (1, 2)   # K6b is also timed at these rows per bias tile (bf16: at most 2)
# operations per (batch, head, query, key, head-dim element): two products
# forward, three in the dq kernel, four in the dk/dv kernel
OPS_PER_ELEMENT = {"flash_bwd_dq": 6.0, "flash_bwd_dkv": 8.0}
WIDE_ABOVE = 160   # head dims 161..512 take the wide kernels
# K1, K2, K3, K5a, K6a and K6b (csrc/attn_mma.cuh), the wide K1 and K2
# (csrc/attn_mma_wide.cuh), K4 (csrc/frame_attention.cu) and K5b and K5c
# (csrc/attn_mma_bwd.cuh) run bf16 on the tensor cores at every head dim they
# take, K7 (csrc/dense_matmul.cu) at every shape; K3 with its lse is the same
# kernel
TC_KERNELS = ("tiny_attention", "mh_flash_attention", "shared_bias_attention",
              "frame_attention", "flash_attention_lse", "flash_bwd_dq", "flash_bwd_dkv",
              "flash_attention_t", "shared_bias_attention_folded", "dense_matmul")
TC_SITE_KERNELS = TC_KERNELS + ("shared_bias_attention_lse",)
# the sites whose TFLOP/s and share of the bound are logged at the end
TC_REPORT_SITES = (("tiny_attention", "pers_spatial_s0"),
                   ("mh_flash_attention", "pano_spatial_s0"),
                   ("tiny_attention", "vae_pers_encode"),
                   ("mh_flash_attention", "vae_pano_encode"),
                   ("mh_flash_attention", "vae_pano_decode"),
                   ("shared_bias_attention", "warp_r2_pano_q"),
                   ("shared_bias_attention", "warp_r2_pers_q"),
                   ("shared_bias_attention", "warp_r4_pano_q"),
                   ("frame_attention", "motion_pers_s0"),
                   ("frame_attention", "motion_pano_s0"),
                   ("frame_attention", "motion_pers_s2"),
                   ("shared_bias_attention_folded", "folded_warp_r2_pano_q"),
                   ("shared_bias_attention_folded", "folded_warp_r8_pano_q"),
                   ("shared_bias_attention_lse", "train_warp_r2_pano_q"),
                   ("flash_attention_lse", "train_pano_spatial_s0"),
                   ("flash_attention_lse", "train_pano_spatial_s1"),
                   ("flash_bwd_dq", "train_pano_spatial_s0"),
                   ("flash_bwd_dq", "train_warp_r2_pano_q"),
                   ("flash_bwd_dkv", "train_pano_spatial_s0"),
                   ("flash_attention_t", "v2_pano_spatial_s0"),
                   ("dense_matmul", "dense_pers_s0"),
                   ("dense_matmul", "dense_pers_s1"))
WIDE_SOURCES = {
    "tiny_attention": "imagine360_tpu_torch/csrc/tiny_attention_wide.cu",
    "mh_flash_attention": "imagine360_tpu_torch/csrc/mh_flash_wide.cu",
}
# phase 5's launches of the wide kernels: the VAE mid-block attention, K1 on
# the 320 view-frames in 4 chunks of 80 and K2 on the pano when encoding, K2
# on the 4 chunks of 4 frames when decoding
PIPELINE_WIDE = {"tiny_attention": 4, "mh_flash_attention": 5}


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# the tensor-core kernels and their instantiations: K1 6 head-dim buckets x
# 1, 2 or 4 warps; K2, K3, K5a, K5b, K5c and K6a 6 buckets; K6b 6 buckets x
# 2 bias dtypes; K4 10 head dims padded to 16, 32, ..., 160; the wide K1 and
# K2 2 buckets (256, 512); K7 2 weight layouts
MMA_KERNEL_NAMES = {"tiny_attention_mma_kernel": 18, "mh_flash_mma_kernel": 6,
                    "tiny_attention_wide_mma_kernel": 2, "mh_flash_wide_mma_kernel": 2,
                    "shared_bias_mma_kernel": 6, "flash_lse_mma_kernel": 6,
                    "flash_bwd_dq_mma_kernel": 6, "flash_bwd_dkv_mma_kernel": 6,
                    "flash_t_mma_kernel": 6, "dense_matmul_mma_kernel": 2,
                    "frame_attention_mma_kernel": 10, "shared_bias_folded_mma_kernel": 12}


def check_mma_build(kernels, lib):
    """{kernel: (registers, spill bytes, HMMA instructions)} of every
    tensor-core kernel of K1, K2 (the wide ones too), K3, K5a-c, K6a and K7,
    from the ptxas
    report kept beside the library and from `cuobjdump -sass` of it. Fails
    on a spill, a kernel with no HMMA, or fewer instantiations of one than
    MMA_KERNEL_NAMES lists."""
    report, fn = {}, None
    for line in lib.with_suffix(".ptxas.txt").read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            # [registers, spill bytes (stores + loads), HMMA instructions]
            report[fn] = [None, nums[1] + nums[2], 0]
        elif fn and "Used" in line and "registers" in line and fn in report:
            report[fn][0] = int(line.split("Used")[1].split()[0])
    report = {f: r for f, r in report.items() if any(n in f for n in MMA_KERNEL_NAMES)}
    cuobjdump = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn in report and "HMMA" in line:
            report[fn][2] += 1
    found = {n: sum(n in f for f in report) for n in MMA_KERNEL_NAMES}
    if any(found[n] < want for n, want in MMA_KERNEL_NAMES.items()):
        raise SystemExit(f"FAIL: tensor-core kernels in the ptxas report {found}, "
                         f"want {MMA_KERNEL_NAMES}")
    for name in MMA_KERNEL_NAMES:
        mine = [r for f, r in report.items() if name in f]
        regs = sorted(r[0] for r in mine)
        log(f"  {len(mine)} {name}: registers {regs[0]}-{regs[-1]}, spill bytes "
            f"{max(r[1] for r in mine)}, HMMA instructions {min(r[2] for r in mine)}-"
            f"{max(r[2] for r in mine)}")
    bad = {f: r for f, r in report.items() if r[1] != 0 or r[2] == 0}
    if bad:
        raise SystemExit(f"FAIL: tensor-core kernels spilling or without HMMA: {bad}")
    return report


def cuda_ms(fn, iters):
    """Mean ms per call over `iters` calls after one warm-up, CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_tensor_cores(phase, kernels):
    """Every launch of K1, K2, K3, K5a-c, K6a and K7 since the counts were
    zeroed took the tensor cores, the wide (D > 160) ones of K1 and K2
    included: tc_launches equals launches. Returns the tensor-core
    launches."""
    counts, tc = kernels.counts(), kernels.tc_counts()
    want = {n: counts[n]["launches"] for n in TC_KERNELS}
    log(f"  tensor-core launches {json.dumps(tc)} (launches {json.dumps(want)})")
    if tc != want:
        raise SystemExit(f"FAIL: {phase}: tensor-core launches {tc}, want {want}")
    return tc


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def site_call(kernels, name, site, shape, gen, dev, dtype=torch.bfloat16):
    """(kernel thunk, plain thunk, library thunk) on random inputs of this
    shape and dtype. The library thunk is the one PyTorch call that computes
    the same function, F.scaled_dot_product_attention on [B, H, S, D] views
    of the same tensors (for K4 with the frame axis folded out as the
    sequence); it is timed as a yardstick and used nowhere in the port."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=torch.float32).to(dtype)
    if name == "frame_attention":
        B, F, HW, C, heads = shape
        q, k, v = (rnd(B, F, HW, C) for _ in range(3))
        kw = dict(scale=(C // heads) ** -0.5, heads=heads)

        def fold(x):      # [B, F, HW, C] -> [B*HW, heads, F, D]
            return x.permute(0, 2, 1, 3).reshape(B * HW, F, heads, C // heads).transpose(1, 2)

        def library():
            o = sdpa(fold(q), fold(k), fold(v))
            return o.transpose(1, 2).reshape(B, HW, F, C).permute(0, 2, 1, 3)

        return (lambda: kernels.frame_attention(q, k, v, **kw),
                lambda: kernels.frame_attention_plain(q, k, v, **kw), library)
    if name in LAB_KERNELS:
        return lab_site_call(kernels, name, site, shape, rnd, gen, dev, dtype)
    if name in OPT_IN_KERNELS:
        return opt_in_site_call(kernels, name, site, shape, rnd, gen, dev, dtype)
    B, Sq, Sk, H, D = shape
    heads_first = lambda x: x.reshape(B, -1, H, D).transpose(1, 2)
    if name in TRAIN_KERNELS:
        return train_site_call(kernels, name, site, shape, rnd, gen, dev, dtype)
    if name == "shared_bias_attention":
        q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D)
        if site == CLIP_SITE:
            bias = torch.full((Sq, Sk), float("-inf"), device=dev).triu(1)
        else:
            bias = torch.rand(Sq, Sk, generator=gen, device=dev) * 2 - 1
        mask = bias.to(dtype)
        return (lambda: kernels.shared_bias_attention(q, k, v, bias, scale=D ** -0.5),
                lambda: kernels.shared_bias_attention_plain(q, k, v, bias, scale=D ** -0.5),
                lambda: sdpa(heads_first(q), heads_first(k), heads_first(v),
                             attn_mask=mask).transpose(1, 2))
    q, k, v = rnd(B, Sq, H * D), rnd(B, Sk, H * D), rnd(B, Sk, H * D)
    fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    kw = dict(scale=D ** -0.5, heads=H)
    bias, mask = (), None
    if site.endswith("_bias"):      # K1's optional operand, shared by rows and heads
        bias = (torch.rand(Sq, Sk, generator=gen, device=dev) * 2 - 1,)
        mask = bias[0].to(dtype)
    return (lambda: fn(q, k, v, *bias, **kw), lambda: plain(q, k, v, *bias, **kw),
            lambda: sdpa(heads_first(q), heads_first(k), heads_first(v), attn_mask=mask)
            .transpose(1, 2).reshape(B, Sq, H * D))


def lab_site_call(kernels, name, site, shape, rnd, gen, dev, dtype):
    """site_call for the lab variants of K4 with the packs of LAB_PARAMS.
    Library thunk: K4's (the frame axis folded out as the sequence) for L1,
    L3 and L2 under the block-diagonal bias; for L2 under another bias
    F.scaled_dot_product_attention on the packed [B*T, H, G*F, D] sequences
    with the bias as its mask (the packed copies are made outside its
    time)."""
    from imagine360_tpu_torch.ops import motion_lab

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, F, HW, C, heads = shape
    kw = dict(LAB_PARAMS[site])
    f32_kw = kw.pop("f32", {})
    if dtype == torch.float32:
        kw.update(f32_kw)
    bias_kind = kw.pop("bias", None)
    q, k, v = (rnd(B, F, HW, C) for _ in range(3))
    kw.update(scale=(C // heads) ** -0.5, heads=heads)
    fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")

    def fold(x):      # [B, F, HW, C] -> [B*HW, heads, F, D]
        return x.permute(0, 2, 1, 3).reshape(B * HW, F, heads, C // heads).transpose(1, 2)

    def library():
        o = sdpa(fold(q), fold(k), fold(v))
        return o.transpose(1, 2).reshape(B, HW, F, C).permute(0, 2, 1, 3)

    if bias_kind is None:
        return lambda: fn(q, k, v, **kw), lambda: plain(q, k, v, **kw), library
    G = kw["G"]
    S, T = G * F, HW // G
    if bias_kind == "block_diag":
        bias = torch.from_numpy(motion_lab.block_diag_bias(G, F, F)[0]).to(dev)
    else:
        bias = (torch.rand(1, S, S, generator=gen, device=dev) * 2 - 1).to(
            torch.bfloat16 if bias_kind == "random_bf16" else torch.float32)
        mask = bias.to(dtype)
        # [B, F, T*G, C] -> [B*T, heads, G*F, D], rows in block order g*F + f
        qp, kp, vp = (x.reshape(B, F, T, G, heads, C // heads).permute(0, 2, 4, 3, 1, 5)
                      .reshape(B * T, heads, S, C // heads) for x in (q, k, v))

        def library():
            o = sdpa(qp, kp, vp, attn_mask=mask)
            return o.reshape(B, T, heads, G, F, C // heads).permute(0, 4, 1, 3, 2, 5).reshape(
                B, F, HW, C)

    return lambda: fn(q, k, v, bias, **kw), lambda: plain(q, k, v, bias, **kw), library


def opt_in_site_call(kernels, name, site, shape, rnd, gen, dev, dtype):
    """site_call for K6a (q/k/v [B, H, D, S], the WarpAttn sites with their
    shared float32 bias), K6b (q/k/v [BH, S, D]; a bfloat16 bias at the
    `_bf16_bias` site, the lse too at the `_lse` site) and K7 (x [N, K], the
    weight [M, K] as nn.Linear stores it). Library thunks:
    F.scaled_dot_product_attention on [B, H, S, D] tensors, F.linear."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if name == "dense_matmul":
        N, K, M = shape
        x, w = rnd(N, K), rnd(M, K)
        return (lambda: kernels.dense_matmul(x, w, linear_layout=True),
                lambda: kernels.dense_matmul_plain(x, w, linear_layout=True),
                lambda: torch.nn.functional.linear(x, w))
    if name == "flash_attention_t":
        B, Sq, Sk, H, D = shape
        q, k, v = rnd(B, H, D, Sq), rnd(B, H, D, Sk), rnd(B, H, D, Sk)
        bias = mask = None
        if "warp" in site:
            bias = (torch.rand(Sq, Sk, generator=gen, device=dev) * 2 - 1)[None, None]
            mask = bias.to(dtype)
        # the library call's fused kernels want the head dim contiguous: it
        # gets [B, H, S, D] copies of the same values, made outside its time
        qs, ks, vs = (x.transpose(2, 3).contiguous() for x in (q, k, v))
        return (lambda: kernels.flash_attention_t(q, k, v, bias, scale=D ** -0.5),
                lambda: kernels.flash_attention_t_plain(q, k, v, bias, scale=D ** -0.5),
                lambda: sdpa(qs, ks, vs, attn_mask=mask))
    BH, Sq, Sk, D = shape
    q, k, v = rnd(BH, Sq, D), rnd(BH, Sk, D), rnd(BH, Sk, D)
    bias = torch.rand(Sq, Sk, generator=gen, device=dev) * 2 - 1
    if "bf16_bias" in site:
        bias = bias.bfloat16()
    mask = bias.to(dtype)
    kw = dict(scale=D ** -0.5, with_lse=site.endswith("_lse"))
    lib = lambda: sdpa(q[None], k[None], v[None], attn_mask=mask)[0]
    return (lambda: kernels.shared_bias_attention_folded(q, k, v, bias, **kw),
            lambda: kernels.shared_bias_attention_folded_plain(q, k, v, bias, **kw),
            (lambda: (lib(), None)) if kw["with_lse"] else lib)


def train_site_call(kernels, name, site, shape, rnd, gen, dev, dtype):
    """site_call for the kernels of the training step; q/k/v [B, S, H, D].
    The WarpAttn sites carry their shared [Sq, Sk] bias. The backward
    kernels read the lse of the plain forward and delta = rowsum(dO * O).
    Library thunk: F.scaled_dot_product_attention forward (K5a, K3), and
    forward + backward through torch.autograd.grad returning dq (K5b) or
    (dk, dv) (K5c)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, Sq, Sk, H, D = shape
    scale = D ** -0.5
    q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D)
    bias = mask = None
    if "warp" in site:
        bias = (torch.rand(Sq, Sk, generator=gen, device=dev) * 2 - 1)[None, None]
        mask = bias.to(dtype)
    t = lambda x: x.transpose(1, 2)
    if name == "shared_bias_attention_lse":
        return (lambda: kernels.shared_bias_attention(q, k, v, bias[0, 0], scale=scale,
                                                      with_lse=True),
                lambda: kernels.shared_bias_attention_plain(q, k, v, bias[0, 0], scale=scale,
                                                            with_lse=True),
                lambda: (t(sdpa(t(q), t(k), t(v), attn_mask=mask)), None))
    if name == "flash_attention_lse":
        return (lambda: kernels.flash_attention_lse(q, k, v, bias, scale=scale),
                lambda: kernels.flash_attention_lse_plain(q, k, v, bias, scale=scale),
                lambda: (t(sdpa(t(q), t(k), t(v), attn_mask=mask)), None))
    do = rnd(B, Sq, H, D)
    out, lse = kernels.flash_attention_lse_plain(q, k, v, bias, scale=scale)
    delta = kernels.attention_delta(do, out)
    del out
    args = (q, k, v, bias, do, lse, delta)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def library_grads():
        o = sdpa(*(t(x) for x in leaves), attn_mask=mask)
        return torch.autograd.grad(o, leaves, t(do))

    if name == "flash_bwd_dq":
        return (lambda: kernels.flash_bwd_dq(*args, scale=scale),
                lambda: kernels.flash_bwd_dq_plain(*args, scale=scale),
                lambda: library_grads()[0])
    return (lambda: kernels.flash_bwd_dkv(*args, scale=scale),
            lambda: kernels.flash_bwd_dkv_plain(*args, scale=scale),
            lambda: library_grads()[1:])


def site_ops(name, shape):
    """Operations of one call at this shape: 4*Sq*Sk*D per (batch, head)
    for the attention kernels (two products, a multiply and an add each; 6
    for K5b's three products, 8 for K5c's four), 2*N*K*M for K7, and
    4*F*F*C per (batch row, location) for K4 and its lab variants."""
    if name == "frame_attention" or name in LAB_KERNELS:
        B, F, HW, C, heads = shape
        return 4.0 * B * HW * F * F * C
    if name == "dense_matmul":
        return 2.0 * math.prod(shape)
    return OPS_PER_ELEMENT.get(name, 4.0) * math.prod(shape)


def site_bound(name, shape, itemsize=2, site=""):
    """(bound ms, "operations" or "bytes") of one call at this shape in a
    2-byte dtype: its operations (site_ops) over the bf16 tensor-core rate,
    against every input read once and every output written once over the
    memory rate: q, k, v and out forward, with the float32 lse where it is
    written; q, k, v, dO, the float32 lse and delta and dq for K5b, or dk
    and dv for K5c (neither reads out: delta stands in for it); the float32
    bias at the biased sites. K7 reads x and the weight and writes the
    output. K6b reads its bias in its own dtype (2 bytes at the `_bf16_bias`
    site)."""
    flops = site_ops(name, shape)
    if name == "frame_attention" or name in LAB_KERNELS:
        # the lab variants are held to the useful work, K4's: the logits L2
        # computes off the diagonal blocks are its own doing; its bias is an
        # input, read once in its own dtype
        B, F, HW, C, heads = shape
        nbytes = 4.0 * B * F * HW * C * itemsize
        if name == "fused_motion_attention":
            G = LAB_PARAMS[site]["G"]
            nbytes += (2.0 if "bf16_bias" in site else 4.0) * (G * F) ** 2
    elif name == "dense_matmul":
        N, K, M = shape
        nbytes = float(N * K + K * M + N * M) * itemsize
    elif name == "shared_bias_attention_folded":
        BH, Sq, Sk, D = shape
        nbytes = (float(BH * (2 * Sq + 2 * Sk) * D * itemsize)
                  + (2.0 if "bf16_bias" in site else 4.0) * Sq * Sk
                  + 4.0 * BH * Sq * site.endswith("_lse"))
    else:
        B, Sq, Sk, H, D = shape
        # rows of H*D elements on the query side and on the key side, and
        # float32 rows of H statistics: q, out | k, v | none, or lse
        q_rows, k_rows, stat_rows = 2, 2, int(name.endswith("_lse"))
        if name == "flash_bwd_dq":      # q, dO, dq | k, v | lse, delta
            q_rows, k_rows, stat_rows = 3, 2, 2
        if name == "flash_bwd_dkv":     # q, dO | k, v, dk, dv | lse, delta
            q_rows, k_rows, stat_rows = 2, 4, 2
        nbytes = float(B * (q_rows * Sq + k_rows * Sk) * H * D * itemsize
                       + 4 * B * H * Sq * stat_rows)
        if name.startswith("shared_bias_attention") or "warp" in site or site.endswith("_bias"):
            nbytes += 4.0 * Sq * Sk
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def compare(kern, plain, dtype_tol=None):
    """(max abs error, max |plain|, all finite, within tolerance) of one
    kernel call against its plain version. A call may return several
    tensors (out and lse; dk and dv; None entries are skipped): the error
    and the peak are the largest over them, and each is held to its own
    tolerance: `dtype_tol(max |plain|)` for an output in the inputs' dtype,
    LSE_TOL for a float32 lse beside a lower-precision output."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    err = peak = 0.0
    finite = ok = True
    main_dtype = want[0].dtype
    for g, w in zip(got, want):
        if g is None or w is None:
            continue
        e = (g.float() - w.float()).abs().max().item()
        pk = w.float().abs().max().item()
        if w.dtype == torch.float32 and main_dtype != torch.float32:
            ok = ok and e <= LSE_TOL
        else:
            err, peak = max(err, e), max(peak, pk)
            ok = ok and (dtype_tol is None or e <= dtype_tol(pk))
        finite = finite and bool(torch.isfinite(g).all())
    return err, peak, finite, ok


def bf16_tol(name, peak):
    """The bf16 limit of a kernel's output whose plain version peaks at
    `peak`. The gradients are unnormalised sums, far below unit scale at the
    long sites, so they are held to their own size alone."""
    if name in OPS_PER_ELEMENT:      # K5b, K5c
        return GRAD_BF16_REL * peak
    if name == "dense_matmul":
        return DENSE_BF16_REL * peak
    return min(BF16_TOL, BF16_REL * peak)


def extra_times(kernels, name, site, shape, gen, dev, iters):
    """What phase 2 times beside the kernel alone. K6a: the whole site as
    the model runs it, dot_product_attention on [B, S, H, D] tensors under
    attn_v2, so with the three copies to [B, H, D, S] and the permute back
    (`with_permutes_ms`). K6b at its first site: the kernel at each of
    FOLDED_T_ROWS folded rows per bias tile (`ms_by_t_rows`)."""
    from imagine360_tpu_torch.ops import attention as attn
    from imagine360_tpu_torch.ops.dispatch import configure

    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev,
                                 dtype=torch.float32).bfloat16()
    if name == "flash_attention_t":
        B, Sq, Sk, H, D = shape
        q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D)
        bias = None
        if "warp" in site:
            bias = (torch.rand(Sq, Sk, generator=gen, device=dev) * 2 - 1)[None, None]
        with configure(attn_v2=True):
            before = kernels.counts()[name]["launches"]
            ms = cuda_ms(lambda: attn.dot_product_attention(q, k, v, bias=bias), iters)
            if kernels.counts()[name]["launches"] != before + iters + 1:
                raise SystemExit(f"FAIL: {site} under attn_v2 did not take flash_attention_t")
        return {"with_permutes_ms": ms}
    if site == "folded_warp_r2_pano_q":
        BH, Sq, Sk, D = shape
        q, k, v = rnd(BH, Sq, D), rnd(BH, Sk, D), rnd(BH, Sk, D)
        bias = torch.rand(Sq, Sk, generator=gen, device=dev) * 2 - 1
        return {"ms_by_t_rows": {str(t): cuda_ms(
            lambda: kernels.shared_bias_attention_folded(q, k, v, bias, scale=D ** -0.5,
                                                         t_rows=t), iters)
            for t in FOLDED_T_ROWS}}
    return {}


def phase_kernels(kernels, dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, per_kernel = [], {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    for name, site, shape in SITES:
        kernels.reset_counts()
        kern, plain, library = site_call(kernels, name, site, shape, gen, dev)
        err, peak, finite, ok = compare(kern, plain, lambda pk: bf16_tol(name, pk))
        lib_err = compare(library, plain)[0]
        tol = bf16_tol(name, peak)
        iters = 3 if shape[0] * shape[1] * shape[2] > 2 ** 27 else 10
        ms = cuda_ms(kern, iters)
        # every bf16 launch of a tensor-core kernel at this site took the tensor cores
        wrapper = "shared_bias_attention" if name == "shared_bias_attention_lse" else name
        if wrapper in TC_KERNELS:
            n, n_tc = kernels.counts()[wrapper]["launches"], kernels.tc_counts()[wrapper]
            if n == 0 or n_tc != n:
                raise SystemExit(f"FAIL: {name} at {site}: {n_tc} of {n} bf16 launches on "
                                 "the tensor cores")
        plain_ms = cuda_ms(plain, iters)
        library_ms = cuda_ms(library, iters)
        extra = extra_times(kernels, name, site, shape, gen, dev, iters)
        if name in MATCH_KERNELS:
            first = lambda out: out[0] if isinstance(out, tuple) else out
            extra["match"] = (first(kern()) == first(plain())).float().mean().item()
            ok = ok and extra["match"] >= K5A_MATCH
        del kern, plain, library
        torch.backends.cuda.matmul.allow_tf32 = False
        f32_shape = (min(shape[0], DENSE_F32_ROWS if name == "dense_matmul" else F32_ROWS),
                     ) + shape[1:]
        f32_tol = (lambda pk: DENSE_F32_REL * pk) if name == "dense_matmul" \
            else (lambda pk: F32_TOL)
        if site.endswith("exp_bf16"):
            # the probabilities are bfloat16 values in float32 too: a logit on
            # a rounding boundary may round the other way in another summation
            # order, one bfloat16 ulp of that probability
            f32_tol = lambda pk: bf16_tol(name, pk)
        err32, peak32, finite32, ok32 = compare(*site_call(kernels, name, site, f32_shape, gen,
                                                           dev, torch.float32)[:2], f32_tol)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        bound_ms, bound_by = site_bound(name, shape, site=site)
        if name in TC_SITE_KERNELS:
            extra["tflops"] = site_ops(name, shape) / (ms * 1e-3) / 1e12
        rows.append(dict(kernel=name, site=site, shape=list(shape), max_abs_err=err,
                         tol=tol, f32_rows=f32_shape[0], f32_max_abs_err=err32, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         library_max_abs_err=lib_err, bound_ms=bound_ms, bound_by=bound_by,
                         **extra))
        log(f"  {name:22s} {site:22s} {str(shape):30s} bf16 err={err:.3e} "
            f"(tol {tol:.3e}) f32 err={err32:.3e} kernel={ms:.3f} ms plain={plain_ms:.3f} ms "
            f"library={library_ms:.3f} ms bound={bound_ms:.4f} ms ({bound_by})"
            + (f" {json.dumps(extra)}" if extra else ""))
        if not (finite and finite32 and ok and ok32):
            raise SystemExit(f"FAIL: {name} at {site} bf16 err={err} (tol {tol}), "
                             f"f32 err={err32} (tol {f32_tol(peak32)})"
                             + (f", match {extra['match']} (at least {K5A_MATCH})"
                                if "match" in extra else ""))
        # the JSON line gives each kernel's numbers at its first (largest)
        # site and its largest bf16 error over all sites; the wide variants of
        # K1 and K2 (head dim > 160) are kernels of their own
        wide = name in WIDE_SOURCES and shape[4] > WIDE_ABOVE
        rec = per_kernel.setdefault(name + "_wide" if wide else name, dict(rows[-1]))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        gc.collect()
        torch.cuda.empty_cache()
    return rows, per_kernel


# ---------------------------------------------------------------------------
# phase 3: tiny parity, CUDA kernels vs CPU plain
# ---------------------------------------------------------------------------


def tiny_inputs(cfg, M, F, gen):
    f = lambda *s: torch.randn(*s, generator=gen)
    ctx, hid = cfg.pers.cross_attention_dim, cfg.pers.image_hidden_size
    (ph, pw), (eh, ew) = TINY_PERS_HW, TINY_PANO_HW
    return dict(pers=f(2, M, F, ph, pw, 9), pano=f(2, F, eh, ew, 9),
                t=torch.full((2,), 321.0), pers_text=f(2 * M, 7, ctx), pano_text=f(2, 7, ctx),
                fps=torch.full((2,), 8.0), ref_pers=f(2 * M, 16, 16, hid),
                ref_pano=f(2, 16, 16, hid), rel=torch.randint(0, 50, (2, F, 6), generator=gen)
                .float(), pitch=torch.randint(0, 90, (2, F), generator=gen).float())


def run_dual(model, x, geoms, use_opp, dev):
    x = {k: v.to(dev) for k, v in x.items()}
    with torch.no_grad():
        ip_pers, ip_pano = model.compute_ip_tokens(x["ref_pers"], x["ref_pano"], x["rel"],
                                                   x["pitch"])
        return model(x["pers"], x["pano"], x["t"], x["pers_text"], x["pano_text"], x["fps"],
                     geoms, use_opp, ip_pers, ip_pano)


def phase_tiny(dev):
    from imagine360_tpu_torch.geometry.cameras import CameraRig
    from imagine360_tpu_torch.models.dual import DualUNet
    from imagine360_tpu_torch.ops import attention as attn
    from imagine360_tpu_torch.pipeline.sampler import build_dual_warp_geoms
    from imagine360_tpu_torch.presets import tiny_dual_config
    from imagine360_tpu_torch.utils.init import seeded_init_

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    M, F = 4, 4
    cfg = tiny_dual_config(num_views=M)
    gen = torch.Generator().manual_seed(2)
    cpu_model = DualUNet(cfg).eval()
    seeded_init_(cpu_model, gen)
    x = tiny_inputs(cfg, M, F, gen)
    rig = CameraRig.icosahedron(16).take(M)
    use_opp = [True, False, True, False, False, True, False]
    want = run_dual(cpu_model, x, build_dual_warp_geoms(cfg, rig, TINY_PERS_HW, TINY_PANO_HW,
                                                          device="cpu"),
                    use_opp, "cpu")
    cuda_model = DualUNet(cfg).eval().to(dev)
    cuda_model.load_state_dict(cpu_model.state_dict())
    attn.reset_counts()
    got = run_dual(cuda_model, x,
                   build_dual_warp_geoms(cfg, rig, TINY_PERS_HW, TINY_PANO_HW, device=dev),
                   use_opp, dev)
    torch.cuda.synchronize()
    launches = {k: v["launches"] for k, v in attn.kernels.counts().items()}
    for g, w, label in zip(got, want, ("pers", "pano")):
        err = (g.cpu() - w).abs().max().item()
        scale = w.abs().max().item()
        log(f"  tiny DualUNet {label}: max abs err {err:.3e}, max |out| {scale:.3e}, "
            f"tol {TINY_REL_TOL} x max |out|")
        if not err <= TINY_REL_TOL * scale:
            raise SystemExit(f"FAIL: tiny parity {label} err={err}")
    tc = attn.kernels.tc_counts()
    if (attn.plain_path_calls() != 0 or min(launches[k] for k in INFERENCE_KERNELS) == 0
            or any(tc.values())):
        raise SystemExit(f"FAIL: tiny CUDA run launches={launches} tensor cores={tc} "
                         f"plain={attn.plain_path_calls()}")
    log(f"  tiny CUDA launches {launches}, on the tensor cores {tc} (float32: none)")

    # the same forward behind the opt-in switches: the 2048-token pano sites
    # and the r2 WarpAttn sites (512 x 256) take K6a, proj_in / proj_out K7
    from imagine360_tpu_torch.ops.dispatch import KernelConfig, configure, kernel_config
    with configure(**OPT_IN_SWITCHES):
        want_v2 = run_dual(cpu_model, x, build_dual_warp_geoms(
            cfg, rig, TINY_PERS_HW, TINY_PANO_HW, device="cpu"), use_opp, "cpu")
        attn.reset_counts()
        got_v2 = run_dual(cuda_model, x, build_dual_warp_geoms(
            cfg, rig, TINY_PERS_HW, TINY_PANO_HW, device=dev), use_opp, dev)
        torch.cuda.synchronize()
    launches = {k: v["launches"] for k, v in attn.kernels.counts().items()}
    for g, w, label in zip(got_v2, want_v2, ("pers", "pano")):
        err = (g.cpu() - w).abs().max().item()
        scale = w.abs().max().item()
        log(f"  tiny DualUNet under {OPT_IN_SWITCHES} {label}: max abs err {err:.3e}, "
            f"max |out| {scale:.3e}, tol {TINY_REL_TOL} x max |out|")
        if not err <= TINY_REL_TOL * scale:
            raise SystemExit(f"FAIL: tiny opt-in parity {label} err={err}")
    tc = attn.kernels.tc_counts()
    log(f"  tiny CUDA launches under the opt-in switches {launches}, on the tensor cores "
        f"{tc} (float32: none)")
    if (attn.plain_path_calls() != 0 or launches["flash_attention_t"] == 0
            or launches["dense_matmul"] == 0 or launches["mh_flash_attention"] != 0
            or kernel_config() != KernelConfig() or any(tc.values())):
        raise SystemExit(f"FAIL: tiny opt-in CUDA run launches={launches} tensor cores={tc} "
                         f"plain={attn.plain_path_calls()} config={kernel_config()}")

    # the gradient of a loss on both outputs, for every parameter, IP tokens
    # computed with grad: CUDA through K1, K3 with lse, K4, K5a-c and the
    # einsum backward against the CPU through the plain versions
    def loss_grads(model, geoms, device):
        xs = {k: v.to(device) for k, v in x.items()}
        ip_pers, ip_pano = model.compute_ip_tokens(xs["ref_pers"], xs["ref_pano"], xs["rel"],
                                                   xs["pitch"])
        pers, pano = model(xs["pers"], xs["pano"], xs["t"], xs["pers_text"], xs["pano_text"],
                           xs["fps"], geoms, use_opp, ip_pers, ip_pano)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(pers.pow(2).mean() + pano.pow(2).mean(), params)
        return dict(zip(names, grads))

    want_g = loss_grads(cpu_model, build_dual_warp_geoms(cfg, rig, TINY_PERS_HW, TINY_PANO_HW,
                                                         device="cpu"), "cpu")
    attn.reset_counts()
    got_g = loss_grads(cuda_model, build_dual_warp_geoms(cfg, rig, TINY_PERS_HW, TINY_PANO_HW,
                                                         device=dev), dev)
    torch.cuda.synchronize()
    launches = {k: v["launches"] for k, v in attn.kernels.counts().items()}
    lse = attn.kernels.lse_counts()["shared_bias_attention"]
    top = max(g.abs().max().item() for g in want_g.values())
    worst, worst_name, floored = 0.0, "", 0
    for name, w in want_g.items():
        err = (got_g[name].cpu() - w).abs().max().item()
        # each parameter is held to GRAD_REL_TOL x its own largest gradient. A
        # gradient that is zero but for rounding (a conv bias ahead of a
        # GroupNorm with one channel per group, which removes it) has no
        # scale of its own: it is held to GRAD_FLOOR x the largest gradient
        # of any parameter instead
        peak = w.abs().max().item()
        floored += peak < GRAD_FLOOR * top
        ratio = err / max(peak, GRAD_FLOOR * top)
        if not ratio <= worst:
            worst, worst_name = ratio, f"{name}: err {err:.3e}, max |grad| {peak:.3e}"
    log(f"  tiny DualUNet gradient, {len(want_g)} parameters, largest |grad| {top:.3e}, "
        f"{floored} held to the floor: worst max abs err {worst:.3e} x max |grad| "
        f"({worst_name}), tol {GRAD_REL_TOL}; launches {launches}, "
        f"K3 with lse {lse}, einsum backward calls {attn.einsum_backward_calls()}")
    if not worst <= GRAD_REL_TOL:
        raise SystemExit(f"FAIL: tiny gradient parity {worst_name} err={worst} x max |grad|")
    used = {k: launches[k] for k in ("tiny_attention", "shared_bias_attention",
                                     "frame_attention", "flash_attention_lse",
                                     "flash_bwd_dq", "flash_bwd_dkv")}
    if (attn.plain_path_calls() != 0 or launches["mh_flash_attention"] != 0
            or min(used.values()) == 0 or lse == 0 or attn.einsum_backward_calls() == 0
            or any(attn.kernels.tc_counts().values())):
        raise SystemExit(f"FAIL: tiny CUDA gradient launches={launches} lse={lse} "
                         f"tensor cores={attn.kernels.tc_counts()} "
                         f"plain={attn.plain_path_calls()}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def phase_tiny_encoders(dev):
    """Tiny VAE (encode -> decode) and tiny CLIP text encoder on CUDA through
    the kernels against the same weights on the CPU through the plain
    versions; f32, TF32 off, max abs error <= TINY_REL_TOL x max |out|.

    The VAE runs at two widths: (32, 32, 32, 32), whose one head of 32 takes
    K1 on a 128 x 128 image (256 tokens) and K2 on a 256 x 512 one (2048),
    and (32, 32, 64, 192), whose head of 192 takes the wide kernels."""
    from imagine360_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from imagine360_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from imagine360_tpu_torch.ops import attention as attn
    from imagine360_tpu_torch.utils.init import seeded_init_

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(3)

    def check(label, got, want):
        err = (got.cpu() - want).abs().max().item()
        scale = want.abs().max().item()
        log(f"  {label}: max abs err {err:.3e}, max |out| {scale:.3e}, "
            f"tol {TINY_REL_TOL} x max |out|")
        if not (torch.isfinite(got).all() and err <= TINY_REL_TOL * scale):
            raise SystemExit(f"FAIL: tiny parity {label} err={err}")

    def pair(ctor, cfg):
        cpu = ctor(cfg).eval()
        seeded_init_(cpu, gen)
        cuda = ctor(cfg).eval().to(dev)
        cuda.load_state_dict(cpu.state_dict())
        return cpu, cuda

    def vae_round_trip(vae, x):
        with torch.no_grad():
            mean, logvar = vae.encode(x)
            return mean, logvar, vae.decode(mean)

    launches = {fn.__name__: 0 for fn in attn.kernels.KERNELS}
    wide = dict.fromkeys(attn.kernels.wide_counts(), 0)
    tc = dict.fromkeys(attn.kernels.tc_counts(), 0)
    plain = 0

    def on_card(fn, *args):
        """fn(*args) with the counts of that call alone added to the totals
        (the CPU runs beside it take the plain versions, by design)."""
        nonlocal plain
        attn.reset_counts()
        out = fn(*args)
        torch.cuda.synchronize()
        for k, c in attn.kernels.counts().items():
            launches[k] += c["launches"]
        for k, n in attn.kernels.wide_counts().items():
            wide[k] += n
        for k, n in attn.kernels.tc_counts().items():
            tc[k] += n
        plain += attn.plain_path_calls()
        return out

    for widths in ((32, 32, 32, 32), (32, 32, 64, 192)):
        cpu, cuda = pair(AutoencoderKL, VAEConfig(block_out_channels=widths, layers_per_block=1))
        for hw in ((128, 128), (256, 512)):
            x = torch.rand(2, *hw, 3, generator=gen) * 2 - 1
            for name, g, w in zip(("mean", "logvar", "decode"),
                                  on_card(vae_round_trip, cuda, x.to(dev)),
                                  vae_round_trip(cpu, x)):
                check(f"tiny VAE {widths[-1]} wide, {hw[0]}x{hw[1]} {name}", g, w)
    cfg = CLIPTextConfig(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
                         intermediate_size=128)
    cpu, cuda = pair(CLIPTextModel, cfg)
    ids = torch.randint(0, 1000, (2, 77), generator=gen)
    with torch.no_grad():
        check("tiny CLIP text", on_card(cuda, ids.to(dev)), cpu(ids))
    log(f"  tiny encoder CUDA launches {launches}, of them wide {wide}, on the tensor cores "
        f"{tc} (float32: none)")
    if (plain != 0 or min(wide.values()) == 0 or any(tc.values())
            or min(launches[k] for k in ("tiny_attention", "mh_flash_attention",
                                         "shared_bias_attention")) == 0):
        raise SystemExit(f"FAIL: tiny encoders launches={launches} wide={wide} plain={plain}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


# ---------------------------------------------------------------------------
# phase 4: the full-width denoise loop alone
# ---------------------------------------------------------------------------


def phase_slice(dev, steps=SLICE_STEPS, solver="ddim", switches=None, profiler=None):
    """compute_ip and `steps` CFG steps of full_dual_config. `solver` and
    `switches` (KernelConfig fields for a configure() block around both)
    make it phase 7: the launch checks then ask for K6a and K7 in place of
    K2, and K6b is driven through its own entry point afterwards.
    `profiler` (a context manager) serves scripts/torch_profile_step.py: one
    more step from the same latents runs under it after the counted ones."""
    from imagine360_tpu_torch.geometry.cameras import CameraRig
    from imagine360_tpu_torch.models.dual import DualUNet
    from imagine360_tpu_torch.ops import attention as attn
    from imagine360_tpu_torch.ops.dispatch import KernelConfig, configure, kernel_config
    from imagine360_tpu_torch.pipeline.conditioning import init_shared_noise
    from imagine360_tpu_torch.pipeline.sampler import (DualDiffusionSampler, SamplerConfig,
                                                       build_dual_warp_geoms)
    from imagine360_tpu_torch.presets import full_dual_config
    from imagine360_tpu_torch.utils.init import seeded_init_

    opt_in = bool(switches)
    frames, M = 16, 20
    bf = torch.bfloat16
    cfg = full_dual_config("bfloat16")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.time()
    with torch.device(dev):
        model = DualUNet(cfg)
    model = model.to(bf).eval()
    seeded_init_(model, gen)
    n_params = sum(p.numel() for p in model.parameters())
    rig = CameraRig.icosahedron(image_size=256)
    geoms = build_dual_warp_geoms(cfg, rig, (32, 32), (64, 128), device=dev)
    torch.cuda.synchronize()
    log(f"  model {n_params / 1e9:.3f} B params, geometry, set-up {time.time() - t0:.1f} s")

    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=torch.float32).to(bf)
    pano_lat, pers_lat = init_shared_noise(gen, 1, frames, (64, 128), (32, 32), rig)
    pano_mask = (torch.rand(1, frames, 64, 128, 1, generator=gen, device=dev) > 0.5).float()
    pers_mask = (torch.rand(1, M, frames, 32, 32, 1, generator=gen, device=dev) > 0.5).float()
    pano_masked, pers_masked = rnd(1, frames, 64, 128, 4).float(), \
        rnd(1, M, frames, 32, 32, 4).float()
    pano_text, pers_text = rnd(2, 77, 1024), rnd(2 * M, 77, 1024)
    fps = torch.full((2,), 8.0, device=dev)
    ref_pano, ref_pers = rnd(2, 16, 4096, 256), rnd(2 * M, 16, 4096, 256)
    rel = torch.randint(0, 50, (2, frames, 6), generator=gen, device=dev).float()
    pitch = torch.randint(0, 90, (2, frames), generator=gen, device=dev).float()
    sampler = DualDiffusionSampler(model, SamplerConfig(num_steps=50, add_ip_noise=True,
                                                        solver=solver))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.reset_counts()
    with configure(**(switches or {})):
        t0 = time.time()
        ip_pers, ip_pano = sampler.compute_ip(ref_pers, ref_pano, rel, pitch)
        torch.cuda.synchronize()
        ip_s = time.time() - t0
        ip_shapes = attn.kernels.shape_counts()
        del ref_pano, ref_pers
        t0 = time.time()
        pano_out, pers_out = sampler.denoise(
            pano_lat, pers_lat, pano_mask, pano_masked, pers_mask, pers_masked, pano_text,
            pers_text, geoms, fps, ip_pers, ip_pano, generator=gen, num_steps=steps)
        torch.cuda.synchronize()
        loop_s = time.time() - t0
    if kernel_config() != KernelConfig():
        raise SystemExit(f"FAIL: the kernel config after the block is {kernel_config()}")
    counts = attn.kernels.counts()
    # launches of one denoise step at each site of SITES (compute_ip's taken off)
    shapes = attn.kernels.shape_counts()
    per_step = {site: (shapes.get((name, shape), 0) - ip_shapes.get((name, shape), 0)) / steps
                for name, site, shape in SITES}
    # K3 at every shape it ran (the WarpAttn sites: r2 and r4 twice, r8
    # three times per direction, at two head counts)
    k3_per_step = {str(shape): (n - ip_shapes.get((kn, shape), 0)) / steps
                   for (kn, shape), n in shapes.items() if kn == "shared_bias_attention"}
    plain = attn.plain_path_calls()
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches per step by site {json.dumps(per_step)}")
    log(f"  K3 launches per step by shape {json.dumps(k3_per_step)}")
    log(f"  compute_ip {ip_s:.3f} s; {steps} CFG {solver} steps {loop_s:.3f} s = "
        f"{loop_s / steps:.3f} s/step; peak device memory {peak / 2**30:.2f} GiB")
    log(f"  main-path launches {json.dumps(counts)}; plain-path attention calls {plain}")
    tc = check_tensor_cores("slice", attn.kernels)
    if profiler is not None:
        with configure(**(switches or {})), profiler:
            sampler.denoise(pano_lat, pers_lat, pano_mask, pano_masked, pers_mask, pers_masked,
                            pano_text, pers_text, geoms, fps, ip_pers, ip_pano, generator=gen,
                            num_steps=1)
            torch.cuda.synchronize()
    ok_shape = (tuple(pano_out.shape) == (1, frames, 64, 128, 4)
                and tuple(pers_out.shape) == (1, M, frames, 32, 32, 4))
    finite = bool(torch.isfinite(pano_out).all() and torch.isfinite(pers_out).all())
    log(f"  latents: shapes ok {ok_shape}, finite {finite}, "
        f"pano std {pano_out.float().std().item():.4f}, "
        f"pers std {pers_out.float().std().item():.4f}")
    if not (ok_shape and finite):
        raise SystemExit("FAIL: slice latents wrong shape or not finite")
    # by default K1-K4 launch and the opt-in kernels do not; behind the
    # switches K6a takes every K2 site and K7 launches
    need = [k for k in INFERENCE_KERNELS if not (opt_in and k == "mh_flash_attention")]
    idle = (["mh_flash_attention"] if opt_in else list(OPT_IN_KERNELS)) + list(LAB_KERNELS)
    need += ["flash_attention_t", "dense_matmul"] if opt_in else []
    if (plain != 0 or min(counts[k]["launches"] for k in need) == 0
            or max(counts[k]["launches"] for k in idle) != 0):
        raise SystemExit(f"FAIL: slice launches={counts} plain={plain}")
    launches = {k: c["launches"] for k, c in counts.items()}
    if opt_in:
        launches["shared_bias_attention_folded"] = drive_folded_entry_point(geoms, gen, dev)
    return launches, per_step, dict(
        s_per_step=loop_s / steps, compute_ip_s=ip_s, peak_bytes=peak, steps=steps,
        solver=solver, switches=switches or {}, tc_launches=tc,
        shared_bias_launches_per_step_by_shape=k3_per_step,
        launches_per_step_by_kernel={k: (c["launches"] - sum(
            n for (kn, _), n in ip_shapes.items() if kn == k)) / steps
            for k, c in counts.items()})


def drive_folded_entry_point(geoms, gen, dev):
    """K6b through its own entry point, `kernels.shared_bias_attention_folded`,
    on the WarpAttn masks of the loop just run: every resolution, both
    directions, the mask in bfloat16, 32 batch rows x the site's heads folded,
    head dim 32. Each result is finite and within the bf16 limit of the plain
    version. Returns the launches counted from zero."""
    from imagine360_tpu_torch.ops import attention as attn

    kernels = attn.kernels
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev,
                                 dtype=torch.float32).bfloat16()
    outs = []
    attn.reset_counts()
    for rkey, heads in (("r2", 10), ("r4", 20), ("r8", 40)):
        for key in ("pers_bias", "equi_bias"):
            bias = geoms[rkey][key].bfloat16()
            Sq, Sk = bias.shape
            q, k, v = rnd(32 * heads, Sq, 32), rnd(32 * heads, Sk, 32), rnd(32 * heads, Sk, 32)
            outs.append((rkey, key, q, k, v, bias, kernels.shared_bias_attention_folded(
                q, k, v, bias, scale=32 ** -0.5)))
    torch.cuda.synchronize()
    launches = kernels.counts()["shared_bias_attention_folded"]["launches"]
    plain = attn.plain_path_calls()
    worst = 0.0
    for rkey, key, q, k, v, bias, got in outs:
        want = kernels.shared_bias_attention_folded_plain(q, k, v, bias, scale=32 ** -0.5)
        err = (got.float() - want.float()).abs().max().item()
        tol = bf16_tol("shared_bias_attention_folded", want.float().abs().max().item())
        worst = max(worst, err)
        if not (torch.isfinite(got).all() and err <= tol):
            raise SystemExit(f"FAIL: folded entry point at {rkey} {key} err={err} (tol {tol})")
    log(f"  K6b through its entry point on the loop's bfloat16 masks: {launches} launches, "
        f"worst max abs err {worst:.3e}, plain-path calls {plain}")
    tc = kernels.tc_counts()["shared_bias_attention_folded"]
    if launches != len(outs) or plain != 0 or tc != launches:
        raise SystemExit(f"FAIL: folded entry point launches={launches} plain={plain} "
                         f"tensor cores={tc}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: video in, 360-degree video out, at full width
# ---------------------------------------------------------------------------


def full_width_configs(dtype="bfloat16"):
    """(DualUNetConfig, VAEConfig, CLIPTextConfig, SAMConfig, pano (H, W)) of
    the production system."""
    from imagine360_tpu_torch.models.clip_text import CLIPTextConfig
    from imagine360_tpu_torch.models.sam import SAMConfig
    from imagine360_tpu_torch.models.vae import VAEConfig
    from imagine360_tpu_torch.presets import full_dual_config

    return (full_dual_config(dtype), VAEConfig(dtype=dtype), CLIPTextConfig(dtype=dtype),
            SAMConfig(dtype=dtype), (512, 1024))


def phase_pipeline(dev, out_dir, steps=PIPELINE_STEPS, configs=None, dtype="bfloat16"):
    """`configs` replaces full_width_configs() when the phase is rehearsed at
    a tiny size."""
    import numpy as np

    from imagine360_tpu_torch import cli
    from imagine360_tpu_torch.config import RunConfig
    from imagine360_tpu_torch.ops import attention as attn
    from imagine360_tpu_torch.pipeline.generate import Imagine360Pipeline
    from imagine360_tpu_torch.utils.observability import StageTimer
    from imagine360_tpu_torch.utils.video_io import read_video, save_video

    frames_n = 16
    dual_cfg, vae_cfg, text_cfg, sam_cfg, (H, W) = configs or full_width_configs(dtype)
    cfg = RunConfig.from_dict(dict(
        output_dir=out_dir, pano_H=H, pano_W=W, num_inference_steps=steps,
        video_sample_length=frames_n, angle_adapt="linear_fit", dtype=dtype,
        global_seed=0))
    t0 = time.time()
    modules = cli.build_modules(cfg, dual_cfg, device=dev, seed=0, vae_cfg=vae_cfg,
                                text_cfg=text_cfg, sam_cfg=sam_cfg)
    # no tokenizer vocabulary is in the repo: token ids from a seed, one
    # sequence per prompt string
    vocab = modules.text_encoder.cfg.vocab_size
    modules.tokenizer = lambda text: np.random.default_rng(len(text)).integers(0, vocab, 77)
    pipe = Imagine360Pipeline(modules, cfg, dual_cfg, device=dev)
    torch.cuda.synchronize()
    n_params = {k: sum(p.numel() for p in m.parameters()) / 1e6
                for k, m in (("dual", modules.dual), ("vae", modules.vae),
                             ("clip", modules.text_encoder), ("sam", modules.sam))}
    log(f"  models (M params) {json.dumps({k: round(v, 1) for k, v in n_params.items()})}, "
        f"geometry, set-up {time.time() - t0:.1f} s")

    clip_path = os.path.join(SCRIPT_DIR, "examples", "synthetic.npy")
    frames = read_video(clip_path, num_frames=frames_n)
    with open(os.path.splitext(clip_path)[0] + ".txt") as f:
        prompt = f.read().strip()
    raw_pitches = np.linspace(-8.0, 12.0, frames_n) + np.random.default_rng(0).normal(
        0, 1.5, frames_n)
    class PeakStageTimer(StageTimer):
        """Also the peak device memory of each stage: the peak counter is
        reset when a stage starts and read when it ends."""

        def __init__(self, device):
            super().__init__(device=device)
            self.peaks = {}

        def __call__(self, name):
            stage = super().__call__(name)

            @contextlib.contextmanager
            def tracked():
                torch.cuda.reset_peak_memory_stats()
                with stage:
                    yield
                self.peaks[name] = max(self.peaks.get(name, 0),
                                       torch.cuda.max_memory_allocated())
            return tracked()

    timer = PeakStageTimer(dev)
    torch.cuda.synchronize()
    attn.reset_counts()
    t0 = time.time()
    out = pipe(frames, prompt, raw_pitches=raw_pitches, timer=timer,
               generator=torch.Generator(device=dev).manual_seed(cfg.global_seed))
    torch.cuda.synchronize()
    total_s = time.time() - t0
    counts = attn.kernels.counts()
    wide = attn.kernels.wide_counts()
    shapes = attn.kernels.shape_counts()
    by_site = {site: shapes.get((name, shape), 0) for name, site, shape in SITES}
    plain = attn.plain_path_calls()
    peak = max(timer.peaks.values())
    stages = timer.report()
    log(f"  launches by site {json.dumps(by_site)}")
    log(f"  peak device memory by stage (GiB) "
        f"{json.dumps({k: round(v / 2**30, 2) for k, v in timer.peaks.items()})}")
    log(f"  stages (s) {json.dumps({k: round(v, 3) for k, v in stages.items()})}; "
        f"total {total_s:.3f} s; peak device memory {peak / 2**30:.2f} GiB")
    log(f"  main-path launches {json.dumps(counts)}; at D = 512 {json.dumps(wide)}; "
        f"plain-path attention calls {plain}")
    tc = check_tensor_cores("pipeline", attn.kernels)
    video, masks = out["videos"], out["masks"]
    ok_shape = video.shape == (frames_n, H, W, 3) and masks.shape == (frames_n, H, W, 1)
    finite = bool(np.isfinite(video).all())
    in_range = finite and float(video.min()) >= 0.0 and float(video.max()) <= 1.0
    log(f"  video: shapes ok {ok_shape}, finite {finite}, in [0, 1] {in_range}, "
        f"mean {video.mean():.4f}, std {video.std():.4f}; masked share {masks.mean():.4f}; "
        f"pitches {out['pitches'][0]:.2f} .. {out['pitches'][-1]:.2f}")
    if not (ok_shape and in_range and video.std() > 0 and 0.0 < masks.mean() < 1.0):
        raise SystemExit("FAIL: pipeline video wrong shape, not finite, out of range or flat")
    if plain != 0 or min(counts[k]["launches"] for k in INFERENCE_KERNELS) == 0 \
            or wide != PIPELINE_WIDE:
        raise SystemExit(f"FAIL: pipeline launches={counts} wide={wide} (want "
                         f"{PIPELINE_WIDE}) plain={plain}")
    # the outputs, written as the CLI writes them and read back
    for name, arr in (("output", video), ("input", out["pano_input"]),
                      ("mask", np.repeat(masks, 3, axis=-1))):
        path = save_video(arr, os.path.join(out_dir, f"synthetic_{name}.mp4"), cfg.fps)
        back = read_video(path)
        want = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        exact = path.endswith(".npy")        # a video codec is lossy
        if back.shape != want.shape or (exact and not np.array_equal(back, want)):
            raise SystemExit(f"FAIL: {path} read back as {back.shape}, differs from what "
                             "was written")
        log(f"  wrote and read back {os.path.basename(path)} {back.shape}")
    return ({k: c["launches"] for k, c in counts.items()}, wide, by_site,
            dict(stages_s=stages, total_s=total_s, peak_bytes=peak,
                 stage_peak_bytes=dict(timer.peaks), steps=steps, tc_launches=tc))


# ---------------------------------------------------------------------------
# phase 6: the training step at full width and depth
# ---------------------------------------------------------------------------


def phase_train(dev, views=TRAIN_VIEWS, frames=TRAIN_FRAMES, steps=TRAIN_STEPS, cfg=None,
                latent_hw=((32, 32), (64, 128)), batch_kw=None, layers_per_block=None,
                remat=True, profiler=None):
    """`cfg`, `latent_hw` and `batch_kw` replace the production model and
    shapes when the phase is rehearsed at a tiny size. `layers_per_block`
    (a cut of depth), `remat` and `profiler` (a context manager under which
    one more step runs after the timed ones) serve
    scripts/torch_train_memory.py, which sizes other configurations."""
    import dataclasses

    from imagine360_tpu_torch.geometry.cameras import CameraRig
    from imagine360_tpu_torch.models.dual import DualUNet
    from imagine360_tpu_torch.ops import attention as attn
    from imagine360_tpu_torch.pipeline.sampler import build_dual_warp_geoms
    from imagine360_tpu_torch.presets import full_dual_config
    from imagine360_tpu_torch.training.train import (TrainConfig, TrainState, make_dual_batch,
                                                     make_train_step)
    from imagine360_tpu_torch.utils.init import seeded_init_

    full = cfg is None
    cfg = cfg or full_dual_config("bfloat16")
    depth = cfg.pers.layers_per_block
    unet = dataclasses.replace(cfg.pers, remat=remat, layers_per_block=layers_per_block or depth)
    cfg = dataclasses.replace(cfg, pers=unet, pano=unet, num_views=views)
    cuts = [what for what, cut in (
        (f"views {views} of 20", views != 20), (f"frames {frames} of 16", frames != 16),
        (f"layers per block {unet.layers_per_block} of {depth}",
         unet.layers_per_block != depth)) if cut]
    log(f"  widths {unet.block_out_channels}, {unet.layers_per_block} layers per block, "
        f"{views} views x {frames} frames, remat {'on' if remat else 'off'}; "
        f"cut: {', '.join(cuts) or 'nothing'}")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.time()
    with torch.device(dev):
        model = DualUNet(cfg)
    model = model.to(unet.torch_dtype).train()
    seeded_init_(model, gen)
    rig = CameraRig.icosahedron(image_size=256).take(views)
    pers_hw, equi_hw = latent_hw
    geoms = build_dual_warp_geoms(cfg, rig, pers_hw, equi_hw, device=dev)
    batch = make_dual_batch(gen, cfg, frames, pers_hw, equi_hw, device=dev, **(batch_kw or {}))
    train_step, optimizer = make_train_step(model, geoms, train_cfg=TrainConfig(), device=dev)
    state = TrainState.create(model, optimizer)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    setup_bytes = torch.cuda.memory_allocated()
    log(f"  model {n_params / 1e9:.3f} B params in {unet.dtype}, float32 masters and AdamW "
        f"moments, geometry, batch, set-up {time.time() - t0:.1f} s, "
        f"{setup_bytes / 2**30:.2f} GiB allocated")

    def checksums():
        # two float64 sums per master weight: a step that moves any element
        # changes them, and no copy of the weights is held
        return {n: (p.double().sum().item(), p.double().pow(2).sum().item())
                for n, p in state.params.items()}

    before = checksums()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses, norms = [], [], []
    for i in range(1 + steps):
        if i == 1:           # the counts are those of the timed steps alone
            attn.reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        state, metrics = train_step(state, batch, gen)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    counts = attn.kernels.counts()
    launches = {k: c["launches"] for k, c in counts.items()}
    tc = check_tensor_cores("training", attn.kernels)
    lse = attn.kernels.lse_counts()["shared_bias_attention"]
    shapes = attn.kernels.shape_counts()
    einsum_bwd, plain = attn.einsum_backward_calls(), attn.plain_path_calls()
    peak = torch.cuda.max_memory_allocated()
    after = checksums()
    if profiler is not None:
        with profiler:
            train_step(state, batch, gen)
            torch.cuda.synchronize()
    still = [n for n in before if before[n] == after[n]]
    finite = all(math.isfinite(x) for x in losses + norms)
    per_step = {k: v / steps for k, v in dict(launches, shared_bias_attention_lse=lse).items()}
    log(f"  warm step {step_s[0]:.3f} s; {steps} timed steps "
        f"{' '.join(f'{t:.3f}' for t in step_s[1:])} s = {sum(step_s[1:]) / steps:.3f} s/step; "
        f"peak device memory {peak / 2**30:.2f} GiB")
    log(f"  loss {' '.join(f'{x:.4f}' for x in losses)}; grad norm "
        f"{' '.join(f'{x:.3f}' for x in norms)}; parameters that did not move: {len(still)} "
        f"of {len(before)}")
    log(f"  launches per step {json.dumps(per_step)}; einsum backward calls per step "
        f"{einsum_bwd / steps}; plain-path attention calls {plain}")
    if not finite:
        raise SystemExit(f"FAIL: training loss {losses} or grad norm {norms} not finite")
    if still:
        raise SystemExit(f"FAIL: {len(still)} parameters did not move, e.g. {still[:5]}")
    need = ("tiny_attention", "frame_attention", "flash_attention_lse", "flash_bwd_dq",
            "flash_bwd_dkv")
    if (plain != 0 or launches["mh_flash_attention"] != 0 or lse == 0
            or lse != launches["shared_bias_attention"]
            or min(launches[k] for k in need) == 0 or einsum_bwd == 0):
        raise SystemExit(f"FAIL: training launches={launches} lse={lse} plain={plain} "
                         f"einsum_backward={einsum_bwd}")
    by_site = {(name, site): shapes.get((name.replace("_lse", "") if name.startswith("shared")
                                         else name, shape), 0) / steps
               for name, site, shape in SITES if name in TRAIN_KERNELS}
    return dict(launches, shared_bias_attention_lse=lse), by_site, dict(
        s_per_step=sum(step_s[1:]) / steps, step_s=step_s, peak_bytes=peak, losses=losses,
        grad_norms=norms, einsum_backward_calls_per_step=einsum_bwd / steps, views=views,
        frames=frames, cut=cuts, full_width=full, params=n_params, setup_bytes=setup_bytes,
        tc_launches_per_step={k: n / steps for k, n in tc.items()})


def phase_motion_lab(kernels, dev):
    """Phase 8: run_lab at LAB_SITES in bf16. Returns (launches by kernel
    from counts zeroed just before the lab, its rows with the limit, the
    library call's time and the site's bound added)."""
    from imagine360_tpu_torch.ops import attention as attn
    from imagine360_tpu_torch.ops import motion_lab

    attn.reset_counts()
    rows = motion_lab.run_lab(dev, LAB_SITES, iters=LAB_ITERS)
    torch.cuda.synchronize()
    counts = kernels.counts()
    plain = attn.plain_path_calls()
    gen = torch.Generator(device=dev).manual_seed(8)
    for site, shape in LAB_SITES:
        bound_ms, bound_by = site_bound("frame_attention", shape)
        library_ms = cuda_ms(site_call(kernels, "frame_attention", site, shape, gen, dev)[2],
                             LAB_ITERS)
        got = [r for r in rows if r["site"] == site]
        fits = [n for n, _, _ in motion_lab.lab_variants(shape, 2)]
        if [r["variant"] for r in got] != fits \
                or {r["kernel"] for r in got} != {"frame_attention", *LAB_KERNELS}:
            raise SystemExit(f"FAIL: lab at {site} ran {[r['variant'] for r in got]}, "
                             f"the variants that fit are {fits}")
        for r in got:
            tol = EXP_BF16_TOL if r["params"].get("exp_bf16") else bf16_tol(r["kernel"],
                                                                            r["peak"])
            r.update(tol=tol, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
            log(f"  {site:15s} {str(shape):26s} {r['variant']:20s} err vs plain K4 "
                f"{r['max_abs_err']:.3e} vs K4 kernel {r['k4_max_abs_err']:.3e} (tol {tol:.3e}) "
                f"{r['ms']:.3f} ms, K4 {r['k4_ms']:.3f} ms, library {library_ms:.3f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}); launches {r['launches']}")
            if not (r["max_abs_err"] <= tol and r["k4_max_abs_err"] <= tol
                    and r["launches"] == LAB_ITERS + 2 and r["plain_calls"] == 0):
                raise SystemExit(f"FAIL: lab variant {r}")
    launches = {k: c["launches"] for k, c in counts.items()}
    log(f"  lab launches {json.dumps({k: launches[k] for k in ('frame_attention', *LAB_KERNELS)})}"
        f"; plain-path attention calls {plain}")
    tc = kernels.tc_counts()["frame_attention"]
    if plain != 0 or min(launches[k] for k in LAB_KERNELS) == 0 \
            or tc != launches["frame_attention"]:
        raise SystemExit(f"FAIL: lab launches={launches} plain={plain} K4 on the tensor "
                         f"cores {tc}")
    return launches, rows


def kernel_report(per_kernel, loop_launches, pipe_launches, wide_launches, train_launches,
                  opt_in_launches, lab_launches):
    """The JSON kernel list. `launches` is over the main paths, each driven
    from zeroed counts: the three default ones for K1-K5c, and for the
    opt-in kernels also phase 7's (`opt_in_loop`: the loop behind the
    switches for K6a and K7, its own entry point on the loop's masks for
    K6b), and for K4 and its lab variants phase 8's (`motion_lab`: run_lab
    at the eight motion sites). The wide variants run in the pipeline only
    (the VAE), and a wrapper's count includes them, so they are taken off
    the narrow kernel's; K3's launches that also wrote the lse (all of the
    training step's) are listed as `shared_bias_attention_lse`, and taken
    off K3's."""
    def entry(name, wide):
        rec = per_kernel[name + "_wide" if wide else name]
        n_wide = wide_launches.get(name, 0)
        if wide:
            by_path = {"denoise_loop": 0, "pipeline": n_wide, "train_step": 0}
        elif name in TRAIN_KERNELS:
            by_path = {"denoise_loop": 0, "pipeline": 0, "train_step": train_launches[name]}
        elif name in OPT_IN_KERNELS + LAB_KERNELS:
            by_path = {"denoise_loop": loop_launches[name], "pipeline": pipe_launches[name],
                       "train_step": train_launches[name],
                       "opt_in_loop": opt_in_launches[name]}
        else:
            n_lse = train_launches["shared_bias_attention_lse"] \
                if name == "shared_bias_attention" else 0
            by_path = {"denoise_loop": loop_launches[name],
                       "pipeline": pipe_launches[name] - n_wide,
                       "train_step": train_launches[name] - n_lse}
        if name in ("frame_attention",) + LAB_KERNELS:     # the lab and its baseline
            by_path["motion_lab"] = lab_launches[name]
        return {"name": name + "_wide" if wide else name, "route": "cuda",
                "tensor_cores": name in TC_SITE_KERNELS,
                "source": (WIDE_SOURCES if wide else SOURCES)[name],
                "replaces": REPLACES[name], "launches": sum(by_path.values()),
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "site": rec["site"], "launches_by_path": by_path}

    return {"kernels": [entry(n, False) for n in SOURCES]
            + [entry(n, True) for n in WIDE_SOURCES]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for the build report and "
                    "a JSON copy of the results")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SCRIPT_DIR)
    from imagine360_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    lib = kernels.build_library()
    kernels.load_library()
    build_s = time.time() - t0
    log(f"phase 1: built {lib.name} in {build_s:.1f} s")
    mma_build = check_mma_build(kernels, lib)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "ptxas.txt"), "w") as f:
            f.write(lib.with_suffix(".ptxas.txt").read_text())

    log("phase 2: kernels vs plain and library call, production shapes")
    rows, per_kernel = phase_kernels(kernels, dev)
    log("phase 3: tiny DualUNet, VAE and CLIP text, f32, CUDA kernels vs CPU plain")
    phase_tiny(dev)
    phase_tiny_encoders(dev)
    log(f"phase 4: full_dual_config bf16, compute_ip + {SLICE_STEPS} CFG DDIM steps")
    loop_launches, per_step, slice_stats = phase_slice(dev)
    log(f"phase 5: Imagine360Pipeline at full width, bf16, {PIPELINE_STEPS} DDIM steps")
    tmp = None if args.out else tempfile.mkdtemp(prefix="i360_smoke_")
    try:
        pipe_launches, wide_launches, by_site, pipe_stats = phase_pipeline(
            dev, os.path.join(args.out or tmp, "pipeline"))
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 6: make_train_step on full_dual_config, 1 warm + {TRAIN_STEPS} timed steps")
    train_launches, train_by_site, train_stats = phase_train(dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 7: full_dual_config bf16 under {OPT_IN_SWITCHES}, compute_ip + "
        f"{SLICE_STEPS} CFG {OPT_IN_SOLVER} steps, then K6b through its entry point")
    opt_in_launches, opt_in_per_step, opt_in_stats = phase_slice(
        dev, solver=OPT_IN_SOLVER, switches=OPT_IN_SWITCHES)
    log(f"  phase 7 {opt_in_stats['s_per_step']:.3f} s/step, peak "
        f"{opt_in_stats['peak_bytes'] / 2**30:.2f} GiB (phase 4: "
        f"{slice_stats['s_per_step']:.3f} s/step, {slice_stats['peak_bytes'] / 2**30:.2f} GiB); "
        f"launches per step {json.dumps(opt_in_stats['launches_per_step_by_kernel'])}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 8: the motion-attention lab at {len(LAB_SITES)} full-width motion sites, bf16")
    lab_launches, lab_rows = phase_motion_lab(kernels, dev)
    for row in rows:
        if row["kernel"] in LAB_KERNELS:
            row["launches_in_motion_lab"] = lab_launches[row["kernel"]]
        elif row["kernel"] in TRAIN_KERNELS:
            row["launches_per_train_step"] = train_by_site[(row["kernel"], row["site"])]
        elif row["kernel"] in OPT_IN_KERNELS:
            row["launches_per_opt_in_step"] = opt_in_per_step[row["site"]]
        else:
            row["launches_per_denoise_step"] = per_step[row["site"]]
            row["launches_in_pipeline"] = by_site[row["site"]]

    for name, site in TC_REPORT_SITES:
        r = next(r for r in rows if (r["kernel"], r["site"]) == (name, site))
        log(f"{name} at {site} {tuple(r['shape'])}, bf16 on the tensor cores: "
            f"{r['ms']:.3f} ms, {r['tflops']:.1f} TFLOP/s, "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound ({r['bound_ms']:.4f} ms, "
            f"{r['bound_by']}); library {r['library_ms']:.3f} ms")
    report = kernel_report(per_kernel, loop_launches, pipe_launches, wide_launches,
                           train_launches, opt_in_launches, lab_launches)
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"card": smi, "build_s": build_s, "script_s": time.time() - t0,
                       "mma_build": mma_build, "sites": rows, "slice": slice_stats,
                       "pipeline": pipe_stats, "train": train_stats,
                       "opt_in_slice": opt_in_stats, "motion_lab": lab_rows, **report},
                      f, indent=1)
    print(json.dumps(report))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
