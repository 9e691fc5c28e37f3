"""Drive the PyTorch/H100 port (imagine360_tpu_torch) once on one card.

    python3 chip_smoke.py [--out DIR]

Phases, each fatal on failure:
  0. card, power limit and versions;
  1. build the attention kernels from imagine360_tpu_torch/csrc with nvcc,
     and the threaded host library from imagine360_tpu_torch/native/remap.cc
     with g++ (its build time is logged);
     every bf16 kernel of K1, K2, K3, K5a, K6a and K6b (the `mma_kernel`s on
     the body of csrc/attn_mma.cuh), of K4, L1 and L3 (on the tile of
     csrc/frame_mma.cuh), of L2 (csrc/motion_fused.cu), of the wide K1 and
     K2 (on the tile of csrc/attn_mma_wide.cuh), of K5b and K5c (on the
     backward tiles of csrc/attn_mma_bwd.cuh) and of K7
     (csrc/dense_matmul.cu) has HMMA instructions in its SASS (cuobjdump) and
     0 spill bytes in the ptxas report; the wgmma kernels of K1, K2, K5a
     and K6a (csrc/attn_wgmma.cuh), of K3, K6a and K6b (the biased D = 32
     body of csrc/attn_wgmma_bias.cuh in its three row layouts), of K7
     (csrc/dense_matmul.cu) and of K5b and K5c (csrc/attn_wgmma_bwd.cuh,
     and at D = 32 under a shared bias csrc/attn_wgmma_bwd_bias.cuh; all in
     WGMMA_KERNEL_NAMES) have HGMMA instructions and 0 spill bytes,
     their registers logged;
  2. each kernel against its plain PyTorch version at the production shapes
     of the denoise loop, the VAE (one head of 512), the CLIP text encoder
     (causal -inf bias), the training step (K5a forward with lse, K5b dq,
     K5c dk/dv, K3 with its lse, at 16 frames) and the opt-in kernels (K6a
     on sequence-minor inputs, K6b on folded inputs with a float32 and a
     bfloat16 bias and with its lse, K7 at the projection sites and at one
     ragged shape) and of the motion-attention lab (L1 at two packs, L2 at
     G = 32 under the block-diagonal bias, under a seeded random bias in
     float32 and in bfloat16 and with exp_bf16, L3 at two pack sizes, all at
     the perspective stage-0 motion site), the wide K2 at the SR decode's
     mid-block attention (5 frames of a 72 x 128 latent tile), and K1 with a
     seeded random bias, K1 without one at D = 64 and K2, at ragged sequence
     lengths, also at the wide head dims 200 and 192: in bf16 on every batch
     row,
     max abs error <= min(2e-2, 2**-5 * max|plain|), but at least one bf16
     ulp of max|plain| (bf16_limit), per output (dq, dk, dv
     and K7's unnormalised sums: 2**-7 * max|plain|; a float32 lse: 1e-4);
     in f32 (TF32 off) on the first F32_ROWS batch rows (K7: DENSE_F32_ROWS
     rows), max abs error <= 1e-4 (K7: 1e-5 * max|plain|); with the kernel's time, the plain version's, the
     time of the one PyTorch call that computes the same function
     (F.scaled_dot_product_attention, and its backward through
     torch.autograd.grad for K5b/K5c; F.linear for K7: a yardstick the port
     never calls), for K5b and K5c also that of PyTorch's attention backward
     alone on its own forward's out and lse (the flash one at the sites
     without a bias, the memory-efficient one under the WarpAttn bias:
     `library_bwd_ms`, to set beside K5b + K5c together), and the
     site's bound on this card, and for K1-K4 (the
     wide ones too), K5a-c, K6a, K6b, K7 and L1-L3 (bf16 on the tensor
     cores: every bf16 launch at the site counted in `tc_launches`) the
     TFLOP/s and the share of the bound; K4 at
     all eight motion stages of a denoise step; the bf16 output of K5a, K6a
     and K6b equals its plain version's (float32 probabilities, one rounding
     to bf16) in at least K5A_MATCH of its elements (`match`), which a
     single bf16 rounding of the probabilities does not reach (K3's share,
     whose probabilities are rounded to bf16 as its TPU kernel rounds them,
     is logged where the rule puts it on its wgmma body); K3, K5a, K5b,
     K5c, K6a, K6b and K7 where the rule puts them on a wgmma body also on
     their `mma.sync` body through its C entry (error, `match` and time, in
     turns with the wgmma body's: `mma_ms`; K5b and K5c held to their
     gradient limit), K5a's lse against the plain version's
     (`lse_max_abs_err`), and at the two training sites K5b and K5c run on
     the out and lse of the kernel's forward and of the plain version's,
     their gradients within each other's K5b / K5c limit (`bwd_on_forward`);
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
     a plain path, every remap, uint8 conversion and largest rectangle of
     the host stages on the host library (native.calls(): 0 on numpy), SAM's
     resize and preprocessing on the card, the host stages' split (grids,
     remaps, rectangles, resizes; SAM resize, preprocess, encoder) logged,
     and the outputs are written and read back;
  6. the training step: make_train_step on full_dual_config at full width
     and depth (bf16 modules, float32 master weights and AdamW moments,
     remat on, TRAIN_VIEWS views x TRAIN_FRAMES frames), seeded random
     weights, make_dual_batch at production shapes, 1 warm + 2 timed steps;
     the loss and the gradient norm are finite, every parameter got a
     gradient and moved, K3 (with lse), K5a, K5b, K5c, K1 and K4 launched,
     K2 did not, and no attention call took a plain path; every K5b and K5c
     launch on a wgmma body (TRAIN_BWD_WGMMA a step), the WarpAttn ones
     (D = 32, a bias; TRAIN_BWD_WGMMA_BIAS) on the biased one, none on
     `mma.sync`, every K3 launch on its wgmma body;
  7. the opt-in path: compute_ip and 2 CFG steps of the same loop with
     SamplerConfig(solver="dpmpp_2m") under configure(attn_v2=True,
     pallas_dense=True), full width and depth, bf16: the latents are finite,
     K6a and K7 launched, K2 did not, no call took a plain path, and the
     config is the default again after the block, every K7 launch on its
     wgmma GEMM; then K6b through its own entry point on the loop's WarpAttn
     masks (bfloat16, r2, r4 and r8, both directions) against its plain
     version, every launch on its wgmma body;
  8. the motion-attention lab: ops/motion_lab.py:run_lab at the eight
     full-width motion sites of full_dual_config (every stage of both
     branches, 16 frames, 8 heads, bf16): K4 and every pack of L1, L2 and L3
     that fits a site, each against K4's plain version and the K4 kernel
     (the phase-2 limit; the exp_bf16 variant 5e-2) and timed beside K4, the
     library call and the site's bound; every variant launched, at least one
     of each kernel at every site, every K4 and L1-L3 launch on the tensor
     cores, no call on a plain path;
  9. the SR stage's decode: the temporal-decoder VAE (VAEConfig(), bf16,
     seeded random weights), first on a small video against the same
     weights in float32 on the CPU (SR_REL_TOL of the output's largest
     element), then through tiled_chunked_decode on the latents of 16 frames
     of a 2x SR frame of the 512 x 1024 pano with the enhancer's 32-px
     circular pad
     (1024 x 2112 px: [16, 4, 128, 264]), tiles of 72 x 128 latents, overlap
     0.25, 5-frame chunks (3 x 3 tiles x 4 chunks = 36 decoder calls), the
     pad cropped, then wavelet_color_fix against a 2x bilinear upsample of a
     512 x 1024 source; the frames are finite, in [0, 1] and of the right
     shape, the mid-block attention took the wide K2 (SR_WIDE_LAUNCHES) and
     nothing else, no call on a plain path;
 10. the SR stage with the pano engine: Video360Enhancer on phase 5's 16
     frames of 512 x 1024 with the refiner and VAE that sr/cli.py builds
     (build_sr_modules: full_unet_config, VAEConfig(), bf16, seeded
     weights; the default EnhancerConfig: 2x, 4 of 15 steps from
     noise_aug 250, SDE, 32-px pads, 5-frame chunks, 72 x 128 tiles, colour
     fix): seconds of each stage (each ending in a synchronize), s/SR-clip,
     peak memory, launches by kernel and shape; the frames are
     [16, 1024, 2048, 3], finite, in [0, 1] and not flat, K1, K2 and K4
     launched at every SR site of SR_ENGINE_SITES, the wide K2 40 times
     (the encoder's 4 chunks and the decoder's 36 tile chunks), nothing
     else, no call on a plain path; then sr.cli.main --tiny on the card on a
     small .npy clip, its output read back;
 11. the same with the V2V engine (V2VConfig(), ControlledV2VUNet): K1 and
     K2 at its sites, no K4;
 12. the rest at full width: geometry/cubemap.py e2c of phase 5's 16 output
     frames to faces of 256 and c2e back on the card (interior median error
     under CUBE_MEDIAN_TOL; PSNR and SSIM of the round trip logged);
     feathered_replace of phase 5's output over its pano input under its
     masks on the card against the CPU (float32, TF32 off, FEATHER_TOL);
     entry()'s full-width forward (full_dual_config, bf16, seeded random
     weights) under profile_trace (a trace is written), every K1-K4
     launched, all on the tensor cores, no plain path; the same forward
     under disable_warp (K3 never, every other launch as before) and under
     pano_only (no K3, a part of the full forward's launches), outputs
     finite.
 13. the multi-device path (parallel/mesh.py) on this one card: a
     world-size-1 NCCL group through init_from_config (use_mesh: on; the
     NCCL version is logged); the rule of the pano rows logged (at world 1
     they shard: every stage height divides 1); phase 4's loop on phase 4's
     weights and inputs under the mesh (geometry rows and views cut per
     rank, the WarpAttn keys all-gathered, the pano's rows sharded: halo
     convs, merged GroupNorm statistics, gathered keys, the pano gathered at
     the head; the latents gathered at the end), its halo and gather
     collectives counted: its latents within
     bf16_limit(max|phase 4's|) of phase 4's, its launches per step
     by kernel equal to phase 4's, no plain path, s/step and peak logged;
     one training forward and backward of phase 6's configuration without
     and with the group from the same weights, batch and draws, before any
     optimizer step: loss and global gradient norm within 2**-7 of each
     other, every gradient, the loss and the gradient of every gathered
     tensor all-reduced through NCCL, the halo rows' gradients sent back,
     the same launches; then K1-K4 (K3 under a bias that is a row block of
     a larger one) and K5a-c at the per-shard shapes of a 2- and a 4-rank
     mesh, the perspective views' and the pano rows' (SHARD_SITES), each
     against its plain version as in phase 2.

Phase 2 also holds the SR sites (SITES `sr_*`): K2 at 33792, 8448 and 2112
tokens, K1 at the cross-attention and the V2V temporal transformer, K4 at
HW = 33792 and 8448, the wide K2 at the encoder's (5, 33792, 33792, 1, 512);
where the float32 logits of all rows do not fit, against the plain version
on the (batch, head) rows of SR_SUBSETS.

In phases 2, 4-13 every bf16 launch of K1-K4, K5a-c, K6a, K6b, K7 and L1-L3
took the tensor cores (`tc_launches` = launches: the wide K1 and K2 in
phases 5, 9-11, K4's in phases 4-7 and 10, K5b's and K5c's in phase 6, K6a's,
K6b's and K7's in phase 7, L1's, L2's and L3's in phases 2 and 8 included);
in phase 3 (float32) none did, the wide ones included. Every K1, K2, K3,
K5a, K5b, K5c, K6a, K6b and K7 launch that its rule assigns to its wgmma
body (kernels.wgmma_route: bf16, D = 64, no bias; K1 with more than 32
queries and 128 keys; K6a with Sq and Sk multiples of 8; K5c with Sq a
multiple of 4; kernels.bwd_bias_wgmma_route: K5b and K5c at D = 32 under a
bias shared by every row, its rows multiples of 16 bytes: every WarpAttn
launch of phases 6 and 13; kernels.folded_wgmma_route: K6b at D = 32 with a bias row
of a multiple of 16 bytes; kernels.shared_bias_wgmma_route: K3 at D = 32,
the same bias rows: every WarpAttn launch in phases 4-6, 12 and 13;
kernels.flash_t_bias_wgmma_route: K6a at D = 32 under a bias shared by
every row, Sq and Sk multiples of 8: every WarpAttn launch of phase 7;
kernels.dense_wgmma_route: K7 with nn.Linear's weight, K and M multiples of
8) took it: `wgmma_launches` equals the rule's count by shape
(shape_routed) in phases 4-13, and at each phase-2 site all or none of its
launches, as the rule says.

The last three lines are the JSON kernel list (K1, K2, K5a, K5b, K5c, K6a,
K6b and K7 with their launches and numbers by body under `bodies`; K5b and
K5c also with `library_bwd_ms`), the card's name and power
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
# float32 or bfloat16 bias, gives 99.4-99.8% at its sites on the mma.sync
# body (scripts/torch_frame_folded_check.py; emulated in
# tests/test_torch_frame_folded_mma.py), and its wgmma body, with the logit
# and the bias in one FFMA, is held to the same share (emulated in
# tests/test_torch_wgmma_dense_folded.py). K5b and K5c on their wgmma body,
# with dS (and P) split, keep 99.7-99.8% of dq and of dk and dv together in
# the CPU emulation, 57-59% with them rounded once or their lo products left
# out (tests/test_torch_wgmma_bwd.py); on an H100 both bodies keep
# 99.0-99.7% at the routed sites. At the WarpAttn sites (D = 32 under the
# bias, the biased wgmma body) the emulation keeps it too
# (tests/test_torch_wgmma_bwd_warp.py). They are held to the share where the
# rule gives them a wgmma body, which is every model site.
# K3 is not held to it: its TPU kernel rounds P to the inputs' bf16 before
# P·V, and so do its plain version (the normalised P) and both its bodies
# (the unnormalised P), so their outputs part at that rounding: the CPU
# emulation of its wgmma body keeps 49-51% of the plain version's bits
# (56-59% with P split, tests/test_torch_wgmma_warp.py). Its share is
# logged (MATCH_LOGGED), its limit is the bf16 one
K5A_MATCH = 0.98
MATCH_KERNELS = ("flash_attention_lse", "flash_attention_t", "shared_bias_attention_folded",
                 "flash_bwd_dq", "flash_bwd_dkv")
MATCH_LOGGED = ("shared_bias_attention", "shared_bias_attention_lse")
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
    # ragged query and key tails at D = 64 without a bias: the wgmma body's
    ("tiny_attention", "ragged_d64", (64, 333, 1000, 5, 64)),
    ("tiny_attention", "vae_pers_encode", (80, 1024, 1024, 1, 512)),
    ("mh_flash_attention", "pano_spatial_s0", (32, 8192, 8192, 5, 64)),
    ("mh_flash_attention", "pano_spatial_s1", (32, 2048, 2048, 10, 64)),
    ("mh_flash_attention", "ragged", (4, 1000, 3001, 5, 64)),
    # the same at D = 40: flash_tile_mma, which keeps K2's launches off the rule
    ("mh_flash_attention", "ragged_d40", (4, 1000, 3001, 5, 40)),
    ("mh_flash_attention", "vae_pano_encode", (16, 8192, 8192, 1, 512)),
    ("mh_flash_attention", "vae_pano_decode", (4, 8704, 8704, 1, 512)),
    # the SR decode's mid-block attention: 5 frames of a 72 x 128 latent tile
    ("mh_flash_attention", "sr_temporal_decode", (5, 9216, 9216, 1, 512)),
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
    # the other K7 shapes of a phase-7 step: pano s1, pers s2 and both s3
    ("dense_matmul", "dense_pano_s1", (65536, 640, 640)),
    ("dense_matmul", "dense_pers_s2", (40960, 1280, 1280)),
    ("dense_matmul", "dense_pers_s3", (10240, 1280, 1280)),
    ("dense_matmul", "dense_pano_s3", (4096, 1280, 1280)),
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
    # the SR stage (phases 10 and 11): 16 frames of a 2x SR of the 512 x 1024
    # pano with its 32-px pads, latents 128 x 264, so 33792, 8448, 2112 and
    # 528 tokens at stages 0-3; spatial self-attention (both engines), the
    # pano engine's IP cross-attention (64 of its 77 context tokens) and
    # motion modules, the V2V engine's text cross-attention and temporal
    # transformer (its 16 frames at each location), the VAE encoder's
    # mid-block attention (5-frame chunks)
    ("mh_flash_attention", "sr_spatial_s0", (16, 33792, 33792, 5, 64)),
    ("mh_flash_attention", "sr_spatial_s1", (16, 8448, 8448, 10, 64)),
    ("mh_flash_attention", "sr_spatial_s2", (16, 2112, 2112, 20, 64)),
    ("tiny_attention", "sr_pano_ip_cross_s0", (16, 33792, 64, 5, 64)),
    ("tiny_attention", "sr_text_cross_s0", (16, 33792, 77, 5, 64)),
    ("tiny_attention", "sr_v2v_temporal_s0", (33792, 16, 16, 5, 64)),
    ("frame_attention", "sr_motion_s0", (1, 16, 33792, 320, 8)),
    ("frame_attention", "sr_motion_s1", (1, 16, 8448, 640, 8)),
    ("mh_flash_attention", "sr_vae_encode", (5, 33792, 33792, 1, 512)),
    # the rest of K3's launches of a denoise step: the other directions and
    # the decoder's sites, whose stages are twice as wide (models/dual.py).
    # Appended last: phase 2 draws every site's inputs from one seeded
    # generator in this order, so the sites above keep the inputs they had
    # before these were added
    ("shared_bias_attention", "warp_r4_pers_q", (32, 1280, 512, 20, 32)),
    ("shared_bias_attention", "warp_r8_pers_q", (32, 320, 128, 40, 32)),
    ("shared_bias_attention", "warp_r2_pano_q_h20", (32, 2048, 5120, 20, 32)),
    ("shared_bias_attention", "warp_r2_pers_q_h20", (32, 5120, 2048, 20, 32)),
    ("shared_bias_attention", "warp_r4_pano_q_h40", (32, 512, 1280, 40, 32)),
    ("shared_bias_attention", "warp_r4_pers_q_h40", (32, 1280, 512, 40, 32)),
    # the rest of K5b's and K5c's WarpAttn launches of a training step, so
    # that phase 2 times all ten of its shapes (appended last, as above)
    ("flash_bwd_dq", "train_warp_r2_pano_q_h20", (16, 2048, 5120, 20, 32)),
    ("flash_bwd_dq", "train_warp_r2_pers_q_h20", (16, 5120, 2048, 20, 32)),
    ("flash_bwd_dq", "train_warp_r4_pano_q", (16, 512, 1280, 20, 32)),
    ("flash_bwd_dq", "train_warp_r4_pers_q", (16, 1280, 512, 20, 32)),
    ("flash_bwd_dq", "train_warp_r4_pano_q_h40", (16, 512, 1280, 40, 32)),
    ("flash_bwd_dq", "train_warp_r4_pers_q_h40", (16, 1280, 512, 40, 32)),
    ("flash_bwd_dq", "train_warp_r8_pers_q", (16, 320, 128, 40, 32)),
    ("flash_bwd_dkv", "train_warp_r2_pano_q_h20", (16, 2048, 5120, 20, 32)),
    ("flash_bwd_dkv", "train_warp_r2_pers_q_h20", (16, 5120, 2048, 20, 32)),
    ("flash_bwd_dkv", "train_warp_r4_pano_q", (16, 512, 1280, 20, 32)),
    ("flash_bwd_dkv", "train_warp_r4_pers_q", (16, 1280, 512, 20, 32)),
    ("flash_bwd_dkv", "train_warp_r4_pano_q_h40", (16, 512, 1280, 40, 32)),
    ("flash_bwd_dkv", "train_warp_r4_pers_q_h40", (16, 1280, 512, 40, 32)),
    ("flash_bwd_dkv", "train_warp_r8_pers_q", (16, 320, 128, 40, 32)),
]
# (batch rows, heads) of an SR site that the plain version is held to: its
# float32 logits of all rows do not fit (33792**2 * 4 B = 4.6 GB a head), so
# the first rows and heads of the kernel's output (which computes each
# (row, head) on its own) are compared, in bf16 and in f32
SR_SUBSETS = {"sr_spatial_s0": (1, 1), "sr_spatial_s1": (1, 10), "sr_vae_encode": (1, 1)}
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
# K6b's mma.sync body is also timed at these rows per bias tile (at most 2;
# the wgmma body takes its own four)
FOLDED_T_ROWS = (1, 2)
# operations per (batch, head, query, key, head-dim element): two products
# forward, three in the dq kernel, four in the dk/dv kernel
OPS_PER_ELEMENT = {"flash_bwd_dq": 6.0, "flash_bwd_dkv": 8.0}
WIDE_ABOVE = 160   # head dims 161..512 take the wide kernels
# K1, K2, K3, K5a, K6a and K6b (csrc/attn_mma.cuh), the wide K1 and K2
# (csrc/attn_mma_wide.cuh), K4, L1 and L3 (csrc/frame_mma.cuh), L2
# (csrc/motion_fused.cu) and K5b and K5c (csrc/attn_mma_bwd.cuh) run bf16 on
# the tensor cores at every head dim they take, K7 (csrc/dense_matmul.cu) at
# every shape; K3 with its lse is the same kernel
TC_KERNELS = ("tiny_attention", "mh_flash_attention", "shared_bias_attention",
              "frame_attention", "flash_attention_lse", "flash_bwd_dq", "flash_bwd_dkv",
              "flash_attention_t", "shared_bias_attention_folded", "dense_matmul",
              "striped_v2_attention", "fused_motion_attention", "diag_motion_attention")
TC_SITE_KERNELS = TC_KERNELS + ("shared_bias_attention_lse",)
# the sites whose TFLOP/s and share of the bound are logged at the end
TC_REPORT_SITES = (("tiny_attention", "pers_spatial_s0"),
                   ("mh_flash_attention", "pano_spatial_s0"),
                   ("tiny_attention", "vae_pers_encode"),
                   ("mh_flash_attention", "vae_pano_encode"),
                   ("mh_flash_attention", "vae_pano_decode"),
                   ("mh_flash_attention", "sr_temporal_decode"),
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
                   ("flash_bwd_dq", "train_pano_spatial_s1"),
                   ("flash_bwd_dkv", "train_pano_spatial_s1"),
                   ("flash_attention_t", "v2_pano_spatial_s0"),
                   ("dense_matmul", "dense_pers_s0"),
                   ("dense_matmul", "dense_pers_s1"),
                   ("fused_motion_attention", "lab_fused_G32"),
                   ("fused_motion_attention", "lab_fused_G32_random_bias"),
                   ("fused_motion_attention", "lab_fused_G32_exp_bf16"),
                   ("diag_motion_attention", "lab_diag_G16"),
                   ("diag_motion_attention", "lab_diag_G4"),
                   ("striped_v2_attention", "lab_v2_G1_R1"),
                   ("striped_v2_attention", "lab_v2_G2_R8"),
                   ("mh_flash_attention", "sr_spatial_s0"),
                   ("mh_flash_attention", "sr_vae_encode"),
                   ("tiny_attention", "sr_v2v_temporal_s0"),
                   ("frame_attention", "sr_motion_s0"))
# K1 and K2 up to D = 160, K5a and K6a have two bodies: the wgmma one where
# kernels.wgmma_route says so, else flash_tile_mma; K5b and K5c too (the
# backward tiles of attn_mma_bwd.cuh) and a third at D = 32 under a shared
# bias (kernels.bwd_bias_wgmma_route: `wgmma_bias`), K3, K6b and K7 too
# (kernels.shared_bias_wgmma_route, kernels.folded_wgmma_route,
# kernels.dense_wgmma_route); K6a a third at D = 32 under a shared bias
# (kernels.flash_t_bias_wgmma_route: `wgmma_bias`)
TWO_BODY_KERNELS = ("tiny_attention", "mh_flash_attention", "flash_attention_lse",
                    "flash_attention_t", "shared_bias_attention_folded", "dense_matmul",
                    "flash_bwd_dq", "flash_bwd_dkv", "shared_bias_attention")
# the two-body kernels whose `mma.sync` body phase 2 also runs through its C
# entry at the sites the rule gives the wgmma one (mma_body, both_bodies)
SPLIT_BODY_KERNELS = ("flash_attention_lse", "flash_attention_t",
                      "shared_bias_attention_folded", "dense_matmul", "flash_bwd_dq",
                      "flash_bwd_dkv", "shared_bias_attention")
# phase 6: K5b's and K5c's launches a training step on a wgmma body: all of
# them, the pano spatial self-attention of stages 0 and 1 (five each, D = 64)
# and the WarpAttn sites on the biased body (TRAIN_BWD_WGMMA_BIAS: each r2
# and r4 shape once, the r8 ones three times)
TRAIN_BWD_WGMMA = {"flash_bwd_dq": 24, "flash_bwd_dkv": 24}
TRAIN_BWD_WGMMA_BIAS = {"flash_bwd_dq": 14, "flash_bwd_dkv": 14}
# K5a's sites where K5b and K5c run on the kernel's forward (bwd_on_forward)
BWD_ON_FORWARD_SITES = ("train_pano_spatial_s0", "train_pano_spatial_s1")
BODY_SOURCES = {"wgmma": "imagine360_tpu_torch/csrc/attn_wgmma.cuh",
                "mma_sync": "imagine360_tpu_torch/csrc/attn_mma.cuh"}
# ... K3's, K6a's, K6b's, K7's, K5b's and K5c's own
KERNEL_BODY_SOURCES = {
    "shared_bias_attention": {"wgmma": "imagine360_tpu_torch/csrc/attn_wgmma_bias.cuh",
                              "mma_sync": "imagine360_tpu_torch/csrc/attn_mma.cuh"},
    "flash_attention_t": {"wgmma": "imagine360_tpu_torch/csrc/attn_wgmma.cuh",
                          "wgmma_bias": "imagine360_tpu_torch/csrc/attn_wgmma_bias.cuh",
                          "mma_sync": "imagine360_tpu_torch/csrc/attn_mma.cuh"},
    "flash_bwd_dq": {"wgmma": "imagine360_tpu_torch/csrc/attn_wgmma_bwd.cuh",
                     "wgmma_bias": "imagine360_tpu_torch/csrc/attn_wgmma_bwd_bias.cuh",
                     "mma_sync": "imagine360_tpu_torch/csrc/attn_mma_bwd.cuh"},
    "flash_bwd_dkv": {"wgmma": "imagine360_tpu_torch/csrc/attn_wgmma_bwd.cuh",
                      "wgmma_bias": "imagine360_tpu_torch/csrc/attn_wgmma_bwd_bias.cuh",
                      "mma_sync": "imagine360_tpu_torch/csrc/attn_mma_bwd.cuh"},
    "shared_bias_attention_folded": {"wgmma": "imagine360_tpu_torch/csrc/attn_wgmma_bias.cuh",
                                     "mma_sync": "imagine360_tpu_torch/csrc/attn_mma.cuh"},
    "dense_matmul": {"wgmma": "imagine360_tpu_torch/csrc/dense_matmul.cu",
                     "mma_sync": "imagine360_tpu_torch/csrc/dense_matmul.cu"}}
WIDE_SOURCES = {
    "tiny_attention": "imagine360_tpu_torch/csrc/tiny_attention_wide.cu",
    "mh_flash_attention": "imagine360_tpu_torch/csrc/mh_flash_wide.cu",
}
# phase 5's launches of the wide kernels: the VAE mid-block attention, K1 on
# the 320 view-frames in 4 chunks of 80 and K2 on the pano when encoding, K2
# on the 4 chunks of 4 frames when decoding
PIPELINE_WIDE = {"tiny_attention": 4, "mh_flash_attention": 5}
# phase 9: the SR decode of 16 frames of a 2x SR frame of the 512 x 1024 pano
# with the enhancer's 32-px circular pad on each side, its tiles, overlap and
# chunks (imagine360_tpu/sr/enhance.py:26-36, 78-80, 113-122)
SR_FRAMES, SR_SOURCE_HW, SR_UP, SR_PAD_PX = 16, (512, 1024), 2, 32
SR_TILE_HW, SR_OVERLAP, SR_CHUNK = (72, 128), 0.25, 5
# the mid-block attention's launches there: wide K2 on each of the 3 x 3
# tiles, three chunks of 5 frames and one of 1
SR_WIDE_LAUNCHES = {("mh_flash_attention", (5, 9216, 9216, 1, 512)): 27,
                    ("mh_flash_attention", (1, 9216, 9216, 1, 512)): 9}
# the bf16 temporal decoder on the card against float32 on the CPU, relative
# to the output's largest element: bf16 activations through some 50
# convolutions (1.5% in bf16 on the CPU at the phase's small input)
SR_REL_TOL = 5e-2


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# the tensor-core kernels and their instantiations: K1 6 head-dim buckets x
# 1, 2 or 4 warps; K2, K3, K5a, K5b, K5c and K6a 6 buckets; K6b 6 buckets x
# 2 bias dtypes; K4, L1 and L3 10 head dims padded to 16, 32, ..., 160; L2 8
# buckets (16, 32, 48, 64, 80, 96, 128, 160) x 2 bias dtypes; the wide K1
# and K2 2 buckets (256, 512); K7 2 weight layouts
MMA_KERNEL_NAMES = {"tiny_attention_mma_kernel": 18, "mh_flash_mma_kernel": 6,
                    "tiny_attention_wide_mma_kernel": 2, "mh_flash_wide_mma_kernel": 2,
                    "shared_bias_mma_kernel": 6, "flash_lse_mma_kernel": 6,
                    "flash_bwd_dq_mma_kernel": 6, "flash_bwd_dkv_mma_kernel": 6,
                    "flash_t_mma_kernel": 6, "dense_matmul_mma_kernel": 2,
                    "frame_attention_mma_kernel": 10, "shared_bias_folded_mma_kernel": 12,
                    "fused_motion_mma_kernel": 32, "diag_motion_mma_kernel": 10,
                    "striped_v2_mma_kernel": 10}
# the wgmma kernels of K1, K2, K5a and K6a (csrc/attn_wgmma.cuh, bf16 at
# D = 64): one each; K6b's (csrc/attn_wgmma_bias.cuh, folded rows) one per
# bias dtype, K3's (natural rows) and K6a's (sequence-minor) on the same
# body one each; K7's (csrc/dense_matmul.cu) one; K5b's and K5c's
# (csrc/attn_wgmma_bwd.cuh, and under a bias csrc/attn_wgmma_bwd_bias.cuh)
# one each; their SASS has HGMMA (warpgroup products), which no HMMA count
# sees
WGMMA_KERNEL_NAMES = {"tiny_attention_wgmma_kernel": 1, "mh_flash_wgmma_kernel": 1,
                      "flash_lse_wgmma_kernel": 1, "flash_t_wgmma_kernel": 1,
                      "shared_bias_folded_wgmma_kernel": 2, "dense_matmul_wgmma_kernel": 1,
                      "flash_bwd_dq_wgmma_kernel": 1, "flash_bwd_dkv_wgmma_kernel": 1,
                      "shared_bias_wgmma_kernel": 1, "flash_t_bias_wgmma_kernel": 1,
                      "flash_bwd_dq_bias_wgmma_kernel": 1, "flash_bwd_dkv_bias_wgmma_kernel": 1}


def check_mma_build(kernels, lib):
    """{kernel: (registers, spill bytes, HMMA or HGMMA instructions)} of
    every tensor-core kernel of K1, K2 (the wide ones too), K3, K4, K5a-c,
    K6a, K6b, K7 and L1-L3, from the ptxas report kept beside the library
    and from `cuobjdump -sass` of it: the `mma.sync` kernels of
    MMA_KERNEL_NAMES count HMMA, the `wgmma` kernels of WGMMA_KERNEL_NAMES
    HGMMA. Fails on a spill, a kernel with none of its instruction, or fewer
    instantiations of one than the tables list. Logs what ptxas says about
    the wgmma kernels' products (a serialised wgmma is slower, not wrong)."""
    names = {**MMA_KERNEL_NAMES, **WGMMA_KERNEL_NAMES}
    op = lambda f: "HGMMA" if any(n in f for n in WGMMA_KERNEL_NAMES) else "HMMA"
    report, fn = {}, None
    for line in lib.with_suffix(".ptxas.txt").read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            # [registers, spill bytes (stores + loads), HMMA or HGMMA instructions]
            report[fn] = [None, nums[1] + nums[2], 0]
        elif fn and "Used" in line and "registers" in line and fn in report:
            report[fn][0] = int(line.split("Used")[1].split()[0])
        elif "wgmma.mma_async" in line or "setmaxnreg" in line:
            log(f"  ptxas: {line.strip()}")
    report = {f: r for f, r in report.items() if any(n in f for n in names)}
    cuobjdump = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn in report and op(fn) in line:
            report[fn][2] += 1
    found = {n: sum(n in f for f in report) for n in names}
    if any(found[n] < want for n, want in names.items()):
        raise SystemExit(f"FAIL: tensor-core kernels in the ptxas report {found}, "
                         f"want {names}")
    for name in names:
        mine = [r for f, r in report.items() if name in f]
        regs = sorted(r[0] for r in mine)
        log(f"  {len(mine)} {name}: registers {regs[0]}-{regs[-1]}, spill bytes "
            f"{max(r[1] for r in mine)}, {op(name)} instructions {min(r[2] for r in mine)}-"
            f"{max(r[2] for r in mine)}")
    bad = {f: r for f, r in report.items() if r[1] != 0 or r[2] == 0}
    if bad:
        raise SystemExit(f"FAIL: tensor-core kernels spilling or without HMMA / HGMMA: {bad}")
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


def wgmma_expected(kernels):
    """{K1, K2, K3, K5a-c, K6a, K6b, K7: launches since the counts were
    zeroed at the shapes whose bf16 calls their rule sends to a wgmma body
    (shape_routed: bias-free K1, K2, K5a-c, K6a at D = 64; K3, K5b, K5c
    and K6a at D = 32 under the WarpAttn bias; K6b under a bf16 bias, the
    dtype of the loop's masks; K7 with nn.Linear's weight)}."""
    shapes = kernels.shape_counts()
    return {name: sum(n for (kn, shape), n in shapes.items()
                      if kn == name and shape_routed(kernels, name, shape))
            for name in kernels.wgmma_counts()}


def check_tensor_cores(phase, kernels):
    """Every launch of K1, K2, K3, K5a-c, K6a and K7 since the counts were
    zeroed took the tensor cores, the wide (D > 160) ones of K1 and K2
    included: tc_launches equals launches; and every K1, K2, K3, K5a-c, K6a
    and K7 launch that its rule assigns to a wgmma body took it (bf16
    phases: no model launch of K1 or K5a carries a bias, K3's and K6a's
    launches at D = 32 are the WarpAttn sites, each under one float32 bias
    shared by every row, every K7 launch has nn.Linear's weight, so the
    shape decides): wgmma_launches equals `wgmma_expected`. Returns the
    tensor-core launches."""
    counts, tc = kernels.counts(), kernels.tc_counts()
    want = {n: counts[n]["launches"] for n in TC_KERNELS}
    wg, want_wg = kernels.wgmma_counts(), wgmma_expected(kernels)
    log(f"  tensor-core launches {json.dumps(tc)} (launches {json.dumps(want)}); on the wgmma "
        f"body {json.dumps(wg)} (by the rule {json.dumps(want_wg)})")
    if tc != want:
        raise SystemExit(f"FAIL: {phase}: tensor-core launches {tc}, want {want}")
    if wg != want_wg:
        raise SystemExit(f"FAIL: {phase}: wgmma launches {wg}, the rule assigns {want_wg}")
    return tc


# the kernels with a third, biased D = 32 body beside a D = 64 wgmma one
BIAS_BODY_KERNELS = ("flash_attention_t", "flash_bwd_dq", "flash_bwd_dkv")


def path_launches(kernels):
    """{wrapper: launches} since the counts were zeroed, with the launches
    of the two-body kernels' wgmma bodies also under "<wrapper>_wgmma", and
    those of K6a's, K5b's and K5c's biased one (their D = 32 shapes that
    the rule admits, which check_tensor_cores holds the wgmma launches to)
    also under "<wrapper>_wgmma_bias"."""
    out = {k: c["launches"] for k, c in kernels.counts().items()}
    out.update({f"{k}_wgmma": n for k, n in kernels.wgmma_counts().items()})
    for name in BIAS_BODY_KERNELS:
        out[f"{name}_wgmma_bias"] = sum(
            n for (kn, shape), n in kernels.shape_counts().items()
            if kn == name and shape[4] == kernels.BIAS_WGMMA_HEAD_DIM
            and shape_routed(kernels, kn, shape))
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def site_bias(Sq, Sk, gen, dev, shard=None):
    """A seeded uniform [-1, 1) float32 bias [Sq, Sk]; with `shard` (W, r),
    rank r's rows of a bias of W * Sq rows, as a rank of a W-rank mesh
    keeps the perspective-query rows of a WarpAttn bias (a view at a row
    offset of the larger matrix)."""
    W, r = shard or (1, 0)
    return (torch.rand(W * Sq, Sk, generator=gen, device=dev) * 2 - 1)[r * Sq:(r + 1) * Sq]


def site_call(kernels, name, site, shape, gen, dev, dtype=torch.bfloat16, shard=None):
    """(kernel thunk, plain thunk, library thunk) on random inputs of this
    shape and dtype. The library thunk is the one PyTorch call that computes
    the same function, F.scaled_dot_product_attention on [B, H, S, D] views
    of the same tensors (for K4 with the frame axis folded out as the
    sequence); it is timed as a yardstick and used nowhere in the port.
    `shard` (W, r): a WarpAttn site's bias is rank r's rows of a W-rank
    mesh (site_bias)."""
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
        return train_site_call(kernels, name, site, shape, rnd, gen, dev, dtype, shard)
    if name == "shared_bias_attention":
        q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D)
        if site == CLIP_SITE:
            bias = torch.full((Sq, Sk), float("-inf"), device=dev).triu(1)
        else:
            bias = site_bias(Sq, Sk, gen, dev, shard)
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
    kern = lambda: fn(q, k, v, *bias, **kw)
    library = lambda: sdpa(heads_first(q), heads_first(k), heads_first(v), attn_mask=mask
                           ).transpose(1, 2).reshape(B, Sq, H * D)
    if site not in SR_SUBSETS:
        return kern, lambda: plain(q, k, v, *bias, **kw), library
    rows, n_heads = SR_SUBSETS[site]
    sub = lambda x: x[:rows, :, :n_heads * D]
    return (lambda: sub(kern()),
            lambda: plain(sub(q), sub(k), sub(v), *bias, scale=D ** -0.5, heads=n_heads),
            lambda: sub(library()))


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


def train_site_call(kernels, name, site, shape, rnd, gen, dev, dtype, shard=None):
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
        bias = site_bias(Sq, Sk, gen, dev, shard)[None, None]
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


def site_ops(name, shape, site=""):
    """Operations of one call at this shape: 4*Sq*Sk*D per (batch, head)
    for the attention kernels (two products, a multiply and an add each; 6
    for K5b's three products, 8 for K5c's four), 2*N*K*M for K7, and
    4*F*F*C per (batch row, location) for K4 and its lab variants; L2 at a
    lab site of phase 2 (pack size G) attends over G*F tokens under a bias
    that may tie any two of them, so 4*(G*F)**2*D per (batch row, pack,
    head), G times K4's."""
    if name == "frame_attention" or name in LAB_KERNELS:
        B, F, HW, C, heads = shape
        G = LAB_PARAMS[site]["G"] if name == "fused_motion_attention" and site else 1
        return 4.0 * B * HW * G * F * F * C
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
        # computes off the diagonal blocks are its own doing (its own
        # operations, site_ops with the site, are under its bytes' time at
        # every pack of the lab); its bias is an input, read once in its own
        # dtype
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


def bf16_limit(peak):
    """min(BF16_TOL, BF16_REL x peak), but never less than one bf16 ulp of
    `peak` (2**(floor(log2 peak) - 7)): from a peak of 4 on, BF16_TOL is
    below that ulp, and a result exact in float32 that falls on the other
    side of one rounding than the plain version's would fail it. Below 4
    the ulp is under the other two and the limit is theirs."""
    limit = min(BF16_TOL, BF16_REL * peak)
    return max(limit, 2.0 ** (math.floor(math.log2(peak)) - 7)) if peak > 0 else limit


def bf16_tol(name, peak):
    """The bf16 limit of a kernel's output whose plain version peaks at
    `peak`. The gradients are unnormalised sums, far below unit scale at the
    long sites, so they are held to their own size alone."""
    if name in OPS_PER_ELEMENT:      # K5b, K5c
        return GRAD_BF16_REL * peak
    if name == "dense_matmul":
        return DENSE_BF16_REL * peak
    return bf16_limit(peak)


def extra_times(kernels, name, site, shape, gen, dev, iters, shard=None):
    """What phase 2 times beside the kernel alone. K6a: the whole site as
    the model runs it, dot_product_attention on [B, S, H, D] tensors under
    attn_v2, so with the three copies to [B, H, D, S] and the permute back
    (`with_permutes_ms`). K6b at its first site: its mma.sync body
    (mma_body) at each of FOLDED_T_ROWS folded rows per bias tile
    (`mma_ms_by_t_rows`). K5b and K5c: PyTorch's attention backward alone
    (`library_bwd_ms`, library_bwd), under the site's bias (`shard` as
    site_call takes it) at the WarpAttn sites."""
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
        return {"mma_ms_by_t_rows": {str(t): cuda_ms(
            lambda: mma_body(kernels, name, q, k, v, D ** -0.5, bias=bias, t_rows=t), iters)
            for t in FOLDED_T_ROWS}}
    if name in OPS_PER_ELEMENT:
        bias = site_bias(shape[1], shape[2], gen, dev, shard) if site_has_bias(site) else None
        return {"library_bwd_ms": cuda_ms(library_bwd(shape, gen, dev, bias), iters)}
    return {}


def library_bwd(shape, gen, dev, bias=None):
    """K5b's and K5c's backward-only yardstick: PyTorch's attention
    backward (the aten op under F.scaled_dot_product_attention's gradient)
    on [B, H, S, D] views of seeded bf16 q, k, v and dO, fed by its own
    forward's out and lse: the flash one without a bias, under a bias
    [Sq, Sk] the memory-efficient one (the flash one takes no bias), with
    the bias in bf16 broadcast over batch rows and heads and no gradient
    asked for it. A thunk returning (dq, dk, dv) in one call; timed, never
    called by the port."""
    B, Sq, Sk, H, D = shape
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).bfloat16()
    t = lambda x: x.transpose(1, 2)
    q, k, v, do = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D), rnd(B, Sq, H, D)
    if bias is not None:
        mask = bias.bfloat16().expand(B, H, Sq, Sk)
        out, lse, seed, offset = torch.ops.aten._scaled_dot_product_efficient_attention(
            t(q), t(k), t(v), mask, True, scale=D ** -0.5)
        return lambda: torch.ops.aten._scaled_dot_product_efficient_attention_backward(
            t(do), t(q), t(k), t(v), mask, out, lse, seed, offset, 0.0,
            [True, True, True, False], scale=D ** -0.5)[:3]
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(t(q), t(k), t(v), 0.0, False, False,
                                                             scale=D ** -0.5)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        t(do), t(q), t(k), t(v), out, lse, cum_q, cum_k, max_q, max_k, 0.0, False, seed, offset,
        scale=D ** -0.5)


def site_has_bias(site):
    """Whether a phase-2 site's call carries a bias: K1's `_bias` sites and
    the WarpAttn sites of K3, K5b, K5c and K6a."""
    return site.endswith("_bias") or "warp" in site


def site_bias_dtype(site):
    """The dtype of K6b's bias at a phase-2 site."""
    return torch.bfloat16 if "bf16_bias" in site else torch.float32


def shape_routed(kernels, name, shape, bias=None, bias_dtype=torch.bfloat16):
    """Whether the rule of a two-body kernel sends bf16 calls at `shape` (as
    shape_launches counts it; fresh, so 16-byte-aligned, tensors) to a
    wgmma body: K1, K2, K5a-c and K6a with a bias or without (`bias`; None:
    as the models call them, K5b, K5c and K6a at D = 32 under the WarpAttn
    bias shared by every row, the others without), K3 (with or without its
    lse) under its float32 bias, K6b under a bias of `bias_dtype`, K7 with
    nn.Linear's weight."""
    if name == "dense_matmul":
        N, K, M = shape
        return kernels.dense_wgmma_route(torch.bfloat16, K, M, True)
    if name == "shared_bias_attention_folded":
        BH, Sq, Sk, D = shape
        return kernels.folded_wgmma_route(torch.bfloat16, Sk, D, bias_dtype)
    B, Sq, Sk, H, D = shape
    if name.startswith("shared_bias_attention"):
        return kernels.shared_bias_wgmma_route(torch.bfloat16, Sk, D)
    if name == "flash_attention_t" and D == kernels.BIAS_WGMMA_HEAD_DIM:
        return kernels.flash_t_bias_wgmma_route(torch.bfloat16, Sq, Sk, D, bias is not False)
    if name in OPS_PER_ELEMENT and D == kernels.BIAS_WGMMA_HEAD_DIM:
        return kernels.bwd_bias_wgmma_route(name, torch.bfloat16, Sq, Sk, D,
                                            None if bias is False else (0, 0))
    return kernels.wgmma_route(name, torch.bfloat16, Sq, Sk, H, D, bool(bias))


def bwd_inputs(kernels, shape, gen, dev, bias=None):
    """bfloat16 q, k, v, dO [B, S, H, D] of (B, Sq, Sk, H, D) from `gen`
    and the plain forward's lse and delta = rowsum(dO * O) under `bias`
    (None, or float32 [1, 1, Sq, Sk] as at the WarpAttn sites): the
    arguments of K5b and K5c but the bias, as (q, k, v, dO, lse, delta)."""
    B, Sq, Sk, H, D = shape
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).bfloat16()
    q, k, v, do = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D), rnd(B, Sq, H, D)
    out, lse = kernels.flash_attention_lse_plain(q, k, v, bias, scale=D ** -0.5)
    return q, k, v, do, lse, kernels.attention_delta(do, out)


def match_share(name, got, want):
    """The share of a kernel's bf16 outputs equal bit for bit to its plain
    version's: the output without the lse (K5a, K6b), dk and dv together
    (K5c)."""
    if name == "flash_bwd_dkv":
        got, want = (torch.cat([x.flatten() for x in r]) for r in (got, want))
    else:
        got, want = (r[0] if isinstance(r, tuple) else r for r in (got, want))
    return (got == want).float().mean().item()


def mma_body(kernels, name, q, k, v, scale, out=None, lse=None, bias=None, t_rows=None,
             g=None, delta=None):
    """One launch of the `mma.sync` body of K3, K5a, K5b, K5c, K6a, K6b or
    K7 through its C entry, bf16, counted nowhere, into `out` (and `lse`) or
    new tensors: K3 (q [B, Sq, H, D] under `bias` [Sq, Sk]) out, or (out,
    lse) where `lse` is given, K5a (q [B, Sq, H, D], no bias) returns (out,
    lse), K5b and K5c (q [B, Sq, H, D], `bias` None or float32 [1, 1, Sq,
    Sk], the cotangent `g`, the forward's `lse` and `delta`) dq, or (dk,
    dv) into `out` = (dk, dv), K6a
    (q [B, H, D, Sq], `bias` None or [1, 1, Sq, Sk]) out [B, H, Sq, D], K6b
    (q [BH, Sq, D] under
    `bias` [Sq, Sk] of its dtype, `t_rows` rows a block, by default
    kernels.FOLDED_T_ROWS) out, or (out, lse) where `lse` is given, K7 (q =
    x [N, K], k = w [M, K] as nn.Linear stores it; v and scale unused) out
    [N, M]. Views are taken as they are."""
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    if name in ("flash_bwd_dq", "flash_bwd_dkv"):
        B, Sq, H, D = q.shape
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if bias is None else bias.data_ptr(), g.data_ptr(), lse.data_ptr(),
                delta.data_ptr())
        if name == "flash_bwd_dq":
            res = torch.empty_like(q) if out is None else out
            err = lib.i360_flash_bwd_dq(*ptrs, res.data_ptr(), B, Sq, k.shape[1], H, D, 0, 0,
                                        scale, 1, stream)
        else:
            res = (torch.empty_like(k), torch.empty_like(v)) if out is None else out
            err = lib.i360_flash_bwd_dkv(*ptrs, res[0].data_ptr(), res[1].data_ptr(), B, Sq,
                                         k.shape[1], H, D, 0, 0, scale, 1, stream)
    elif name == "dense_matmul":
        (N, K), M = q.shape, k.shape[0]
        out = torch.empty(N, M, device=q.device, dtype=q.dtype) if out is None else out
        err = lib.i360_dense_matmul(q.data_ptr(), k.data_ptr(), out.data_ptr(), N, K, M, 1, K, 1,
                                    stream)
        res = out
    elif name == "shared_bias_attention_folded":
        BH, Sq, D = q.shape
        out = torch.empty_like(q) if out is None else out
        err = lib.i360_shared_bias_attention_folded(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), BH, Sq, k.shape[1], D,
            t_rows or kernels.FOLDED_T_ROWS, scale, 1, int(bias.dtype == torch.bfloat16), stream)
        res = out if lse is None else (out, lse)
    elif name == "shared_bias_attention":
        B, Sq, H, D = q.shape
        out = torch.empty_like(q) if out is None else out
        err = lib.i360_shared_bias_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Sq, k.shape[1], H, D, scale, 1, stream)
        res = out if lse is None else (out, lse)
    elif name == "flash_attention_lse":
        B, Sq, H, D = q.shape
        out = torch.empty_like(q) if out is None else out
        if lse is None:
            lse = torch.empty(B, H, Sq, device=q.device, dtype=torch.float32)
        err = lib.i360_flash_attention_lse(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                                           out.data_ptr(), lse.data_ptr(), B, Sq, k.shape[1],
                                           H, D, 0, 0, scale, 1, stream)
        res = (out, lse)
    else:
        B, H, D, Sq = q.shape
        if out is None:
            out = torch.empty(B, H, Sq, D, device=q.device, dtype=q.dtype)
        res = out
        err = lib.i360_flash_attention_t(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         None if bias is None else bias.data_ptr(),
                                         out.data_ptr(), B, Sq, k.shape[-1], H, D, 0, 0, scale,
                                         1, stream)
    if err != 0:
        raise SystemExit(f"FAIL: {name}'s mma.sync body: launch error {err}")
    return res


def both_bodies(kernels, name, site, shape, gen, dev, iters, shard=None):
    """K3 (with its lse at the `shared_bias_attention_lse` sites), K5a,
    K5b, K5c, K6a, K6b or K7 at a site the rule gives a wgmma body, on fresh
    inputs (a WarpAttn site's bias as site_call makes it, `shard` too): its
    `mma.sync` body (mma_body) against the plain version (max abs error and
    the share of outputs equal bit for bit; K5c over dk and dv; K5b and K5c
    also their limit on these inputs, `mma_tol`), and the time of both
    bodies in turns, mma.sync, wgmma (the wrapper), wgmma, mma.sync."""
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).bfloat16()
    first = lambda r: r[0] if isinstance(r, tuple) else r
    extra = {}
    if name in OPS_PER_ELEMENT:      # K5b, K5c on the plain forward's lse and delta
        B, Sq, Sk, H, D = shape
        scale = D ** -0.5
        bias = site_bias(Sq, Sk, gen, dev, shard)[None, None] if site_has_bias(site) else None
        q, k, v, do, lse, delta = bwd_inputs(kernels, shape, gen, dev, bias)
        args = (q, k, v, bias, do, lse, delta)
        want = getattr(kernels, name + "_plain")(*args, scale=scale)
        wrapper = getattr(kernels, name)
        wrapped = lambda: wrapper(*args, scale=scale)
        body = lambda: mma_body(kernels, name, q, k, v, scale, lse=lse, bias=bias, g=do,
                                delta=delta)
        first = lambda r: torch.cat([x.flatten() for x in r]) if isinstance(r, tuple) else r
        want = first(want)
        extra["mma_tol"] = bf16_tol(name, want.float().abs().max().item())
    elif name == "dense_matmul":
        N, K, M = shape
        x, w = rnd(N, K), rnd(M, K)
        want = kernels.dense_matmul_plain(x, w, linear_layout=True)
        wrapped = lambda: kernels.dense_matmul(x, w, linear_layout=True)
        body = lambda: mma_body(kernels, name, x, w, None, None)
    elif name == "shared_bias_attention_folded":
        BH, Sq, Sk, D = shape
        q, k, v = rnd(BH, Sq, D), rnd(BH, Sk, D), rnd(BH, Sk, D)
        bias = (torch.rand(Sq, Sk, generator=gen, device=dev) * 2 - 1).to(site_bias_dtype(site))
        kw = dict(scale=D ** -0.5, with_lse=site.endswith("_lse"))
        lse = torch.empty(BH, Sq, device=dev) if kw["with_lse"] else None
        want = first(kernels.shared_bias_attention_folded_plain(q, k, v, bias, **kw))
        wrapped = lambda: kernels.shared_bias_attention_folded(q, k, v, bias, **kw)
        body = lambda: mma_body(kernels, name, q, k, v, D ** -0.5, lse=lse, bias=bias)
    elif name.startswith("shared_bias_attention"):
        B, Sq, Sk, H, D = shape
        q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D)
        bias = site_bias(Sq, Sk, gen, dev, shard)
        kw = dict(scale=D ** -0.5, with_lse=name.endswith("_lse"))
        lse = torch.empty(B, H, Sq, device=dev) if kw["with_lse"] else None
        want = first(kernels.shared_bias_attention_plain(q, k, v, bias, **kw))
        wrapped = lambda: kernels.shared_bias_attention(q, k, v, bias, **kw)
        body = lambda: mma_body(kernels, "shared_bias_attention", q, k, v, D ** -0.5, lse=lse,
                                bias=bias)
    else:
        B, Sq, Sk, H, D = shape
        scale = D ** -0.5
        bias = None
        if name == "flash_attention_lse":
            q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D)
        else:
            q, k, v = rnd(B, H, D, Sq), rnd(B, H, D, Sk), rnd(B, H, D, Sk)
            if site_has_bias(site):      # K6a's WarpAttn sites
                bias = (torch.rand(Sq, Sk, generator=gen, device=dev) * 2 - 1)[None, None]
        want = first(getattr(kernels, name + "_plain")(q, k, v, bias, scale=scale))
        wrapper = getattr(kernels, name)
        wrapped = lambda: wrapper(q, k, v, bias, scale=scale)
        body = lambda: mma_body(kernels, name, q, k, v, scale, bias=bias)
    got = first(body())
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    match = (got == want).float().mean().item()
    del got, want
    t = {label: cuda_ms(wrapped if label.startswith("wgmma") else body, iters)
         for label in ("mma_a", "wgmma_a", "wgmma_b", "mma_b")}
    return dict(mma_ms=(t["mma_a"] + t["mma_b"]) / 2, wgmma_ms=(t["wgmma_a"] + t["wgmma_b"]) / 2,
                body_times=t, mma_max_abs_err=err, mma_match=match, **extra)


def bwd_on_forward(kernels, shape, gen, dev):
    """K5b (dq) and K5c (dk, dv) at a K5a training site, run on the out and
    lse of the K5a kernel's forward and on those of its plain version (the
    same q, k, v and dO): {gradient: (max abs difference, limit)}, each
    held to phase 2's K5b / K5c limit, 2**-7 x max|gradient from the plain
    forward|. Fails the run past it or on a value that is not finite."""
    B, Sq, Sk, H, D = shape
    scale = D ** -0.5
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).bfloat16()
    q, k, v, do = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D), rnd(B, Sq, H, D)
    grads = {}
    for label, fwd in (("kernel", kernels.flash_attention_lse),
                       ("plain", kernels.flash_attention_lse_plain)):
        out, lse = fwd(q, k, v, None, scale=scale)
        delta = kernels.attention_delta(do, out)
        dq = kernels.flash_bwd_dq(q, k, v, None, do, lse, delta, scale=scale)
        grads[label] = (dq, *kernels.flash_bwd_dkv(q, k, v, None, do, lse, delta, scale=scale))
        del out, lse, delta
    torch.cuda.synchronize()
    res = {}
    for i, g in enumerate(("dq", "dk", "dv")):
        got, want = grads["kernel"][i].float(), grads["plain"][i].float()
        res[g] = ((got - want).abs().max().item(), GRAD_BF16_REL * want.abs().max().item())
        if not (bool(torch.isfinite(got).all()) and res[g][0] <= res[g][1]):
            raise SystemExit(f"FAIL: {g} from the K5a kernel's forward at {shape}: "
                             f"difference {res[g][0]} (limit {res[g][1]})")
    return res


def site_row(kernels, name, site, shape, gen, dev, shard=None):
    """One row of phase 2 (and of phase 13's per-shard sites, `shard` as
    site_call takes it): the kernel against its plain version in bf16 and
    in f32, its time, the plain version's, the library call's and the
    bound; fails the run where the kernel disagrees or a bf16 launch missed
    the tensor cores."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    kernels.reset_counts()
    kern, plain, library = site_call(kernels, name, site, shape, gen, dev, shard=shard)
    err, peak, finite, ok = compare(kern, plain, lambda pk: bf16_tol(name, pk))
    lib_err = compare(library, plain)[0]
    tol = bf16_tol(name, peak)
    iters = 3 if shape[0] * shape[1] * shape[2] > 2 ** 27 else 10
    ms = cuda_ms(kern, iters)
    extra = {}
    # every bf16 launch of a tensor-core kernel at this site took the tensor cores
    wrapper = "shared_bias_attention" if name == "shared_bias_attention_lse" else name
    if wrapper in TC_KERNELS:
        n, n_tc = kernels.counts()[wrapper]["launches"], kernels.tc_counts()[wrapper]
        if n == 0 or n_tc != n:
            raise SystemExit(f"FAIL: {name} at {site}: {n_tc} of {n} bf16 launches on "
                             "the tensor cores")
        extra.update(launches=n, tc_launches=n_tc)
    routed = False
    if wrapper in TWO_BODY_KERNELS and not (len(shape) == 5 and shape[4] > WIDE_ABOVE):
        # K1, K2, K3, K5a-c, K6a, K6b and K7: every launch at this site on the
        # body the rule names
        routed = shape_routed(kernels, wrapper, shape, site_has_bias(site),
                              site_bias_dtype(site))
        n_wg = kernels.wgmma_counts()[wrapper]
        if n_wg != (extra["launches"] if routed else 0):
            raise SystemExit(f"FAIL: {name} at {site}: {n_wg} of {extra['launches']} launches on "
                             f"the wgmma body, the rule says {'all' if routed else 'none'}")
        body = "wgmma" if routed else "mma_sync"
        if routed and wrapper in BIAS_BODY_KERNELS and shape[4] == kernels.BIAS_WGMMA_HEAD_DIM:
            body = "wgmma_bias"
        extra.update(wgmma_launches=n_wg, body=body)
    plain_ms = cuda_ms(plain, iters)
    library_ms = cuda_ms(library, iters)
    extra.update(extra_times(kernels, name, site, shape, gen, dev, iters, shard))
    if (name in MATCH_KERNELS and (routed or name not in OPS_PER_ELEMENT)
            or name in MATCH_LOGGED and routed):
        got, want = kern(), plain()
        extra["match"] = match_share(name, got, want)
        if name == "flash_attention_lse":
            extra["lse_max_abs_err"] = (got[1] - want[1]).abs().max().item()
        ok = ok and (name not in MATCH_KERNELS or extra["match"] >= K5A_MATCH)
        del got, want
    del kern, plain, library
    if wrapper in SPLIT_BODY_KERNELS and routed:
        extra.update(both_bodies(kernels, name, site, shape, gen, dev, iters, shard))
        ok = ok and extra["mma_max_abs_err"] <= extra.get("mma_tol", tol) and (
            name not in MATCH_KERNELS or extra["mma_match"] >= K5A_MATCH)
    if name == "flash_attention_lse" and site in BWD_ON_FORWARD_SITES:
        extra["bwd_on_forward"] = bwd_on_forward(kernels, shape, gen, dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    if site in SR_SUBSETS:
        extra["plain_rows_heads"] = list(SR_SUBSETS[site])
    f32_rows = DENSE_F32_ROWS if name == "dense_matmul" else F32_ROWS
    f32_shape = (min(shape[0], f32_rows, SR_SUBSETS.get(site, (f32_rows,))[0]),
                 ) + shape[1:]
    f32_tol = (lambda pk: DENSE_F32_REL * pk) if name == "dense_matmul" \
        else (lambda pk: F32_TOL)
    if site.endswith("exp_bf16"):
        # the probabilities are bfloat16 values in float32 too: a logit on
        # a rounding boundary may round the other way in another summation
        # order, one bfloat16 ulp of that probability
        f32_tol = lambda pk: bf16_tol(name, pk)
    err32, peak32, finite32, ok32 = compare(*site_call(kernels, name, site, f32_shape, gen,
                                                       dev, torch.float32, shard)[:2], f32_tol)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    bound_ms, bound_by = site_bound(name, shape, site=site)
    if name in TC_SITE_KERNELS:
        extra["tflops"] = site_ops(name, shape, site) / (ms * 1e-3) / 1e12
        extra["bound_share"] = bound_ms / ms
    row = dict(kernel=name, site=site, shape=list(shape), max_abs_err=err,
               tol=tol, f32_rows=f32_shape[0], f32_max_abs_err=err32, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               library_max_abs_err=lib_err, bound_ms=bound_ms, bound_by=bound_by,
               **extra)
    log(f"  {name:22s} {site:22s} {str(shape):30s} bf16 err={err:.3e} "
        f"(tol {tol:.3e}) f32 err={err32:.3e} kernel={ms:.3f} ms plain={plain_ms:.3f} ms "
        f"library={library_ms:.3f} ms bound={bound_ms:.4f} ms ({bound_by})"
        + (f" {json.dumps(extra)}" if extra else ""))
    if not (finite and finite32 and ok and ok32):
        raise SystemExit(f"FAIL: {name} at {site} bf16 err={err} (tol {tol}), "
                         f"f32 err={err32} (tol {f32_tol(peak32)})"
                         + (f", match {extra['match']} (at least {K5A_MATCH})"
                            if "match" in extra else ""))
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_kernels(kernels, dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, per_kernel = [], {}
    for name, site, shape in SITES:
        rows.append(site_row(kernels, name, site, shape, gen, dev))
        err = rows[-1]["max_abs_err"]
        # the JSON line gives each kernel's numbers at its first (largest)
        # site and its largest bf16 error over all sites; the wide variants of
        # K1 and K2 (head dim > 160) are kernels of their own
        wide = name in WIDE_SOURCES and shape[4] > WIDE_ABOVE
        rec = per_kernel.setdefault(name + "_wide" if wide else name, dict(rows[-1]))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if "body" in rows[-1]:       # the two-body kernels: the same by body
            rec = per_kernel.setdefault(f"{name}@{rows[-1]['body']}", dict(rows[-1]))
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
    for name in SPLIT_BODY_KERNELS:
        # K5a, K6a and K6b have no phase-2 site on the mma.sync body: their
        # numbers are those of both_bodies at the first site (K3's and K7's
        # are those of their first site on it, set above: the CLIP site, the
        # ragged one)
        r = next(r for r in rows if r["kernel"] == name and "mma_ms" in r)
        per_kernel.setdefault(f"{name}@mma_sync", dict(r, ms=r["mma_ms"],
                                                       max_abs_err=r["mma_max_abs_err"]))
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


def phase_slice(dev, steps=SLICE_STEPS, solver="ddim", switches=None, profiler=None,
                mesh=None, latents_out=None):
    """compute_ip and `steps` CFG steps of full_dual_config. `solver` and
    `switches` (KernelConfig fields for a configure() block around both)
    make it phase 7: the launch checks then ask for K6a and K7 in place of
    K2, and K6b is driven through its own entry point afterwards.
    `profiler` (a context manager) serves scripts/torch_profile_step.py: one
    more step from the same latents runs under it after the counted ones.
    `mesh` (parallel/mesh.py) makes it phase 13: the geometry and the loop
    under the mesh, on the same weights and inputs. `latents_out` (a dict)
    receives the final latents, on the CPU."""
    from imagine360_tpu_torch.geometry.cameras import CameraRig
    from imagine360_tpu_torch.models.dual import DualUNet
    from imagine360_tpu_torch.ops import attention as attn
    from imagine360_tpu_torch.ops.dispatch import KernelConfig, configure, kernel_config
    from imagine360_tpu_torch.parallel.mesh import activate_mesh
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
    with activate_mesh(mesh):
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
    with configure(**(switches or {})), activate_mesh(mesh):
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
    # three times per direction, at two head counts), and K6a (phase 7)
    by_shape = lambda name: {str(shape): (n - ip_shapes.get((kn, shape), 0)) / steps
                             for (kn, shape), n in shapes.items() if kn == name}
    k3_per_step, k6a_per_step = by_shape("shared_bias_attention"), by_shape("flash_attention_t")
    plain = attn.plain_path_calls()
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches per step by site {json.dumps(per_step)}")
    log(f"  K3 launches per step by shape {json.dumps(k3_per_step)}"
        + (f"; K6a {json.dumps(k6a_per_step)}" if k6a_per_step else ""))
    log(f"  compute_ip {ip_s:.3f} s; {steps} CFG {solver} steps {loop_s:.3f} s = "
        f"{loop_s / steps:.3f} s/step; peak device memory {peak / 2**30:.2f} GiB")
    log(f"  main-path launches {json.dumps(counts)}; plain-path attention calls {plain}")
    tc = check_tensor_cores("slice", attn.kernels)
    # read before the profiled step adds its launches
    launches, wg7 = path_launches(attn.kernels), attn.kernels.wgmma_counts()["dense_matmul"]
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
    if latents_out is not None:
        latents_out.update(pano=pano_out.cpu(), pers=pers_out.cpu())
    # by default K1-K4 launch and the opt-in kernels do not; behind the
    # switches K6a takes every K2 site and K7 launches
    need = [k for k in INFERENCE_KERNELS if not (opt_in and k == "mh_flash_attention")]
    idle = (["mh_flash_attention"] if opt_in else list(OPT_IN_KERNELS)) + list(LAB_KERNELS)
    need += ["flash_attention_t", "dense_matmul"] if opt_in else []
    if (plain != 0 or min(counts[k]["launches"] for k in need) == 0
            or max(counts[k]["launches"] for k in idle) != 0):
        raise SystemExit(f"FAIL: slice launches={counts} plain={plain}")
    if opt_in:
        n7 = counts["dense_matmul"]["launches"]
        log(f"  K7: {wg7} of {n7} launches on its wgmma GEMM")
        if wg7 != n7:
            raise SystemExit(f"FAIL: slice: {wg7} of {n7} K7 launches on its wgmma GEMM")
        (launches["shared_bias_attention_folded"],
         launches["shared_bias_attention_folded_wgmma"]) = drive_folded_entry_point(geoms, gen,
                                                                                   dev)
    return launches, per_step, dict(
        s_per_step=loop_s / steps, compute_ip_s=ip_s, peak_bytes=peak, steps=steps,
        solver=solver, switches=switches or {}, tc_launches=tc,
        shared_bias_launches_per_step_by_shape=k3_per_step,
        flash_t_launches_per_step_by_shape=k6a_per_step,
        launches_per_step_by_kernel={k: (c["launches"] - sum(
            n for (kn, _), n in ip_shapes.items() if kn == k)) / steps
            for k, c in counts.items()})


def drive_folded_entry_point(geoms, gen, dev):
    """K6b through its own entry point, `kernels.shared_bias_attention_folded`,
    on the WarpAttn masks of the loop just run: every resolution, both
    directions, the mask in bfloat16, 32 batch rows x the site's heads folded,
    head dim 32. Each result is finite and within the bf16 limit of the plain
    version, and every launch took the wgmma body. Returns the launches and
    those of the wgmma body, counted from zero."""
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
    log(f"  K6b through its entry point on the loop's bfloat16 masks: {launches} launches "
        f"({kernels.wgmma_counts()['shared_bias_attention_folded']} on the wgmma body), "
        f"worst max abs err {worst:.3e}, plain-path calls {plain}")
    tc = kernels.tc_counts()["shared_bias_attention_folded"]
    wg = kernels.wgmma_counts()["shared_bias_attention_folded"]
    if launches != len(outs) or plain != 0 or tc != launches or wg != launches:
        raise SystemExit(f"FAIL: folded entry point launches={launches} plain={plain} "
                         f"tensor cores={tc} wgmma body={wg}")
    return launches, wg


# ---------------------------------------------------------------------------
# phase 5: video in, 360-degree video out, at full width
# ---------------------------------------------------------------------------


def peak_stage_timer(dev):
    """A StageTimer that also keeps the peak device memory of each stage
    (`peaks`): the peak counter is reset when a stage starts and read when
    it ends."""
    from imagine360_tpu_torch.utils.observability import StageTimer

    class PeakStageTimer(StageTimer):
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

    return PeakStageTimer(dev)


@contextlib.contextmanager
def record_devices(module, names):
    """Wrap the functions `names` of `module` for the block, recording the
    device type of every tensor each call takes: {name: [device types]}."""
    seen, saved = {}, {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def recorded(*args, **kw):
            for a in (*args, *kw.values()):
                if isinstance(a, torch.Tensor) and a.device.type not in seen.setdefault(name, []):
                    seen[name].append(a.device.type)
            return fn(*args, **kw)
        return recorded

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


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

    from imagine360_tpu_torch import cli, native
    from imagine360_tpu_torch.config import RunConfig
    from imagine360_tpu_torch.ops import attention as attn
    from imagine360_tpu_torch.pipeline import generate
    from imagine360_tpu_torch.pipeline.generate import Imagine360Pipeline
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
    timer = peak_stage_timer(dev)
    torch.cuda.synchronize()
    attn.reset_counts()
    native.reset_calls()
    t0 = time.time()
    with record_devices(generate, ("resize_bilinear_tensor", "sam_preprocess_tensor")) as seen:
        out = pipe(frames, prompt, raw_pitches=raw_pitches, timer=timer,
                   generator=torch.Generator(device=dev).manual_seed(cfg.global_seed))
    torch.cuda.synchronize()
    total_s = time.time() - t0
    host_calls, splits = native.calls(), dict(timer.splits)
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
    log(f"  host stages split (s) {json.dumps({k: round(v, 3) for k, v in splits.items()})}")
    log(f"  host library calls by route {json.dumps(host_calls)}; SAM preprocessing "
        f"devices {json.dumps(seen)}")
    if sum(host_calls["numpy"].values()) != 0 or min(host_calls["library"].values()) == 0:
        raise SystemExit(f"FAIL: pipeline host calls {host_calls}: want every remap, "
                         "uint8 conversion and rectangle on the library, none on numpy")
    if sorted(seen) != ["resize_bilinear_tensor", "sam_preprocess_tensor"] or any(
            d != [dev.type] for d in seen.values()):
        raise SystemExit(f"FAIL: SAM's resize and preprocessing ran on {seen}, not the card")
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
    return (path_launches(attn.kernels), wide, by_site,
            dict(stages_s=stages, total_s=total_s, peak_bytes=peak,
                 stage_peak_bytes=dict(timer.peaks), steps=steps, tc_launches=tc,
                 host_split_s=splits, host_calls=host_calls), video, out)


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
    launches = path_launches(attn.kernels)
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
    # K5b and K5c: every launch on a wgmma body, the WarpAttn ones (D = 32,
    # a bias) on the biased one (the depth, not views or frames, sets how
    # many)
    bwd_wgmma = {k: launches[f"{k}_wgmma"] / steps for k in TRAIN_BWD_WGMMA}
    bwd_bias = {k: launches[f"{k}_wgmma_bias"] / steps for k in TRAIN_BWD_WGMMA_BIAS}
    bwd_mma = {k: launches[k] / steps - n for k, n in bwd_wgmma.items()}
    log(f"  K5b / K5c launches a step on a wgmma body {json.dumps(bwd_wgmma)}, of them on the "
        f"biased one {json.dumps(bwd_bias)}, on mma.sync {json.dumps(bwd_mma)}")
    if any(bwd_mma.values()) or full and layers_per_block is None and (
            bwd_wgmma != TRAIN_BWD_WGMMA or bwd_bias != TRAIN_BWD_WGMMA_BIAS):
        raise SystemExit(f"FAIL: K5b / K5c on a wgmma body {bwd_wgmma} a step, on the biased "
                         f"one {bwd_bias}, want {TRAIN_BWD_WGMMA} and {TRAIN_BWD_WGMMA_BIAS} "
                         f"and none on mma.sync ({launches})")
    by_site = {(name, site): shapes.get((name.replace("_lse", "") if name.startswith("shared")
                                         else name, shape), 0) / steps
               for name, site, shape in SITES if name in TRAIN_KERNELS}
    # K3 (all with the lse), K5b and K5c at every shape they ran, a step
    by_shape = {f"{kn} {shape}": n / steps for (kn, shape), n in shapes.items()
                if kn in ("shared_bias_attention", "flash_bwd_dq", "flash_bwd_dkv")}
    log(f"  K3, K5b and K5c launches per step by shape {json.dumps(by_shape)}")
    return dict(launches, shared_bias_attention_lse=lse), by_site, dict(
        s_per_step=sum(step_s[1:]) / steps, step_s=step_s, peak_bytes=peak, losses=losses,
        grad_norms=norms, einsum_backward_calls_per_step=einsum_bwd / steps, views=views,
        launches_per_step_by_shape=by_shape,
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
    # K4 and L1-L3 take the tensor cores for every bf16 call
    tc = {k: n for k, n in kernels.tc_counts().items() if k in ("frame_attention", *LAB_KERNELS)}
    log(f"  lab tensor-core launches {json.dumps(tc)}")
    if plain != 0 or min(launches[k] for k in LAB_KERNELS) == 0 \
            or any(n != launches[k] for k, n in tc.items()):
        raise SystemExit(f"FAIL: lab launches={launches} plain={plain} on the tensor "
                         f"cores {tc}")
    return launches, rows


# ---------------------------------------------------------------------------
# phase 9: the SR stage's tiled temporal decode and colour fix, at full width
# ---------------------------------------------------------------------------


def phase_sr_decode(dev, frames=SR_FRAMES, source_hw=SR_SOURCE_HW, cfg=None,
                    tile_hw=SR_TILE_HW, wide_launches=None, dtype=torch.bfloat16):
    """`cfg`, `source_hw`, `tile_hw` and `wide_launches` (the wide K2's
    launches by shape) replace the production ones when the phase is
    rehearsed at a tiny size."""
    import torch.nn.functional as nnf

    from imagine360_tpu_torch.models.vae import VAEConfig
    from imagine360_tpu_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
    from imagine360_tpu_torch.ops import attention as attn
    from imagine360_tpu_torch.sr import tiled_chunked_decode, wavelet_color_fix
    from imagine360_tpu_torch.utils.init import seeded_init_

    cfg = cfg or VAEConfig()
    want_wide = SR_WIDE_LAUNCHES if wide_launches is None else wide_launches
    gen = torch.Generator(device=dev).manual_seed(9)
    t0 = time.time()
    with torch.device(dev):
        vae = AutoencoderKLTemporalDecoder(cfg)
    seeded_init_(vae, gen)
    vae = vae.to(dtype).eval()
    ref = AutoencoderKLTemporalDecoder(cfg).eval()
    ref.load_state_dict(vae.state_dict())
    small = torch.randn(3, cfg.latent_channels, 8, 16, generator=gen, device=dev)
    with torch.no_grad():
        want = ref.decode(small.cpu() / cfg.scaling_factor)
        got = vae.decode(small / cfg.scaling_factor).float().cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"  small video {tuple(small.shape)} on the card in {dtype} against float32 on the "
        f"CPU: max abs error {rel:.3e} of the output's largest element (limit {SR_REL_TOL})")
    if not (bool(torch.isfinite(got).all()) and rel <= SR_REL_TOL):
        raise SystemExit(f"FAIL: SR decoder on the card off its CPU version by {rel}")
    del ref
    f = 2 ** (len(cfg.block_out_channels) - 1)
    H, W = source_hw[0] * SR_UP, source_hw[1] * SR_UP
    latents = torch.randn(frames, cfg.latent_channels, H // f, (W + 2 * SR_PAD_PX) // f,
                          generator=gen, device=dev)
    source = torch.rand(frames, 3, *source_hw, generator=gen, device=dev)
    n_params = sum(p.numel() for p in vae.parameters())
    log(f"  temporal VAE {n_params / 1e6:.1f} M params in {dtype}, set-up "
        f"{time.time() - t0:.1f} s; latents {tuple(latents.shape)}, tiles {tile_hw}, overlap "
        f"{SR_OVERLAP}, chunk {SR_CHUNK}")
    torch.cuda.synchronize()
    attn.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.time()
        dec = tiled_chunked_decode(lambda z: vae.decode(z / cfg.scaling_factor), latents,
                                   tile_hw=tile_hw, overlap=SR_OVERLAP, chunk=SR_CHUNK,
                                   scale=f, pano_wrap=False)
        out = (dec[..., SR_PAD_PX:-SR_PAD_PX] / 2 + 0.5).clamp(0.0, 1.0)
        torch.cuda.synchronize()
        decode_s = time.time() - t0
        decode_peak = torch.cuda.max_memory_allocated()
        del dec
        t0 = time.time()
        up = nnf.interpolate(source, scale_factor=SR_UP, mode="bilinear", align_corners=False)
        fixed = wavelet_color_fix(out, up)
        torch.cuda.synchronize()
        fix_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    counts, wide = attn.kernels.counts(), attn.kernels.wide_counts()
    shapes = attn.kernels.shape_counts()
    plain = attn.plain_path_calls()
    launches = {k: c["launches"] for k, c in counts.items() if c["launches"]}
    log(f"  decode {decode_s:.3f} s (peak {decode_peak / 2**30:.2f} GiB), colour fix "
        f"{fix_s:.3f} s; peak device memory {peak / 2**30:.2f} GiB")
    log(f"  launches {json.dumps(launches)}; by shape "
        f"{json.dumps({str(k): n for k, n in shapes.items()})}; at D = 512 {json.dumps(wide)}; "
        f"plain-path attention calls {plain}")
    tc = check_tensor_cores("sr_decode", attn.kernels)
    finite = bool(torch.isfinite(fixed).all())
    in_range = finite and float(fixed.min()) >= 0.0 and float(fixed.max()) <= 1.0
    ok_shape = tuple(fixed.shape) == (frames, 3, H, W)
    log(f"  frames {tuple(fixed.shape)}: finite {finite}, in [0, 1] {in_range}, mean "
        f"{fixed.mean().item():.4f}, std {fixed.std().item():.4f}")
    if not (ok_shape and in_range and fixed.std().item() > 0):
        raise SystemExit("FAIL: SR frames wrong shape, not finite, out of range or flat")
    n_wide = sum(want_wide.values())
    if (plain != 0 or {k: shapes.get(k, 0) for k in want_wide} != want_wide
            or launches != {"mh_flash_attention": n_wide}
            or wide["mh_flash_attention"] != n_wide):
        raise SystemExit(f"FAIL: SR decode launches={launches} by shape {shapes} (want "
                         f"{want_wide}) wide={wide} plain={plain}")
    return {k: c["launches"] for k, c in counts.items()}, shapes, dict(
        decode_s=decode_s, color_fix_s=fix_s, decode_peak_bytes=decode_peak, peak_bytes=peak,
        latents=list(latents.shape), frames=list(fixed.shape), tc_launches=tc)


# ---------------------------------------------------------------------------
# phases 10 and 11: the SR stage through its entry points, at full width
# ---------------------------------------------------------------------------


# the phase-2 sites each engine runs (with the decode's wide K2 of phase 9)
SR_ENGINE_SITES = {
    "pano": ("sr_spatial_s0", "sr_spatial_s1", "sr_spatial_s2", "sr_pano_ip_cross_s0",
             "sr_motion_s0", "sr_motion_s1", "sr_vae_encode", "sr_temporal_decode"),
    "v2v": ("sr_spatial_s0", "sr_spatial_s1", "sr_spatial_s2", "sr_text_cross_s0",
            "sr_v2v_temporal_s0", "sr_vae_encode", "sr_temporal_decode"),
}
# the VAE's mid-block attention (the wide K2) in an SR call of 16 frames:
# encoding in chunks of 5, 5, 5 and 1 frames, decoding 3 x 3 tiles so
SR_ENGINE_WIDE = 4 + sum(SR_WIDE_LAUNCHES.values())
# frames, height, width of the tiny CLI run: 32 x 72 latents, 2304 tokens at
# stage 0, so K2 launches beside K1 and K4
SR_CLI_CLIP = (4, 128, 256)


def phase_sr_engine(dev, engine, clip, out_dir, wide_launches=SR_ENGINE_WIDE, argv=(),
                    profiler=None):
    """Video360Enhancer with the `engine` refiner as sr/cli.py builds it
    (build_sr_modules: full_unet_config or V2VConfig(), VAEConfig(), bf16,
    seeded weights, the default EnhancerConfig) on `clip` [F, H, W, 3] in
    [0, 1], counts zeroed just before. Then, for the pano engine, the CLI
    itself (sr.cli.main --tiny) on a small .npy clip on the card, its output
    read back. Returns (launches, launches by (kernel, shape), stats).
    `argv` (more CLI arguments: `--tiny`) serves a rehearsal at a tiny size;
    `profiler` (a context manager) scripts/torch_profile_step.py --sr: the
    enhancer runs once more under it after the counted run."""
    from imagine360_tpu_torch.ops import attention as attn
    from imagine360_tpu_torch.sr import cli as sr_cli
    from imagine360_tpu_torch.sr.enhance import Video360Enhancer

    args = sr_cli.parse_args(["--input", "-", "--output", "-", "--engine", engine, *argv])
    t0 = time.time()
    refiner, vae = sr_cli.build_sr_modules(args, dev, seed=10)
    enhancer = Video360Enhancer(refiner, vae, sr_cli.enhancer_config(args))
    model = refiner.unet if engine == "pano" else refiner.model
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    F = clip.shape[0]
    log(f"  {type(model).__name__} {n_params / 1e9:.3f} B params, VAE, {refiner.dtype}, set-up "
        f"{time.time() - t0:.1f} s; clip {tuple(clip.shape)} -> latents "
        f"{enhancer.latent_shape(clip.shape)}, {enhancer.refine_steps} of "
        f"{enhancer.cfg.num_steps} steps from noise_aug {enhancer.cfg.noise_aug}")
    timer = peak_stage_timer(dev)
    torch.cuda.synchronize()
    attn.reset_counts()
    t0 = time.time()
    out = enhancer(clip, generator=torch.Generator(device=dev).manual_seed(args.seed),
                   timer=timer)
    torch.cuda.synchronize()
    total_s = time.time() - t0
    counts, wide = attn.kernels.counts(), attn.kernels.wide_counts()
    shapes = attn.kernels.shape_counts()
    plain = attn.plain_path_calls()
    launches = {k: n for k, n in path_launches(attn.kernels).items() if n}
    stages = timer.report()
    peak = max(timer.peaks.values())
    by_site = {site: shapes.get((name, shape), 0) for name, site, shape in SITES
               if site.startswith("sr_")}
    log(f"  stages (s) {json.dumps({k: round(v, 3) for k, v in stages.items()})}; refine "
        f"{stages['refine'] / enhancer.refine_steps:.3f} s/step over {enhancer.refine_steps} "
        f"steps; total {total_s:.3f} s/SR-clip; peak device memory {peak / 2**30:.2f} GiB")
    log(f"  peak device memory by stage (GiB) "
        f"{json.dumps({k: round(v / 2**30, 2) for k, v in timer.peaks.items()})}")
    log(f"  launches {json.dumps(launches)}; at D = 512 {json.dumps(wide)}; by SR site "
        f"{json.dumps(by_site)}; plain-path attention calls {plain}")
    log(f"  launches by shape {json.dumps({str(k): n for k, n in shapes.items()})}")
    tc = check_tensor_cores(f"sr_{engine}", attn.kernels)
    finite = bool(torch.isfinite(out).all())
    in_range = finite and float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    s = enhancer.cfg.up_scale
    ok_shape = tuple(out.shape) == (F, clip.shape[1] * s, clip.shape[2] * s, 3)
    log(f"  frames {tuple(out.shape)}: finite {finite}, in [0, 1] {in_range}, mean "
        f"{out.mean().item():.4f}, std {out.std().item():.4f}")
    if not (ok_shape and in_range and out.std().item() > 0):
        raise SystemExit(f"FAIL: SR ({engine}) frames wrong shape, not finite, out of range or "
                         "flat")
    need = ("tiny_attention", "mh_flash_attention") + (("frame_attention",)
                                                       if engine == "pano" else ())
    idle = [k for k in counts if k not in need and counts[k]["launches"]]
    missed = [site for site in SR_ENGINE_SITES[engine] if not by_site.get(site)]
    if (plain != 0 or min(counts[k]["launches"] for k in need) == 0 or idle or missed
            or wide["mh_flash_attention"] != wide_launches or wide["tiny_attention"] != 0):
        raise SystemExit(f"FAIL: SR ({engine}) launches={launches} wide={wide} (want "
                         f"{wide_launches} of K2) sites not launched {missed} plain={plain}")
    stats = dict(stages_s=stages, refine_steps=enhancer.refine_steps,
                 refine_s_per_step=stages["refine"] / enhancer.refine_steps, total_s=total_s,
                 peak_bytes=peak, stage_peak_bytes=dict(timer.peaks), params=n_params,
                 frames=list(out.shape), launches_by_site=by_site, tc_launches=tc,
                 wide=dict(wide))
    if profiler is not None:
        with profiler:
            enhancer(clip, generator=torch.Generator(device=dev).manual_seed(args.seed))
    del out, enhancer, refiner, vae, model
    gc.collect()
    torch.cuda.empty_cache()
    if engine == "pano":
        stats["cli"] = drive_sr_cli(dev, out_dir)
    return launches, shapes, stats


def drive_sr_cli(dev, out_dir):
    """sr.cli.main --tiny on the card on a seeded .npy clip of SR_CLI_CLIP:
    its output file read back at twice the size, K1, K2 and K4 launched, no
    plain path."""
    import numpy as np

    from imagine360_tpu_torch.ops import attention as attn
    from imagine360_tpu_torch.sr import cli as sr_cli
    from imagine360_tpu_torch.utils.video_io import read_video

    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "sr_cli_clip.npy")
    F, H, W = SR_CLI_CLIP
    np.save(src, np.random.default_rng(10).integers(0, 256, (F, H, W, 3), dtype=np.uint8))
    attn.reset_counts()
    t0 = time.time()
    rc = sr_cli.main(["--input", src, "--output", os.path.join(out_dir, "sr_cli_out.mp4"),
                      "--tiny", "--device", str(dev)])
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    launches = {k: c["launches"] for k, c in attn.kernels.counts().items() if c["launches"]}
    plain = attn.plain_path_calls()
    written = [f for f in os.listdir(out_dir) if f.startswith("sr_cli_out")]
    back = read_video(os.path.join(out_dir, written[0])) if written else None
    log(f"  sr.cli.main --tiny on {src}: rc {rc}, {cli_s:.1f} s, wrote {written} "
        f"{None if back is None else back.shape}; launches {json.dumps(launches)}, "
        f"plain-path attention calls {plain}")
    if (rc != 0 or back is None or back.shape != (F, 2 * H, 2 * W, 3) or plain != 0
            or min(launches.get(k, 0) for k in INFERENCE_KERNELS if k != "shared_bias_attention")
            == 0):
        raise SystemExit(f"FAIL: sr.cli.main on the card rc={rc} output "
                         f"{None if back is None else back.shape} launches={launches} "
                         f"plain={plain}")
    return dict(s=cli_s, launches=launches, output=written[0])


# ---------------------------------------------------------------------------
# phase 12: the rest of the port at full width
# ---------------------------------------------------------------------------

CUBE_FACE = 256                  # e2c faces of a 512 x 1024 panorama
CUBE_MEDIAN_TOL = 0.03           # tests/test_cubemap.py: interior median round-trip error
FEATHER_TOL = 1e-5               # feathered_replace on the card against the CPU, float32


def phase_rest(dev, video, pano_input, masks, out_dir):
    """e2c / c2e of phase 5's frames on the card, feathered_replace of its
    output over its pano input, and entry()'s full-width forward under
    profile_trace, then under disable_warp and pano_only."""
    import dataclasses

    import numpy as np

    from imagine360_tpu_torch.entry import entry
    from imagine360_tpu_torch.geometry.cubemap import c2e, e2c
    from imagine360_tpu_torch.ops import attention as attn
    from imagine360_tpu_torch.presets import full_dual_config
    from imagine360_tpu_torch.utils.metrics import psnr, ssim
    from imagine360_tpu_torch.utils.observability import profile_trace
    from imagine360_tpu_torch.utils.video_io import feathered_replace

    stats = {}
    n, H, W, C = video.shape
    # all frames in one call: the frames side by side in the channel axis
    frames = np.ascontiguousarray(video.transpose(1, 2, 0, 3).reshape(H, W, n * C), np.float32)
    torch.cuda.synchronize()
    t0 = time.time()
    cube = e2c(frames, face_w=CUBE_FACE, device=dev)
    back = c2e(cube, H, W, device=dev)
    torch.cuda.synchronize()
    cube_s = time.time() - t0
    back = back.reshape(H, W, n, C).transpose(2, 0, 1, 3)
    crop = H // 8                  # the poles lose bilinear taps (8 of 64 rows in the test)
    err = float(np.median(np.abs(back - video)[:, crop:H - crop]))
    stats["cube"] = dict(seconds=cube_s, median_abs_err=err, psnr=psnr(back, video),
                         ssim=ssim(back, video), faces=list(cube.shape))
    log(f"  e2c -> c2e of {n} frames of {H} x {W} through faces of {CUBE_FACE}: "
        f"{cube_s:.3f} s; interior median error {err:.5f} (limit {CUBE_MEDIAN_TOL}), "
        f"PSNR {stats['cube']['psnr']:.2f} dB, SSIM {stats['cube']['ssim']:.4f}")
    if not err < CUBE_MEDIAN_TOL:
        raise SystemExit(f"FAIL: cubemap round trip median error {err} >= {CUBE_MEDIAN_TOL}")

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False        # the blur is a cuDNN convolution
    try:
        t0 = time.time()
        soft = feathered_replace(video, pano_input, masks, device=dev)
        feather_s = time.time() - t0
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    want = feathered_replace(video, pano_input, masks, device="cpu")
    ferr = float(np.abs(soft - want).max())
    stats["feathered_replace"] = dict(seconds=feather_s, max_abs_err=ferr)
    log(f"  feathered_replace of {n} frames on the card {feather_s:.3f} s, against the CPU "
        f"max abs error {ferr:.2e} (limit {FEATHER_TOL})")
    if not (soft.shape == video.shape and ferr <= FEATHER_TOL):
        raise SystemExit(f"FAIL: feathered_replace on the card: error {ferr}")

    runs = {}
    cfg = full_dual_config("bfloat16")
    for label, c in (("full", cfg), ("disable_warp", dataclasses.replace(cfg, disable_warp=True)),
                     ("pano_only", dataclasses.replace(cfg, pano_only=True))):
        fn, args = entry(dev, c)
        fn(*args)                  # warm: cuDNN's first calls pick their algorithms
        torch.cuda.synchronize()
        t0 = time.time()
        fn(*args)
        torch.cuda.synchronize()
        fwd_s = time.time() - t0
        # the counted forward: the full one under the profiler
        trace = profile_trace(os.path.join(out_dir, "trace")) if label == "full" \
            else contextlib.nullcontext()
        attn.reset_counts()
        t0 = time.time()
        with trace as prof:
            pers_out, pano_out = fn(*args)
            torch.cuda.synchronize()
        traced_s = time.time() - t0
        counts = {k: v["launches"] for k, v in attn.kernels.counts().items()}
        shapes = attn.kernels.shape_counts()
        plain = attn.plain_path_calls()
        tc = check_tensor_cores(f"entry {label}", attn.kernels)
        finite = bool(torch.isfinite(pano_out).all()) and (
            pers_out is None or bool(torch.isfinite(pers_out).all()))
        runs[label] = dict(seconds=fwd_s, launches=counts, shapes=shapes, tc_launches=tc,
                           finite=finite, pers=None if pers_out is None else list(pers_out.shape),
                           pano=list(pano_out.shape))
        log(f"  entry() {label}: warm forward {fwd_s:.3f} s, launches {json.dumps(counts)}, "
            f"plain-path attention calls {plain}, outputs finite {finite}, pers "
            f"{runs[label]['pers']}, pano {runs[label]['pano']}")
        if label == "full":
            size = os.path.getsize(prof.trace_path) if os.path.exists(prof.trace_path) else 0
            runs[label].update(trace_bytes=size, traced_s=traced_s)
            log(f"  under profile_trace {traced_s:.3f} s; trace {prof.trace_path}: {size} bytes")
            if size == 0:
                raise SystemExit("FAIL: profile_trace wrote no trace")
            os.remove(prof.trace_path)     # large; the check is that it was written
        idle = list(OPT_IN_KERNELS) + list(LAB_KERNELS)
        if plain != 0 or not finite or max(counts[k] for k in idle) != 0:
            raise SystemExit(f"FAIL: entry {label}: launches {counts}, plain {plain}, "
                             f"finite {finite}")
        del fn, args, pers_out, pano_out
        gc.collect()
        torch.cuda.empty_cache()
    full, nowarp, pano = runs["full"], runs["disable_warp"], runs["pano_only"]
    if min(full["launches"][k] for k in INFERENCE_KERNELS) == 0 or full["pers"] is None:
        raise SystemExit(f"FAIL: entry forward launches {full['launches']}")
    k3 = "shared_bias_attention"
    # without WarpAttn the same attention runs, K3 (WarpAttn's kernel) aside
    if nowarp["launches"][k3] != 0 or {k: v for k, v in nowarp["launches"].items() if k != k3} \
            != {k: v for k, v in full["launches"].items() if k != k3}:
        raise SystemExit(f"FAIL: disable_warp launches {nowarp['launches']}")
    # the pano branch alone: no K3, a part of the full forward's launches
    if pano["launches"][k3] != 0 or pano["pers"] is not None or any(
            n > full["shapes"].get(key, 0) for key, n in pano["shapes"].items()) or \
            sum(pano["launches"].values()) >= sum(full["launches"].values()):
        raise SystemExit(f"FAIL: pano_only launches {pano['launches']}")
    for r in runs.values():
        r["shapes"] = {f"{k[0]} {k[1]}": v for k, v in r["shapes"].items()}
    stats["entry"] = runs
    return stats


# ---------------------------------------------------------------------------
# phase 13: the multi-device path (parallel/mesh.py) on one card
# ---------------------------------------------------------------------------

MESH_VIEWS = 20
# the loss and the global gradient norm of the training step with and
# without the group: 2 bf16 ulps
MESH_TRAIN_REL = 2 ** -7
# the per-shard sites of a W-rank mesh: (kernel, site of SITES, what the
# shard divides, world sizes); a rank keeps the last block of a W-rank mesh.
# The perspective sites divide their view batch or their view queries; the
# pano sites, at the worlds whose pano rows shard (2 and 4 at 64 latent
# rows), divide their queries (the rank's latent rows against every row's
# keys), the pano-query WarpAttn bias to the rank's row block, and the
# motion module's locations
SHARD_SITES = [
    ("tiny_attention", "pers_spatial_s0", "batch", (2, 4)),
    ("shared_bias_attention", "warp_r2_pers_q", "queries", (2, 4)),
    ("frame_attention", "motion_pers_s0", "batch", (2, 4)),
    ("flash_bwd_dq", "train_warp_r2_pers_q", "queries", (2,)),
    ("flash_bwd_dkv", "train_warp_r2_pers_q", "queries", (2,)),
    ("mh_flash_attention", "pano_spatial_s0", "queries", (2, 4)),
    ("mh_flash_attention", "pano_spatial_s1", "queries", (2, 4)),
    ("tiny_attention", "pano_spatial_s2", "queries", (2, 4)),
    ("shared_bias_attention", "warp_r2_pano_q", "queries", (2, 4)),
    ("frame_attention", "motion_pano_s0", "locations", (2, 4)),
    ("flash_attention_lse", "train_pano_spatial_s0", "queries", (2,)),
    ("flash_bwd_dq", "train_pano_spatial_s0", "queries", (2,)),
    ("flash_bwd_dkv", "train_pano_spatial_s0", "queries", (2,)),
]
PANO_LATENT_ROWS, UNET_LEVELS = 64, 4     # full_dual_config on a 512 x 1024 pano


def shard_shape(shape, what, world):
    """The per-rank shape of a site on a `world`-rank mesh: the batch rows
    (B), the query rows (Sq) or K4's locations (HW) divided over the
    ranks."""
    i = {"batch": 0, "queries": 1, "locations": 2}[what]
    if shape[i] % world:
        raise SystemExit(f"FAIL: {shape} does not shard over {world} ranks")
    return shape[:i] + (shape[i] // world,) + shape[i + 1:]


def phase_mesh_train(dev, mesh, views=MESH_VIEWS, frames=TRAIN_FRAMES, cfg=None,
                     latent_hw=((32, 32), (64, 128)), batch_kw=None):
    """One training forward and backward of phase 6's configuration (remat
    on) without and then with `mesh` active, from the same weights, batch
    and draws, before any optimizer update (the optimizer keeps no state
    and takes no step, so no master weights or moments are held). `cfg`,
    `latent_hw` and `batch_kw` replace the production ones when the phase
    is rehearsed at a tiny size. Returns the stats of both runs."""
    import dataclasses

    import torch.distributed as dist

    from imagine360_tpu_torch.geometry.cameras import CameraRig
    from imagine360_tpu_torch.models.dual import DualUNet, warp_sites
    from imagine360_tpu_torch.ops import attention as attn
    from imagine360_tpu_torch.parallel import mesh as meshlib
    from imagine360_tpu_torch.pipeline.sampler import build_dual_warp_geoms
    from imagine360_tpu_torch.presets import full_dual_config
    from imagine360_tpu_torch.training.train import (Optimizer, TrainConfig, TrainState,
                                                     make_dual_batch, make_train_step)
    from imagine360_tpu_torch.utils.init import seeded_init_

    cfg = cfg or full_dual_config("bfloat16")
    unet = dataclasses.replace(cfg.pers, remat=True)
    cfg = dataclasses.replace(cfg, pers=unet, pano=unet, num_views=views)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        model = DualUNet(cfg)
    model = model.to(unet.torch_dtype).train()
    seeded_init_(model, gen)
    rig = CameraRig.icosahedron(image_size=256).take(views)
    pers_hw, equi_hw = latent_hw
    batch = make_dual_batch(gen, cfg, frames, pers_hw, equi_hw, device=dev, **(batch_kw or {}))
    n_tok, c_tok = unet.num_ip_tokens, unet.image_cross_attention_dim
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    draws = dict(t=torch.randint(0, 1000, (1,), generator=gen, device=dev),
                 noise_pers=rnd(*batch["pers_latents"].shape),
                 noise_pano=rnd(*batch["pano_latents"].shape),
                 use_opp=(torch.rand(len(warp_sites(len(unet.block_out_channels))),
                                     generator=gen, device=dev) < 0.4).tolist(),
                 ip_noise=(rnd(views, n_tok, c_tok), rnd(1, n_tok, c_tok)))

    class GradProbe(Optimizer):
        """Keeps no state and takes no step: the gradients are compared."""
        def init(self, params):
            return {}

        def update(self, grads, state, params):
            return False

    probe = GradProbe(TrainConfig())
    # the module's own tensors stand in for the masters: no step is taken
    state = TrainState({n: p for n, p in model.named_parameters()}, {})
    real_all_reduce, n_all_reduce = dist.all_reduce, [0]

    def counted(*args, **kwargs):
        n_all_reduce[0] += 1
        return real_all_reduce(*args, **kwargs)

    runs = {}
    for label, m in (("one_device", None), ("mesh", mesh)):
        with meshlib.activate_mesh(m):
            rows_shard = meshlib.pano_row_mesh(equi_hw[0], len(unet.block_out_channels)) \
                is not None
            geoms = build_dual_warp_geoms(cfg, rig, pers_hw, equi_hw, device=dev)
            step, _ = make_train_step(model, geoms, optimizer=probe, train_cfg=probe.cfg,
                                      device=dev)
            attn.reset_counts()
            meshlib.reset_collective_counts()
            n_all_reduce[0] = 0
            dist.all_reduce = counted
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.time()
                _, metrics = step(state, batch, **draws)
                torch.cuda.synchronize()
                step_s = time.time() - t0
            finally:
                dist.all_reduce = real_all_reduce
        check_tensor_cores(f"training ({label})", attn.kernels)
        runs[label] = dict(loss=metrics["loss"].item(), grad_norm=metrics["grad_norm"].item(),
                           step_s=step_s, peak_bytes=torch.cuda.max_memory_allocated(),
                           all_reduce_calls=n_all_reduce[0], pano_rows_shard=rows_shard,
                           collectives=meshlib.collective_counts(),
                           plain_path_calls=attn.plain_path_calls(),
                           launches=dict(path_launches(attn.kernels),
                                         shared_bias_attention_lse=attn.kernels.lse_counts()[
                                             "shared_bias_attention"]))
        del geoms, step
        log(f"  training {label}: loss {runs[label]['loss']:.6f}, grad norm "
            f"{runs[label]['grad_norm']:.6f}, {step_s:.3f} s forward + backward, peak device "
            f"memory {runs[label]['peak_bytes'] / 2**30:.2f} GiB, all-reduce calls "
            f"{n_all_reduce[0]}, collectives {json.dumps(runs[label]['collectives'])}, "
            f"pano rows sharded {rows_shard}, plain-path attention calls "
            f"{runs[label]['plain_path_calls']}")
    n_params, n_sites = len(state.params), len(draws["use_opp"])
    one, sharded = runs["one_device"], runs["mesh"]
    rel = {k: abs(sharded[k] - one[k]) / abs(one[k]) for k in ("loss", "grad_norm")}
    runs.update(rel_diff=rel, parameters=n_params)
    del model, state, batch
    if not (all(math.isfinite(r[k]) for r in (one, sharded) for k in ("loss", "grad_norm"))
            and max(rel.values()) <= MESH_TRAIN_REL):
        raise SystemExit(f"FAIL: the training step under the mesh {sharded} against one "
                         f"device {one}")
    # every gradient, the loss and the gradient of every gathered tensor went
    # through the group's all-reduce: each WarpAttn site's perspective keys
    # and, with the pano's rows sharded, its gathered pano, the pano output,
    # every spatial self-attention's keys and every GroupNorm's statistics;
    # the halo rows went both ways
    coll = sharded["collectives"]
    want = n_params + 1 + coll["gather_grad"]
    least = n_sites + (n_sites + 1 if sharded["pano_rows_shard"] else 0)
    if one["all_reduce_calls"] != 0 or sharded["all_reduce_calls"] != want or \
            coll["gather_grad"] < least or (sharded["pano_rows_shard"] and not (
                coll["halo"] and coll["halo_grad"])):
        raise SystemExit(f"FAIL: all-reduce calls {one['all_reduce_calls']} (one device), "
                         f"{sharded['all_reduce_calls']} (mesh), want 0 and {want}; "
                         f"collectives {coll}, at least {least} gathers differentiated")
    # K5b and K5c: every launch on a wgmma body, the WarpAttn ones (under
    # the rank's rows of the bias) on the biased one, with and without the
    # group: (launches, on a wgmma body, on the biased one)
    bwd = {label: {k: tuple(r["launches"][k + sfx] for sfx in ("", "_wgmma", "_wgmma_bias"))
                   for k in TRAIN_BWD_WGMMA} for label, r in (("one_device", one),
                                                              ("mesh", sharded))}
    log(f"  K5b / K5c launches (all, on a wgmma body, on the biased one) {json.dumps(bwd)}")
    if any(n != wg or not wb for r in bwd.values() for n, wg, wb in r.values()):
        raise SystemExit(f"FAIL: K5b / K5c launches of the training step (all, on a wgmma "
                         f"body, on the biased one) {bwd}: some took mma.sync")
    need = ("tiny_attention", "shared_bias_attention", "frame_attention",
            "flash_attention_lse", "flash_bwd_dq", "flash_bwd_dkv")
    if sharded["plain_path_calls"] or one["plain_path_calls"] or \
            sharded["launches"] != one["launches"] or \
            min(sharded["launches"][k] for k in need) == 0:
        raise SystemExit(f"FAIL: training launches under the mesh {sharded['launches']}, one "
                         f"device {one['launches']}")
    return runs


def phase_mesh(kernels, dev, slice_latents, slice_stats):
    """Phase 13: a world-size-1 NCCL group through init_from_config
    (use_mesh: on); phase 4's loop on phase 4's weights and inputs under it,
    the pano's rows sharded; the training step with and without it; then
    the kernels at the per-shard shapes of a 2- and a 4-rank mesh. Returns (the loop's
    launches, the training launches under the mesh, the per-shard rows,
    stats)."""
    import torch.distributed as dist

    from imagine360_tpu_torch.config import RunConfig
    from imagine360_tpu_torch.parallel import mesh as meshlib

    mesh = meshlib.init_from_config(RunConfig(use_mesh="on"), dev, views=MESH_VIEWS)
    try:
        backend = dist.get_backend()
        nccl = ".".join(map(str, torch.cuda.nccl.version()))
        log(f"  group: backend {backend}, NCCL {nccl}, world {mesh.world}, rank {mesh.rank}, "
            f"replicas {mesh.replicas}, device {mesh.device}")
        if backend != "nccl" or mesh.world != 1 or mesh.device.type != "cuda":
            raise SystemExit(f"FAIL: the mesh is {mesh} on {backend}, want NCCL on the card")
        with meshlib.activate_mesh(mesh):
            layout = meshlib.pano_layout(PANO_LATENT_ROWS, UNET_LEVELS)
            rows_shard = meshlib.pano_row_mesh(PANO_LATENT_ROWS, UNET_LEVELS) is mesh
        log(f"  the rule: {layout}")
        if not rows_shard:
            raise SystemExit(f"FAIL: on a world of {mesh.world} the pano rows must shard")
        latents = {}
        meshlib.reset_collective_counts()
        launches, _, stats = phase_slice(dev, mesh=mesh, latents_out=latents)
        loop_coll = meshlib.collective_counts()
        log(f"  collectives of the loop under the mesh {json.dumps(loop_coll)}")
        if not (loop_coll["halo"] and loop_coll["gather"]) or loop_coll["gather_grad"]:
            raise SystemExit(f"FAIL: the loop under the mesh ran collectives {loop_coll}: "
                             "the pano-row path did not run")
        diff = {k: (latents[k].float() - slice_latents[k].float()).abs().max().item()
                for k in ("pano", "pers")}
        tol = {k: bf16_limit(slice_latents[k].float().abs().max().item()) for k in diff}
        per_step, per_step4 = (st["launches_per_step_by_kernel"] for st in (stats, slice_stats))
        log(f"  loop under the mesh: {stats['s_per_step']:.3f} s/step (phase 4: "
            f"{slice_stats['s_per_step']:.3f}), peak {stats['peak_bytes'] / 2**30:.2f} GiB "
            f"(phase 4: {slice_stats['peak_bytes'] / 2**30:.2f}); largest difference from "
            f"phase 4's latents {json.dumps(diff)} (limits {json.dumps(tol)}); launches per "
            f"step equal phase 4's: {per_step == per_step4}")
        if any(diff[k] > tol[k] for k in diff) or per_step != per_step4:
            raise SystemExit(f"FAIL: the loop under the mesh: differences {diff} (limits "
                             f"{tol}), launches per step {per_step} against {per_step4}")
        gc.collect()
        torch.cuda.empty_cache()
        train = phase_mesh_train(dev, mesh)
    finally:
        meshlib.destroy()
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(13)
    sites = {site: shape for _, site, shape in SITES}
    rows = []
    for name, site, what, worlds in SHARD_SITES:
        for world in worlds:
            shape = shard_shape(sites[site], what, world)
            rows.append(dict(site_row(kernels, name, f"{site}_w{world}", shape, gen, dev,
                                      shard=(world, world - 1)), world=world, shards=what))
    return launches, train["mesh"]["launches"], rows, dict(
        nccl=nccl, backend=backend, pano_layout=layout, loop=stats, loop_collectives=loop_coll,
        loop_latent_diff=diff, loop_latent_tol=tol, train=train)


def kernel_report(per_kernel, loop_launches, pipe_launches, wide_launches, train_launches,
                  opt_in_launches, lab_launches, sr_launches, sr_engines, mesh_loop_launches,
                  mesh_train_launches):
    """The JSON kernel list. `launches` is over the main paths, each driven
    from zeroed counts: the three default ones for K1-K5c, and for the
    opt-in kernels also phase 7's (`opt_in_loop`: the loop behind the
    switches for K6a and K7, its own entry point on the loop's masks for
    K6b), and for K4 and its lab variants phase 8's (`motion_lab`: run_lab
    at the eight motion sites). The wide variants run in the pipeline (the
    VAE) and the wide K2 also in phase 9 (`sr_decode`, the temporal decoder)
    and in phases 10 and 11 (`sr_pano`, `sr_v2v`: the SR stage, whose K1, K2
    and K4 launches are listed there too; `sr_engines` maps each to its
    launches and its wide launches), and a wrapper's count includes them,
    so they are taken off the narrow kernel's; K3's launches that also
    wrote the lse (all of the training step's) are listed as
    `shared_bias_attention_lse`, and taken off K3's. Phase 13's runs under
    the mesh are paths of their own: its loop (`mesh_denoise_loop`) for
    K1-K4 and its training step (`mesh_train_step`) for K5a-c."""
    def sr_paths(name, wide):
        return {path: (n_wide.get(name, 0) if wide else launches.get(name, 0) - n_wide.get(
            name, 0)) for path, (launches, n_wide) in sr_engines.items()}

    def entry(name, wide):
        rec = per_kernel[name + "_wide" if wide else name]
        n_wide = wide_launches.get(name, 0)
        if wide:
            by_path = {"denoise_loop": 0, "pipeline": n_wide, "train_step": 0,
                       "sr_decode": sr_launches[name], **sr_paths(name, True)}
        elif name in TRAIN_KERNELS:
            by_path = {"denoise_loop": 0, "pipeline": 0, "train_step": train_launches[name],
                       "mesh_train_step": mesh_train_launches[name]}
        elif name in OPT_IN_KERNELS + LAB_KERNELS:
            by_path = {"denoise_loop": loop_launches[name], "pipeline": pipe_launches[name],
                       "train_step": train_launches[name],
                       "opt_in_loop": opt_in_launches[name]}
        else:
            n_lse = train_launches["shared_bias_attention_lse"] \
                if name == "shared_bias_attention" else 0
            by_path = {"denoise_loop": loop_launches[name],
                       "pipeline": pipe_launches[name] - n_wide,
                       "train_step": train_launches[name] - n_lse, **sr_paths(name, False),
                       "mesh_denoise_loop": mesh_loop_launches[name]}
        if name in ("frame_attention",) + LAB_KERNELS:     # the lab and its baseline
            by_path["motion_lab"] = lab_launches[name]
        out = {"name": name + "_wide" if wide else name, "route": "cuda",
               "tensor_cores": name in TC_SITE_KERNELS,
               "source": (WIDE_SOURCES if wide else SOURCES)[name],
               "replaces": REPLACES[name], "launches": sum(by_path.values()),
               "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
               "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
               "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
               "site": rec["site"], "launches_by_path": by_path}
        if "library_bwd_ms" in rec:      # K5b, K5c: the backward alone
            out["library_bwd_ms"] = rec["library_bwd_ms"]
        if not wide and name in TWO_BODY_KERNELS:
            out["bodies"] = bodies(name, by_path)
        return out

    path_counts = {"denoise_loop": loop_launches, "pipeline": pipe_launches,
                   "train_step": train_launches, "opt_in_loop": opt_in_launches,
                   "mesh_denoise_loop": mesh_loop_launches,
                   "mesh_train_step": mesh_train_launches,
                   **{path: launches for path, (launches, _) in sr_engines.items()}}

    def bodies(name, by_path):
        """A two-body kernel's launches and numbers by body: the wgmma one
        (K6a's at D = 64; its biased one `wgmma_bias`) and the mma.sync one
        (the rest of the narrow launches), each at its first phase-2 site
        (K5a's, K6a's and K6b's mma.sync body: both_bodies). The training
        step's K3 launches, all of them with the lse and on the wgmma body,
        are listed under `shared_bias_attention_lse`, not here."""
        wg = {path: path_counts[path].get(f"{name}_wgmma", 0) for path in by_path}
        wb = {path: path_counts[path].get(f"{name}_wgmma_bias", 0) for path in by_path}
        if name == "shared_bias_attention":
            wg["train_step"] -= train_launches["shared_bias_attention_lse"]
        out = {}
        for body, src in KERNEL_BODY_SOURCES.get(name, BODY_SOURCES).items():
            n = {"wgmma": {k: wg[k] - wb[k] for k in by_path}, "wgmma_bias": wb}.get(
                body, {k: by_path[k] - wg[k] for k in by_path})
            r = per_kernel.get(f"{name}@{body}", {})
            out[body] = dict({k: r.get(k) for k in ("site", "max_abs_err", "ms", "plain_ms",
                                                    "library_ms", "bound_ms", "bound_by")},
                             source=src, launches=sum(n.values()), launches_by_path=n)
        return out

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

    script_t0 = t0 = time.time()
    lib = kernels.build_library()
    kernels.load_library()
    build_s = time.time() - t0
    log(f"phase 1: built {lib.name} in {build_s:.1f} s")
    from imagine360_tpu_torch import native
    t0 = time.time()
    host_lib = native.build_library()
    native.load_library()
    host_build_s = time.time() - t0
    log(f"phase 1: built the host library {host_lib.name} in {host_build_s:.1f} s "
        f"({native.NUM_THREADS} threads a call)")
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
    slice_latents = {}
    loop_launches, per_step, slice_stats = phase_slice(dev, latents_out=slice_latents)
    log(f"phase 5: Imagine360Pipeline at full width, bf16, {PIPELINE_STEPS} DDIM steps")
    tmp = None if args.out else tempfile.mkdtemp(prefix="i360_smoke_")
    try:
        pipe_launches, wide_launches, by_site, pipe_stats, pipe_video, pipe_out = \
            phase_pipeline(dev, os.path.join(args.out or tmp, "pipeline"))
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
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 9: the SR decode, temporal-decoder VAE at full width, bf16, {SR_FRAMES} "
        f"frames of {SR_UP * SR_SOURCE_HW[0]} x {SR_UP * SR_SOURCE_HW[1]} + {SR_PAD_PX} px "
        "pads, then the wavelet colour fix")
    sr_launches, sr_shapes, sr_stats = phase_sr_decode(dev)
    gc.collect()
    torch.cuda.empty_cache()
    sr_engines, sr_engine_shapes, sr_engine_stats = {}, {}, {}
    clip = pipe_video.astype("float32")
    tmp = None if args.out else tempfile.mkdtemp(prefix="i360_smoke_")
    try:
        for phase, engine in ((10, "pano"), (11, "v2v")):
            log(f"phase {phase}: the SR stage, {engine} engine, at full width, bf16: "
                f"Video360Enhancer on phase 5's {clip.shape[0]} frames of {clip.shape[1]} x "
                f"{clip.shape[2]}")
            launches, shapes, stats = phase_sr_engine(dev, engine, clip,
                                                      os.path.join(args.out or tmp, "sr"))
            sr_engines[f"sr_{engine}"] = (launches, stats["wide"])
            sr_engine_shapes[engine], sr_engine_stats[engine] = shapes, stats
        gc.collect()
        torch.cuda.empty_cache()
        log("phase 12: the rest at full width: cubemap and feathered composite of phase 5's "
            "frames, entry()'s forward under profile_trace, disable_warp and pano_only")
        rest_stats = phase_rest(dev, clip, pipe_out["pano_input"].astype("float32"),
                                pipe_out["masks"], args.out or tmp)
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 13: the multi-device path on a world-size-1 NCCL group: phase 4's loop and "
        "a training step under the mesh, the kernels at per-shard shapes of 2 and 4 ranks")
    mesh_loop_launches, mesh_train_launches, shard_rows, mesh_stats = phase_mesh(
        kernels, dev, slice_latents, slice_stats)
    for row in rows:
        key = (row["kernel"], tuple(row["shape"]))
        for engine, shapes in sr_engine_shapes.items():
            if key in shapes:
                row[f"launches_in_sr_{engine}"] = shapes[key]
        if (row["kernel"], tuple(row["shape"])) in sr_shapes:
            row["launches_in_sr_decode"] = sr_shapes[(row["kernel"], tuple(row["shape"]))]
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
            f"{r['bound_by']}); library {r['library_ms']:.3f} ms"
            + (f", its backward alone {r['library_bwd_ms']:.3f} ms" if "library_bwd_ms" in r
               else ""))
    report = kernel_report(per_kernel, loop_launches, pipe_launches, wide_launches,
                           train_launches, opt_in_launches, lab_launches, sr_launches,
                           sr_engines, mesh_loop_launches, mesh_train_launches)
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"card": smi, "build_s": build_s, "host_build_s": host_build_s,
                       "script_s": time.time() - script_t0, "rest": rest_stats,
                       "mma_build": mma_build, "sites": rows, "slice": slice_stats,
                       "pipeline": pipe_stats, "train": train_stats,
                       "opt_in_slice": opt_in_stats, "motion_lab": lab_rows,
                       "sr_decode": sr_stats, "sr_engines": sr_engine_stats,
                       "mesh": mesh_stats, "shard_sites": shard_rows, **report},
                      f, indent=1)
    print(json.dumps(report))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
