"""Attention route selection: a pure function of the call's shape.

Counterpart of imagine360_tpu/ops/dispatch.py:select_attention_route, with
Hopper's reasons instead of the TPU's VMEM budgets. On a CUDA tensor every
attention site of the denoise loop goes to one of the four kernels in
ops/kernels.py:

- "shared_bias" (K3): any site with a bias, head dim up to 160. The biased
  sites are the WarpAttn correspondence masks, one [Sq, Sk] matrix shared
  by every batch row and head, at every resolution (r2, r4 and r8), and the
  CLIP text encoder's causal mask (77 x 77, -inf above the diagonal).
- "single" (K1): no bias and Sk <= 1024. A 16-row tile of f32 logits over
  the whole key row is at most 64 KB and fits in shared memory beside the
  K/V tile, so the softmax is exact in two passes with no running rescale.
  This covers perspective spatial self-attention at every stage, pano
  spatial attention at 512/128 tokens, text/IP cross-attention on both
  branches, the resampler, the TemporalProjection frame attention, and
  the VAE mid-block attention on 256 x 256 views (1024 tokens, one head
  of 512).
- "mh_flash" (K2): no bias and Sk > 1024 (pano spatial self-attention at
  8192 and 2048 tokens, and the VAE mid-block attention on panoramas:
  8192 tokens encoding, 8704 decoding, one head of 512): the row no longer
  fits, so keys stream through an online softmax.

K1 and K2 take head dims up to 512 (above 160 through their wide kernels,
csrc/attn_wide.cuh); beyond that, or above 160 with a bias, no kernel
exists and the selector raises.

The motion modules' frame attention has its own entry point
(ops/attention.py:temporal_attention) and always takes K4 on CUDA.

On the CPU the plain einsum runs: "einsum", or "chunked" when the f32
logits would exceed LOGITS_BYTES_LIMIT. These two exits exist for CPU
tensors only.
"""
from __future__ import annotations

from .kernels import LOGITS_BYTES_LIMIT, MAX_HEAD_DIM, TINY_MAX_SK, WIDE_MAX_HEAD_DIM


def select_attention_route(B: int, Sq: int, Sk: int, H: int, D: int,
                           has_bias: bool, on_cuda: bool) -> str:
    """Which path `dot_product_attention` takes for a call of this shape."""
    if not on_cuda:
        if B * H * Sq * Sk * 4 > LOGITS_BYTES_LIMIT:
            return "chunked"
        return "einsum"
    max_dim = MAX_HEAD_DIM if has_bias else WIDE_MAX_HEAD_DIM
    if D > max_dim:
        raise ValueError(f"no attention kernel takes head dim {D} "
                         f"{'with' if has_bias else 'without'} a bias (max {max_dim})")
    if has_bias:
        return "shared_bias"
    if Sk <= TINY_MAX_SK:
        return "single"
    return "mh_flash"
