"""Attention route selection: a pure function of the call's shape.

Counterpart of imagine360_tpu/ops/dispatch.py:select_attention_route, with
Hopper's reasons instead of the TPU's VMEM budgets. On a CUDA tensor every
attention site goes to one of the kernels in ops/kernels.py. Without grad:

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

Under grad (`needs_grad`: grad mode is on and q, k or v requires it) the
forward must leave what the backward needs:

- "shared_bias" stays K3, which then also writes its lse; the backward is
  K5b + K5c reading the same shared bias.
- "mh_flash" becomes "flash_lse": K2 keeps no lse, so the long no-bias
  sites (pano spatial self-attention at 8192 and 2048 tokens) take K5a
  forward, K5b + K5c backward. A bias that is not one shared [Sq, Sk]
  matrix ([B, H, Sq, Sk] or broadcast on one axis only) takes "flash_lse"
  too: K3 reads only a shared matrix, K5a-c take a pair of bias strides.
- "single" stays K1: a site of at most 1024 keys has no backward kernel,
  as in the JAX package; its backward recomputes the einsum reference from
  q, k, v (ops/attention.py), batch-chunked under LOGITS_BYTES_LIMIT.
- K5a-c take head dims up to 160 only: beyond that the selector raises.

The motion modules' frame attention has its own entry point
(ops/attention.py:temporal_attention) and always takes K4 on CUDA, with the
einsum-reference backward under grad.

On the CPU without grad the plain einsum runs: "einsum", or "chunked" when
the f32 logits would exceed LOGITS_BYTES_LIMIT. Under grad a CPU call takes
the same routes as a CUDA one, so the same autograd functions run there with
each wrapper's plain version in the kernel's place (a head dim no kernel
takes falls to the plain einsum and PyTorch's own autograd). The two plain
exits exist for CPU tensors only.
"""
from __future__ import annotations

from .kernels import LOGITS_BYTES_LIMIT, MAX_HEAD_DIM, TINY_MAX_SK, WIDE_MAX_HEAD_DIM


def select_attention_route(B: int, Sq: int, Sk: int, H: int, D: int,
                           has_bias: bool, on_cuda: bool, needs_grad: bool = False,
                           bias_is_shared: bool = True) -> str:
    """Which path `dot_product_attention` takes for a call of this shape.
    `bias_is_shared`: the bias is one [1, 1, Sq, Sk] matrix."""
    plain = "chunked" if B * H * Sq * Sk * 4 > LOGITS_BYTES_LIMIT else "einsum"
    if not on_cuda and not needs_grad:
        return plain
    streams = has_bias or Sk > TINY_MAX_SK
    max_dim = MAX_HEAD_DIM if has_bias or (needs_grad and streams) else WIDE_MAX_HEAD_DIM
    if D > max_dim:
        if not on_cuda:
            return plain
        raise ValueError(f"no attention kernel takes head dim {D} "
                         f"{'with' if has_bias else 'without'} a bias"
                         f"{' under grad' if needs_grad else ''} (max {max_dim})")
    if has_bias:
        return "shared_bias" if bias_is_shared or not needs_grad else "flash_lse"
    if Sk <= TINY_MAX_SK:
        return "single"
    return "flash_lse" if needs_grad else "mh_flash"
