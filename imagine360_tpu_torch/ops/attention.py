"""Attention entry points used by every attention site of the port.

`dot_product_attention` (q/k/v [B, S, H, D]) and `temporal_attention`
(q/k/v [B, F, HW, C]) keep the JAX package's layouts
(imagine360_tpu/ops/attention.py). On CUDA tensors they call the kernel
chosen by ops/dispatch.py; on CPU tensors they run the plain einsum and
count one `plain_calls`, so a run on the card can show that no site took
the plain path.
"""
from __future__ import annotations

import torch

from . import kernels
from .dispatch import select_attention_route


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """Multi-head attention; q [B, Sq, H, D], k/v [B, Sk, H, D], bias
    broadcastable to [B, H, Sq, Sk]. Returns [B, Sq, H, D] in q.dtype."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    fscale = float(D ** -0.5 if scale is None else scale)
    route = select_attention_route(B, Sq, Sk, H, D, bias is not None,
                                   q.device.type == "cuda")
    if route == "shared_bias":
        if bias.dim() != 4 or bias.shape[0] != 1 or bias.shape[1] != 1:
            raise ValueError("the shared-bias kernel takes a [1, 1, Sq, Sk] bias, "
                             f"got {tuple(bias.shape)}")
        return kernels.shared_bias_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), bias[0, 0], scale=fscale)
    if route in ("single", "mh_flash"):
        fn = kernels.tiny_attention if route == "single" else kernels.mh_flash_attention
        out = fn(q.reshape(B, Sq, H * D).contiguous(),
                 k.reshape(B, Sk, H * D).contiguous(),
                 v.reshape(B, Sk, H * D).contiguous(), scale=fscale, heads=H)
        return out.reshape(B, Sq, H, D)
    dot_product_attention.plain_calls += 1
    return kernels.reference_attention(q, k, v, bias=bias, scale=fscale)


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int, scale: float | None = None) -> torch.Tensor:
    """Attention over the frame axis: q/k/v [B, F, HW, C]; every spatial
    location attends over its own F frames (the AnimateDiff motion-module
    pattern). Returns [B, F, HW, C]."""
    D = q.shape[-1] // heads
    fscale = float(D ** -0.5 if scale is None else scale)
    if q.device.type == "cuda":
        return kernels.frame_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                       scale=fscale, heads=heads)
    temporal_attention.plain_calls += 1
    return kernels.frame_attention_plain(q, k, v, scale=fscale, heads=heads)


def reset_counts() -> None:
    """Zero every kernel launch count and plain-path count."""
    kernels.reset_counts()
    dot_product_attention.plain_calls = 0
    temporal_attention.plain_calls = 0


def plain_path_calls() -> int:
    """Attention calls that ran a plain version since the last reset."""
    return (dot_product_attention.plain_calls + temporal_attention.plain_calls
            + sum(fn.plain_calls for fn in kernels.KERNELS))


reset_counts()
