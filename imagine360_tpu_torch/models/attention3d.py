"""Per-frame spatial transformer with text + image-prompt cross-attention
(counterpart of imagine360_tpu/models/attention3d.py).

Under `rows` (the pano's row-sharded layout, models/layers.py) the tokens
are this rank's rows, one contiguous block of the H-major [H*W] sequence:
the self-attention's queries stay local and its keys and values are
projected from the normed tokens of every rank, gathered once per block in
rank order (half the bytes of gathering K and V). Cross-attention, the
LayerNorms and the FF are local."""
from __future__ import annotations

import torch.nn as nn

from ..parallel.mesh import gather_pano
from .layers import (Attention, FeedForward, GroupNorm, IPCrossAttention, LayerNorm,
                     MMDense)


class SpatialTransformerBlock(nn.Module):
    """norm1 -> self-attn -> norm2 -> (IP) cross-attn -> norm3 -> GEGLU FF,
    each with a residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 use_ip: bool = True, ip_scale: float = 1.0, num_ip_tokens: int = 64):
        super().__init__()
        self.use_ip, self.num_ip_tokens = use_ip, num_ip_tokens
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        if use_ip:
            self.attn2 = IPCrossAttention(dim, context_dim, heads, dim_head, ip_scale)
        else:
            self.attn2 = Attention(dim, heads, dim_head, context_dim=context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, rows=None):
        h = self.norm1(x)
        x = self.attn1(h, gather_pano(h, rows, 1)) + x
        h = self.norm2(x)
        if self.use_ip:
            n = self.num_ip_tokens
            x = self.attn2(h, context[:, :-n], context[:, -n:]) + x
        else:
            x = self.attn2(h, context) + x
        return self.ff(self.norm3(x)) + x


class Transformer3DModel(nn.Module):
    """GroupNorm -> linear proj_in -> blocks -> linear proj_out + residual,
    per frame (use_linear_projection=True)."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 num_layers: int = 1, use_ip: bool = True, ip_scale: float = 1.0,
                 num_ip_tokens: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(32, channels, 1e-6, inflated=True)
        self.proj_in = MMDense(channels, inner)
        self.transformer_blocks = nn.ModuleList([
            SpatialTransformerBlock(inner, heads, dim_head, context_dim, use_ip, ip_scale,
                                    num_ip_tokens) for _ in range(num_layers)])
        self.proj_out = MMDense(inner, channels)

    def forward(self, x, context, rows=None):
        # x [B, F, H, W, C]; context [B, L, Cctx], shared by the B's frames
        B, F, H, W, C = x.shape
        h = self.proj_in(self.norm(x, rows).reshape(B * F, H * W, C))
        ctx = context.repeat_interleave(F, dim=0)
        for blk in self.transformer_blocks:
            h = blk(h, ctx, rows)
        return self.proj_out(h).reshape(B, F, H, W, C) + x
