"""AnimateDiff temporal motion module: attention over the frame axis at
every spatial location (counterpart of imagine360_tpu/models/motion.py).

The module stays in the natural [B, F, HW, C] layout throughout; the
reference's `(b f) d c -> (b d) f c` fold is the business of
ops/attention.temporal_attention (kernel K4 on the card). Module names are
the reference's: motion_modules.N.temporal_transformer.transformer_blocks.0
.attention_blocks.{0,1}.to_q, ...
"""
from __future__ import annotations

import torch.nn as nn

from ..ops.attention import temporal_attention
from .layers import FeedForward, GroupNorm, LayerNorm, MMDense, sinusoidal_position_table


class VersatileAttention(nn.Module):
    """Temporal self-attention over frames with the sinusoidal position
    table added to its input (reference VersatileAttention, Temporal_Self).
    Input [B, F, HW, C]."""

    def __init__(self, dim: int, heads: int, max_len: int = 64):
        super().__init__()
        self.heads, self.max_len = heads, max_len
        inner = heads * (dim // heads)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(self, x):
        F, C = x.shape[1], x.shape[-1]
        pe = sinusoidal_position_table(self.max_len, C, device=x.device)[:F]
        x = x + pe.to(x.dtype)[None, :, None, :]
        out = temporal_attention(self.to_q(x), self.to_k(x), self.to_v(x), self.heads)
        return self.to_out[0](out)


class TemporalTransformerBlock(nn.Module):
    """Two temporal self-attentions and a GEGLU FF, each pre-norm with a
    residual."""

    def __init__(self, dim: int, heads: int, max_len: int = 64):
        super().__init__()
        self.attention_blocks = nn.ModuleList(
            [VersatileAttention(dim, heads, max_len) for _ in range(2)])
        self.norms = nn.ModuleList([LayerNorm(dim) for _ in range(2)])
        self.ff = FeedForward(dim)
        self.ff_norm = LayerNorm(dim)

    def forward(self, x):
        for attn, norm in zip(self.attention_blocks, self.norms):
            x = attn(norm(x)) + x
        return self.ff(self.ff_norm(x)) + x


class TemporalTransformer3DModel(nn.Module):
    """GroupNorm (eps 1e-6) -> proj_in -> temporal blocks -> proj_out, plus
    the residual."""

    def __init__(self, channels: int, heads: int, num_layers: int = 1, max_len: int = 64):
        super().__init__()
        self.norm = GroupNorm(32, channels, 1e-6, inflated=True)
        self.proj_in = MMDense(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [TemporalTransformerBlock(channels, heads, max_len) for _ in range(num_layers)])
        self.proj_out = MMDense(channels, channels)

    def forward(self, x, rows=None):
        """x [B, F, H, W, C]; under `rows` (models/layers.py) only the
        GroupNorm's statistics cross the ranks: the frame attention is per
        location."""
        B, F, H, W, C = x.shape
        h = self.proj_in(self.norm(x, rows).reshape(B, F, H * W, C))
        for blk in self.transformer_blocks:
            h = blk(h)
        return self.proj_out(h).reshape(B, F, H, W, C) + x


class MotionModule(nn.Module):
    """VanillaTemporalModule (config: 8 heads, 1 block, PE max_len 64)."""

    def __init__(self, channels: int, heads: int = 8, num_layers: int = 1,
                 max_len: int = 64):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3DModel(channels, heads, num_layers,
                                                               max_len)

    def forward(self, x, rows=None):
        return self.temporal_transformer(x, rows)
