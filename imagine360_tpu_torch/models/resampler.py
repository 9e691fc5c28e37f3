"""Perceiver resampler and temporal projection for image-prompt (IP-plus)
conditioning from SAM video features (counterpart of
imagine360_tpu/models/resampler.py; reference names: layers.i.0 /
layers.i.1.{0,1,3}, ff.{0,1,3}, patch_embed)."""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from .layers import Attention, LayerNorm


def ResamplerFeedForward(dim: int, mult: int = 4) -> nn.Sequential:
    """LayerNorm -> Linear -> GELU -> Linear, no biases."""
    inner = int(dim * mult)
    return nn.Sequential(LayerNorm(dim), nn.Linear(dim, inner, bias=False), nn.GELU(),
                         nn.Linear(inner, dim, bias=False))


class PerceiverAttention(nn.Module):
    """Latents attend to concat(x, latents)."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, latents):
        x = self.norm1(x)
        latents = self.norm2(latents)
        B, L, _ = latents.shape
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)
        S = k.shape[1]
        out = dot_product_attention(q.reshape(B, L, self.heads, -1),
                                    k.reshape(B, S, self.heads, -1),
                                    v.reshape(B, S, self.heads, -1))
        return self.to_out(out.flatten(2))


class Resampler(nn.Module):
    """Learned latent queries -> perceiver layers -> IP tokens."""

    def __init__(self, dim: int = 1024, depth: int = 4, heads: int = 12, dim_head: int = 64,
                 num_queries: int = 64, embedding_dim: int = 1024, output_dim: int = 1024,
                 ff_mult: int = 4):
        super().__init__()
        self.latents = nn.Parameter(torch.randn(1, num_queries, dim) / dim ** 0.5)
        self.proj_in = nn.Linear(embedding_dim, dim)
        self.layers = nn.ModuleList([
            nn.ModuleList([PerceiverAttention(dim, heads, dim_head),
                           ResamplerFeedForward(dim, ff_mult)]) for _ in range(depth)])
        self.proj_out = nn.Linear(dim, output_dim)
        self.norm_out = LayerNorm(output_dim)

    def forward(self, x):
        # x [B, S, embedding_dim] -> [B, num_queries, output_dim]
        latents = self.latents.expand(x.shape[0], -1, -1)
        x = self.proj_in(x)
        for attn, ff in self.layers:
            latents = attn(x, latents) + latents
            latents = ff(latents) + latents
        return self.norm_out(self.proj_out(latents))


class TemporalProjection(nn.Module):
    """SAM per-frame features -> 4x4 patch embed -> frame self-attention +
    FF -> pool 4 frames -> again -> pool. [B, F, D, C] -> [B, F/16, D/16, 4C]
    for SAM (C = 256 < 1024)."""

    def __init__(self, dim: int = 256, heads: int = 8, dim_head: int = 64,
                 kernel_size: int = 4, compress_video_features: bool = True):
        super().__init__()
        self.kernel_size = kernel_size
        self.compress = compress_video_features
        self.spatial_compress = dim < 1024
        C = dim * 4 if self.spatial_compress else dim
        if self.spatial_compress:
            self.patch_embed = nn.Conv2d(dim, C, kernel_size, kernel_size)
        self.attn_temp = Attention(C, heads, dim_head)
        self.norm_temp = LayerNorm(C)
        self.ff = ResamplerFeedForward(C)
        self.norm1 = LayerNorm(C)
        if compress_video_features:
            self.attn_temp_2 = Attention(C, heads, dim_head)
            self.norm_temp_2 = LayerNorm(C)
            self.ff_2 = ResamplerFeedForward(C)
            self.norm2 = LayerNorm(C)

    def _temporal_attn(self, x, attn, norm):
        # [B, F, D, C] -> attention over F at each spatial token
        B, Fr, D, C = x.shape
        h = x.permute(0, 2, 1, 3).reshape(B * D, Fr, C)
        h = attn(norm(h)) + h
        return h.reshape(B, D, Fr, C).permute(0, 2, 1, 3)

    def _pool_frames(self, x):
        B, Fr, D, C = x.shape
        g = Fr // self.kernel_size
        return x[:, :g * self.kernel_size].reshape(B, g, self.kernel_size, D, C).mean(dim=2)

    def forward(self, x):
        B, Fr, D, C = x.shape
        if self.spatial_compress:
            hw = math.isqrt(D)
            # [B*F, hw, hw, C] -> channels_last NCHW view for the conv
            h = x.reshape(B * Fr, hw, hw, C).permute(0, 3, 1, 2)
            h = F.conv2d(h, self.patch_embed.weight, self.patch_embed.bias,
                         stride=self.kernel_size)
            x = h.permute(0, 2, 3, 1).reshape(B, Fr, -1, h.shape[1])
        x = self._temporal_attn(x, self.attn_temp, self.norm_temp)
        x = self.ff(self.norm1(x)) + x
        if self.compress:
            x = self._pool_frames(x)
            x = self._temporal_attn(x, self.attn_temp_2, self.norm_temp_2)
            x = self.ff_2(self.norm2(x)) + x
            x = self._pool_frames(x)
        return x
