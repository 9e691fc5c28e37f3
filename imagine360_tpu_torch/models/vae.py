"""SD2.1 AutoencoderKL (f8, 4-channel latents, scale 0.18215), the
counterpart of imagine360_tpu/models/vae.py.

Public layout is the JAX package's: images and latents are [N, H, W, C].
Module and parameter names are diffusers' AutoencoderKL names
(`encoder.down_blocks.0.resnets.0.conv1.weight`,
`decoder.mid_block.attentions.0.to_q.weight`, ...), so a diffusers
`state_dict` loads directly.

Inside, tensors are [N, C, H, W] views of channels-last memory (the permute
of an NHWC tensor), so cuDNN runs its NHWC convolutions without a copy.
GroupNorm is `F.group_norm` with eps 1e-6. The mid-block attention is one
head as wide as the block (512): it goes through
ops/attention.py:dot_product_attention, on CUDA to kernel K1 for a 256 x 256
view (1024 tokens) and to K2 for a panorama (8192 or 8704 tokens).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _norm(groups: int, channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=1e-6)


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int = 32):
        super().__init__()
        self.norm1 = _norm(groups, in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = _norm(groups, out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial tokens (diffusers VAE
    mid-block Attention)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = _norm(groups, channels)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        o = dot_product_attention(q[:, :, None, :], k[:, :, None, :], v[:, :, None, :])
        o = self.to_out[0](o[:, :, 0, :])
        return x + o.reshape(B, H, W, C).permute(0, 3, 1, 2)


class _MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(channels, channels, groups),
                                      VAEResnetBlock(channels, channels, groups)])
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class _Resample(nn.Module):
    """diffusers Downsample2D / Upsample2D: holds `conv`."""

    def __init__(self, channels: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=stride,
                              padding=0 if stride == 2 else 1)


class _Block(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, layers: int, groups: int,
                 resample: Optional[str]):
        super().__init__()
        self.resnets = nn.ModuleList([
            VAEResnetBlock(in_channels if j == 0 else out_channels, out_channels, groups)
            for j in range(layers)])
        if resample == "down":
            self.downsamplers = nn.ModuleList([_Resample(out_channels, 2)])
        elif resample == "up":
            self.upsamplers = nn.ModuleList([_Resample(out_channels, 1)])

    def forward(self, h):
        for r in self.resnets:
            h = r(h)
        if hasattr(self, "downsamplers"):
            # diffusers Downsample2D: asymmetric (0, 1) pad, then a stride-2 conv
            h = self.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        elif hasattr(self, "upsamplers"):
            h = self.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return h


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _Block(boc[max(i - 1, 0)], ch, cfg.layers_per_block, g,
                   "down" if i < len(boc) - 1 else None)
            for i, ch in enumerate(boc)])
        self.mid_block = _MidBlock(boc[-1], g)
        self.conv_norm_out = _norm(g, boc[-1])
        self.conv_out = nn.Conv2d(boc[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _MidBlock(rev[0], g)
        self.up_blocks = nn.ModuleList([
            _Block(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1, g,
                   "up" if i < len(rev) - 1 else None)
            for i, ch in enumerate(rev)])
        self.conv_norm_out = _norm(g, rev[-1])
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """encode(x) -> (mean, logvar); decode(z) -> image. [N, H, W, C]."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def _nchw(self, x):
        return x.to(self.quant_conv.weight.dtype).permute(0, 3, 1, 2)

    def encode(self, x):
        """x [N, H, W, 3] -> (mean, logvar), each [N, H/8, W/8, 4]."""
        moments = self.quant_conv(self.encoder(self._nchw(x))).permute(0, 2, 3, 1)
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def sample(self, x, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None):
        """A draw from the posterior of x: mean + std * noise. The unit
        noise [N, H/8, W/8, 4] is passed in, or drawn from `generator` (on
        the generator's device)."""
        if (generator is None) == (noise is None):
            raise ValueError("sample takes a torch.Generator or a noise tensor, one of them")
        mean, logvar = self.encode(x)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=generator.device,
                                dtype=torch.float32)
        return mean + torch.exp(0.5 * logvar) * noise.to(device=mean.device, dtype=mean.dtype)

    def decode(self, z):
        """z [N, h, w, 4] -> [N, 8h, 8w, 3]."""
        return self.decoder(self.post_quant_conv(self._nchw(z))).permute(0, 2, 3, 1)
