"""Inflated ResNet blocks, spatial up/down sampling and the temporal conv
block (counterpart of imagine360_tpu/models/resnet.py). [B, F, H, W, C]."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import GroupNorm, InflatedConv


class ResnetBlock3D(nn.Module):
    """norm1 -> silu -> conv1 -> (+temb) -> norm2 -> silu -> conv2, plus the
    (1x1-projected) shortcut."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 inflated: bool = True, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps, inflated)
        self.conv1 = InflatedConv(in_channels, out_channels, 3, 1, 1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps, inflated)
        self.conv2 = InflatedConv(out_channels, out_channels, 3, 1, 1)
        self.conv_shortcut = (InflatedConv(in_channels, out_channels, 1, 1, 0)
                              if in_channels != out_channels else None)

    def forward(self, x, temb, rows=None):
        h = self.conv1(F.silu(self.norm1(x, rows)), rows)
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, None, :]
        h = self.conv2(F.silu(self.norm2(h, rows)), rows)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample3D(nn.Module):
    """Stride-2 3x3 conv, padding 1 (under `rows` the halo: a rank's even
    row count puts its output rows at r * n / 2 of the whole output)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = InflatedConv(channels, channels, 3, 2, 1)

    def forward(self, x, rows=None):
        return self.conv(x, rows)


class Upsample3D(nn.Module):
    """Nearest x2 spatial upsample, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = InflatedConv(channels, channels, 3, 1, 1)

    def forward(self, x, rows=None):
        x = x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
        return self.conv(x, rows)


class TemporalConvBlock(nn.Module):
    """Frame-axis conv residual block: 4 x [GroupNorm (statistics over the
    frames too) -> SiLU -> (3, 1, 1) Conv3d, zero-padded over the frames],
    the last conv zero at construction, an identity residual around all
    four (ModelScope's TemporalConvBlock_v2; the Imagine360 inference path
    does not use it). Names as the reference's: `conv1` is [norm, SiLU,
    conv], `conv2`-`conv4` are [norm, SiLU, Dropout, conv] (SiLU and Dropout
    hold no parameters and are identities here)."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        for n in range(1, 5):
            conv = nn.Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))
            if n == 4:
                nn.init.zeros_(conv.weight)
                nn.init.zeros_(conv.bias)
            gap = [nn.Identity()] * (1 if n == 1 else 2)
            setattr(self, f"conv{n}", nn.ModuleList(
                [GroupNorm(groups, channels, eps, inflated=False), *gap, conv]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for n in range(1, 5):
            stack = getattr(self, f"conv{n}")
            h = F.silu(stack[0](h))
            # [B, F, H, W, C] viewed as [B, C, F, H, W] (channels-last memory)
            h = stack[-1](h.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        return x + h
