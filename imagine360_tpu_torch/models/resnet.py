"""Inflated ResNet blocks and spatial up/down sampling
(counterpart of imagine360_tpu/models/resnet.py). [B, F, H, W, C]."""
from __future__ import annotations

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

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample3D(nn.Module):
    """Stride-2 3x3 conv, padding 1."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = InflatedConv(channels, channels, 3, 2, 1)

    def forward(self, x):
        return self.conv(x)


class Upsample3D(nn.Module):
    """Nearest x2 spatial upsample, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = InflatedConv(channels, channels, 3, 1, 1)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)
        return self.conv(x)
