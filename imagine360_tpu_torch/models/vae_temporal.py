"""The SVD temporal-decoder VAE of the super-resolution stage, the
counterpart of imagine360_tpu/models/vae_temporal.py.

The reference SR pipeline decodes its refined latents with diffusers'
`AutoencoderKLTemporalDecoder` (reference sr/video_to_video_model.py:61-67):
the SD VAE encoder, and a decoder whose every resnet is a per-frame spatial
resnet blended (a learned scalar) with a frame-axis (3, 1, 1) temporal
resnet, then a final 3-tap temporal conv over the output frames.

Module and parameter names are diffusers' (`decoder.mid_block.resnets.0.
spatial_res_block.conv1.weight`, `...temporal_res_block.conv1.weight`
[Co, Ci, 3, 1, 1], `...time_mixer.mix_factor`, `decoder.time_conv_out`), so
such a state dict loads with `load_state_dict` as it stands. The mix is
diffusers' own: out = (1 - σ(m))·spatial + σ(m)·temporal (the JAX module
stores -m; utils/convert.py:from_jax_params negates it). As in diffusers,
the temporal GroupNorms take eps 1e-5 and statistics over all frames, the
spatial ones 1e-6 per frame; every GroupNorm has 32 groups.

Layout: channel-first. Images [N, 3, H, W], latents [N, 4, h, w]; a video is
[F, C, H, W], a batch of videos [B, F, C, H, W]. Inside the decoder the
frames are folded into the batch ([B*F, C, H, W]) for the spatial layers and
moved behind the channels ([B, C, F, H, W]) for the temporal convs, which pad
the frame axis with zeros (a one-frame video sees zeros on both sides). The
mid-block attention (one head as wide as the block) goes through
ops/attention.py:dot_product_attention, on the card to the wide K2 for a
72 x 128 latent tile (9216 tokens).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .vae import Encoder, VAEAttention, VAEConfig, VAEResnetBlock, _Resample

GROUPS = 32
TEMPORAL_EPS = 1e-5
SPATIAL_EPS = 1e-6


def _frame_conv(channels_in: int, channels_out: int) -> nn.Conv3d:
    """A (3, 1, 1) conv over the frame axis of [B, C, F, H, W], zero-padded."""
    return nn.Conv3d(channels_in, channels_out, (3, 1, 1), padding=(1, 0, 0))


def _to_frames_minor(x: torch.Tensor, frames: int) -> torch.Tensor:
    """[B*F, C, H, W] -> [B, C, F, H, W]."""
    BF, C, H, W = x.shape
    return x.reshape(BF // frames, frames, C, H, W).transpose(1, 2)


def _to_frames_major(x: torch.Tensor) -> torch.Tensor:
    """[B, C, F, H, W] -> [B*F, C, H, W]."""
    B, C, Fr, H, W = x.shape
    return x.transpose(1, 2).reshape(B * Fr, C, H, W)


class TemporalResnetBlock(nn.Module):
    """GroupNorm -> silu -> (3, 1, 1) conv, twice, with an identity (or a
    1x1x1 conv) residual, on [B, C, F, H, W]."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(GROUPS, in_channels, eps=TEMPORAL_EPS)
        self.conv1 = _frame_conv(in_channels, out_channels)
        self.norm2 = nn.GroupNorm(GROUPS, out_channels, eps=TEMPORAL_EPS)
        self.conv2 = _frame_conv(out_channels, out_channels)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv3d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class _AlphaBlender(nn.Module):
    """diffusers' AlphaBlender, "learned", switch_spatial_to_temporal_mix:
    holds `mix_factor` [1]."""

    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.zeros(1))

    def forward(self, spatial, temporal):
        alpha = (1.0 - torch.sigmoid(self.mix_factor)).to(spatial.dtype)
        return alpha * spatial + (1.0 - alpha) * temporal


class SpatioTemporalResBlock(nn.Module):
    """A per-frame spatial resnet, then a temporal resnet on its output,
    blended by `time_mixer`. [B*F, Ci, H, W] -> [B*F, Co, H, W]."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.spatial_res_block = VAEResnetBlock(in_channels, out_channels, GROUPS)
        self.temporal_res_block = TemporalResnetBlock(out_channels, out_channels)
        self.time_mixer = _AlphaBlender()

    def forward(self, x, frames: int):
        s = _to_frames_minor(self.spatial_res_block(x), frames)
        return _to_frames_major(self.time_mixer(s, self.temporal_res_block(s)))


class _MidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([SpatioTemporalResBlock(channels, channels),
                                      SpatioTemporalResBlock(channels, channels)])
        self.attentions = nn.ModuleList([VAEAttention(channels, GROUPS)])

    def forward(self, h, frames: int):
        h = self.attentions[0](self.resnets[0](h, frames))
        return self.resnets[1](h, frames)


class _UpBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, layers: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(in_channels if j == 0 else out_channels, out_channels)
            for j in range(layers)])
        if upsample:
            self.upsamplers = nn.ModuleList([_Resample(out_channels, 1)])

    def forward(self, h, frames: int):
        for r in self.resnets:
            h = r(h, frames)
        if hasattr(self, "upsamplers"):
            h = self.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return h


class TemporalDecoder(nn.Module):
    """conv_in -> mid (resnet, attention, resnet) -> up blocks of
    layers_per_block + 1 spatio-temporal resnets (2x nearest upsample and a
    conv between) -> per-frame norm, silu, conv_out -> time_conv_out.
    z [B*F, 4, h, w] of videos of `frames` frames -> [B*F, 3, H, W]."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _MidBlock(rev[0])
        self.up_blocks = nn.ModuleList([
            _UpBlock(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1, i < len(rev) - 1)
            for i, ch in enumerate(rev)])
        self.conv_norm_out = nn.GroupNorm(GROUPS, rev[-1], eps=SPATIAL_EPS)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)
        self.time_conv_out = _frame_conv(cfg.out_channels, cfg.out_channels)

    def forward(self, z, frames: int):
        h = self.mid_block(self.conv_in(z), frames)
        for blk in self.up_blocks:
            h = blk(h, frames)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return _to_frames_major(self.time_conv_out(_to_frames_minor(h, frames)))


class AutoencoderKLTemporalDecoder(nn.Module):
    """The SD encoder and the temporal decoder; no post_quant_conv, as in
    the SVD layout. encode / sample take images [N, 3, H, W]; decode takes
    a video [F, 4, h, w] or a batch of them [B, F, 4, h, w]."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = TemporalDecoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)

    def encode(self, x):
        """x [N, 3, H, W] -> (mean, logvar), each [N, 4, h, w]."""
        moments = self.quant_conv(self.encoder(x.to(self.quant_conv.weight.dtype)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def sample(self, x, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None):
        """mean + std * noise; the unit noise [N, 4, h, w] is passed in, or
        drawn from `generator` (on the generator's device)."""
        if (generator is None) == (noise is None):
            raise ValueError("sample takes a torch.Generator or a noise tensor, one of them")
        mean, logvar = self.encode(x)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=generator.device,
                                dtype=torch.float32)
        return mean + torch.exp(0.5 * logvar) * noise.to(device=mean.device, dtype=mean.dtype)

    def decode(self, z):
        """z [F, 4, h, w] (one video) or [B, F, 4, h, w] -> frames at the
        decoder's scale, [F, 3, H, W] or [B, F, 3, H, W]."""
        video = z.dim() == 4
        if video:
            z = z[None]
        B, Fr = z.shape[:2]
        out = self.decoder(z.reshape(B * Fr, *z.shape[2:]).to(self.quant_conv.weight.dtype),
                           Fr)
        out = out.reshape(B, Fr, *out.shape[1:])
        return out[0] if video else out
