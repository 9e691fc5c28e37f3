"""AnimateDiff-style inflated 3D UNet: SD2.1 backbone + motion modules +
IP-plus image conditioning + outpaint channels (counterpart of
imagine360_tpu/models/unet3d.py). Activations are [B, F, H, W, C].

Panorama 360-degree continuity is a `pad` argument on each block that
wrap-pads the width axis around the convolutions (wpad/wunpad), with the
per-stage amounts of the JAX package. A `rows` argument (a parallel/mesh.py
Mesh, or None) says the pano's H axis holds this rank's latent rows
(models/layers.py); it reaches every conv, GroupNorm and spatial
transformer, and the wrap padding stays local to the rows, so a halo row
carries its neighbour's wrapped columns.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .attention3d import Transformer3DModel
from .layers import GroupNorm, InflatedConv, TimestepEmbedding, timestep_embedding
from .motion import MotionModule
from .resampler import Resampler, TemporalProjection
from .resnet import Downsample3D, ResnetBlock3D, Upsample3D


def wpad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Circular pad of the width axis of [B, F, H, W, C]."""
    if p <= 0:
        return x
    return torch.cat([x[..., -p:, :], x, x[..., :p, :]], dim=-2)


def wunpad(x: torch.Tensor, p: int) -> torch.Tensor:
    if p <= 0:
        return x
    return x[..., p:-p, :]


REMAT_RANGE = "i360::remat_unit"     # torch.profiler range around every rematerialised unit


def maybe_remat(remat: bool, fn, *args):
    """fn(*args), under activation checkpointing when `remat` is set and a
    gradient is being taken: fn's intermediates are dropped after the
    forward and recomputed in the backward (non-reentrant, so tensor and
    non-tensor arguments pass through as they are; no block draws random
    numbers, so no generator state is kept)."""
    if remat and torch.is_grad_enabled():
        def unit(*a):     # runs twice a step: forward, and recompute in the backward
            with torch.profiler.record_function(REMAT_RANGE):
                return fn(*a)
        return checkpoint(unit, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    in_channels: int = 9            # use_outpaint: 4 + 1 + 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    norm_eps: float = 1e-5
    use_motion_module: bool = True
    motion_module_mid_block: bool = True
    motion_heads: int = 8
    motion_max_len: int = 64
    use_ip: bool = True
    ip_scale: float = 1.0
    num_ip_tokens: int = 64
    image_hidden_size: int = 256     # SAM
    image_cross_attention_dim: int = 1024
    use_fps_condition: bool = True
    use_relative_positions: bool = True   # 'WithAdapter'
    use_inflated_groupnorm: bool = True
    # rematerialise activations in the backward pass (the JAX package's
    # UNet3DConfig.remat): every resnet, spatial transformer and motion
    # module of the Down/Mid/Up blocks, and every WarpAttn of the dual walk,
    # keeps only its input and output and recomputes the rest
    remat: bool = False
    resampler_dim: int = 1024
    resampler_depth: int = 4
    resampler_heads: int = 12
    resampler_dim_head: int = 64
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


def _resnet(c: UNet3DConfig, cin: int, cout: int) -> ResnetBlock3D:
    return ResnetBlock3D(cin, cout, c.time_embed_dim, c.use_inflated_groupnorm,
                         eps=c.norm_eps)


def _transformer(c: UNet3DConfig, ch: int, heads: int) -> Transformer3DModel:
    return Transformer3DModel(ch, heads, ch // heads, c.cross_attention_dim, use_ip=c.use_ip,
                              ip_scale=c.ip_scale, num_ip_tokens=c.num_ip_tokens)


def _motion(c: UNet3DConfig, ch: int) -> MotionModule:
    return MotionModule(ch, c.motion_heads, 1, c.motion_max_len)


def _padded_resnet(resnet, h, temb, pad: bool, rows=None):
    """One resnet, inside the pano branch's circular width padding."""
    return wunpad(resnet(wpad(h, 2), temb, rows), 2) if pad else resnet(h, temb, rows)


class DownBlock3D(nn.Module):
    """CrossAttnDownBlock3D / DownBlock3D. `heads=None` means no spatial
    attention (the last down block). `motion=False` builds no motion
    modules (the dual walk skips them in blocks without attention)."""

    def __init__(self, c: UNet3DConfig, cin: int, cout: int, heads: Optional[int],
                 add_downsample: bool, motion: bool):
        super().__init__()
        n = c.layers_per_block
        self.heads, self.remat = heads, c.remat
        self.resnets = nn.ModuleList([_resnet(c, cin if j == 0 else cout, cout)
                                      for j in range(n)])
        if heads is not None:
            self.attentions = nn.ModuleList([_transformer(c, cout, heads) for _ in range(n)])
        if motion:
            self.motion_modules = nn.ModuleList([_motion(c, cout) for _ in range(n)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample3D(cout)])

    def forward(self, h, temb, context, pad: bool = False, apply_motion: bool = True,
                rows=None):
        skips = []
        for j, resnet in enumerate(self.resnets):
            h = maybe_remat(self.remat, _padded_resnet, resnet, h, temb, pad, rows)
            if self.heads is not None:
                h = maybe_remat(self.remat, self.attentions[j], h, context, rows)
            if apply_motion and hasattr(self, "motion_modules"):
                h = maybe_remat(self.remat, self.motion_modules[j], h, rows)
            skips.append(h)
        if hasattr(self, "downsamplers"):
            down = self.downsamplers[0]
            h = wunpad(down(wpad(h, 2), rows), 1) if pad else down(h, rows)
            skips.append(h)
        return h, skips


class MidBlock3D(nn.Module):
    """UNetMidBlock3DCrossAttn."""

    def __init__(self, c: UNet3DConfig, ch: int, heads: int):
        super().__init__()
        self.remat = c.remat
        self.resnets = nn.ModuleList([_resnet(c, ch, ch) for _ in range(2)])
        self.attentions = nn.ModuleList([_transformer(c, ch, heads)])
        if c.use_motion_module and c.motion_module_mid_block:
            self.motion_modules = nn.ModuleList([_motion(c, ch)])

    def forward(self, h, temb, context, pad: bool = False, rows=None):
        r0, r1 = self.resnets
        h = maybe_remat(self.remat, _padded_resnet, r0, h, temb, pad, rows)
        h = maybe_remat(self.remat, self.attentions[0], h, context, rows)
        if hasattr(self, "motion_modules"):
            h = maybe_remat(self.remat, self.motion_modules[0], h, rows)
        return maybe_remat(self.remat, _padded_resnet, r1, h, temb, pad, rows)


class UpBlock3D(nn.Module):
    """CrossAttnUpBlock3D / UpBlock3D."""

    def __init__(self, c: UNet3DConfig, prev: int, cout: int, skip_chs, heads: Optional[int],
                 add_upsample: bool, motion: bool):
        super().__init__()
        n = c.layers_per_block + 1
        self.heads, self.remat = heads, c.remat
        self.resnets = nn.ModuleList([
            _resnet(c, (prev if j == 0 else cout) + skip_chs[j], cout) for j in range(n)])
        if heads is not None:
            self.attentions = nn.ModuleList([_transformer(c, cout, heads) for _ in range(n)])
        if motion:
            self.motion_modules = nn.ModuleList([_motion(c, cout) for _ in range(n)])
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample3D(cout)])

    def forward(self, h, skips, temb, context, pad: bool = False, apply_motion: bool = True,
                rows=None):
        """`skips` holds len(resnets) skip tensors, consumed from the end."""
        n = len(self.resnets)
        assert len(skips) == n, (len(skips), n)
        for j, resnet in enumerate(self.resnets):
            h = torch.cat([h, skips[n - 1 - j]], dim=-1)
            h = maybe_remat(self.remat, _padded_resnet, resnet, h, temb, pad, rows)
            if self.heads is not None:
                h = maybe_remat(self.remat, self.attentions[j], h, context, rows)
            if apply_motion and hasattr(self, "motion_modules"):
                h = maybe_remat(self.remat, self.motion_modules[j], h, rows)
        return h

    def upsample(self, h, pad: bool = False, rows=None):
        if hasattr(self, "upsamplers"):
            up = self.upsamplers[0]
            h = wunpad(up(wpad(h, 1), rows), 2) if pad else up(h, rows)
        return h


class FpsEmbedding(TimestepEmbedding):
    """TimestepEmbedding (the reference zero-initialises linear_2)."""


class UNet3DConditionModel(nn.Module):
    """One denoiser branch, with stage methods so the dual coupler can walk
    two of them in lockstep.

    `dual_walk=True` builds the branch as DualUNet uses it: no motion
    modules in blocks without spatial attention (the dual walk skips them),
    and the relative-position adapter only where `rel_pos_adapter` asks for
    it (the pano branch). The parameter set then equals the JAX DualUNet's.
    """

    def __init__(self, cfg: UNet3DConfig, dual_walk: bool = False,
                 rel_pos_adapter: Optional[bool] = None):
        super().__init__()
        c = self.cfg = cfg
        boc = c.block_out_channels
        ted = c.time_embed_dim
        self.conv_in = InflatedConv(c.in_channels, boc[0], 3, 1, 1)
        self.time_embedding = TimestepEmbedding(boc[0], ted)
        if c.use_fps_condition:
            self.fps_embedding = FpsEmbedding(boc[0], ted)
        rel = c.use_relative_positions if rel_pos_adapter is None else rel_pos_adapter
        if rel:
            icd = c.image_cross_attention_dim
            self.add_cond_embedding = TimestepEmbedding(6 * boc[0], icd)
            self.cond_rp_proj = nn.Linear(icd, icd // 4 * 3, bias=False)
            self.add_cond_embedding2 = TimestepEmbedding(boc[0], icd // 4)
        if c.use_ip:
            self.temporal_proj = TemporalProjection(dim=c.image_hidden_size)
            self.image_proj_model = Resampler(
                dim=c.resampler_dim, depth=c.resampler_depth, heads=c.resampler_heads,
                dim_head=c.resampler_dim_head, num_queries=c.num_ip_tokens,
                embedding_dim=(c.image_hidden_size * 4 if c.image_hidden_size < 1024
                               else c.image_hidden_size),
                output_dim=c.image_cross_attention_dim)

        nb = len(boc)
        self.down_blocks = nn.ModuleList()
        skip_chs = [boc[0]]
        for i in range(nb):
            final = i == nb - 1
            heads = None if final else c.attention_heads[i]
            motion = c.use_motion_module and not (dual_walk and heads is None)
            cin = boc[max(i - 1, 0)]
            self.down_blocks.append(DownBlock3D(c, cin, boc[i], heads, not final, motion))
            skip_chs += [boc[i]] * (c.layers_per_block + (0 if final else 1))
        self.mid_block = MidBlock3D(c, boc[-1], c.attention_heads[-1])
        rev, rev_heads = list(reversed(boc)), list(reversed(c.attention_heads))
        self.up_blocks = nn.ModuleList()
        prev = boc[-1]
        n = c.layers_per_block + 1
        for i in range(nb):
            final = i == nb - 1
            heads = None if i == 0 else rev_heads[i]
            motion = c.use_motion_module and not (dual_walk and heads is None)
            sk = skip_chs[-n:]
            del skip_chs[-n:]
            self.up_blocks.append(UpBlock3D(c, prev, rev[i], list(reversed(sk)), heads,
                                            not final, motion))
            prev = rev[i]
        self.conv_norm_out = GroupNorm(32, boc[0], c.norm_eps, c.use_inflated_groupnorm)
        self.conv_out = InflatedConv(boc[0], c.out_channels, 3, 1, 1)

    # ---- conditioning -------------------------------------------------------

    def time_embed(self, timesteps, fps=None):
        """timesteps [B] (+ fps [B]) -> temb [B, time_embed_dim]."""
        c = self.cfg
        dt = self.conv_in.weight.dtype
        emb = self.time_embedding(timestep_embedding(timesteps, c.block_out_channels[0]).to(dt))
        if fps is not None and c.use_fps_condition:
            emb = emb + self.fps_embedding(
                timestep_embedding(fps, c.block_out_channels[0]).to(dt))
        return emb

    def ip_tokens(self, ref_feats, rel_pos=None, pitch=None):
        """SAM video features [B, F, D, Csam] -> IP tokens [B, num_ip_tokens,
        image_cross_attention_dim], with the relative-position/pitch adapter
        added where this branch has one."""
        c = self.cfg
        dt = self.conv_in.weight.dtype
        x = self.temporal_proj(ref_feats)
        B, f, d, ch = x.shape
        tokens = self.image_proj_model(x.reshape(B, f * d, ch))
        if rel_pos is not None and hasattr(self, "add_cond_embedding"):
            B_, n, six = rel_pos.shape
            c0 = c.block_out_channels[0]
            rp = timestep_embedding(rel_pos.reshape(-1), c0).reshape(B_ * n, six * c0)
            rp = self.cond_rp_proj(self.add_cond_embedding(rp.to(dt)))
            pt = self.add_cond_embedding2(timestep_embedding(pitch.reshape(-1), c0).to(dt))
            cond = torch.cat([rp, pt], dim=-1).reshape(B_, n, -1)
            if n >= c.num_ip_tokens:
                tokens = tokens + cond[:, :c.num_ip_tokens]
            else:
                pad = cond[:, -1:].expand(-1, c.num_ip_tokens - n, -1)
                tokens = tokens + torch.cat([cond, pad], dim=1)
        return tokens

    def build_context(self, text_embeds, ip_tokens):
        """concat [text | ip tokens] along the sequence."""
        if ip_tokens is None:
            return text_embeds
        return torch.cat([text_embeds, ip_tokens.to(text_embeds.dtype)], dim=1)

    # ---- stages -------------------------------------------------------------

    def stem(self, sample, pad: bool = False, rows=None):
        if pad:
            return wunpad(self.conv_in(wpad(sample, 1), rows), 1)
        return self.conv_in(sample, rows)

    def head(self, h, pad: bool = False, rows=None):
        h = F.silu(self.conv_norm_out(h, rows))
        if pad:
            return wunpad(self.conv_out(wpad(h, 1), rows), 1)
        return self.conv_out(h, rows)

    def forward(self, sample, timesteps, text_embeds, fps=None, ref_feats=None,
                rel_pos=None, pitch=None, pad: bool = False):
        """Single-branch forward: sample [B, F, H, W, 9] -> v prediction
        [B, F, H, W, 4]."""
        c = self.cfg
        temb = self.time_embed(timesteps, fps)
        ip = (self.ip_tokens(ref_feats, rel_pos, pitch)
              if c.use_ip and ref_feats is not None else None)
        context = self.build_context(text_embeds, ip)
        h = self.stem(sample.to(self.conv_in.weight.dtype), pad)
        skips = [h]
        for blk in self.down_blocks:
            h, s = blk(h, temb, context, pad, True)
            skips.extend(s)
        h = self.mid_block(h, temb, context, pad)
        n = c.layers_per_block + 1
        for blk in self.up_blocks:
            sk = tuple(skips[-n:])
            del skips[-n:]
            h = blk.upsample(blk(h, sk, temb, context, pad, True), pad)
        return self.head(h, pad)
