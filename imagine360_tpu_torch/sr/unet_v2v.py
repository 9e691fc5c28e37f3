"""The VEnhancer video-to-video UNet with its ControlNet (counterpart of
imagine360_tpu/sr/unet_v2v.py): the SR stage's second refiner engine,
`sr/cli.py --engine v2v`.

Activations are [B, F, H, W, C], as in every model of the port. Module and
parameter names are the public VEnhancer / ModelScope ones, so such a
`state_dict` loads with `load_state_dict` as it stands:

- `time_embed.{0,2}`, `input_blocks.{i}.{j}.*`, `middle_block.{0..3}.*`,
  `output_blocks.{i}.{j}.*`, `out.{0,2}`;
- a ResBlock's `in_layers.{0,2}`, `emb_layers.1`, `out_layers.{0,3}`,
  `skip_connection` and its temporal conv stack under the misspelt
  `temopral_conv.conv{1..4}.{0, 2|3}`;
- a transformer's `norm`, `proj_in`, `transformer_blocks.0.*`, `proj_out`;
- the ControlNet under `VideoControlNet.`, with `zero_convs.{i}.0`,
  `middle_block_out.0`, `hint_time_zero_linear` and
  `scale_cond_zero_linear`.

The placeholders of the public layout's SiLU and Dropout entries are
`nn.Identity` (no parameters). `utils/convert.py:from_jax_params` carries a
JAX-package parameter tree of these modules across, as the inverse of
`convert_v2v`.

Architecture (public defaults, `V2VConfig()`): dim 320, dim_mult
(1, 2, 4, 4), 2 ResBlocks a level, each followed by four (3, 1, 1) frame
convs; spatial and temporal transformers at scales 1, 1/2 and 1/4; context
1024 (OpenCLIP ViT-H text); head dim 64; a per-frame time embedding
[B, F, 4 * dim]. The ControlNet is a copy of the encoder and middle block
on [x | hint] whose residuals enter the UNet's middle block and skips; the
hint's noise level `t_hint` enters the time embedding on key frames only
(`mask_cond`), the upscale factor `s_cond` on every frame.

GroupNorm statistics are per frame everywhere but in the temporal conv
stack and the temporal transformer, where they span the frames; eps 1e-6 in
the transformers' norms, 1e-5 elsewhere. Every attention call goes through
ops/attention.py:dot_product_attention: the spatial sites to K1 or K2 by
their length, the temporal transformer's F keys to K1.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..diffusion.ddim import add_noise, make_ddim_schedule
from ..models.layers import (Attention, FeedForward, GroupNorm, InflatedConv, LayerNorm,
                             timestep_embedding)
from ..models import resnet


@dataclasses.dataclass(frozen=True)
class V2VConfig:
    in_dim: int = 4
    dim: int = 320
    context_dim: int = 1024        # OpenCLIP ViT-H text width
    out_dim: int = 4
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    head_dim: int = 64
    attn_scales: Tuple[float, ...] = (1.0, 0.5, 0.25)
    temporal_attention: bool = True
    norm_groups: int = 32
    dtype: str = "float32"

    @property
    def embed_dim(self) -> int:
        return self.dim * 4


def tiny_v2v_config(dtype: str = "float32") -> V2VConfig:
    """CPU-testable miniature (same code paths)."""
    return V2VConfig(dim=16, context_dim=24, dim_mult=(1, 2), head_dim=8, num_res_blocks=1,
                     attn_scales=(1.0, 0.5), norm_groups=4, dtype=dtype)


def _zero_(module: nn.Module) -> nn.Module:
    """Zero a module's parameters in place (guided-diffusion zero_module)."""
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()
    return module


class TemporalConvBlock(resnet.TemporalConvBlock):
    """ModelScope TemporalConvBlock_v2 (models/resnet.py) with the V2V
    UNet's GroupNorm eps, 1e-5."""

    def __init__(self, channels: int, groups: int):
        super().__init__(channels, groups, eps=1e-5)


class V2VResBlock(nn.Module):
    """guided-diffusion ResBlock (per-frame embedding [B, F, E]) followed by
    the temporal conv stack."""

    def __init__(self, in_channels: int, out_channels: int, embed_dim: int, groups: int):
        super().__init__()
        self.in_layers = nn.ModuleList([GroupNorm(groups, in_channels, 1e-5), nn.Identity(),
                                        InflatedConv(in_channels, out_channels, 3, 1, 1)])
        self.emb_layers = nn.ModuleList([nn.Identity(), nn.Linear(embed_dim, out_channels)])
        self.out_layers = nn.ModuleList([
            GroupNorm(groups, out_channels, 1e-5), nn.Identity(), nn.Identity(),
            _zero_(InflatedConv(out_channels, out_channels, 3, 1, 1))])
        if in_channels != out_channels:
            self.skip_connection = InflatedConv(in_channels, out_channels, 1, 1, 0)
        self.temopral_conv = TemporalConvBlock(out_channels, groups)   # sic, public name

    def forward(self, x, emb):
        h = self.in_layers[2](F.silu(self.in_layers[0](x)))
        h = h + self.emb_layers[1](F.silu(emb))[:, :, None, None, :]
        h = self.out_layers[3](F.silu(self.out_layers[0](h)))
        if hasattr(self, "skip_connection"):
            x = self.skip_connection(x)
        return self.temopral_conv(x + h)


class V2VTransformerBlock(nn.Module):
    """ldm BasicTransformerBlock: self-attention, cross-attention on the
    context (absent in the temporal transformer), GEGLU feed-forward."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim)
        if context_dim is not None:
            self.norm2 = LayerNorm(dim)
            self.attn2 = Attention(dim, heads, head_dim, context_dim=context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x))
        if hasattr(self, "attn2"):
            x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Per-frame spatial transformer, linear projections, depth 1;
    `proj_out` zero at construction."""

    def __init__(self, channels: int, head_dim: int, context_dim: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([V2VTransformerBlock(
            channels, channels // head_dim, head_dim, context_dim)])
        self.proj_out = _zero_(nn.Linear(channels, channels))

    def forward(self, x, context):
        # x [B, F, H, W, C]; context [B, L, D], shared by the B's frames
        B, Fr, H, W, C = x.shape
        h = self.proj_in(self.norm(x).reshape(B * Fr, H * W, C))
        h = self.transformer_blocks[0](h, context.repeat_interleave(Fr, dim=0))
        return x + self.proj_out(h).reshape(B, Fr, H, W, C)


class TemporalTransformer(nn.Module):
    """Self-attention over the frame axis at every location (public
    only_self_att=True); GroupNorm statistics span the frames; `proj_out`
    zero at construction."""

    def __init__(self, channels: int, head_dim: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(groups, channels, 1e-6, inflated=False)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([V2VTransformerBlock(
            channels, channels // head_dim, head_dim)])
        self.proj_out = _zero_(nn.Linear(channels, channels))

    def forward(self, x):
        B, Fr, H, W, C = x.shape
        h = self.norm(x).permute(0, 2, 3, 1, 4).reshape(B * H * W, Fr, C)
        h = self.proj_out(self.transformer_blocks[0](self.proj_in(h)))
        return x + h.reshape(B, H, W, Fr, C).permute(0, 3, 1, 2, 4)


class Downsample(nn.Module):
    """Stride-2 3x3 conv, padding 1 (public `op`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = InflatedConv(channels, channels, 3, 2, 1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = InflatedConv(channels, channels, 3, 1, 1)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2))


def _plan(cfg: V2VConfig):
    """Channel plan shared by the UNet and the ControlNet's encoder copy:
    (encoder specs, skip channels, middle channels, deepest scale). A spec
    is {kind: 'init' | 'res' | 'down', ch, attn}."""
    enc = [dict(kind="init", ch=cfg.dim, attn=False)]
    shortcuts = [cfg.dim]
    dims = [cfg.dim * m for m in (1,) + tuple(cfg.dim_mult)]
    scale = 1.0
    for i, cout in enumerate(dims[1:]):
        for _ in range(cfg.num_res_blocks):
            enc.append(dict(kind="res", ch=cout, attn=scale in cfg.attn_scales))
            shortcuts.append(cout)
        if i != len(cfg.dim_mult) - 1:
            enc.append(dict(kind="down", ch=cout, attn=False))
            shortcuts.append(cout)
            scale /= 2
    return enc, shortcuts, dims[-1], scale


def _attn_pair(cfg: V2VConfig, ch: int) -> List[nn.Module]:
    mods = [SpatialTransformer(ch, cfg.head_dim, cfg.context_dim, cfg.norm_groups)]
    if cfg.temporal_attention:
        mods.append(TemporalTransformer(ch, cfg.head_dim, cfg.norm_groups))
    return mods


def _run(block: nn.ModuleList, h, emb, context):
    """One block of the public layout: each module with what it takes."""
    for m in block:
        if isinstance(m, V2VResBlock):
            h = m(h, emb)
        elif isinstance(m, SpatialTransformer):
            h = m(h, context)
        else:
            h = m(h)
    return h


class _V2VEncoder(nn.Module):
    """`time_embed`, `input_blocks` and `middle_block`, shared by
    Vid2VidSDUNet and VideoControlNet (the ControlNet's encoder takes
    2 * in_dim channels)."""

    def __init__(self, cfg: V2VConfig, in_channels: int):
        super().__init__()
        self.cfg = cfg
        self.time_embed = nn.ModuleList([nn.Linear(cfg.dim, cfg.embed_dim), nn.Identity(),
                                         nn.Linear(cfg.embed_dim, cfg.embed_dim)])
        enc, _, mid, _ = _plan(cfg)
        self.input_blocks = nn.ModuleList()
        prev = in_channels
        for spec in enc:
            if spec["kind"] == "init":
                mods = [InflatedConv(prev, cfg.dim, 3, 1, 1)]
                if cfg.temporal_attention:
                    mods.append(TemporalTransformer(cfg.dim, cfg.head_dim, cfg.norm_groups))
            elif spec["kind"] == "down":
                mods = [Downsample(spec["ch"])]
            else:
                mods = [V2VResBlock(prev, spec["ch"], cfg.embed_dim, cfg.norm_groups)]
                if spec["attn"]:
                    mods += _attn_pair(cfg, spec["ch"])
            self.input_blocks.append(nn.ModuleList(mods))
            prev = spec["ch"]
        # res / spatial / temporal / res: without temporal attention index 2
        # holds a placeholder, so the public indices stay
        self.middle_block = nn.ModuleList([
            V2VResBlock(mid, mid, cfg.embed_dim, cfg.norm_groups),
            SpatialTransformer(mid, cfg.head_dim, cfg.context_dim, cfg.norm_groups),
            (TemporalTransformer(mid, cfg.head_dim, cfg.norm_groups)
             if cfg.temporal_attention else nn.Identity()),
            V2VResBlock(mid, mid, cfg.embed_dim, cfg.norm_groups)])

    @property
    def dtype(self) -> torch.dtype:
        return self.time_embed[0].weight.dtype

    def embed(self, t: torch.Tensor) -> torch.Tensor:
        """Timesteps [N] -> the time MLP's output [N, 4 * dim]."""
        e = timestep_embedding(t.reshape(-1), self.cfg.dim).to(self.dtype)
        return self.time_embed[2](F.silu(self.time_embed[0](e)))

    def frame_embed(self, t: torch.Tensor, frames: int) -> torch.Tensor:
        """t [B] or per frame [B, F] -> [B, F, 4 * dim]."""
        if t.dim() == 1:
            t = t[:, None].expand(-1, frames)
        return self.embed(t).reshape(t.shape[0], frames, -1)

    def encode(self, x, emb, context):
        """-> (middle output, the features of every input block)."""
        feats = []
        h = x.to(self.dtype)
        for block in self.input_blocks:
            h = _run(block, h, emb, context)
            feats.append(h)
        return _run(self.middle_block, h, emb, context), feats


class Vid2VidSDUNet(_V2VEncoder):
    """The base (uncontrolled) video-to-video UNet."""

    def __init__(self, cfg: V2VConfig = V2VConfig()):
        super().__init__(cfg, cfg.in_dim)
        _, shortcuts, mid, min_scale = _plan(cfg)
        dims = [cfg.dim * m for m in (1,) + tuple(cfg.dim_mult)]
        rev = list(reversed(dims[1:]))
        self.output_blocks = nn.ModuleList()
        skips = list(shortcuts)
        scale, prev = min_scale, mid
        for i, cout in enumerate(rev):
            for j in range(cfg.num_res_blocks + 1):
                mods = [V2VResBlock(prev + skips.pop(), cout, cfg.embed_dim, cfg.norm_groups)]
                if scale in cfg.attn_scales:
                    mods += _attn_pair(cfg, cout)
                if i != len(rev) - 1 and j == cfg.num_res_blocks:
                    mods.append(Upsample(cout))
                    scale *= 2
                self.output_blocks.append(nn.ModuleList(mods))
                prev = cout
        self.out = nn.ModuleList([GroupNorm(cfg.norm_groups, cfg.dim, 1e-5), nn.Identity(),
                                  _zero_(InflatedConv(cfg.dim, cfg.out_dim, 3, 1, 1))])

    def forward(self, x, t, context, control: Optional[List[torch.Tensor]] = None):
        """x [B, F, h, w, in_dim]; t [B] or per frame [B, F]; context
        [B, L, context_dim]; control: the ControlNet's residuals, one per
        input block and the middle one last. -> [B, F, h, w, out_dim]."""
        emb = self.frame_embed(t, x.shape[1])
        context = context.to(self.dtype)
        h, feats = self.encode(x, emb, context)
        control = list(control) if control is not None else None
        if control is not None:
            h = h + control.pop()
        for block in self.output_blocks:
            skip = feats.pop()
            if control is not None:
                skip = skip + control.pop()
            h = _run(block, torch.cat([h, skip], dim=-1), emb, context)
        return self.out[2](F.silu(self.out[0](h)))


class VideoControlNet(_V2VEncoder):
    """The encoder and middle block again, on [x | hint], emitting a
    residual through a zero 1x1 conv for every input block and the middle
    block; the hint's noise level (key frames only) and the upscale factor
    enter the time embedding through zero linears."""

    def __init__(self, cfg: V2VConfig = V2VConfig()):
        super().__init__(cfg, 2 * cfg.in_dim)
        enc, _, mid, _ = _plan(cfg)
        E = cfg.embed_dim
        self.hint_time_zero_linear = _zero_(nn.Linear(E, E))
        self.scale_cond_zero_linear = _zero_(nn.Linear(E, E))
        self.zero_convs = nn.ModuleList([
            nn.ModuleList([_zero_(InflatedConv(s["ch"], s["ch"], 1, 1, 0))]) for s in enc])
        self.middle_block_out = nn.ModuleList([_zero_(InflatedConv(mid, mid, 1, 1, 0))])

    def time_embedding(self, t, frames: int, t_hint=None, mask_cond=None, s_cond=None):
        """The per-frame embedding [B, F, 4 * dim]: t's, plus t_hint's where
        mask_cond is 1 (every frame without a mask), plus s_cond's on every
        frame."""
        emb = self.frame_embed(t, frames)
        if t_hint is not None:
            he = self.hint_time_zero_linear(self.embed(t_hint))[:, None, :]
            if mask_cond is not None:
                he = he * mask_cond[..., None].to(he.dtype)
            emb = emb + he
        if s_cond is not None:
            emb = emb + self.scale_cond_zero_linear(self.embed(s_cond))[:, None, :]
        return emb

    def forward(self, x, t, context, hint, t_hint=None, mask_cond=None, s_cond=None):
        """x, hint [B, F, h, w, in_dim] (hint zero off key frames); t [B] or
        [B, F]; mask_cond [B, F], 1 on key frames; t_hint, s_cond [B]. ->
        the residuals, input blocks first, the middle one last."""
        emb = self.time_embedding(t, x.shape[1], t_hint, mask_cond, s_cond)
        h, feats = self.encode(torch.cat([x, hint.to(x.dtype)], dim=-1), emb,
                               context.to(self.dtype))
        outs = [zc[0](f) for zc, f in zip(self.zero_convs, feats)]
        return outs + [self.middle_block_out[0](h)]


class ControlledV2VUNet(Vid2VidSDUNet):
    """The SR generator: the base UNet (its parameters at the top level, as
    in the public state dict) plus `VideoControlNet`'s residuals."""

    def __init__(self, cfg: V2VConfig = V2VConfig()):
        super().__init__(cfg)
        self.VideoControlNet = VideoControlNet(cfg)

    def forward(self, x, t, context, hint, t_hint=None, mask_cond=None, s_cond=None):
        control = self.VideoControlNet(x, t, context, hint, t_hint=t_hint,
                                       mask_cond=mask_cond, s_cond=s_cond)
        return super().forward(x, t, context, control=control)


def scatter_hint(hint_lowfps: torch.Tensor, frames: int,
                 interp_f_num: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Place low-fps hint latents [B, K, h, w, C] at the key frames of a
    clip of `frames` frames (every (interp_f_num + 1)-th). Returns (hint
    [B, F, h, w, C], zero off the key frames; mask_cond [B, F] float32)."""
    B, K = hint_lowfps.shape[:2]
    idx = np.arange(0, frames, interp_f_num + 1)[:K]
    hint = hint_lowfps.new_zeros((B, frames) + tuple(hint_lowfps.shape[2:]))
    hint[:, idx] = hint_lowfps[:, :len(idx)]
    mask = torch.zeros(B, frames, device=hint_lowfps.device)
    mask[:, idx] = 1.0
    return hint, mask


class V2VRefiner:
    """Video360Enhancer engine driving ControlledV2VUNet (reference
    sr/video_to_video_model.py:120-152): the clean latents of the upsampled
    clip, noise-augmented to `t_hint` with the 15-step DDIM schedule's
    alphas, are the ControlNet's hint; CFG over text with `guidance_scale`
    only when g != 1 and the two prompts differ, else one pass on the
    positive prompt. Runs without grad on the model's device and dtype."""

    def __init__(self, model: ControlledV2VUNet, text_pos=None, text_neg=None,
                 guidance_scale: float = 7.5, t_hint: int = 199, interp_f_num: int = 0,
                 s_cond: float = 2.0):
        self.model = model
        p = next(model.parameters())
        self.device, self.dtype = p.device, p.dtype
        if text_pos is None:
            text_pos = torch.zeros(77, model.cfg.context_dim)
        if text_neg is None:
            text_neg = torch.zeros_like(text_pos)
        self.cfg_active = guidance_scale != 1.0 and not torch.equal(
            text_pos.float().cpu(), text_neg.float().cpu())
        self.text2 = torch.stack([text_neg, text_pos]).to(self.device, self.dtype)
        self.g, self.t_hint = guidance_scale, t_hint
        self.interp_f_num, self.s_cond = interp_f_num, s_cond
        self._hint = self._mask = None

    @torch.no_grad()
    def _step(self, z, hint, mask_cond, t):
        n = 2 if self.cfg_active else 1
        x = z[None].expand(n, *z.shape)
        full = lambda v: torch.full((n,), float(v), device=self.device)
        pred = self.model(x, full(t), self.text2 if self.cfg_active else self.text2[1:],
                          hint[None].expand(n, *hint.shape), t_hint=full(self.t_hint),
                          mask_cond=mask_cond[None].expand(n, -1), s_cond=full(self.s_cond))
        if not self.cfg_active:
            return pred[0].to(z.dtype)
        u, c = pred[0], pred[1]
        return (u + self.g * (c - u)).to(z.dtype)

    def prepare(self, z_clean: torch.Tensor, noise: Optional[torch.Tensor] = None):
        """Enhancer hook: z_clean [F, h, w, C]. The key frames' latents,
        noise-augmented to t_hint, become the hint. `noise` [1, F, h, w, C]
        (float32) is the augmentation's unit noise; without it the noise is
        drawn from a generator seeded 0 on the latents' device. Returns the
        denoise function (z [F, h, w, C], t [1]) -> prediction."""
        Fr = z_clean.shape[0]
        low = z_clean[None, ::self.interp_f_num + 1]
        hint, mask = scatter_hint(low, Fr, self.interp_f_num)
        if noise is None:
            gen = torch.Generator(device=hint.device).manual_seed(0)
            noise = torch.randn(hint.shape, generator=gen, device=hint.device)
        acp = torch.from_numpy(make_ddim_schedule(15).alphas_cumprod)
        t = torch.full((1,), int(self.t_hint), dtype=torch.long, device=hint.device)
        self._hint = add_noise(hint, noise.to(hint.device), acp, t)
        self._mask = mask

        def denoise_fn(z, t):
            return self._step(z, self._hint[0], self._mask[0], float(t[0]))

        return denoise_fn
