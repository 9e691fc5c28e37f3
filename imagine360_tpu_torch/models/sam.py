"""SAM ViT-B image encoder (windowed ViT with decomposed relative-position
attention and a conv neck), the counterpart of imagine360_tpu/models/sam.py.

Used as a frozen per-frame feature extractor: [F, 1024, 1024, 3] ->
[F, 64, 64, 256], flattened to [F, 4096, 256] for the IP conditioning path.
Public layout is the JAX package's (NHWC). Module and parameter names are
segment_anything's (`patch_embed.proj`, `blocks.N.attn.qkv`,
`blocks.N.mlp.lin1`, `neck.0` ...), so the `image_encoder.*` part of a SAM
checkpoint loads after `convert_sam_encoder` strips the prefix.

The attention adds the decomposed relative-position terms to the logits, a
[Sq, Sk] term that differs per batch row and head, so it fits none of the
attention kernels; the JAX package computes it outside any Pallas kernel
too, and here it is plain torch ops.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768            # ViT-B
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: tuple = (2, 5, 8, 11)
    # global-attention query-row chunking: the 64 x 64 token grid would
    # otherwise materialise [B*12, 4096, 4096] float32 logits (12.9 GB at 16
    # frames). Chunks of `global_q_rows` grid rows bound the live logits to
    # [B*12, rows*64, 4096]; the numbers are the same. 0 disables.
    global_q_rows: int = 8
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Decomposed relative-position lookup (SAM's get_rel_pos): [q, k, d]."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        # linear resize along axis 0, as segment_anything does it
        rel_pos = F.interpolate(rel_pos.t()[None].float(), size=max_rel_dist,
                                mode="linear")[0].t().to(rel_pos.dtype)
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


class SAMAttention(nn.Module):
    def __init__(self, cfg: SAMConfig, hw: int):
        super().__init__()
        C, self.heads = cfg.embed_dim, cfg.num_heads
        hd = C // cfg.num_heads
        self.global_q_rows = cfg.global_q_rows
        self.qkv = nn.Linear(C, 3 * C)
        self.proj = nn.Linear(C, C)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * hw - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * hw - 1, hd))

    def forward(self, x):
        """x [B, H, W, C] -> [B, H, W, C]."""
        B, H, W, C = x.shape
        nh = self.heads
        hd = C // nh
        qkv = self.qkv(x).reshape(B, H * W, 3, nh, hd)
        qkv = qkv.permute(2, 0, 3, 1, 4).reshape(3, B * nh, H * W, hd)
        q, k, v = qkv[0], qkv[1], qkv[2]
        Rh = _get_rel_pos(H, H, self.rel_pos_h).to(q.dtype)   # [H, H, d]
        Rw = _get_rel_pos(W, W, self.rel_pos_w).to(q.dtype)   # [W, W, d]
        scale = hd ** -0.5
        BH = q.shape[0]

        def attend(qr, Rhr):
            """qr [BH, rows, W, d], Rhr [rows, H, d] -> [BH, rows, W, d]."""
            rows = qr.shape[1]
            logits = torch.einsum("brwd,bkd->brwk", qr * scale, k)
            rel_h = torch.einsum("brwd,rkd->brwk", qr, Rhr)     # [BH, r, W, H]
            rel_w = torch.einsum("brwd,wkd->brwk", qr, Rw)      # [BH, r, W, W]
            logits = (logits.reshape(BH, rows, W, H, W) + rel_h[..., None]
                      + rel_w[:, :, :, None, :]).reshape(BH, rows, W, H * W)
            p = torch.softmax(logits.float(), dim=-1)
            return torch.einsum("brwk,bkd->brwd", p.to(v.dtype), v)

        q4 = q.reshape(BH, H, W, hd)
        ch = self.global_q_rows
        if ch and H > ch and H % ch == 0:
            # query-row chunks: live logits stay [BH, ch, W, H*W]
            out = torch.cat([attend(q4[:, r:r + ch], Rh[r:r + ch])
                             for r in range(0, H, ch)], dim=1)
        else:
            out = attend(q4, Rh)
        out = out.reshape(B, nh, H * W, hd).permute(0, 2, 1, 3).reshape(B, H, W, C)
        return self.proj(out)


def _window_partition(x, ws: int):
    B, H, W, C = x.shape
    ph = (ws - H % ws) % ws
    pw = (ws - W % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C), (Hp, Wp)


def _window_unpartition(win, ws: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = win.shape[0] // (Hp * Wp // ws // ws)
    x = win.reshape(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class SAMBlock(nn.Module):
    def __init__(self, cfg: SAMConfig, window_size: int):
        super().__init__()
        C = cfg.embed_dim
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(C, eps=1e-6)
        self.attn = SAMAttention(
            cfg, window_size if window_size > 0 else cfg.img_size // cfg.patch_size)
        self.norm2 = nn.LayerNorm(C, eps=1e-6)
        self.mlp = _MLP(C, int(C * cfg.mlp_ratio))

    def forward(self, x):
        h = self.norm1(x)
        if self.window_size > 0:
            H, W = h.shape[1], h.shape[2]
            h, pad_hw = _window_partition(h, self.window_size)
            h = _window_unpartition(self.attn(h), self.window_size, pad_hw, (H, W))
        else:
            h = self.attn(h)
        x = x + h
        return x + self.mlp(self.norm2(x))


class LayerNorm2d(nn.Module):
    """Channel layer norm (SAM's LayerNorm2d), here over the last axis of an
    NHWC feature map."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-6) * self.weight + self.bias


class _NHWCConv(nn.Conv2d):
    """Conv2d on [N, H, W, C] tensors."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        self.proj = _NHWCConv(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size)


class SAMImageEncoder(nn.Module):
    def __init__(self, cfg: SAMConfig = SAMConfig()):
        super().__init__()
        self.cfg = cfg
        gh = cfg.img_size // cfg.patch_size
        self.patch_embed = _PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.zeros(1, gh, gh, cfg.embed_dim))
        self.blocks = nn.ModuleList([
            SAMBlock(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size)
            for i in range(cfg.depth)])
        self.neck = nn.ModuleList([
            _NHWCConv(cfg.embed_dim, cfg.out_chans, 1, bias=False),
            LayerNorm2d(cfg.out_chans),
            _NHWCConv(cfg.out_chans, cfg.out_chans, 3, padding=1, bias=False),
            LayerNorm2d(cfg.out_chans)])

    def forward(self, x):
        """x [B, 1024, 1024, 3] (already mean/std normalised and padded) ->
        [B, 64, 64, 256]."""
        h = self.patch_embed.proj(x.to(self.pos_embed.dtype)) + self.pos_embed
        for blk in self.blocks:
            h = blk(h)
        for layer in self.neck:
            h = layer(h)
        return h


SAM_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


def sam_preprocess(images_u8: np.ndarray, img_size: int = 1024) -> np.ndarray:
    """[F, H, W, 3] uint8 (long side already resized to img_size) ->
    normalised, zero-padded [F, img_size, img_size, 3] float32
    (SamPredictor.set_torch_image semantics)."""
    x = (images_u8.astype(np.float32) - SAM_PIXEL_MEAN) / SAM_PIXEL_STD
    f, h, w, _ = x.shape
    out = np.zeros((f, img_size, img_size, 3), np.float32)
    out[:, :h, :w] = x
    return out


def sam_preprocess_tensor(images_u8: torch.Tensor, img_size: int = 1024) -> torch.Tensor:
    """`sam_preprocess` on a tensor, on its device: [F, H, W, 3] uint8 (long
    side already resized to img_size) -> normalised, zero-padded
    [F, img_size, img_size, 3] float32."""
    mean = torch.from_numpy(SAM_PIXEL_MEAN).to(images_u8.device)
    std = torch.from_numpy(SAM_PIXEL_STD).to(images_u8.device)
    f, h, w, c = images_u8.shape
    out = torch.zeros((f, img_size, img_size, c), dtype=torch.float32, device=images_u8.device)
    out[:, :h, :w] = (images_u8.float() - mean) / std
    return out


def convert_sam_encoder(state_dict: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """segment_anything checkpoint -> `state_dict` of SAMImageEncoder: the
    `image_encoder.*` keys with the prefix stripped; the prompt encoder and
    mask decoder are dropped."""
    prefix = "image_encoder."
    out = {}
    for k, v in state_dict.items():
        if k.startswith(prefix):
            t = v.detach().cpu().float() if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.asarray(v, dtype=np.float32))
            out[k[len(prefix):]] = t
    return out
