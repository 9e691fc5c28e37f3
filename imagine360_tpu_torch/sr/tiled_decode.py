"""360 close-loop tiled and temporally chunked VAE decode with gaussian
blending, the counterpart of imagine360_tpu/sr/tiled_decode.py (reference
sr/video_to_video_model.py:179-245, with the circular latent pre-pad
:156-159 for seam-free panoramas). Channel-first: latents [F, 4, h, w],
frames [F, 3, H, W]."""
from __future__ import annotations

import math

import numpy as np
import torch


def gaussian_weights_1d(n: int, var: float = 0.01) -> np.ndarray:
    """The reference's gaussian tile-blend profile (pipeline
    _gaussian_weights :538-548)."""
    mid = (n - 1) / 2
    x = np.arange(n)
    return (np.exp(-(x - mid) ** 2 / (n * n) / (2 * var))
            / math.sqrt(2 * math.pi * var)).astype(np.float32)


def gaussian_weights_2d(h: int, w: int, var: float = 0.01) -> np.ndarray:
    return np.outer(gaussian_weights_1d(h, var), gaussian_weights_1d(w, var))


def _starts(n: int, t: int, stride: int) -> list:
    """Tile origins along an axis of n: every `stride`, and the last tile
    flush with the edge."""
    s = list(range(0, max(n - t, 0) + 1, stride))
    if s[-1] + t < n:
        s.append(n - t)
    return s


def tiled_chunked_decode(decode_fn, latents: torch.Tensor, tile_hw=(72, 128),
                         overlap: float = 0.25, chunk: int = 5, scale: int = 8,
                         pano_wrap: bool = True) -> torch.Tensor:
    """latents [F, 4, h, w] -> frames [F, 3, h*scale, w*scale], float32 on
    the latents' device.

    decode_fn: [N, 4, th, tw] -> [N, 3, th*scale, tw*scale], N frames of one
    video. Tiles overlap by `overlap` of a tile and blend with gaussian
    weights; the frames of a tile decode in `chunk`-frame groups. With
    `pano_wrap` the width is padded circularly by max(2, tw // 8) latents
    first, so the panorama's seam decodes continuously, and the pad is
    cropped after; a pad wider than the width raises."""
    F, _, h, w = latents.shape
    pad = 0
    if pano_wrap:
        pad = max(2, tile_hw[1] // 8)
        if pad > w:
            raise ValueError(f"tiled_chunked_decode: the circular pad of {pad} latents is "
                             f"wider than the {w}-latent width")
        latents = torch.cat([latents[..., -pad:], latents, latents[..., :pad]], dim=-1)
        w += 2 * pad
    th, tw = min(tile_hw[0], h), min(tile_hw[1], w)
    ys = _starts(h, th, max(1, int(th * (1 - overlap))))
    xs = _starts(w, tw, max(1, int(tw * (1 - overlap))))

    dev = latents.device
    weights = torch.from_numpy(gaussian_weights_2d(th * scale, tw * scale)).to(dev)
    out = torch.zeros(F, 3, h * scale, w * scale, device=dev)
    den = torch.zeros(1, 1, h * scale, w * scale, device=dev)
    for y in ys:
        for x in xs:
            tile = latents[:, :, y:y + th, x:x + tw]
            dec = torch.cat([decode_fn(tile[f0:f0 + chunk]) for f0 in range(0, F, chunk)])
            wy, wx = y * scale, x * scale
            out[:, :, wy:wy + th * scale, wx:wx + tw * scale] += dec.float() * weights
            den[:, :, wy:wy + th * scale, wx:wx + tw * scale] += weights
    out = out / den.clamp_min(1e-8)
    if pano_wrap:
        out = out[..., pad * scale:-pad * scale]
    return out
