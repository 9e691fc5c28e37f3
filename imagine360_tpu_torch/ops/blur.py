"""Small depthwise gaussian blur, the counterpart of
imagine360_tpu/ops/blur.py (the reference softens masks with kornia's
gaussian_blur2d). Shifted sums over the last two axes of [..., H, W], in
the JAX package's order; no kernel of its own."""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _gauss_kernel(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur_5x5(x: torch.Tensor, sigma: float = 1.0,
                      wrap_w: bool = False) -> torch.Tensor:
    """Separable 5x5 blur over the last two axes of [..., H, W]. Border:
    replicate vertically; replicate, or circular with `wrap_w`,
    horizontally."""
    k = [float(w) for w in _gauss_kernel(5, sigma)]
    H, W = x.shape[-2:]
    xp = torch.cat([x[..., :1, :]] * 2 + [x] + [x[..., -1:, :]] * 2, dim=-2)
    x = sum(k[i] * xp[..., i:i + H, :] for i in range(5))
    if wrap_w:
        xp = torch.cat([x[..., -2:], x, x[..., :2]], dim=-1)
    else:
        xp = torch.cat([x[..., :1]] * 2 + [x] + [x[..., -1:]] * 2, dim=-1)
    return sum(k[i] * xp[..., i:i + W] for i in range(5))
