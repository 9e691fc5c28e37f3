"""Wavelet colour transfer: keep the upscaled frame's high frequencies and
the source frame's colour distribution. Counterpart of
imagine360_tpu/sr/wavelet_fix.py (reference sr/inference_utils.py:46-94),
on channel-first videos [F, C, H, W]: the blur walks the last two axes."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _blur_dilated(x: torch.Tensor, radius: int) -> torch.Tensor:
    """The 3x3 kernel [[1, 2, 1], [2, 4, 2], [1, 2, 1]] / 16 with dilation
    `radius` and edge padding, as [1, 2, 1] / 4 along H, then along W. The
    padding may exceed the axis (radius 16 on a short frame): replicate
    padding repeats the edge as far as it is asked to."""
    shape = x.shape
    h = x.reshape(-1, 1, *shape[-2:])
    for dim, pad in ((2, (0, 0, radius, radius)), (3, (radius, radius, 0, 0))):
        n = h.shape[dim]
        hp = F.pad(h, pad, mode="replicate")
        h = (0.25 * hp.narrow(dim, 0, n) + 0.5 * hp.narrow(dim, radius, n)
             + 0.25 * hp.narrow(dim, 2 * radius, n))
    return h.reshape(shape)


def wavelet_decompose(x: torch.Tensor, levels: int = 5):
    """x [..., H, W] -> (high frequencies, low frequencies): `levels`
    blurs of dilation 1, 2, 4, ..., the detail of each summed."""
    high = torch.zeros_like(x)
    low = x
    for i in range(levels):
        smoothed = _blur_dilated(low, 2 ** i)
        high = high + (low - smoothed)
        low = smoothed
    return high, low


def wavelet_color_fix(target: torch.Tensor, source: torch.Tensor,
                      levels: int = 5) -> torch.Tensor:
    """target's detail + source's colour, clipped to [0, 1]; both
    [F, C, H, W] in [0, 1] on one device."""
    t_high, _ = wavelet_decompose(target, levels)
    _, s_low = wavelet_decompose(source, levels)
    return (t_high + s_low).clamp(0.0, 1.0)
