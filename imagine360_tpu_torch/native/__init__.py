"""Host-preprocessing routines in numpy: the port's own versions of what
the JAX package's `native` module offers (bilinear remap, uint8 -> model
range, largest inscribed rectangle). The semantics are those of the JAX
package's Python fallbacks (imagine360_tpu/pipeline/anchor.py); there is no
compiled library behind them.
"""
from __future__ import annotations

import numpy as np


def remap_bilinear(src: np.ndarray, gx: np.ndarray, gy: np.ndarray,
                   wrap_x: bool = True) -> np.ndarray:
    """src [H, W, C] or [H, W]; gx/gy [oh, ow] absolute pixel coords ->
    [oh, ow, C] (or [oh, ow]). Bilinear; x wraps (wrap_x) or clamps, y
    clamps (cv2.BORDER_WRAP behaviour at the 360-degree seam)."""
    H, W = src.shape[:2]
    x0 = np.floor(gx).astype(np.int64)
    y0 = np.floor(gy).astype(np.int64)
    wx, wy = gx - x0, gy - y0
    if src.ndim == 3:
        wx, wy = wx[..., None], wy[..., None]
    if wrap_x:
        xs0, xs1 = x0 % W, (x0 + 1) % W
    else:
        xs0, xs1 = np.clip(x0, 0, W - 1), np.clip(x0 + 1, 0, W - 1)
    ys0 = np.clip(y0, 0, H - 1)
    ys1 = np.clip(y0 + 1, 0, H - 1)
    return (src[ys0, xs0] * (1 - wx) * (1 - wy) + src[ys0, xs1] * wx * (1 - wy)
            + src[ys1, xs0] * (1 - wx) * wy + src[ys1, xs1] * wx * wy)


def u8_to_model_range(frames: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return frames.astype(np.float32) / 127.5 - 1.0


def max_inscribed_rect(mask: np.ndarray):
    """Largest all-ones axis-aligned rectangle in a binary [h, w] mask, as
    (top, left, width, height); of equal areas, the first found scanning
    rows top to bottom and columns left to right.

    Histogram-stack algorithm over column heights. Rows without a set pixel
    and the columns outside a row's first and last nonzero height hold no
    rectangle and cannot end one, so the scan skips them; the result is
    that of the full scan."""
    h, w = mask.shape
    m = np.asarray(mask).astype(bool)
    heights = np.zeros(w, dtype=np.int64)
    best_area = 0
    best = (0, 0, 0, 0)
    for i in range(h):
        heights = np.where(m[i], heights + 1, 0)
        nz = np.flatnonzero(heights)
        if nz.size == 0:
            continue
        lo, hi = int(nz[0]), int(nz[-1]) + 1
        row = heights[lo:hi].tolist() + [0]
        stack = []  # (start index, height)
        for j, cur in enumerate(row, start=lo):
            start = j
            while stack and stack[-1][1] > cur:
                s, hh = stack.pop()
                area = hh * (j - s)
                if area > best_area:
                    best_area = area
                    best = (i - hh + 1, s, j - s, hh)
                start = s
            if not stack or stack[-1][1] < cur:
                stack.append((start, cur))
    return best
