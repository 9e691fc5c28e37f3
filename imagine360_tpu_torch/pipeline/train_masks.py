"""Training-time random outpaint masks (counterpart of
imagine360_tpu/pipeline/train_masks.py; reference
animatediff/utils/video_mask.py: video_mask horizontal / vertical / float
variants, erp_mask and pers2erp_mask built from a 12-view perspective
coverage rig). Host numpy; the draws come from a numpy Generator."""
from __future__ import annotations

import numpy as np

from .anchor import pers_to_erp_frame


def video_mask(rng: np.random.Generator, hw, mode: str | None = None):
    """Random rectangular outpaint mask [h, w, 1]; 1 = region to generate
    (horizontal 40% / vertical 40% / float 20%)."""
    h, w = hw
    mask = np.ones((h, w, 1), np.float32)
    if mode is None:
        r = rng.uniform()
        mode = "horizontal" if r < 0.4 else "vertical" if r < 0.8 else "float"

    def span(n):
        size = rng.integers(n // 4, 3 * n // 4 + 1)
        start = rng.integers(0, n - size + 1)
        return start, start + size

    if mode == "horizontal":
        x0, x1 = span(w)
        mask[:, x0:x1] = 0
    elif mode == "vertical":
        y0, y1 = span(h)
        mask[y0:y1, :] = 0
    else:
        y0, y1 = span(h)
        x0, x1 = span(w)
        mask[y0:y1, x0:x1] = 0
    return mask


def erp_coverage_mask(target_hw, anchor_size: int, fov: float = 90.0):
    """ERP mask where a 12-view rig (yaw {0, 90, 180, 270} x pitch {0, -fov,
    +fov}) minus the forward view covers the sphere; the uncovered hole marks
    the anchor region.

    Returns (mask [h, w, 1] with 1 = covered by another view, anchor_top,
    anchor_left, anchor_hw)."""
    h, w = target_hw
    cover = np.zeros((h, w), np.float32)
    ones = np.ones((anchor_size, anchor_size, 1), np.float32)
    for theta in (0, 90, 180, 270):
        for phi in (0, -fov, fov):
            if theta == 0 and phi == 0:
                continue  # the forward anchor view is excluded
            _, m = pers_to_erp_frame(ones, fov, theta, phi, (h, w))
            cover = np.maximum(cover, m.astype(np.float32))
    ys, xs = np.where(cover == 0)
    if len(ys) == 0:
        return cover[..., None], 0, 0, (0, 0)
    top, left = int(ys.min()), int(xs.min())
    return cover[..., None], top, left, (int(ys.max() - ys.min()), int(xs.max() - xs.min()))
