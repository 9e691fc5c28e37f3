"""Anchor extraction and relative-position conditioning (host side;
counterpart of imagine360_tpu/pipeline/anchor.py): re-extract the
perspective anchor from each warped pano frame, find the largest un-masked
inscribed rectangle, and compute the 6-tuple {Hoff, Woff, Hanchor, Wanchor,
Htarget, Wtarget} per frame.

The remaps and the rectangle run on the host library (native/); `backend`
names the numpy versions instead. With a StageTimer, the grids, remaps,
rectangles and resizes are timed as its splits "<prefix> grids",
"<prefix> remap", "anchor rect" and "anchor resize".
"""
from __future__ import annotations

import numpy as np

from ..geometry.projection import equi_pix_to_pers_grid, pers_pix_to_equi_grid
from ..native import max_inscribed_rect, remap_bilinear
from ..utils.observability import split
from ..utils.video_io import resize_bilinear


def erp_to_pers_frame(erp: np.ndarray, fov, theta, phi, out_hw, backend="library",
                      timer=None, prefix="anchor"):
    """Host-side ERP -> perspective crop (bilinear, x wraps)."""
    with split(timer, f"{prefix} grids"):
        gx, gy = pers_pix_to_equi_grid(erp.shape[0], erp.shape[1], fov, theta, phi,
                                       out_hw[0], out_hw[1])
    with split(timer, f"{prefix} remap"):
        return remap_bilinear(erp, gx, gy, wrap_x=True, backend=backend)


def pers_to_erp_frame(pers: np.ndarray, fov, theta, phi, out_hw, backend="library",
                      timer=None, prefix="anchor"):
    """Host-side perspective -> ERP and its coverage mask."""
    with split(timer, f"{prefix} grids"):
        gx, gy, mask = equi_pix_to_pers_grid(pers.shape[0], pers.shape[1], fov, theta, phi,
                                             out_hw[0], out_hw[1])
    with split(timer, f"{prefix} remap"):
        return remap_bilinear(pers, gx, gy, wrap_x=True, backend=backend) * mask[..., None], \
            mask


def get_anchor_target(pano_frames: np.ndarray, pitches, fov: float = 90.0,
                      theta: float = 0.0, anchor_size: int = 256, backend: str = "library",
                      timer=None):
    """pano_frames [F, H, W, 3] in [-1, 1]; per-frame pitch (degrees).

    Returns dict with:
      anchor [F, 256, 256, 3]        largest-rect crop, resized
      anchor_pers [F, H/2, H/2, 3]   fixed perspective re-extraction
      masks [F, H, W, 1]             outpaint masks (1 = to generate)
      relative_position [F, 6], pitch [F]
    """
    F, H, W, _ = pano_frames.shape
    pers_size = H // 2
    anchors, anchors_pers, masks, rels = [], [], [], []
    for i in range(F):
        pers = erp_to_pers_frame(pano_frames[i], fov, theta, float(pitches[i]),
                                 (pers_size, pers_size), backend, timer)
        anchors_pers.append(pers)
        _, cover = pers_to_erp_frame(pers, fov, theta, float(pitches[i]), (H, W), backend,
                                     timer)
        masks.append((1.0 - cover.astype(np.float32))[..., None])
        with split(timer, "anchor rect"):
            top, left, rw, rh = max_inscribed_rect(cover, backend=backend)
        with split(timer, "anchor resize"):
            crop = pano_frames[i, top:top + rh, left:left + rw]
            anchors.append(resize_bilinear(crop, (anchor_size, anchor_size)))
        rels.append([int(H / 2 - (2 * top + rh) / 2), int(W / 2 - (2 * left + rw) / 2),
                     rh, rw, H, W])
    return {
        "anchor": np.stack(anchors).astype(np.float32),
        "anchor_pers": np.stack(anchors_pers).astype(np.float32),
        "masks": np.stack(masks).astype(np.float32),
        "relative_position": np.asarray(rels, np.float32),
        "pitch": np.asarray(pitches, np.float32),
    }
