"""360-degree horizontal continuity helpers: circular (wrap) padding of the
ERP width (counterpart of imagine360_tpu/geometry/pano.py)."""
from __future__ import annotations

import torch


def pad_pano(pano: torch.Tensor, padding: int) -> torch.Tensor:
    """Circularly pad the last (width) axis by `padding` on both sides."""
    if padding <= 0:
        return pano
    return torch.cat([pano[..., -padding:], pano, pano[..., :padding]], dim=-1)


def unpad_pano(pano: torch.Tensor, padding: int) -> torch.Tensor:
    """Crop `padding` columns from both sides of the last axis."""
    if padding <= 0:
        return pano
    return pano[..., padding:-padding]
