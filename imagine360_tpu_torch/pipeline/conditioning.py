"""Shared initial noise for the dual-branch sampler (counterpart of
imagine360_tpu/pipeline/conditioning.py:init_shared_noise)."""
from __future__ import annotations

import torch

from ..geometry.projection import e2p_grids, remap_nearest


def project_shared_noise(pano: torch.Tensor, cameras, pers_hw) -> torch.Tensor:
    """Perspective noise as the nearest-neighbour ERP -> view projection of
    the pano noise (reference pipeline init_noise, e2p mode='nearest').
    pano [B, F, eh, ew, 4] -> pers [B, M, F, ph, pw, 4]."""
    gx, gy = e2p_grids(cameras, pano.shape[2:4], pers_hw)      # [M, ph, pw]
    gx = torch.from_numpy(gx).to(pano.device)
    gy = torch.from_numpy(gy).to(pano.device)
    pers = remap_nearest(pano.permute(0, 1, 4, 2, 3), gx, gy)  # [B, F, 4, M, ph, pw]
    return pers.permute(0, 3, 1, 4, 5, 2)


def init_shared_noise(generator: torch.Generator, batch: int, frames: int, equi_hw,
                      pers_hw, cameras, dtype=torch.float32):
    """One pano noise field per frame, drawn from `generator` on its device,
    and its projection into every view, so both branches start from shared
    randomness. Returns (pano [B, F, eh, ew, 4], pers [B, M, F, ph, pw, 4])."""
    eh, ew = equi_hw
    pano = torch.randn(batch, frames, eh, ew, 4, generator=generator,
                       device=generator.device, dtype=torch.float32)
    pers = project_shared_noise(pano, cameras, pers_hw)
    return pano.to(dtype), pers.to(dtype)
