"""Latent-space conditioning for the dual-branch sampler (counterpart of
imagine360_tpu/pipeline/conditioning.py): the shared initial noise, the
VAE-encoded masked pixels and the latent-resolution masks."""
from __future__ import annotations

from typing import Optional

import torch

from ..geometry.projection import e2p_grids, remap_nearest
from ..parallel.mesh import map_sharded


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


def downsample_mask_nearest(mask: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """Nearest-neighbour mask downsample by an integer factor (a strided
    subsample, as F.interpolate 'nearest' gives). mask [..., H, W, C] ->
    [..., H/f, W/f, C]."""
    return mask[..., ::factor, ::factor, :]


@torch.no_grad()
def prepare_masked_latents(vae, pixels: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           scaling: float = 0.18215, chunk: Optional[int] = None,
                           deterministic: bool = False) -> torch.Tensor:
    """VAE-encode masked pixel frames to conditioning latents.

    pixels [N, H, W, 3] in [-1, 1] -> [N, H/8, W/8, 4] * scaling, on the
    VAE's device, `chunk` frames at a time (all at once when None).
    deterministic=True takes the posterior mean; otherwise each chunk is a
    posterior sample whose noise is drawn from `generator`. Under a mesh the
    frames are encoded over the ranks (parallel/mesh.py:map_sharded), each
    rank its own in chunks of at most `chunk`; every rank then draws each
    chunk's noise, in the order of one process."""
    n = pixels.shape[0]
    if chunk is None or chunk >= n:
        chunk = n
    if n % chunk != 0:
        raise ValueError(f"{n} frames do not divide into chunks of {chunk}")
    device = vae.quant_conv.weight.device

    def moments(px):        # [n, H, W, 3] -> mean and logvar side by side, [n, h, w, 8]
        return torch.cat([torch.cat(vae.encode(px[s:s + chunk].to(device)), dim=-1)
                          for s in range(0, px.shape[0], chunk)], dim=0)

    mean, logvar = map_sharded(moments, pixels).chunk(2, dim=-1)
    if not deterministic:
        if generator is None:
            raise ValueError("a posterior sample draws its noise: pass a torch.Generator")
        noise = torch.cat([torch.randn((chunk,) + mean.shape[1:], generator=generator,
                                       device=generator.device, dtype=torch.float32)
                           for _ in range(0, n, chunk)], dim=0)
        mean = mean + torch.exp(0.5 * logvar) * noise.to(device=mean.device, dtype=mean.dtype)
    return mean * scaling
