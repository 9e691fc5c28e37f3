"""One full-width dual-branch denoise forward as a callable and its arguments
(counterpart of the repo's `__graft_entry__.py:entry`): `full_dual_config`
in bfloat16, the CFG pair (batch 2), 20 perspective views and the pano, 8
frames, 16 SAM frames, on the latent sizes of a 512 x 1024 panorama (views
of 256 x 256).

The weights are seeded random values drawn from an explicit
torch.Generator (`utils/init.py:seeded_init_`), not zeros: zero weights
make every softmax flat and hide any path. The inputs are drawn from the
same generator, the timestep is 500, the fps 8, and no antipodal mask is
taken. The callable computes the IP tokens from the SAM features, then runs
the forward without IP-token noise, as the JAX entry's
`add_ip_noise=False` does.

    fn, args = entry()           # on the card
    pers_out, pano_out = fn(*args)
"""
from __future__ import annotations

from typing import Optional

import torch

from .geometry.cameras import CameraRig
from .models.dual import DualUNet, DualUNetConfig, warp_sites
from .pipeline.sampler import build_dual_warp_geoms
from .presets import full_dual_config
from .utils.device import require_device
from .utils.init import seeded_init_

FRAMES = 8
SAM_FRAMES = 16
PERS_LATENT_HW = (32, 32)       # 256 x 256 views
PANO_LATENT_HW = (64, 128)      # a 512 x 1024 panorama
TEXT_LEN = 77
SAM_TOKENS = 4096               # SAM ViT-B's 64 x 64 feature map
TIMESTEP, FPS = 500.0, 8.0


def flagship_shapes(cfg: DualUNetConfig, frames: int = FRAMES, sam_frames: int = SAM_FRAMES,
                    pers_latent_hw=PERS_LATENT_HW, pano_latent_hw=PANO_LATENT_HW,
                    text_len: int = TEXT_LEN, sam_tokens: int = SAM_TOKENS) -> dict:
    """The shapes of the forward's tensor arguments, by name, in order."""
    B, M = 2, cfg.num_views
    ctx, sam = cfg.pers.cross_attention_dim, cfg.pers.image_hidden_size
    return {
        "pers_latents": (B, M, frames, *pers_latent_hw, 9),     # latents + mask + masked
        "pano_latent": (B, frames, *pano_latent_hw, 9),
        "timestep": (B,),
        "pers_text": (B * M, text_len, ctx),
        "pano_text": (B, text_len, ctx),
        "fps": (B,),
        "ref_feats_pers": (B * M, sam_frames, sam_tokens, sam),
        "ref_feats_pano": (B, sam_frames, sam_tokens, sam),
        "rel_pos": (B, frames, 6),
        "pitch": (B, frames),
    }


def entry(device=None, cfg: Optional[DualUNetConfig] = None, seed: int = 0, **shape_kw):
    """-> (fn, args): `fn(*args)` is one denoise forward of `cfg` (default
    full_dual_config("bfloat16")) on `device` (default the card; "cpu" runs
    it on the CPU through the plain attention versions) and returns
    (pers_out [2, M, F, h, w, 4] or None under pano_only, pano_out
    [2, F, eh, ew, 4]). args are the tensors of `flagship_shapes(cfg,
    **shape_kw)`, then the WarpAttn geometry and the 7 antipodal choices."""
    dev = require_device("cuda" if device is None else device)
    cfg = cfg or full_dual_config("bfloat16")
    dtype = cfg.pano.torch_dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        model = DualUNet(cfg)
    model = model.to(dtype).eval()
    with torch.no_grad():
        seeded_init_(model, gen)

    shapes = flagship_shapes(cfg, **shape_kw)
    pers_hw, pano_hw = shapes["pers_latents"][3:5], shapes["pano_latent"][2:4]
    rig = CameraRig.icosahedron(image_size=8 * pers_hw[0]).take(cfg.num_views)
    geoms = build_dual_warp_geoms(cfg, rig, pers_hw, pano_hw, device=dev)

    def draw(name):
        s = shapes[name]
        if name == "timestep":
            return torch.full(s, TIMESTEP, device=dev)
        if name == "fps":
            return torch.full(s, FPS, device=dev)
        if name == "rel_pos":
            return torch.randint(0, 50, s, generator=gen, device=dev).float()
        if name == "pitch":
            return torch.randint(0, 90, s, generator=gen, device=dev).float()
        return torch.randn(s, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    use_opp = [False] * len(warp_sites(len(cfg.pers.block_out_channels)))
    args = tuple(draw(name) for name in shapes) + (geoms, use_opp)

    @torch.no_grad()
    def fn(pers_latents, pano_latent, timestep, pers_text, pano_text, fps, ref_feats_pers,
           ref_feats_pano, rel_pos, pitch, warp_geoms, opp):
        ip_pers, ip_pano = model.compute_ip_tokens(ref_feats_pers, ref_feats_pano, rel_pos,
                                                   pitch)
        return model(pers_latents, pano_latent, timestep, pers_text, pano_text, fps,
                     warp_geoms, opp, ip_pers, ip_pano)

    return fn, args
