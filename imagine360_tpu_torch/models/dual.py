"""Dual-branch coupler: the perspective UNet (views folded into the batch)
and the panorama UNet walked in lockstep, with WarpAttn after every encoder
downsample, at the mid block, and before every decoder upsample
(counterpart of imagine360_tpu/models/dual.py).

Reference quirks kept, as in the JAX package:
- motion modules are skipped in blocks without spatial attention during
  the dual walk (so those blocks have none: UNet3DConditionModel
  dual_walk=True);
- sigma-0.1 gaussian noise is added to the IP tokens on every call, drawn
  here from the caller's torch.Generator or passed in as a tensor;
- the relative-position/pitch adapter conditions only the pano branch;
- pano circular padding wraps every conv, with the per-stage amounts.

Under a mesh (parallel/mesh.py) the perspective branch runs this rank's
views. The pano branch runs this rank's latent rows where every stage's
height divides the world (parallel/mesh.py:pano_row_mesh), and whole on
every rank otherwise: the pano enters whole, each rank takes its rows at
the stem, carries them (`rows`) through every block, WarpAttn and
upsample, and the rows are gathered back after the head.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from ..parallel.mesh import current_mesh, gather_pano, pano_row_mesh, shard_pano, shard_views
from .unet3d import UNet3DConditionModel, UNet3DConfig, maybe_remat
from .warp import WarpAttn


def warp_sites(n_blocks: int = 4):
    """(site name, resolution key) in walk order; r{s} is the feature map at
    latent_size / s."""
    sites = [(f"enc_{i}", f"r{2 ** (i + 1)}") for i in range(n_blocks - 1)]
    sites.append(("mid", f"r{2 ** (n_blocks - 1)}"))
    sites += [(f"dec_{i}", f"r{2 ** (n_blocks - 1 - i)}") for i in range(n_blocks - 1)]
    return tuple(sites)


WARP_SITES = warp_sites(4)


@dataclasses.dataclass(frozen=True)
class DualUNetConfig:
    pers: UNet3DConfig = UNet3DConfig()
    pano: UNet3DConfig = UNet3DConfig()
    num_views: int = 20
    pano_pad: bool = True
    # no perspective UNet and no WarpAttn: the pano branch alone
    pano_only: bool = False
    ip_noise_level: float = 0.1
    # skip every WarpAttn site (step bisection, as scripts/step_breakdown.py
    # of the JAX package uses it); the blocks and their weights stay
    disable_warp: bool = False


class DualUNet(nn.Module):

    def __init__(self, cfg: DualUNetConfig):
        super().__init__()
        c = self.cfg = cfg
        self.pano_unet = UNet3DConditionModel(c.pano, dual_walk=True)
        if c.pano_only:
            return
        self.unet = UNet3DConditionModel(c.pers, dual_walk=True, rel_pos_adapter=False)
        boc = c.pers.block_out_channels
        rev = list(reversed(boc))
        self.cp_blocks_encoder = nn.ModuleList(
            [WarpAttn(boc[i], c.num_views) for i in range(len(boc) - 1)])
        self.cp_blocks_mid = WarpAttn(boc[-1], c.num_views)
        self.cp_blocks_decoder = nn.ModuleList(
            [WarpAttn(rev[i], c.num_views) for i in range(len(boc) - 1)])

    def compute_ip_tokens(self, ref_feats_pers, ref_feats_pano, rel_pos=None, pitch=None):
        """The deterministic, loop-invariant part of the IP conditioning
        (temporal projection + resampler + relative-position adapter), run
        once before the denoise loop. Returns (ip_pers, ip_pano)."""
        c = self.cfg
        ip_pano = ip_pers = None
        if c.pano.use_ip and ref_feats_pano is not None:
            ip_pano = self.pano_unet.ip_tokens(ref_feats_pano, rel_pos, pitch)
        if not c.pano_only and c.pers.use_ip and ref_feats_pers is not None:
            ip_pers = self.unet.ip_tokens(ref_feats_pers)
        return ip_pers, ip_pano

    def forward(self, pers_latents, pano_latent, timestep, pers_text, pano_text, fps=None,
                warp_geoms=None, use_opp=None, ip_tokens_pers=None, ip_tokens_pano=None,
                ip_noise_pers: Optional[torch.Tensor] = None,
                ip_noise_pano: Optional[torch.Tensor] = None):
        """pers_latents [B, M, F, h, w, Cin]; pano_latent [B, F, eh, ew, Cin];
        timestep [B]; pers_text [B*M, L, Ctx]; pano_text [B, L, Ctx];
        warp_geoms from build_dual_warp_geoms; use_opp: 7 bools (antipodal
        mask per site); ip_tokens_* from compute_ip_tokens; ip_noise_*:
        unit-variance noise shaped like the tokens (scaled here by
        cfg.ip_noise_level), or None for none. Returns (pers_out
        [B, M, F, h, w, 4], pano_out [B, F, eh, ew, 4]); pers_out is None
        under cfg.pano_only or without pers_latents (the pano branch alone),
        and cfg.disable_warp runs both branches uncoupled.

        Under a mesh the perspective inputs (pers_latents, pers_text,
        ip_tokens_pers, ip_noise_pers) hold all cfg.num_views views, and
        this rank keeps its own, or hold this rank's views already (as the
        sampler's loop passes them); pers_out holds this rank's views. The
        pano latent is whole, and so is the pano output, whether its rows
        were sharded or not. warp_geoms must be built under the same mesh."""
        c = self.cfg
        pad = c.pano_pad
        dual = not c.pano_only and pers_latents is not None
        warp = dual and not c.disable_warp
        sites = warp_sites(len(c.pers.block_out_channels))
        n_enc = len(c.pers.block_out_channels) - 1
        B = pano_latent.shape[0]

        def context(unet, text, tokens, noise):
            if tokens is None:
                return text
            if noise is not None and c.ip_noise_level > 0:
                tokens = tokens + c.ip_noise_level * noise.to(tokens.dtype)
            return unet.build_context(text, tokens)

        def geom(i):
            name, rkey = sites[i]
            return {**warp_geoms[rkey], **warp_geoms["pe"][name]}, bool(use_opp[i])

        rows = pano_row_mesh(pano_latent.shape[2], len(c.pano.block_out_channels))
        pano_temb = self.pano_unet.time_embed(timestep, fps)
        pano_ctx = context(self.pano_unet, pano_text, ip_tokens_pano, ip_noise_pano)
        ha = self.pano_unet.stem(shard_pano(pano_latent, rows).to(
            self.pano_unet.conv_in.weight.dtype), pad=pad, rows=rows)
        if dual:
            if current_mesh() is not None and pers_latents.shape[1] == c.num_views:
                pers_latents = shard_views(pers_latents, 1)
                pers_text, ip_tokens_pers, ip_noise_pers = (
                    None if x is None else shard_views(x, 0, B)
                    for x in (pers_text, ip_tokens_pers, ip_noise_pers))
            _, M, F, h, w, Cin = pers_latents.shape
            temb = self.unet.time_embed(timestep.repeat_interleave(M, dim=0),
                                        None if fps is None else fps.repeat_interleave(M, dim=0))
            pers_ctx = context(self.unet, pers_text, ip_tokens_pers, ip_noise_pers)
            hp = self.unet.stem(pers_latents.reshape(B * M, F, h, w, Cin).to(
                self.unet.conv_in.weight.dtype))
            skips_p = [hp]

        skips_a = [ha]
        for i, blk_a in enumerate(self.pano_unet.down_blocks):
            has_attn = blk_a.heads is not None
            if dual:
                hp, sp = self.unet.down_blocks[i](hp, temb, pers_ctx, False, has_attn)
                skips_p.extend(sp)
            ha, sa = blk_a(ha, pano_temb, pano_ctx, pad, has_attn, rows)
            skips_a.extend(sa)
            if warp and hasattr(blk_a, "downsamplers"):
                g, opp = geom(i)
                hp, ha = maybe_remat(c.pers.remat, self.cp_blocks_encoder[i], hp, ha, g, opp,
                                     rows)

        if dual:
            hp = self.unet.mid_block(hp, temb, pers_ctx)
        ha = self.pano_unet.mid_block(ha, pano_temb, pano_ctx, pad=pad, rows=rows)
        if warp:
            g, opp = geom(n_enc)
            hp, ha = maybe_remat(c.pers.remat, self.cp_blocks_mid, hp, ha, g, opp, rows)

        n_sk = c.pano.layers_per_block + 1
        for i, blk_a in enumerate(self.pano_unet.up_blocks):
            has_attn = blk_a.heads is not None
            if dual:
                blk_p = self.unet.up_blocks[i]
                hp = blk_p(hp, tuple(skips_p[-n_sk:]), temb, pers_ctx, False, has_attn)
                del skips_p[-n_sk:]
            ha = blk_a(ha, tuple(skips_a[-n_sk:]), pano_temb, pano_ctx, pad, has_attn, rows)
            del skips_a[-n_sk:]
            if hasattr(blk_a, "upsamplers"):
                if warp:
                    g, opp = geom(n_enc + 1 + i)
                    hp, ha = maybe_remat(c.pers.remat, self.cp_blocks_decoder[i], hp, ha, g,
                                         opp, rows)
                if dual:
                    hp = blk_p.upsample(hp)
                ha = blk_a.upsample(ha, pad=pad, rows=rows)

        pers_out = self.unet.head(hp).reshape(B, M, F, h, w, -1) if dual else None
        return pers_out, gather_pano(self.pano_unet.head(ha, pad=pad, rows=rows), rows)
