"""Panorama-aware cross-branch attention, WarpAttn (counterpart of
imagine360_tpu/models/warp.py).

Bidirectional masked cross-attention between the panorama feature map and
the m perspective feature maps, with spherical positional encodings. The
correspondence bias masks and the PEs are precomputed
(geometry/corr_masks.warp_geometry); the antipodal-mask choice picks one of
two precomputed bias variants. On the card both directions run kernel K3
(one [Sq, Sk] bias shared by every frame and head).

Under a mesh (parallel/mesh.py) pers_x holds this rank's views only. The
pano queries attend to every view's keys, all-gathered in rank order. The
perspective queries attend to the whole pano under this rank's rows of the
bias, which build_dual_warp_geoms keeps (with this rank's views of the
PE). With the pano's rows sharded (`rows`) equi_x holds this rank's latent
rows: its queries take this rank's row block of the pano-query bias and of
the pano PE (also cut by build_dual_warp_geoms), and the perspective
queries attend to the pano gathered over the rows, its PE added first.
"""
from __future__ import annotations

import torch.nn as nn

from ..parallel.mesh import gather_pano, gather_views
from .layers import Attention, FeedForward, LayerNorm


class WarpTransformerBlock(nn.Module):
    """Pre-norm cross-attention block with optional query PE. Reference
    quirk kept: the SAME norm1 normalizes both query and context."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads=dim // 32, dim_head=32)
        self.ff = FeedForward(dim)

    def forward(self, x, context, bias=None, query_pe=None):
        q = x if query_pe is None else x + query_pe
        x = self.attn1(self.norm1(q), context=self.norm1(context), bias=bias) + x
        return self.ff(self.norm2(x)) + x


class WarpAttn(nn.Module):
    """Pano <-> perspective coupling at one feature resolution; one
    transformer block serves both directions."""

    def __init__(self, dim: int, num_views: int):
        super().__init__()
        self.num_views = num_views
        self.transformer = WarpTransformerBlock(dim)

    def forward(self, pers_x, equi_x, geom: dict, use_opp: bool, rows=None):
        """pers_x [B*m, F, h, w, C] (m: this rank's views, all of them with
        no mesh); equi_x [B, F, eh, ew, C] (eh: this rank's rows under
        `rows`, a parallel/mesh.py Mesh); geom: the bias/PE tensors of this
        site (pipeline/sampler.build_dual_warp_geoms, built under the same
        mesh); use_opp: take the antipodal mask variant."""
        bm, F, h, w, C = pers_x.shape
        b, _, eh, ew, _ = equi_x.shape
        m = bm // b
        tag = "_opp" if use_opp else ""
        dt = pers_x.dtype
        pers_bias = geom["pers_bias" + tag][None, None]      # float32, as K3 reads it
        equi_bias = geom["equi_bias" + tag][None, None]      # this rank's query rows
        pers_pe = geom["pers_pe"].to(dt)                 # [m, h, w, C], this rank's views
        equi_pe = geom["equi_pe"].to(dt)                 # [eh, ew, C], this rank's rows
        if pers_pe.shape[0] != m or equi_bias.shape[2] != m * h * w:
            raise ValueError(f"WarpAttn: the geometry holds {pers_pe.shape[0]} views, the "
                             f"features {m}: build it under the same mesh")
        if equi_pe.shape[0] != eh or pers_bias.shape[2] != eh * ew:
            raise ValueError(f"WarpAttn: the geometry holds {equi_pe.shape[0]} pano rows, the "
                             f"features {eh}: build it under the same mesh")

        # direction 1: ERP queries attend to the perspective keys of every view
        q = equi_x.reshape(b * F, eh * ew, C)
        pers_6 = pers_x.reshape(b, m, F, h, w, C)
        kv = (pers_6 + pers_pe[None, :, None]).permute(0, 2, 1, 3, 4, 5)
        kv = gather_views(kv.reshape(b * F, m * h * w, C), dim=1)
        if kv.shape[1] != self.num_views * h * w:
            raise ValueError(f"WarpAttn: {kv.shape[1] // (h * w)} views, the model has "
                             f"{self.num_views}")
        equi_out = self.transformer(q, kv, bias=pers_bias,
                                    query_pe=equi_pe.reshape(1, eh * ew, C))
        equi_out = equi_out.reshape(b, F, eh, ew, C)

        # direction 2: perspective queries attend to ERP keys
        q = pers_6.permute(0, 2, 1, 3, 4, 5).reshape(b * F, m * h * w, C)
        kv = gather_pano(equi_x + equi_pe[None, None], rows).reshape(b * F, -1, C)
        pers_out = self.transformer(q, kv, bias=equi_bias,
                                    query_pe=pers_pe.reshape(1, m * h * w, C))
        pers_out = pers_out.reshape(b, F, m, h, w, C).permute(0, 2, 1, 3, 4, 5)
        return pers_out.reshape(bm, F, h, w, C), equi_out
