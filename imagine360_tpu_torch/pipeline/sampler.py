"""The dual-branch CFG sampler (counterpart of
imagine360_tpu/pipeline/sampler.py): a Python loop over the steps, with the
DDIM update or, by `SamplerConfig.solver`, DPM-Solver++ 2M.

CFG is the leading batch axis (2), as in the reference. The per-step random
elements, the antipodal mask choice (p = 0.4 per site), the IP-token noise
(sigma 0.1) and the noise of the SDE solver, come from an explicit
torch.Generator, or are passed in.

Under a mesh (parallel/mesh.py) the loop carries this rank's views of the
perspective latents and gathers them once at the end. The pano latent is
whole on every rank: the model shards its rows inside the forward (where
parallel/mesh.py:pano_row_mesh says so) and returns it whole, so the
update stays as it is. Every rank draws each random tensor at its full
size from the same generator and keeps its views, so the draws equal a
one-process run's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..diffusion.ddim import PREDICTION_TYPES, ddim_step, make_ddim_schedule
from ..diffusion.dpm import dpmpp_2m_step, make_dpm_schedule
from ..geometry.corr_masks import warp_geometry
from ..models.dual import DualUNet, DualUNetConfig, warp_sites
from ..parallel.mesh import gather_views, pano_row_mesh, shard_views, view_slice
from ..utils.device import require_device


def build_dual_warp_geoms(cfg: DualUNetConfig, cameras, pers_latent_hw, equi_latent_hw,
                          device="cuda"):
    """All WarpAttn constants for one latent resolution, on `device` (the
    card unless the caller asks for "cpu"; a missing card raises), all
    float32: the bias masks per resolution (shared by the sites of that
    resolution, kept in the dtype kernel K3 reads so no call converts them)
    and the spherical PEs per site. Under a mesh the perspective-query bias
    (`equi_bias*`) keeps this rank's rows and `pers_pe` this rank's views,
    cut here once rather than at every call; where the pano's rows shard
    (parallel/mesh.py:pano_row_mesh, the rule DualUNet takes) the
    pano-query bias (`pers_bias*`) keeps this rank's pano rows and
    `equi_pe` this rank's latent rows too."""
    device = require_device(device)
    boc = cfg.pers.block_out_channels
    n = len(boc)
    rev = list(reversed(boc))
    site_dims = {f"enc_{i}": boc[i] for i in range(n - 1)}
    site_dims["mid"] = boc[-1]
    site_dims.update({f"dec_{i}": rev[i] for i in range(n - 1)})
    scales = {f"r{2 ** (i + 1)}": 2 ** (i + 1) for i in range(n - 1)}
    ph, pw = pers_latent_hw
    eh, ew = equi_latent_hw
    max_s = 2 ** (n - 1)
    if min(ph, pw, eh, ew) < max_s:
        raise ValueError(f"latent sizes pers={pers_latent_hw} equi={equi_latent_hw} too "
                         f"small for a {n}-level UNet (deepest stride {max_s})")

    views = view_slice(cameras.num_views)
    pano_rows = pano_row_mesh(eh, len(cfg.pano.block_out_channels))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=torch.float32)

    def pano_block(a, s, row_len=1):    # this rank's latent rows of stage s, row-major
        if pano_rows is None:
            return a
        n = eh // s // pano_rows.world * row_len
        return a[pano_rows.rank * n:(pano_rows.rank + 1) * n]

    def query_rows(k, bias, s):   # [Sq, Sk] -> this rank's query rows
        if k.startswith("equi"):  # perspective queries, (view, h, w)-major
            hw = (ph // s) * (pw // s)
            return bias[views.start * hw:views.stop * hw]
        return pano_block(bias, s, ew // s)     # pano queries, (row, column)-major

    geoms = {"pe": {}}
    for rkey, s in scales.items():
        g = warp_geometry(cameras, (ph // s, pw // s), (eh // s, ew // s), dim=4)
        geoms[rkey] = {k: dev(query_rows(k, v, s)) for k, v in g.items() if "bias" in k}
    for name, rkey in warp_sites(n):
        s = scales[rkey]
        g = warp_geometry(cameras, (ph // s, pw // s), (eh // s, ew // s),
                          dim=site_dims[name])
        geoms["pe"][name] = {"pers_pe": dev(g["pers_pe"][views]),
                             "equi_pe": dev(pano_block(g["equi_pe"], s))}
    return geoms


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_steps: int = 50
    guidance_scale: float = 7.5
    antipodal_prob: float = 0.4
    add_ip_noise: bool = True
    # what the UNet predicts ("v_prediction", "epsilon" or "sample"), for the
    # DDIM and DPM-Solver++ updates alike
    prediction_type: str = "v_prediction"
    # "ddim" is the reference recipe (50 steps); "dpmpp_2m" is meant for about
    # half the steps, "dpmpp_2m_sde" adds noise at every step
    solver: str = "ddim"


SOLVERS = ("ddim", "dpmpp_2m", "dpmpp_2m_sde")


class DualDiffusionSampler:

    def __init__(self, model: DualUNet, cfg: SamplerConfig = SamplerConfig()):
        if cfg.solver not in SOLVERS:
            raise ValueError(f"solver {cfg.solver!r}: the sampler has {', '.join(SOLVERS)}")
        self.model = model
        self.cfg = cfg
        if cfg.prediction_type not in PREDICTION_TYPES:
            raise ValueError(f"prediction_type {cfg.prediction_type!r}: one of "
                             f"{', '.join(PREDICTION_TYPES)}")
        self.schedule = make_ddim_schedule(cfg.num_steps, prediction_type=cfg.prediction_type)
        self.dpm_schedule = (make_dpm_schedule(cfg.num_steps, cfg.prediction_type)
                             if cfg.solver.startswith("dpmpp") else None)

    @torch.no_grad()
    def compute_ip(self, ref_feats_pers=None, ref_feats_pano=None, rel_pos=None,
                   pitch=None):
        """IP tokens (ip_pers, ip_pano), once before the loop, so the large
        SAM feature tensors can be freed before denoising."""
        return self.model.compute_ip_tokens(ref_feats_pers, ref_feats_pano, rel_pos, pitch)

    @torch.no_grad()
    def denoise(self, pano_latent, pers_latent,         # [1,F,eh,ew,4] / [1,M,F,h,w,4]
                pano_mask, pano_masked,                 # [1,F,eh,ew,1] / [1,F,eh,ew,4]
                pers_mask, pers_masked,                 # [1,M,F,h,w,1] / [1,M,F,h,w,4]
                pano_text, pers_text,                   # [2,L,C] / [2M,L,C] (CFG pairs)
                warp_geoms, fps=None,                   # fps [2] or None
                ip_tokens_pers=None, ip_tokens_pano=None,
                generator: Optional[torch.Generator] = None,
                use_opp: Optional[Sequence[Sequence[bool]]] = None,
                num_steps: Optional[int] = None,
                ip_noise: Optional[Sequence[tuple]] = None,
                sde_noise: Optional[Sequence[tuple]] = None):
        """Runs the CFG denoise loop; returns (pano_latent, pers_latent).

        Per step, `use_opp[i]` (one bool per WarpAttn site) is taken from
        the argument when given, else drawn from `generator` with
        probability cfg.antipodal_prob; the IP-token noise of step i is
        `ip_noise[i]`, a pair (pers, pano) of unit-variance tensors shaped
        like the tokens (or None), when given, else drawn from `generator`
        when cfg.add_ip_noise. With the "dpmpp_2m_sde" solver the noise of
        step i is `sde_noise[i]`, a pair (pano, pers) of unit-variance
        tensors shaped like the latents, when given, else drawn from
        `generator`. `num_steps` runs only the first steps of the schedule.

        Under a mesh every argument is whole (all M views); the loop runs on
        this rank's views and returns the gathered perspective latents."""
        cfg = self.cfg
        use_dpm = self.dpm_schedule is not None
        sde = cfg.solver.endswith("sde")
        draws_sde = sde and sde_noise is None
        draws_ip_noise = ip_noise is None and cfg.add_ip_noise and (
            ip_tokens_pers is not None or ip_tokens_pano is not None)
        draws_opp = use_opp is None and cfg.antipodal_prob > 0
        if generator is None and (draws_ip_noise or draws_opp or draws_sde):
            raise ValueError("denoise draws the antipodal choice, the IP noise or the SDE "
                             "noise: pass a torch.Generator (or use_opp, add_ip_noise=False "
                             "and sde_noise)")
        coeffs = (self.dpm_schedule if use_dpm else self.schedule).step_coeffs()
        n_sites = len(warp_sites(len(self.model.cfg.pers.block_out_channels)))
        g = cfg.guidance_scale
        steps = cfg.num_steps if num_steps is None else num_steps
        M = pers_latent.shape[1]

        def local(x, dim=0):    # this rank's views of a whole perspective tensor
            return None if x is None else shard_views(x, dim, x.shape[dim] // M)

        pano_lat = pano_latent
        pers_lat, pers_mask, pers_masked = (local(x, 1) for x in (pers_latent, pers_mask,
                                                                   pers_masked))
        pers_text, ip_pers = local(pers_text), local(ip_tokens_pers)
        x0_pano = x0_pers = None    # float32 x0 of the previous step (DPM++ 2M)

        def draw_noise(tokens):
            if tokens is None or not cfg.add_ip_noise:
                return None
            return torch.randn(tokens.shape, generator=generator, device=tokens.device,
                               dtype=torch.float32)

        for i in range(steps):
            if use_opp is not None:
                opp = [bool(x) for x in use_opp[i]]
            elif draws_opp:
                opp = (torch.rand(n_sites, generator=generator, device=generator.device)
                       < cfg.antipodal_prob).tolist()
            else:
                opp = [False] * n_sites
            if ip_noise is not None:
                noise_pers, noise_pano = ip_noise[i]
            else:
                noise_pers, noise_pano = draw_noise(ip_tokens_pers), draw_noise(ip_tokens_pano)
            noise_pers = local(noise_pers)

            pano_in = torch.cat([pano_lat, pano_mask, pano_masked], dim=-1).repeat(2, 1, 1, 1, 1)
            pers_in = torch.cat([pers_lat, pers_mask, pers_masked], dim=-1).repeat(
                2, 1, 1, 1, 1, 1)
            t_vec = torch.full((2,), float(coeffs["timestep"][i]), dtype=torch.float32,
                               device=pano_in.device)
            pers_pred, pano_pred = self.model(
                pers_in, pano_in, t_vec, pers_text, pano_text, fps, warp_geoms, opp,
                ip_pers, ip_tokens_pano, noise_pers, noise_pano)

            pano_u, pano_c = pano_pred.chunk(2, dim=0)
            pano_out = pano_u + g * (pano_c - pano_u)
            pers_u, pers_c = pers_pred.chunk(2, dim=0)
            pers_out = pers_u + g * (pers_c - pers_u)
            if use_dpm:
                noise_pano = noise_pers = None
                if sde and sde_noise is not None:
                    noise_pano, noise_pers = sde_noise[i]
                elif draws_sde:
                    noise_pano, noise_pers = (
                        torch.randn(x.shape, generator=generator, device=x.device,
                                    dtype=torch.float32) for x in (pano_lat, pers_latent))
                noise_pers = local(noise_pers, 1)
                pano_lat, x0_pano = dpmpp_2m_step(pano_lat, pano_out, i, coeffs, x0_pano,
                                                  cfg.prediction_type, noise_pano)
                pers_lat, x0_pers = dpmpp_2m_step(pers_lat, pers_out, i, coeffs, x0_pers,
                                                  cfg.prediction_type, noise_pers)
            else:
                a_t = float(coeffs["alpha_prod_t"][i])
                a_prev = float(coeffs["alpha_prod_t_prev"][i])
                pano_lat = ddim_step(pano_out, pano_lat, a_t, a_prev, cfg.prediction_type)
                pers_lat = ddim_step(pers_out, pers_lat, a_t, a_prev, cfg.prediction_type)
        return pano_lat, gather_views(pers_lat, 1)
