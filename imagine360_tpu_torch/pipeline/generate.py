"""End-to-end perspective-to-360 video generation (counterpart of
imagine360_tpu/pipeline/generate.py).

host:          pitch fit -> P2E warp -> anchor / largest rectangle (numpy
               grids; remaps and rectangles on the threaded host library)
device (torch): 20-view E2P, CLIP text encode, SAM resize, preprocessing
               and encode, VAE encodes,
               shared-noise init, IP tokens, CFG denoise loop (DDIM, or
               DPM-Solver++ 2M by `RunConfig.solver`), circular-pad VAE decode
               in 4-frame chunks

The pipeline runs on the card unless the caller asks for the CPU
(`device="cpu"`); a missing card raises. Randomness comes from one explicit
`torch.Generator` on that device, or is passed in (`init_noise`, `use_opp`,
`ip_noise`).

Several devices: `RunConfig.use_mesh` and `mesh_replicas` build a mesh
(parallel/mesh.py:init_from_config) over the ranks torchrun starts. Every
rank runs the host stages on the same frames; SAM, the VAE encodes and the
decode chunks split their frame batch over the ranks (map_sharded); the
denoise loop shards the perspective views and replicates the pano.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import RunConfig
from ..geometry.cameras import CameraRig
from ..geometry.projection import e2p
from ..models.clip_text import CLIPTextModel
from ..models.dual import DualUNet, DualUNetConfig
from ..models.sam import SAMImageEncoder, sam_preprocess_tensor
from ..models.vae import AutoencoderKL
from ..parallel.mesh import Mesh, activate_mesh, init_from_config, map_sharded, pano_layout
from ..utils.device import require_device
from ..utils.observability import StageTimer, get_logger, split
from ..utils.video_io import from_model_range, resize_bilinear_tensor, to_model_range
from .anchor import get_anchor_target
from .conditioning import (downsample_mask_nearest, init_shared_noise,
                           prepare_masked_latents)
from .elevation import PitchEstimator, pers_video_to_pano
from .sampler import DualDiffusionSampler, SamplerConfig, build_dual_warp_geoms

log = get_logger("pipeline")

DECODE_CHUNK = 4        # frames per VAE decode call at full resolution
WRAP_LATENT_COLS = 4    # circular pad of the latent width before decoding


def _under_mesh(method):
    """The method with the pipeline's mesh active."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with activate_mesh(self.mesh):
            return method(self, *args, **kwargs)
    return run


@dataclasses.dataclass
class PipelineModules:
    """The models of a pipeline, already on its device and in its dtype.
    Their weights may be zero or random (dev mode)."""
    dual: DualUNet
    vae: AutoencoderKL
    text_encoder: Optional[CLIPTextModel] = None
    sam: Optional[SAMImageEncoder] = None
    tokenizer: Optional[Callable] = None  # callable(str) -> [77] int ids


class Imagine360Pipeline:
    def __init__(self, modules: PipelineModules, run_cfg: RunConfig,
                 dual_cfg: DualUNetConfig, device="cuda", mesh: Optional[Mesh] = None):
        """`mesh`: the ranks' layout; None builds the one that
        run_cfg.use_mesh and mesh_replicas ask for (none on one process
        under the default "auto"). Under a mesh `device` is the rank's."""
        self.mesh = mesh or init_from_config(run_cfg, device, views=dual_cfg.num_views)
        self.device = require_device(self.mesh.device if self.mesh else device)
        self.m = modules
        self.dtype = modules.dual.unet.conv_in.weight.dtype
        self.cfg = run_cfg
        self.dual_cfg = dual_cfg
        self.sampler = DualDiffusionSampler(
            modules.dual, SamplerConfig(num_steps=run_cfg.num_inference_steps,
                                        guidance_scale=run_cfg.guidance_scale,
                                        antipodal_prob=run_cfg.antipodal_prob,
                                        solver=run_cfg.solver))
        self.pers_size = run_cfg.pano_H // 2
        self.rig = CameraRig.icosahedron(image_size=self.pers_size).take(dual_cfg.num_views)
        with activate_mesh(self.mesh):
            self.geoms = build_dual_warp_geoms(
                dual_cfg, self.rig, (self.pers_size // 8, self.pers_size // 8),
                (run_cfg.pano_H // 8, run_cfg.pano_W // 8), device=self.device)
            if self.mesh is not None:
                log.info("layout: rank %d of %d (%d replicas), %d of %d views a rank; %s",
                         self.mesh.rank, self.mesh.world, self.mesh.replicas,
                         dual_cfg.num_views // self.mesh.world, dual_cfg.num_views,
                         pano_layout(run_cfg.pano_H // 8, len(dual_cfg.pano.block_out_channels)))
        self.pitch = PitchEstimator(mode=run_cfg.angle_adapt)

    def _dev(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    # ---- text ------------------------------------------------------------

    @torch.no_grad()
    def encode_prompt(self, prompt: str, negative: str, views: int):
        """-> (pano_text [2, 77, D], pers_text [2*M, 77, D]), CFG order
        [uncond; cond]."""
        D = self.dual_cfg.pano.cross_attention_dim
        if self.m.text_encoder is None or self.m.tokenizer is None:
            # zeros == unconditioned generation (the CLI refuses this
            # combination up-front when a prompt exists)
            emb = torch.zeros(2, 77, D, device=self.device, dtype=self.dtype)
        else:
            ids = np.stack([self.m.tokenizer(negative), self.m.tokenizer(prompt)])
            emb = self.m.text_encoder(torch.from_numpy(ids).to(self.device)).to(self.dtype)
        # [neg*M ; pos*M] ordering to match the CFG batch layout
        return emb, emb.repeat_interleave(views, dim=0)

    # ---- image prompt (SAM video features) --------------------------------

    @torch.no_grad()
    @_under_mesh
    def encode_sam(self, frames_minus1_1: np.ndarray,
                   timer: Optional[StageTimer] = None) -> torch.Tensor:
        """[F, h, w, 3] in [-1, 1] -> [F, 4096, 256] features (zeros when
        the pipeline has no SAM encoder). The uint8 frames go to the device,
        where they are resized (long side to img_size), normalised and
        padded; with a StageTimer, as its splits "sam resize",
        "sam preprocess" and "sam encoder"."""
        F = frames_minus1_1.shape[0]
        if self.m.sam is None:
            csam = self.dual_cfg.pano.image_hidden_size
            return torch.zeros(F, 4096 if csam == 256 else 16, csam, device=self.device,
                               dtype=self.dtype)
        size = self.m.sam.cfg.img_size
        with split(timer, "sam resize"):
            u8 = torch.from_numpy(((frames_minus1_1 + 1) * 127.5).astype(np.uint8))
            h, w = u8.shape[1:3]
            scale = float(size) / max(h, w)     # long side to img_size, then pad
            resized = resize_bilinear_tensor(u8.to(self.device),
                                             (int(h * scale + 0.5), int(w * scale + 0.5)))
        with split(timer, "sam preprocess"):
            x = sam_preprocess_tensor(resized, size)
        with split(timer, "sam encoder"):
            feats = map_sharded(self.m.sam, x)
            return feats.reshape(F, -1, feats.shape[-1]).to(self.dtype)

    # ---- main -------------------------------------------------------------

    @_under_mesh
    def __call__(self, frames_u8: np.ndarray, prompt: str = "",
                 negative_prompt: Optional[str] = None,
                 generator: Optional[torch.Generator] = None, raw_pitches=None,
                 timer: Optional[StageTimer] = None):
        """frames_u8 [F, h, w, 3] uint8 perspective video -> dict(videos
        [F, H, W, 3] float in [0, 1], pano_input, masks, pitches), numpy."""
        cfg = self.cfg
        if negative_prompt is None:
            negative_prompt = cfg.negative_prompt
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(cfg.global_seed)
        if timer is None:
            timer = StageTimer(log, self.device)
        F = frames_u8.shape[0]
        M = self.dual_cfg.num_views
        H, W = cfg.pano_H, cfg.pano_W
        ps = self.pers_size

        # 1. host preprocessing, on the host library; the grids, remaps and
        # rectangles are the timer's splits
        with timer("pitch+warp"):
            frames = to_model_range(frames_u8)
            pitches = self.pitch(frames_u8, raw_pitches)
            pano_frames, pano_masks = pers_video_to_pano(frames, pitches, (H, W), timer=timer)
        with timer("anchor"):
            anchor = get_anchor_target(pano_frames, pitches, timer=timer)
        with timer("e2p views"):
            # ERP frames -> M perspective views (pixels and masks), on the device
            def views_of(x):        # [F, H, W, c] -> [F, M, ps, ps, c]
                c = x.shape[-1]
                img = self._dev(x).permute(0, 3, 1, 2).reshape(F * c, H, W)
                v = e2p(img, self.rig, (ps, ps)).reshape(M, F, c, ps, ps)
                return v.permute(1, 0, 3, 4, 2)

            views = views_of(pano_frames)
            vmasks = (views_of(pano_masks) > 0.5).float()

        # 2. conditioning encoders
        with timer("text"):
            pano_text, pers_text = self.encode_prompt(prompt, negative_prompt, M)
        with timer("sam"):
            feats = self.encode_sam(anchor["anchor"], timer)        # [F, 4096, 256]
            feats_pers = self.encode_sam(anchor["anchor_pers"], timer)
            # the same embeds serve both CFG halves. They are handed over
            # from a list so that no name of this frame keeps them: once
            # generate_core has the IP tokens it drops the last reference
            refs = [feats[None].repeat(2, 1, 1, 1), feats_pers[None].repeat(2 * M, 1, 1, 1)]
            del feats, feats_pers

        video, _ = self.generate_core(
            pano_frames, pano_masks, views, vmasks, pano_text, pers_text, refs.pop(0),
            refs.pop(0), anchor["relative_position"], anchor["pitch"], generator,
            timer=timer)
        return {
            "videos": video,
            "pano_input": from_model_range(pano_frames),
            "masks": pano_masks,
            "pitches": pitches,
        }

    @torch.no_grad()
    @_under_mesh
    def generate_core(self, pano_frames, pano_masks, views_bfhwc, vmasks_bfhwc, pano_text,
                      pers_text, ref_pano, ref_pers, rel_pos, pitch,
                      generator: Optional[torch.Generator] = None, init_noise=None,
                      deterministic_vae: bool = False,
                      use_opp: Optional[Sequence[Sequence[bool]]] = None,
                      ip_noise: Optional[Sequence[tuple]] = None,
                      timer: Optional[StageTimer] = None):
        """Device-side generation given prepared conditioning: masked-latent
        VAE encodes, shared-noise init, IP tokens, CFG DDIM loop,
        circular-pad decode.

        pano_frames [F, H, W, 3] in [-1, 1]; pano_masks [F, H, W, 1] in
        {0, 1}; views_bfhwc [F, M, ps, ps, 3]; vmasks_bfhwc [F, M, ps, ps, 1];
        ref_pano [2, F, tokens, C]; ref_pers [2M, F, tokens, C]; rel_pos
        [F, 6]; pitch [F] (numpy arrays or tensors). `init_noise` pins
        (pano_noise [1, F, h, w, 4], pers_noise [1, M, F, ph, pw, 4]);
        `use_opp` and `ip_noise` pin the loop's per-step draws (see
        DualDiffusionSampler.denoise); everything not pinned is drawn from
        `generator`. Returns (video [F, H, W, 3] in [0, 1], numpy; final
        pano latents, a tensor)."""
        cfg = self.cfg
        if timer is None:
            timer = StageTimer(log, self.device)
        pano_frames, pano_masks = self._dev(pano_frames), self._dev(pano_masks)
        views, vmasks = self._dev(views_bfhwc), self._dev(vmasks_bfhwc)
        pano_text, pers_text = self._dev(pano_text, self.dtype), self._dev(pers_text, self.dtype)
        ref_pano, ref_pers = self._dev(ref_pano, self.dtype), self._dev(ref_pers, self.dtype)
        F, M = pano_frames.shape[0], views.shape[1]
        H, W = cfg.pano_H, cfg.pano_W
        ps = self.pers_size
        scaling = self.m.vae.cfg.scaling_factor

        # 3. VAE-encode the masked pixels
        with timer("vae encode"):
            pano_masked_lat = prepare_masked_latents(
                self.m.vae, pano_frames * (pano_masks < 0.5), generator, scaling,
                deterministic=deterministic_vae)                  # [F, H/8, W/8, 4]
            n_pers = F * M
            pers_masked_lat = prepare_masked_latents(
                self.m.vae, (views * (vmasks < 0.5)).reshape(n_pers, ps, ps, 3), generator,
                scaling, chunk=n_pers // 4 if n_pers % 4 == 0 else None,
                deterministic=deterministic_vae).reshape(F, M, ps // 8, ps // 8, 4)
            pano_mask_lat = downsample_mask_nearest(pano_masks)
            pers_mask_lat = downsample_mask_nearest(vmasks)

        # 4. shared-noise init + denoise loop
        with timer("denoise"):
            if init_noise is None:
                pano_lat0, pers_lat0 = init_shared_noise(
                    generator, 1, F, (H // 8, W // 8), (ps // 8, ps // 8), self.rig)
            else:
                pano_lat0, pers_lat0 = (self._dev(x) for x in init_noise)
            rel = self._dev(rel_pos)[None].repeat(2, 1, 1)
            pit = self._dev(pitch)[None].repeat(2, 1)
            fps = torch.full((2,), float(cfg.fps), device=self.device)
            # IP tokens first, then drop the SAM features: nothing keeps
            # them on the device during the loop
            ip_pers, ip_pano = self.sampler.compute_ip(ref_pers, ref_pano, rel, pit)
            del ref_pers, ref_pano
            pano_lat, _ = self.sampler.denoise(
                pano_lat0, pers_lat0, pano_mask_lat[None], pano_masked_lat[None].float(),
                pers_mask_lat.permute(1, 0, 2, 3, 4)[None],
                pers_masked_lat.permute(1, 0, 2, 3, 4)[None].float(),
                pano_text, pers_text, self.geoms, fps, ip_pers, ip_pano,
                generator=generator, use_opp=use_opp, ip_noise=ip_noise)

        # 5. circular-pad decode, frame-chunked to bound activation memory
        with timer("vae decode"):
            lat = pano_lat[0] / scaling                           # [F, h, w, 4]
            c = WRAP_LATENT_COLS
            lat = torch.cat([lat[..., -c:, :], lat, lat[..., :c, :]], dim=-2)

            def decode(lat):        # the frames of this rank (all of them on one device)
                n = lat.shape[0]
                step = DECODE_CHUNK if (n % DECODE_CHUNK == 0 and n > DECODE_CHUNK) else n
                return torch.cat([self.m.vae.decode(lat[s:s + step])[..., 8 * c:-8 * c, :]
                                  .float() for s in range(0, n, step)], dim=0)

            video = from_model_range(map_sharded(decode, lat).cpu().numpy())
        return video, pano_lat
