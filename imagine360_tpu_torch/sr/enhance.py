"""360-degree video super-resolution (counterpart of
imagine360_tpu/sr/enhance.py; reference sr/enhance_a_video.py:17-126 and
sr/video_to_video_model.py:77-177): bilinear upscale, a circular pad of the
width, VAE encode, noise augmentation to t = noise_aug, DPM++ 2M (SDE by
default) refinement from there down, the tiled and chunked decode, the pad
cropped, the wavelet colour fix.

The denoiser is pluggable: a callable (z [F, h, w, 4], t [1]) ->
prediction, or a refiner with `prepare(clean latents) -> callable`
(sr/refiner.py:PanoRefiner, sr/unet_v2v.py:V2VRefiner), which is handed the
clean latents of the padded, upsampled clip before the noise augmentation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..diffusion.ddim import add_noise, make_ddim_schedule
from ..diffusion.dpm import dpmpp_2m_step, make_dpm_schedule
from ..models.vae_temporal import AutoencoderKLTemporalDecoder
from ..utils.observability import StageTimer, get_logger
from .tiled_decode import tiled_chunked_decode
from .wavelet_fix import wavelet_color_fix

log = get_logger("sr")


@dataclasses.dataclass(frozen=True)
class EnhancerConfig:
    up_scale: int = 2
    num_steps: int = 15
    noise_aug: int = 250          # noise augmentation level (reference 0-300)
    solver_mode: str = "sde"      # "sde" | "ode" (dpmpp_2m[_sde])
    pano_pad_px: int = 32         # circular pad before refinement
    chunk_frames: int = 5         # frames a VAE call encodes or decodes
    tile_hw: tuple = (72, 128)
    color_fix: bool = True
    prediction_type: str = "v_prediction"


class EnhancerNoise(NamedTuple):
    """The unit noise of one enhancer call, float32, latents channels-last
    [F, h, w, C] with h = H * up_scale / f and w = (W * up_scale +
    2 * pano_pad_px) / f (f the VAE's downsampling factor, C its latent
    channels): `posterior` the VAE posterior's, `augment` the noise
    augmentation's, and `sde` [S, F, h, w, C] one per refine step (S =
    `Video360Enhancer.refine_steps`), None for the "ode" solver."""
    posterior: torch.Tensor
    augment: torch.Tensor
    sde: Optional[torch.Tensor] = None


class Video360Enhancer:
    def __init__(self, denoise_fn: Callable, vae, cfg: EnhancerConfig = EnhancerConfig()):
        """vae: models/vae.py:AutoencoderKL (channels-last) or
        models/vae_temporal.py:AutoencoderKLTemporalDecoder (channel-first);
        everything runs on its device, without grad."""
        self.denoise_fn, self.vae, self.cfg = denoise_fn, vae, cfg
        self.channel_first = isinstance(vae, AutoencoderKLTemporalDecoder)
        self.factor = 2 ** (len(vae.cfg.block_out_channels) - 1)
        self.schedule = make_dpm_schedule(cfg.num_steps, cfg.prediction_type)
        # refine only from noise_aug down
        self.start = int(np.searchsorted(-self.schedule.timesteps, -cfg.noise_aug))

    @property
    def refine_steps(self) -> int:
        return self.cfg.num_steps - self.start

    def latent_shape(self, frames_shape) -> tuple:
        """[F, H, W, 3] frames -> the shape of their latents [F, h, w, C]."""
        n, H, W = frames_shape[:3]
        s, f = self.cfg.up_scale, self.factor
        return (n, H * s // f, (W * s + 2 * self.cfg.pano_pad_px) // f,
                self.vae.cfg.latent_channels)

    def upsample(self, frames) -> torch.Tensor:
        """frames [F, H, W, 3] (numpy or tensor) -> float32 [F, 3, H * s,
        W * s] on the VAE's device: bilinear with half-pixel centres, the
        sampling of cv2.resize INTER_LINEAR, which the JAX package runs on
        the host."""
        dev = next(self.vae.parameters()).device
        src = torch.as_tensor(frames, dtype=torch.float32, device=dev)
        return F.interpolate(src.permute(0, 3, 1, 2), scale_factor=self.cfg.up_scale,
                             mode="bilinear", align_corners=False)

    def _sample(self, x, noise):
        """x [N, 3, H, W], noise [N, h, w, C] -> posterior draw [N, h, w, C]."""
        if self.channel_first:
            return self.vae.sample(x, noise=noise.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.vae.sample(x.permute(0, 2, 3, 1), noise=noise)

    def _decode_tile(self, z):
        """z [N, C, h, w] -> frames [N, 3, f * h, f * w]."""
        z = z / self.vae.cfg.scaling_factor
        if self.channel_first:
            return self.vae.decode(z)
        return self.vae.decode(z.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    @torch.no_grad()
    def __call__(self, frames, generator: Optional[torch.Generator] = None,
                 noise: Optional[EnhancerNoise] = None,
                 timer: Optional[StageTimer] = None) -> torch.Tensor:
        """frames [F, H, W, 3] in [0, 1] (numpy or tensor) -> float32
        [F, H * up_scale, W * up_scale, 3] in [0, 1] on the VAE's device.
        The randomness comes from exactly one of `generator` (drawn on its
        device in the order of EnhancerNoise's fields) and `noise`."""
        if (generator is None) == (noise is None):
            raise ValueError("the enhancer takes a torch.Generator or an EnhancerNoise, "
                             "one of them")
        cfg = self.cfg
        dev = next(self.vae.parameters()).device
        timer = timer or StageTimer(log, dev)
        shape = self.latent_shape(frames.shape)

        def draw(which, want):
            if noise is None:
                return torch.randn(want, generator=generator, device=generator.device)
            got = getattr(noise, which) if isinstance(which, str) else noise.sde[which]
            if tuple(got.shape) != tuple(want):
                raise ValueError(f"enhancer noise {which!r}: shape {tuple(got.shape)}, "
                                 f"want {tuple(want)}")
            return got

        with timer("upsample"):
            up = self.upsample(frames)
            x = up * 2.0 - 1.0
            p = cfg.pano_pad_px
            if p:      # the circular pad lets the refinement see the wrap seam
                x = torch.cat([x[..., -p:], x, x[..., :p]], dim=-1)

        with timer("encode"):
            # in groups of chunk_frames frames: the VAE mixes no frames, so
            # the function is the whole clip's, with one noise draw for it
            post = draw("posterior", shape).to(dev)
            c = cfg.chunk_frames
            z = torch.cat([self._sample(x[f0:f0 + c], post[f0:f0 + c])
                           for f0 in range(0, shape[0], c)]) * self.vae.cfg.scaling_factor
            del post

        denoise_fn = self.denoise_fn
        if hasattr(denoise_fn, "prepare"):      # conditioned on the clean latents
            denoise_fn = denoise_fn.prepare(z)

        acp = torch.from_numpy(make_ddim_schedule(cfg.num_steps).alphas_cumprod)
        z = add_noise(z, draw("augment", shape).to(dev), acp,
                      torch.full((1,), cfg.noise_aug, dtype=torch.long, device=dev))
        coeffs = self.schedule.step_coeffs()
        log.info("refining %d of %d steps (noise_aug %d)", self.refine_steps, cfg.num_steps,
                 cfg.noise_aug)
        x0_prev = torch.zeros(z.shape, device=dev)
        for i in range(self.start, cfg.num_steps):
            with timer("refine"):
                pred = denoise_fn(z, torch.tensor([float(coeffs["timestep"][i])]))
                sde = (draw(i - self.start, shape).to(dev) if cfg.solver_mode == "sde"
                       else None)
                z, x0_prev = dpmpp_2m_step(z, pred, i, coeffs, x0_prev, cfg.prediction_type,
                                           sde_noise=sde)

        with timer("decode"):
            # the latents carry the circular pad already: no wrap in the
            # decode, the pad is cropped in pixel space after it
            dec = tiled_chunked_decode(self._decode_tile, z.permute(0, 3, 1, 2),
                                       tile_hw=cfg.tile_hw, chunk=cfg.chunk_frames,
                                       scale=self.factor, pano_wrap=False)
            if p:
                dec = dec[..., p:-p]
            out = (dec / 2 + 0.5).clamp(0.0, 1.0)
            del dec

        if cfg.color_fix:
            with timer("colour fix"):
                out = wavelet_color_fix(out, up)
        return out.permute(0, 2, 3, 1).contiguous()
