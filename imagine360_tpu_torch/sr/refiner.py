"""The SR stage's default refiner engine: the pano UNet branch as the
denoiser (counterpart of imagine360_tpu/sr/refiner.py).

The reference refines with the external VEnhancer UNet (sr/unet_v2v.py is
the port of its structure, `--engine v2v`). The pano branch needs no weights
of its own beyond the generator's:

- conditioning: its 9-channel outpaint input [latents 4 | mask 1 |
  masked latents 4] carries mask 0 everywhere and, in the masked-latent
  slots, the clean latents of the upsampled clip;
- noise augmentation and the DPM++ steps are Video360Enhancer's;
- CFG over text with `guidance_scale` runs only when g != 1 and the two
  prompts differ; otherwise one pass on the positive prompt (the default CLI
  has no text encoder, so both prompts are zeros and one pass runs);
- 360-degree continuity: the UNet runs with its circular width padding
  (`pad=True`), on latents that also carry the enhancer's pixel pad.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class PanoRefinerConfig:
    guidance_scale: float = 7.5   # reference SR guide_scale
    fps: float = 8.0
    pano_pad: bool = True


class PanoRefiner:
    """A Video360Enhancer engine from a pano-branch UNet3DConditionModel.
    Runs without grad on the UNet's device and dtype."""

    def __init__(self, unet, text_pos: Optional[torch.Tensor] = None,
                 text_neg: Optional[torch.Tensor] = None,
                 cfg: PanoRefinerConfig = PanoRefinerConfig()):
        """text_pos / text_neg: [L, D] prompt embeddings (zeros when None)."""
        self.unet, self.cfg = unet, cfg
        p = next(unet.parameters())
        self.device, self.dtype = p.device, p.dtype
        if text_pos is None:
            text_pos = torch.zeros(77, unet.cfg.cross_attention_dim)
        if text_neg is None:
            text_neg = torch.zeros_like(text_pos)
        self.cfg_active = cfg.guidance_scale != 1.0 and not torch.equal(
            text_pos.float().cpu(), text_neg.float().cpu())
        self.text2 = torch.stack([text_neg, text_pos]).to(self.device, self.dtype)

    @torch.no_grad()
    def _step(self, z, z_cond, t):
        """z, z_cond [F, h, w, 4]; t a float -> the prediction [F, h, w, 4]
        in z's dtype."""
        n = 2 if self.cfg_active else 1
        zin = torch.cat([z, torch.zeros_like(z[..., :1]), z_cond.to(z.dtype)], dim=-1)
        x = zin[None].expand(n, *zin.shape)
        tv = torch.full((n,), float(t), device=self.device)
        fps = (torch.full((n,), float(self.cfg.fps), device=self.device)
               if self.unet.cfg.use_fps_condition else None)
        pred = self.unet(x, tv, self.text2 if self.cfg_active else self.text2[1:], fps=fps,
                         pad=self.cfg.pano_pad)
        if not self.cfg_active:
            return pred[0].to(z.dtype)
        u, c = pred[0], pred[1]
        return (u + self.cfg.guidance_scale * (c - u)).to(z.dtype)

    def prepare(self, z_clean: torch.Tensor):
        """Enhancer hook: the clean latents [F, h, w, 4] of the padded,
        upsampled clip, before noise augmentation. Returns the denoise
        function (z [F, h, w, 4], t [1]) -> prediction."""
        def denoise_fn(z, t):
            return self._step(z, z_clean, float(t[0]))

        return denoise_fn

    def __call__(self, z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Without `prepare`: condition on zeros (pure generation)."""
        return self._step(z, torch.zeros_like(z), float(t[0]))
