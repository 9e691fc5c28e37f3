"""SR command line (counterpart of imagine360_tpu/sr/cli.py; reference
sr/enhance_a_video.py:128-170):

    python -m imagine360_tpu_torch.sr.cli --input out.mp4 --output out_2k.mp4 \\
        [--engine pano|v2v] [--tiny] [--device cpu]

Circular pad -> noise augmentation -> DPM++ refinement conditioned on the
clean upsampled clip -> 360-degree tiled decode -> wavelet colour fix
(sr/enhance.py). The refiner engine is the pano UNet branch by default
(sr/refiner.py; it works without weights of its own) or the VEnhancer V2V
UNet (`--engine v2v`, sr/unet_v2v.py). Runs on the card unless `--device
cpu` asks for the CPU. Weights load where the named files exist (the pano
UNet through utils/checkpoints.py:load_unet_branch, a public-named VEnhancer
state dict as it is, a diffusers VAE through convert_diffusers_vae);
without them the models are zero (dev mode). Nothing is fetched.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..cli import make_module
from ..models.vae import AutoencoderKL, VAEConfig, convert_diffusers_vae
from ..utils.checkpoints import load_state_dict, load_unet_branch
from ..utils.device import require_device
from ..utils.observability import get_logger
from ..utils.video_io import read_video, save_video
from .enhance import EnhancerConfig, Video360Enhancer
from .refiner import PanoRefiner, PanoRefinerConfig

log = get_logger("sr")

VAE_FILES = ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input", required=True, help="clip to enhance (.mp4 or .npy)")
    ap.add_argument("--output", required=True)
    ap.add_argument("--up-scale", type=int, default=2)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--noise-aug", type=int, default=250)
    ap.add_argument("--solver", choices=["sde", "ode"], default="sde")
    ap.add_argument("--guidance", type=float, default=7.5)
    ap.add_argument("--fps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", choices=["pano", "v2v"], default="pano",
                    help="refiner engine: the pano UNet branch (default, works without "
                         "external weights) or the VEnhancer ControlledV2VUNet (needs "
                         "--v2v-ckpt)")
    ap.add_argument("--pano-unet-ckpt", default=None,
                    help="reference-format pano UNet checkpoint for the refiner")
    ap.add_argument("--v2v-ckpt", default=None,
                    help="VEnhancer ControlledV2VUNet state dict (public names)")
    ap.add_argument("--prompt", default=None,
                    help="SR guidance prompt; needs --text-ckpt and --tokenizer-dir")
    ap.add_argument("--neg-prompt", default="")
    ap.add_argument("--text-ckpt", default=None,
                    help="OpenCLIP ViT-H text tower weights (open_clip or "
                         "FrozenOpenCLIPEmbedder state dict)")
    ap.add_argument("--tokenizer-dir", default=None,
                    help="local HF CLIPTokenizer directory (open_clip's BPE)")
    ap.add_argument("--vae-path", default=None, help="SD VAE directory or weights file")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny refiner architecture, float32 (smoke runs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain attention versions")
    return ap.parse_args(argv)


def enhancer_config(args) -> EnhancerConfig:
    return EnhancerConfig(up_scale=args.up_scale, num_steps=args.steps,
                          noise_aug=args.noise_aug, solver_mode=args.solver)


def build_sr_modules(args, device="cuda", seed: Optional[int] = None):
    """(refiner, vae) of the CLI's arguments on `device`: float32 with
    `--tiny`, else bfloat16. Weights no file gives are zero (`seed` None) or
    drawn from a generator seeded with `seed`."""
    device = require_device(device)
    dtype = "float32" if args.tiny else "bfloat16"
    gen = None if seed is None else torch.Generator(device=device).manual_seed(seed)

    def make(ctor, cfg):
        return make_module(ctor, cfg, device=device, dtype=getattr(torch, dtype), gen=gen)

    vae = make(AutoencoderKL, VAEConfig(dtype=dtype))
    path = args.vae_path
    if path and os.path.isdir(path):
        path = next((os.path.join(path, c) for c in VAE_FILES
                     if os.path.exists(os.path.join(path, c))), None)
    if path and os.path.exists(path):
        res = vae.load_state_dict(convert_diffusers_vae(load_state_dict(path)), strict=False)
        log.info("loaded VAE weights from %s (%d missing, %d unexpected)", path,
                 len(res.missing_keys), len(res.unexpected_keys))

    text_pos, text_neg = _encode_sr_prompts(args, make, device)
    if args.engine == "v2v":
        return _build_v2v_refiner(args, make, text_pos, text_neg), vae

    from ..models.unet3d import UNet3DConditionModel
    from ..presets import full_unet_config, tiny_unet_config

    unet = make(UNet3DConditionModel,
                tiny_unet_config(dtype) if args.tiny else full_unet_config(dtype))
    if args.pano_unet_ckpt and os.path.exists(args.pano_unet_ckpt):
        missing, unexpected = load_unet_branch(unet, args.pano_unet_ckpt)
        log.info("refiner ckpt: %d missing, %d unexpected", len(missing), len(unexpected))
    else:
        log.warning("no refiner checkpoint: %s dev mode",
                    "zero-init" if gen is None else "seeded-init")
    refiner = PanoRefiner(unet, text_pos=text_pos, text_neg=text_neg,
                          cfg=PanoRefinerConfig(guidance_scale=args.guidance, fps=args.fps))
    return refiner, vae


def _encode_sr_prompts(args, make, device):
    """(text_pos, text_neg) [77, 1024] prompt embeddings from the OpenCLIP
    ViT-H text tower (its penultimate layer, as SD2.1's CLIPTextModel), or
    (None, None) without a prompt or without its encoder files: the
    refiners then run unconditioned."""
    if not args.prompt:
        return None, None
    if not (args.text_ckpt and os.path.exists(args.text_ckpt)
            and args.tokenizer_dir and os.path.isdir(args.tokenizer_dir)):
        log.warning("--prompt given but --text-ckpt/--tokenizer-dir missing; "
                    "running unconditioned")
        return None, None
    from transformers import CLIPTokenizer

    from ..models.clip_text import (CLIPTextConfig, CLIPTextModel, convert_openclip_text,
                                    openclip_tokenize)

    enc = make(CLIPTextModel, CLIPTextConfig(dtype="float32" if args.tiny else "bfloat16"))
    res = enc.load_state_dict(convert_openclip_text(load_state_dict(args.text_ckpt)),
                              strict=False)
    log.info("text tower: %d missing, %d unexpected", len(res.missing_keys),
             len(res.unexpected_keys))
    tok = CLIPTokenizer.from_pretrained(args.tokenizer_dir, local_files_only=True)
    ids = np.stack([openclip_tokenize(tok, args.neg_prompt), openclip_tokenize(tok, args.prompt)])
    with torch.no_grad():
        emb = enc(torch.from_numpy(ids).to(device))
    return emb[1], emb[0]


def _build_v2v_refiner(args, make, text_pos=None, text_neg=None):
    from .unet_v2v import ControlledV2VUNet, V2VConfig, V2VRefiner, tiny_v2v_config

    dtype = "float32" if args.tiny else "bfloat16"
    model = make(ControlledV2VUNet, tiny_v2v_config(dtype) if args.tiny else V2VConfig(dtype=dtype))
    if args.v2v_ckpt and os.path.exists(args.v2v_ckpt):
        res = model.load_state_dict(load_state_dict(args.v2v_ckpt), strict=False)
        log.info("v2v ckpt: %d missing, %d unexpected", len(res.missing_keys),
                 len(res.unexpected_keys))
    else:
        log.warning("no VEnhancer checkpoint: dev mode")
    return V2VRefiner(model, text_pos=text_pos, text_neg=text_neg,
                      guidance_scale=args.guidance, t_hint=max(0, args.noise_aug - 1),
                      s_cond=float(args.up_scale))


def main(argv=None) -> int:
    args = parse_args(argv)
    device = require_device(args.device)
    frames = read_video(args.input).astype(np.float32) / 255.0
    log.info("input %s frames %s", args.input, frames.shape)
    refiner, vae = build_sr_modules(args, device)
    enhancer = Video360Enhancer(refiner, vae, enhancer_config(args))
    out = enhancer(frames, generator=torch.Generator(device=device).manual_seed(args.seed))
    path = save_video(out.cpu().numpy(), args.output, args.fps)
    log.info("saved %s %s", path, tuple(out.shape))
    return 0


if __name__ == "__main__":
    sys.exit(main())
