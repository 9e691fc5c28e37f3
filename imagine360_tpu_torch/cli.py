"""Command-line entry point (counterpart of imagine360_tpu/cli.py):

    python -m imagine360_tpu_torch.cli --config run.yaml [--tiny] [--device cpu]

Per video under `video_path` (`.mp4` or `.npy`): read and uniformly
subsample, take the sidecar `.txt` prompt, estimate pitch and warp to ERP,
run the dual-branch denoise, and save `<name>_output`, `<name>_input` and
`<name>_mask` (`.mp4` where a video writer is installed, else `.npy`).

Runs on the card by default and raises without one; `--device cpu` asks for
the CPU. `solver` in the YAML picks the sampler (`ddim`, `dpmpp_2m`,
`dpmpp_2m_sde`); the environment variable `I360_KERNELS` (e.g.
`+attn_v2,+pallas_dense`, read once at first use by ops/dispatch.py) turns
on the opt-in kernels. Loading checkpoints is not ported yet: without them the models are
zero-initialised (dev mode), and a config that names an existing checkpoint
path is refused.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Optional

import numpy as np
import torch

from .config import RunConfig
from .models.clip_text import CLIPTextConfig, CLIPTextModel
from .models.dual import DualUNet
from .models.sam import SAMConfig, SAMImageEncoder
from .models.vae import AutoencoderKL, VAEConfig
from .pipeline.generate import Imagine360Pipeline, PipelineModules
from .presets import full_dual_config, tiny_dual_config
from .utils.device import require_device
from .utils.init import seeded_init_, zero_init_
from .utils.observability import get_logger
from .utils.video_io import read_video, save_video

log = get_logger("cli")

CHECKPOINT_FIELDS = (
    "pretrained_model_path", "mvmodel_pretrained_model_path",
    "pers_unet_pretrained_model_path", "pano_unet_pretrained_model_path",
    "perslora_motion_module_path", "panolora_motion_module_path",
    "image_pretrained_model_path")


def build_modules(cfg: RunConfig, dual_cfg, device="cuda", seed: Optional[int] = None,
                  vae_cfg: Optional[VAEConfig] = None,
                  text_cfg: Optional[CLIPTextConfig] = None,
                  sam_cfg: Optional[SAMConfig] = None) -> PipelineModules:
    """Construct the models on `device` in `cfg.dtype`, with every weight
    zero (`seed` None: dev mode) or drawn from a generator seeded with
    `seed`. The VAE is `VAEConfig()` unless `vae_cfg` is given; a CLIP text
    encoder and a SAM encoder are built only when their config is given (in
    the JAX package they come with their checkpoints, and checkpoint
    loading is not ported yet). A configured checkpoint path that exists
    raises."""
    device = require_device(device)
    found = [f"{name}={getattr(cfg, name)}" for name in CHECKPOINT_FIELDS
             if getattr(cfg, name) and os.path.exists(getattr(cfg, name))]
    if found:
        raise NotImplementedError(
            "checkpoint loading is not ported yet (the JAX package's "
            "utils/checkpoints.py has no counterpart here); the config names existing "
            f"checkpoints: {', '.join(found)}. Remove them to run with "
            "zero-initialised weights")
    dtype = getattr(torch, cfg.dtype)
    gen = None if seed is None else torch.Generator(device=device).manual_seed(seed)

    def make(ctor, *args):
        with torch.device(device):
            model = ctor(*args)
        model = model.to(dtype).eval().requires_grad_(False)
        if gen is None:
            zero_init_(model)
        else:
            seeded_init_(model, gen)
        return model

    if gen is None:
        log.warning("no checkpoints: zero-init dev mode")
    return PipelineModules(
        dual=make(DualUNet, dual_cfg),
        vae=make(AutoencoderKL, vae_cfg or VAEConfig(dtype=cfg.dtype)),
        text_encoder=make(CLIPTextModel, text_cfg) if text_cfg else None,
        sam=make(SAMImageEncoder, sam_cfg) if sam_cfg else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="YAML file with RunConfig keys")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny architecture (CPU smoke runs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain attention versions")
    args = ap.parse_args(argv)

    device = require_device(args.device)
    cfg = RunConfig.from_yaml(args.config)
    if args.tiny:
        # tiny mode is the weightless plumbing smoke: unconditioned is fine
        cfg.allow_unconditioned = True
    dual_cfg = tiny_dual_config() if args.tiny else full_dual_config(cfg.dtype)
    videos = sorted(glob.glob(os.path.join(cfg.video_path, "*.mp4"))
                    + glob.glob(os.path.join(cfg.video_path, "*.npy")))
    if not videos:
        log.error("no videos found under %s", cfg.video_path)
        return 1
    # a prompt with no text encoder would silently generate unconditioned
    # video (zero text embeddings): refuse before the expensive model build
    vp = cfg.pretrained_model_path
    has_tokenizer = bool(vp) and os.path.isdir(os.path.join(vp, "tokenizer"))
    if not has_tokenizer:
        prompted = [p for p in videos if os.path.exists(os.path.splitext(p)[0] + ".txt")]
        if (cfg.prompt.strip() or prompted) and not cfg.allow_unconditioned:
            log.error(
                "prompts exist (%s) but no CLIP tokenizer/text encoder is available: "
                "generation would silently ignore them. Point pretrained_model_path at "
                "an SD2.1 tree with text_encoder/ and tokenizer/, or set "
                "allow_unconditioned: true.",
                cfg.prompt.strip()[:40] or f"{len(prompted)} sidecar .txt files")
            return 1
    os.makedirs(cfg.output_dir, exist_ok=True)
    cfg.to_yaml(os.path.join(cfg.output_dir, "config.yaml"))

    modules = build_modules(cfg, dual_cfg, device)
    pipe = Imagine360Pipeline(modules, cfg, dual_cfg, device)

    generator = torch.Generator(device=device).manual_seed(cfg.global_seed)
    for path in videos:
        name = os.path.splitext(os.path.basename(path))[0]
        log.info("processing %s", name)
        frames = read_video(path, num_frames=cfg.video_sample_length)
        sidecar = os.path.splitext(path)[0] + ".txt"
        prompt = cfg.prompt
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                prompt = f.read().strip()
        out = pipe(frames, prompt, generator=generator)
        base = os.path.join(cfg.output_dir, name)
        written = [save_video(out["videos"], base + "_output.mp4", cfg.fps),
                   save_video(out["pano_input"], base + "_input.mp4", cfg.fps),
                   save_video(np.repeat(out["masks"], 3, axis=-1), base + "_mask.mp4",
                              cfg.fps)]
        log.info("saved %s", ", ".join(written))
    return 0


if __name__ == "__main__":
    sys.exit(main())
