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
on the opt-in kernels. The reference's checkpoints are loaded where the
configured paths exist (utils/checkpoints.py); without them the models are
zero-initialised (dev mode). A video whose generation fails is logged and
skipped, and the batch goes on.

On several devices, one process a device:

    torchrun --nproc_per_node N -m imagine360_tpu_torch.cli --config run.yaml [--device cpu]

`use_mesh` and `mesh_replicas` in the YAML take effect
(parallel/mesh.py:init_from_config): "auto" (the default) shards the
perspective views over the N ranks when N > 1, "on" builds the group also
for one process, "off" refuses N > 1. The 20 views must divide over N
(N = 1, 2, 4, 5, 10 or 20) and mesh_replicas must divide N, else the run
stops before any model is built. Only rank 0 writes files. A clip that
fails on every rank is logged and skipped; one that fails on some ranks
only ends the run on all of them.
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
from .models.clip_text import CLIPTextConfig, CLIPTextModel, convert_hf_clip_text
from .models.dual import DualUNet
from .models.sam import SAMConfig, SAMImageEncoder, convert_sam_encoder
from .models.vae import AutoencoderKL, VAEConfig, convert_diffusers_vae
from .parallel import mesh as meshlib
from .pipeline.generate import Imagine360Pipeline, PipelineModules
from .presets import full_dual_config, tiny_dual_config
from .utils.checkpoints import load_cache, load_dual_model, load_state_dict, save_cache
from .utils.device import require_device
from .utils.init import seeded_init_, zero_init_
from .utils.observability import get_logger
from .utils.video_io import read_video, save_video

log = get_logger("cli")

VAE_FILES = ("vae/diffusion_pytorch_model.safetensors", "vae/diffusion_pytorch_model.bin")
TEXT_FILES = ("text_encoder/model.safetensors", "text_encoder/pytorch_model.bin")


def _load_first(module, root, candidates, convert, what):
    """Load the first of `candidates` under `root` that exists into `module`
    (strict=False) through `convert`; log what was loaded."""
    for cand in candidates:
        path = os.path.join(root, cand)
        if os.path.exists(path):
            res = module.load_state_dict(convert(load_state_dict(path)), strict=False)
            log.info("loaded %s weights from %s (%d missing, %d unexpected)", what, path,
                     len(res.missing_keys), len(res.unexpected_keys))
            return


def _tokenizer(root):
    """callable(str) -> [77] int32 ids from the CLIPTokenizer saved under
    root/tokenizer, or None. Only a local directory is read."""
    path = os.path.join(root, "tokenizer")
    if not os.path.isdir(path):
        log.warning("tokenizer unavailable: no directory %s", path)
        return None
    try:
        from transformers import CLIPTokenizer

        tok = CLIPTokenizer.from_pretrained(path, local_files_only=True)
    except Exception as e:  # a broken or partial tokenizer directory: run without it
        log.warning("tokenizer unavailable: %s", e)
        return None
    return lambda s: np.asarray(tok(s, padding="max_length", max_length=77,
                                    truncation=True).input_ids, np.int32)


def make_module(ctor, *args, device, dtype: torch.dtype,
                gen: Optional[torch.Generator] = None) -> torch.nn.Module:
    """ctor(*args) built on `device` in `dtype`, in eval mode without grad,
    its weights zero (`gen` None: the dev mode of a run without checkpoints)
    or drawn from `gen`."""
    with torch.device(device):
        model = ctor(*args)
    model = model.to(dtype).eval().requires_grad_(False)
    if gen is None:
        zero_init_(model)
    else:
        seeded_init_(model, gen)
    return model


def build_modules(cfg: RunConfig, dual_cfg, device="cuda", seed: Optional[int] = None,
                  vae_cfg: Optional[VAEConfig] = None,
                  text_cfg: Optional[CLIPTextConfig] = None,
                  sam_cfg: Optional[SAMConfig] = None) -> PipelineModules:
    """Construct the models on `device` in `cfg.dtype` and load the
    reference's checkpoints where the configured paths exist, as
    imagine360_tpu/cli.py:build_modules does: the dual UNet from
    `<orbax_cache>/dual.pt` when present, else from the MVModel, per-branch
    and LoRA files (then cached there); the VAE, CLIP text encoder and
    tokenizer from the SD2.1 tree at `pretrained_model_path`; SAM from
    `image_pretrained_model_path` (when the UNet takes SAM's 256-wide
    features). Weights no checkpoint gives are zero (`seed` None: dev mode)
    or drawn from a generator seeded with `seed`. The VAE is `VAEConfig()`
    unless `vae_cfg` is given; a CLIP text encoder is built when `text_cfg`
    is given or the tree has text_encoder/, a SAM encoder when `sam_cfg` is
    given or its checkpoint is loaded."""
    device = require_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = None if seed is None else torch.Generator(device=device).manual_seed(seed)

    def make(ctor, *args):
        return make_module(ctor, *args, device=device, dtype=dtype, gen=gen)

    dual = make(DualUNet, dual_cfg)
    cache = os.path.join(cfg.orbax_cache, "dual.pt") if cfg.orbax_cache else None
    pers = cfg.pers_unet_pretrained_model_path
    if cache and os.path.exists(cache):
        log.info("restoring the cached dual UNet from %s", cache)
        missing, unexpected = load_cache(dual, cache)
        log.info("cache load: %d missing, %d unexpected", len(missing), len(unexpected))
    elif pers and os.path.exists(pers):
        log.info("loading reference checkpoints")
        missing, unexpected = load_dual_model(
            dual, cfg.mvmodel_pretrained_model_path, pers, cfg.pano_unet_pretrained_model_path,
            cfg.perslora_motion_module_path, cfg.panolora_motion_module_path,
            cfg.lora_alpha_pers, cfg.lora_alpha_pano)
        log.info("ckpt load: %d missing, %d unexpected", len(missing), len(unexpected))
        if cache:
            os.makedirs(cfg.orbax_cache, exist_ok=True)
            save_cache(dual, cache)
            log.info("cached the dual UNet at %s", cache)
    else:
        log.warning("no UNet checkpoints found: %s dev mode",
                    "zero-init" if gen is None else "seeded-init")

    vae = make(AutoencoderKL, vae_cfg or VAEConfig(dtype=cfg.dtype))
    vp = cfg.pretrained_model_path
    if vp:
        _load_first(vae, vp, VAE_FILES, convert_diffusers_vae, "VAE")

    text_encoder = tokenizer = None
    text_dir = bool(vp) and os.path.isdir(os.path.join(vp, "text_encoder"))
    if text_cfg or text_dir:
        text_encoder = make(CLIPTextModel, text_cfg or CLIPTextConfig(dtype=cfg.dtype))
    if text_dir:
        _load_first(text_encoder, vp, TEXT_FILES, convert_hf_clip_text, "CLIP text")
        tokenizer = _tokenizer(vp)

    sp = cfg.image_pretrained_model_path
    sam_ckpt = bool(sp) and os.path.exists(sp) and dual_cfg.pano.image_hidden_size == 256
    sam = (make(SAMImageEncoder, sam_cfg or SAMConfig(dtype=cfg.dtype))
           if sam_cfg or sam_ckpt else None)
    if sam_ckpt:
        res = sam.load_state_dict(convert_sam_encoder(load_state_dict(sp)), strict=False)
        log.info("loaded SAM encoder from %s (%d missing, %d unexpected)", sp,
                 len(res.missing_keys), len(res.unexpected_keys))
    return PipelineModules(dual=dual, vae=vae, text_encoder=text_encoder, sam=sam,
                           tokenizer=tokenizer)


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
    mesh = meshlib.init_from_config(cfg, device, views=dual_cfg.num_views)
    try:
        return _generate_all(cfg, dual_cfg, mesh.device if mesh else device, mesh, videos)
    finally:
        if mesh is not None:
            meshlib.destroy()


def _failed_everywhere(mesh, failed: bool) -> bool:
    """Whether the clip failed on every rank; raises where it failed on
    some only, since the others cannot go on without them."""
    if mesh is None:
        return failed
    with meshlib.activate_mesh(mesh):
        n = int(meshlib.reduce_sum(torch.tensor([int(failed)], device=mesh.device)).item())
    if 0 < n < mesh.world:
        raise RuntimeError(f"the clip failed on {n} of {mesh.world} ranks")
    return n > 0


def _generate_all(cfg: RunConfig, dual_cfg, device, mesh, videos) -> int:
    writer = mesh is None or mesh.rank == 0
    if writer:
        os.makedirs(cfg.output_dir, exist_ok=True)
        cfg.to_yaml(os.path.join(cfg.output_dir, "config.yaml"))

    modules = build_modules(cfg, dual_cfg, device)
    pipe = Imagine360Pipeline(modules, cfg, dual_cfg, device, mesh=mesh)

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
        out = None
        try:
            out = pipe(frames, prompt, generator=generator)
        except Exception:   # one failing clip must not stop the batch
            log.exception("generation failed for %s", name)
        if _failed_everywhere(mesh, out is None) or not writer:
            continue
        base = os.path.join(cfg.output_dir, name)
        written = [save_video(out["videos"], base + "_output.mp4", cfg.fps),
                   save_video(out["pano_input"], base + "_input.mp4", cfg.fps),
                   save_video(np.repeat(out["masks"], 3, axis=-1), base + "_mask.mp4",
                              cfg.fps)]
        log.info("saved %s", ", ".join(written))
    return 0


if __name__ == "__main__":
    sys.exit(main())
