"""Checkpoint loading (counterpart of imagine360_tpu/utils/checkpoints.py).

The reference's checkpoint families (reference inference_dual_p2e.py:175-250,
425-440):

- per-branch UNet checkpoints, {'epoch', 'global_step', 'state_dict'} with
  'module.' DDP prefixes, loaded with strict=False;
- motion-LoRA checkpoints, merged into the base weights as
  W += alpha * up @ down;
- the MVModel checkpoint (the WarpAttn coupling blocks; it may also carry
  unet. / pano_unet. copies, which the per-branch files override);
- HF-format SD2.1 VAE / CLIP text weights and the SAM ViT-B checkpoint.

The port's modules carry the reference's parameter names, so a loaded dict
goes into `Module.load_state_dict(strict=False)` as it is; the JAX package's
conversion to Flax names has no counterpart here. In place of its orbax
persistence, `save_cache` / `load_cache` keep the assembled state_dict with
`torch.save` / `torch.load`.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .convert import merge_lora, strip_prefix


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch .ckpt / .pt / .bin file (a {'state_dict': ...} wrapper
    unwrapped, 'module.' prefixes stripped) or a .safetensors file, as
    {name: tensor} on the CPU. Reading .safetensors needs the safetensors
    package, imported only when such a file is named."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"{path}: reading a .safetensors file needs the safetensors "
                              "package") from e
        return dict(load_file(path, device="cpu"))
    # the reference's Lightning checkpoints hold more than tensors; only
    # files the run's configuration names are read
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return strip_prefix(obj)


def _load(module: nn.Module, state) -> tuple:
    res = module.load_state_dict(state, strict=False)
    return list(res.missing_keys), list(res.unexpected_keys)


def load_unet_branch(module: nn.Module, path: str, lora_path: Optional[str] = None,
                     lora_alpha: float = 1.0, prefix: str = "") -> tuple:
    """Load one UNet branch from its checkpoint (only the keys under
    `prefix`, which is stripped), with an optional motion LoRA merged in
    first (reference load_unetbranch, inference_dual_p2e.py:197-250).
    Returns (missing, unexpected) parameter names."""
    state = load_state_dict(path)
    if prefix:
        state = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    if lora_path:
        state = merge_lora(state, load_state_dict(lora_path), alpha=lora_alpha)
    return _load(module, state)


def load_dual_model(dual: nn.Module, mv_ckpt: Optional[str],
                    pers_ckpt: Optional[str] = None, pano_ckpt: Optional[str] = None,
                    pers_lora: Optional[str] = None, pano_lora: Optional[str] = None,
                    alpha_pers: float = 1.0, alpha_pano: float = 1.0) -> tuple:
    """Assemble the DualUNet's state_dict from the reference's three
    checkpoint families and load it: the MVModel file first, then the
    per-branch files (each with its LoRA merged) under unet. / pano_unet.,
    which win. Returns (missing, unexpected) parameter names."""
    merged = {}
    if mv_ckpt:
        merged.update(load_state_dict(mv_ckpt))
    for branch, ckpt, lora, alpha in (("unet", pers_ckpt, pers_lora, alpha_pers),
                                      ("pano_unet", pano_ckpt, pano_lora, alpha_pano)):
        if not ckpt:
            continue
        state = load_state_dict(ckpt)
        if lora:
            state = merge_lora(state, load_state_dict(lora), alpha=alpha)
        merged.update({f"{branch}.{k}": v for k, v in state.items()})
    return _load(dual, merged)


def save_cache(module: nn.Module, path: str) -> None:
    """The module's assembled state_dict, for `load_cache` to restore."""
    torch.save(module.state_dict(), path)


def load_cache(module: nn.Module, path: str) -> tuple:
    """Restore a state_dict written by `save_cache`. Returns (missing,
    unexpected) parameter names."""
    return _load(module, torch.load(path, map_location="cpu", weights_only=True))
