"""JAX-package parameters -> this port's `state_dict`, and the two helpers
of checkpoint loading that work on reference state dicts (`strip_prefix`,
`merge_lora`; utils/checkpoints.py uses them).

`from_jax_params` is the inverse of
imagine360_tpu/utils/convert.py:convert_state_dict. It takes the flat
{'a.b.c': array} parameters that `flatten_params` gives for a Flax tree and
returns torch tensors under the original reference's module names, which
the port's modules use:

- Dense kernels [in, out] -> Linear weights [out, in];
- conv kernels HWIO -> OIHW (and the flat `patch_embed_kernel` /
  `patch_embed_bias` -> `patch_embed.weight` / `.bias`);
- norm `scale` -> `weight`, and the GroupNorm wrapper's extra `.norm.`
  level dropped;
- the renames of `_fixups` undone, and indexed module names restored
  (`down_blocks_0` -> `down_blocks.0`).

The same function serves the DualUNet, the VAE (`down_blocks_0_resnets_1`
-> `down_blocks.0.resnets.1`, `mid_block_attentions_0` ->
`mid_block.attentions.0`), the CLIP text encoder (`token_embedding.embedding`
-> `token_embedding.weight`) and the SAM encoder (`patch_embed_proj` ->
`patch_embed.proj`, `mlp_lin1` -> `mlp.lin1`, `neck_1` -> `neck.1`;
`rel_pos_h/w`, `pos_embed` and the `neck_1/3` norms keep their names).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

# module lists whose index the Flax tree folds into the name ("name_3")
_LIST_NAMES = (
    "down_blocks", "up_blocks", "resnets", "attentions", "motion_modules",
    "downsamplers", "upsamplers", "transformer_blocks", "attention_blocks",
    "norms", "cp_blocks_encoder", "cp_blocks_decoder", "layers", "net",
    "to_out", "blocks", "neck",
)
_GROUPNORM_HOSTS = ("norm1", "norm2", "conv_norm_out", "norm")


def _torch_key(key: str, arr: np.ndarray):
    parts = key.split(".")
    leaf = parts[-1]
    # flat patch-embed conv params of TemporalProjection
    if leaf in ("patch_embed_kernel", "patch_embed_bias"):
        parts[-1:] = ["patch_embed", "kernel" if leaf.endswith("kernel") else "bias"]
        leaf = parts[-1]
    # GroupNorm wrapper level: <mod>.norm.scale -> <mod>.scale
    if (leaf in ("scale", "bias") and len(parts) >= 3 and parts[-2] == "norm"
            and parts[-3] in _GROUPNORM_HOSTS):
        del parts[-2]
    if leaf == "kernel":
        parts[-1] = "weight"
        if arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))     # HWIO -> OIHW
        elif arr.ndim == 2:
            arr = np.transpose(arr, (1, 0))           # [in, out] -> [out, in]
    elif leaf in ("scale", "embedding"):
        parts[-1] = "weight"
    key = ".".join(parts)

    # VAE: block lists folded into one level of the Flax tree
    key = re.sub(r"(down|up)_blocks_(\d+)_resnets_(\d+)", r"\1_blocks.\2.resnets.\3", key)
    key = re.sub(r"(down|up)_blocks_(\d+)_(down|up)samplers_0_conv",
                 r"\1_blocks.\2.\3samplers.0.conv", key)
    key = re.sub(r"mid_block_(resnets|attentions)_(\d+)", r"mid_block.\1.\2", key)
    # SAM
    key = key.replace("patch_embed_proj.", "patch_embed.proj.")
    key = re.sub(r"\.mlp_lin(\d)\.", r".mlp.lin\1.", key)

    # undo imagine360_tpu/utils/convert.py:_fixups
    key = key.replace(".net_0_proj.", ".net.0.proj.")
    key = re.sub(r"(layers_\d+_1)\.net_(\d+)\.", r"\1.\2.", key)
    # Sequential FFs of TemporalProjection (net_0/1/3); the GEGLU
    # FeedForward's net_2 stays a module-list index
    key = re.sub(r"\.(ff|ff_2)\.net_([013])\.", r".\1.\2.", key)
    key = re.sub(r"layers_(\d+)_([01])\.", r"layers_\1.\2.", key)
    key = re.sub(r"(attention_blocks_\d+)\.attn\.", r"\1.", key)
    key = re.sub(r"(motion_modules_\d+)\.", r"\1.temporal_transformer.", key)
    # module-list indices: "name_3" -> "name.3"
    for name in _LIST_NAMES:
        key = re.sub(rf"(^|\.)({name})_(\d+)(?=\.|$)", r"\1\2.\3", key)
    return key, arr


def from_jax_params(flat_params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX-package params -> a state_dict for the port's module of the
    same architecture (float32 tensors; `load_state_dict` casts them)."""
    out = {}
    for k, v in flat_params.items():
        tk, arr = _torch_key(k, np.asarray(v, dtype=np.float32))
        if tk in out:
            raise ValueError(f"two JAX params map to {tk!r}")
        out[tk] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested {'a': {'b': array}} -> flat {'a.b': array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def from_jax_tree(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A nested JAX-package tree shaped like a module's parameters (the
    parameters themselves, their gradients, optimizer moments, EMA weights;
    with or without the top-level 'params' key) -> {port parameter name:
    float32 tensor}, through the renames and transposes of
    `from_jax_params`. A gradient transposes exactly as its parameter does,
    so the result compares name by name with `named_parameters()` and their
    `.grad`."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    return from_jax_params(flatten_tree(tree))


def _tensor(x) -> torch.Tensor:
    return x.detach().cpu().float() if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.asarray(x, dtype=np.float32))


def strip_prefix(state: Mapping[str, object], prefix: str = "module.") -> dict:
    """`prefix` (a DDP wrapper's 'module.') taken off every key that has it."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in state.items()}


def merge_lora(state: Mapping[str, object], lora_state: Mapping[str, object],
               alpha: float = 1.0) -> dict:
    """Merge diffusers-style LoRA pairs into the base weights of a reference
    state dict: W += alpha * up @ down, in float32 (reference
    inference_dual_p2e.py:175-195 unet_load_diffusers_lora). An up weight is
    a key with '.up.weight', 'lora.up' or ending in 'lora_up.weight'; its down
    weight has '.down.' / 'lora_down' in their place, and its base weight drops
    the LoRA suffix and '.processor'. Pairs without a down weight or a base
    weight are skipped, as in the JAX package
    (imagine360_tpu/utils/convert.py:merge_lora)."""
    out = dict(state)
    for up_key, up in lora_state.items():
        if not (".up.weight" in up_key or "lora.up" in up_key
                or up_key.endswith("lora_up.weight")):
            continue
        down_key = up_key.replace(".up.", ".down.").replace("lora_up", "lora_down")
        base_key = (up_key.replace(".lora.up.weight", ".weight")
                    .replace("_lora.up.weight", ".weight")
                    .replace(".lora_up.weight", ".weight")
                    .replace(".processor", ""))
        if down_key not in lora_state or base_key not in out:
            continue
        out[base_key] = _tensor(out[base_key]) + alpha * (
            _tensor(up) @ _tensor(lora_state[down_key]))
    return out
