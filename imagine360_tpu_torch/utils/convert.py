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
`rel_pos_h/w`, `pos_embed` and the `neck_1/3` norms keep their names), and
the temporal-decoder VAE under diffusers' names (inverse of
`convert_temporal_vae_state_dict`): the flat (3, Ci, Co) `conv1_kernel`,
`conv2_kernel` and `time_conv_out_kernel` -> Conv3d weights
[Co, Ci, 3, 1, 1] (their `_bias` -> `.bias`), a temporal `conv_shortcut`
Dense [Ci, Co] -> Conv3d [Co, Ci, 1, 1, 1], and a resnet's `mix_factor` m'
-> `time_mixer.mix_factor` [-m'] (the JAX module blends σ(m')·spatial, the
diffusers one (1 - σ(m))·spatial).

A tree of the SR stage's video-to-video UNet (`ControlledV2VUNet`,
`Vid2VidSDUNet` or `VideoControlNet` of imagine360_tpu/sr/unet_v2v.py, told
apart by its `enc.input_0_` encoder) goes to the public VEnhancer names of
the port's sr/unet_v2v.py, as the inverse of `convert_v2v`: `unet.` dropped,
`controlnet.` -> `VideoControlNet.`, `enc.input_{i}_res` ->
`input_blocks.{i}.0`, its `_attn` -> `.1` and `_tempattn` -> `.2` (`.1` in
block 0, after the stem conv), `enc.middle_*` -> `middle_block.{0..3}`,
`output_{i}_*` -> `output_blocks.{i}.{j}` (the upsample after the block's
transformers), a ResBlock's `in_norm` / `in_conv` / `emb_proj` /
`out_norm` / `out_conv` / `skip` -> `in_layers.0` / `in_layers.2` /
`emb_layers.1` / `out_layers.0` / `out_layers.3` / `skip_connection`, its
`temporal_conv.norm{n}` / `.conv{n}` -> `temopral_conv.conv{n}.0` /
`.conv{n}.{2|3}` with the (3, 1, 1) kernels DHWIO -> OIDHW, and
`zero_conv_{i}` -> `zero_convs.{i}.0`.

models/resnet.py:TemporalConvBlock's flat `conv_{i}_kernel` (3, Ci, Co) and
`conv_{i}_bias` go to `conv{i+1}.{2|3}` (a Conv3d [Co, Ci, 3, 1, 1]), its
GroupNorms `norm_{i}.norm.scale` / `.bias` to `conv{i+1}.0.weight` / `.bias`.
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
# flat (3, Ci, Co) frame-axis convs of the temporal-decoder VAE
_FRAME_CONV = re.compile(r"(conv1|conv2|time_conv_out)_(kernel|bias)")
# models/resnet.py:TemporalConvBlock: flat conv_{i}_kernel (3, Ci, Co) and
# conv_{i}_bias, and the GroupNorms norm_{i}
_TEMPORAL_CONV = re.compile(r"conv_(\d)_(kernel|bias)")
_TEMPORAL_NORM = re.compile(r"norm_(\d)")


def _temporal_conv_block_key(parts, arr):
    """A TemporalConvBlock leaf -> (port name parts, array), or None."""
    leaf = parts[-1]
    conv = _TEMPORAL_CONV.fullmatch(leaf)
    if conv:
        i, kind = int(conv.group(1)), conv.group(2)
        if kind == "kernel":                         # (3, Ci, Co) -> [Co, Ci, 3, 1, 1]
            arr = np.transpose(arr, (2, 1, 0))[..., None, None]
        return parts[:-1] + [f"conv{i + 1}", "2" if i == 0 else "3",
                             "weight" if kind == "kernel" else "bias"], arr
    norm = _TEMPORAL_NORM.fullmatch(parts[-3]) if len(parts) >= 3 else None
    if norm and parts[-2] == "norm" and leaf in ("scale", "bias"):
        return parts[:-3] + [f"conv{int(norm.group(1)) + 1}", "0",
                             "weight" if leaf == "scale" else "bias"], arr
    return None


def _torch_key(key: str, arr: np.ndarray):
    parts = key.split(".")
    temporal = _temporal_conv_block_key(parts, arr)
    if temporal is not None:
        return ".".join(temporal[0]), temporal[1]
    leaf = parts[-1]
    # flat patch-embed conv params of TemporalProjection
    if leaf in ("patch_embed_kernel", "patch_embed_bias"):
        parts[-1:] = ["patch_embed", "kernel" if leaf.endswith("kernel") else "bias"]
        leaf = parts[-1]
    # temporal-decoder VAE: frame-axis convs, the temporal shortcut, the mix
    frame_conv = _FRAME_CONV.fullmatch(leaf)
    if frame_conv:
        parts[-1:] = list(frame_conv.groups())
        leaf = parts[-1]
        if leaf == "kernel":                          # (3, Ci, Co) -> [Co, Ci, 3, 1, 1]
            arr = np.transpose(arr, (2, 1, 0))[..., None, None]
            leaf = parts[-1] = "weight"
    elif leaf == "kernel" and parts[-2] == "conv_shortcut" and arr.ndim == 2:
        # the temporal resnet's Dense [Ci, Co] (every other shortcut is a
        # conv) -> Conv3d [Co, Ci, 1, 1, 1]
        arr = np.transpose(arr, (1, 0))[..., None, None, None]
        leaf = parts[-1] = "weight"
    elif leaf == "mix_factor":
        parts[-1:] = ["time_mixer", "mix_factor"]
        arr = -np.reshape(arr, (1,))
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


# the SR stage's V2V UNet tree (imagine360_tpu/sr/unet_v2v.py)
_V2V_TREE = re.compile(r"(unet\.|controlnet\.)?enc\.input_0_")
_V2V_BLOCK = re.compile(
    r"enc\.input_(\d+)_(conv|tempattn|down|res|attn)|enc\.middle_(res0|attn|tempattn|res1)"
    r"|output_(\d+)_(res|attn|tempattn|upsample)|time_embed_(\d)|out_norm|out_conv"
    r"|zero_conv_(\d+)|middle_block_out|hint_time_zero_linear|scale_cond_zero_linear")
_V2V_MIDDLE = {"res0": 0, "attn": 1, "tempattn": 2, "res1": 3}
_V2V_INNER = (  # (pattern, replacement) on the rest of a block's path
    (r"^\.in_norm\.norm", ".in_layers.0"), (r"^\.in_conv", ".in_layers.2"),
    (r"^\.emb_proj", ".emb_layers.1"), (r"^\.out_norm\.norm", ".out_layers.0"),
    (r"^\.out_conv", ".out_layers.3"), (r"^\.skip$", ".skip_connection"),
    (r"^\.temporal_conv\.norm(\d)\.norm", r".temopral_conv.conv\1.0"),
    (r"^\.temporal_conv\.conv1$", ".temopral_conv.conv1.2"),
    (r"^\.temporal_conv\.conv(\d)$", r".temopral_conv.conv\1.3"),
    (r"^\.norm\.norm$", ".norm"), (r"^\.block_0\.", ".transformer_blocks.0."),
    (r"\.to_out_0$", ".to_out.0"), (r"\.ff\.net_0_proj$", ".ff.net.0.proj"),
    (r"\.ff\.net_2$", ".ff.net.2"))


def _v2v_key(key: str, arr: np.ndarray, keys):
    """One leaf of a V2V tree -> (port name, array); `keys` (all the tree's
    names) tell where an output block's upsample sits."""
    parts = key.split(".")
    path, leaf = ".".join(parts[:-1]), parts[-1]
    if leaf == "kernel":
        leaf = "weight"
        if arr.ndim == 5:
            arr = np.transpose(arr, (4, 3, 0, 1, 2))      # DHWIO -> OIDHW
        elif arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))         # HWIO -> OIHW
        elif arr.ndim == 2:
            arr = np.transpose(arr, (1, 0))               # [in, out] -> [out, in]
    elif leaf == "scale":
        leaf = "weight"
    prefix = ""
    if path.startswith(("unet.", "controlnet.")):
        branch, path = path.split(".", 1)
        prefix = "VideoControlNet." if branch == "controlnet" else ""
    m = _V2V_BLOCK.match(path)
    if m is None:
        raise ValueError(f"V2V parameter {key!r} has no port name")
    rest, g = path[m.end():], m.groups()
    if g[0] is not None:                                   # input block g[0]
        i, kind = int(g[0]), g[1]
        j = {"conv": 0, "down": 0, "res": 0, "attn": 1, "tempattn": 1 if i == 0 else 2}[kind]
        head = f"input_blocks.{i}.{j}"
    elif g[2] is not None:
        head = f"middle_block.{_V2V_MIDDLE[g[2]]}"
    elif g[3] is not None:                                 # output block g[3]
        i, kind = int(g[3]), g[4]
        if kind == "upsample":
            j = 1 + sum(any(re.match(rf"(unet\.)?output_{i}_{t}\.", k) for k in keys)
                        for t in ("attn", "tempattn"))
        else:
            j = {"res": 0, "attn": 1, "tempattn": 2}[kind]
        head = f"output_blocks.{i}.{j}"
    elif g[5] is not None:
        head = f"time_embed.{g[5]}"
    elif g[6] is not None:
        head = f"zero_convs.{g[6]}.0"
    else:
        head = {"out_norm": "out.0", "out_conv": "out.2",
                "middle_block_out": "middle_block_out.0"}.get(m.group(0), m.group(0))
        if head == "out.0":
            rest = rest.replace(".norm", "", 1)            # the GroupNorm wrapper
    for pat, rep in _V2V_INNER:
        rest = re.sub(pat, rep, rest)
    return ".".join(filter(None, (prefix + head + rest, leaf))), arr


def from_jax_params(flat_params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX-package params -> a state_dict for the port's module of the
    same architecture (float32 tensors; `load_state_dict` casts them)."""
    out = {}
    v2v = any(_V2V_TREE.match(k) for k in flat_params)
    for k, v in flat_params.items():
        arr = np.asarray(v, dtype=np.float32)
        tk, arr = _v2v_key(k, arr, flat_params) if v2v else _torch_key(k, arr)
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
