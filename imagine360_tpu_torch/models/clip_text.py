"""CLIP text encoder (the OpenCLIP ViT-H text tower SD2.1 uses), the
counterpart of imagine360_tpu/models/clip_text.py: a pre-LN causal
transformer whose last hidden state is the 77 x 1024 prompt conditioning.

Module names follow the JAX package's tree (`token_embedding`,
`position_embedding`, `layers.N.self_attn.q_proj`, `layers.N.fc1`,
`final_layer_norm`); `convert_hf_clip_text` and `convert_openclip_text` turn
a transformers or an open_clip state dict into this module's `state_dict`.

The causal mask is an additive [1, 1, S, S] float32 bias, -inf above the
diagonal; on CUDA the attention takes kernel K3 (shared-bias).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"   # SD2.1 (SD1.x uses quick_gelu)
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _act(name: str):
    if name == "gelu":
        return F.gelu
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    raise ValueError(name)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        D = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)

    def forward(self, x, mask):
        B, S, D = x.shape
        split = lambda t: t.reshape(B, S, self.heads, D // self.heads)
        o = dot_product_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                  split(self.v_proj(x)), bias=mask)
        return self.out_proj(o.reshape(B, S, D))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        D = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(D, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, D)
        self.act = _act(cfg.hidden_act)

    def forward(self, x, mask):
        x = self.self_attn(self.layer_norm1(x), mask) + x
        return x + self.fc2(self.act(self.fc1(self.layer_norm2(x))))


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(
            0.01 * torch.randn(cfg.max_position_embeddings, cfg.hidden_size))
        self.layers = nn.ModuleList([CLIPLayer(cfg) for _ in range(cfg.num_layers)])
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids):
        """input_ids [B, S] integer -> last_hidden_state [B, S, D]."""
        S = input_ids.shape[1]
        tok = self.token_embedding(input_ids.long())
        x = tok + self.position_embedding[None, :S].to(tok.dtype)
        causal = torch.full((S, S), float("-inf"), dtype=torch.float32,
                            device=x.device).triu(1)[None, None]
        for layer in self.layers:
            x = layer(x, causal)
        return self.final_layer_norm(x)


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float()
    return torch.from_numpy(np.asarray(v, dtype=np.float32))


def convert_openclip_text(state_dict: Mapping[str, object],
                          num_layers: int = 23) -> Dict[str, torch.Tensor]:
    """open_clip-format ViT-H text tower -> `state_dict` of CLIPTextModel.

    open_clip's text transformer run to the penultimate block (23 of 24)
    and then `ln_final` is the SD2.1 CLIPTextModel. Maps open_clip naming
    (token_embedding.weight, transformer.resblocks.N.*, ln_final), splits
    the fused in_proj qkv, drops resblocks >= num_layers and the non-text
    keys (visual.*, logit_scale, text_projection, attn_mask)."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("model."):       # FrozenOpenCLIPEmbedder prefix
            k = k[len("model."):]
        if (k.startswith("visual.") or k in ("logit_scale", "text_projection", "attn_mask")
                or k.endswith(".attn_mask")):
            continue
        t = _tensor(v)
        m = re.match(r"transformer\.resblocks\.(\d+)\.(.*)", k)
        if m:
            i, rest = int(m.group(1)), m.group(2)
            if i >= num_layers:
                continue                  # penultimate: skip the final block(s)
            base = f"layers.{i}."
            fused = re.match(r"attn\.in_proj_(weight|bias)$", rest)
            if fused:
                for name, part in zip(("q_proj", "k_proj", "v_proj"), t.chunk(3, dim=0)):
                    out[f"{base}self_attn.{name}.{fused.group(1)}"] = part.contiguous()
                continue
            for old, new in (("attn.out_proj", "self_attn.out_proj"), ("ln_1", "layer_norm1"),
                             ("ln_2", "layer_norm2"), ("mlp.c_fc", "fc1"),
                             ("mlp.c_proj", "fc2")):
                rest = rest.replace(old, new)
            k = base + rest
        else:
            k = k.replace("positional_embedding", "position_embedding")
            k = k.replace("ln_final", "final_layer_norm")
        out[k] = t
    return out


def openclip_tokenize(hf_tokenizer, text: str, context_length: int = 77) -> np.ndarray:
    """open_clip.tokenize semantics through a HF CLIPTokenizer (same BPE
    vocabulary): [sot] + bpe(text) + [eot], then ZERO padding (open_clip
    pads with 0 where HF/SD pads with the eos id)."""
    ids = hf_tokenizer(text, truncation=True, max_length=context_length,
                       add_special_tokens=True)["input_ids"]
    out = np.zeros((context_length,), np.int32)
    out[:len(ids)] = ids
    return out


def convert_hf_clip_text(state_dict: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """transformers CLIPTextModel state_dict -> `state_dict` of
    CLIPTextModel."""
    out = {}
    for k, v in state_dict.items():
        if k.endswith("position_ids"):
            continue
        k = k.replace("text_model.", "")
        k = k.replace("embeddings.token_embedding.weight", "token_embedding.weight")
        k = k.replace("embeddings.position_embedding.weight", "position_embedding")
        k = re.sub(r"encoder\.layers\.(\d+)\.", r"layers.\1.", k)
        k = k.replace(".mlp.", ".")
        out[k] = _tensor(v)
    return out
