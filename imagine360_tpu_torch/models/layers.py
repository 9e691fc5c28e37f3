"""Core building blocks shared by every model of the port
(counterpart of imagine360_tpu/models/layers.py).

Layouts at the public functions are the JAX package's: video features
[B, F, H, W, C], token sequences [B, S, C]. Module and parameter names are
the original reference's torch names (to_q, to_out.0, ff.net.0.proj, ...),
so a reference `state_dict` loads directly and
imagine360_tpu/utils/convert.py maps it to the Flax tree.

Convolutions: a channels-last [N, H, W, C] tensor permuted to [N, C, H, W]
is an NCHW tensor in `torch.channels_last` memory format, so `F.conv2d`
runs cuDNN's NHWC convolution on it with no copy, and permuting the result
back is free again. GroupNorm is `F.group_norm` on the [N, C, L] view in
bf16, and its own float64 statistics in float32 (see GroupNorm).

`rows` (a parallel/mesh.py Mesh, or None) says that the H axis of a pano
activation holds this rank's latent rows only: a 3x3 conv then takes a halo
row from each neighbour and pads only W, and GroupNorm merges its
statistics over the ranks. The argument is passed down by the blocks (never
held in a context), so a rematerialised unit recomputes under the same
layout.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import kernels
from ..ops.attention import dot_product_attention
from ..ops.dispatch import kernel_config
from ..parallel.mesh import halo_rows, merge_var_mean


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding (diffusers get_timestep_embedding). [N] -> [N, dim]
    float32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    freqs = torch.exp(exponent)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear_1 -> silu -> linear_2."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class InflatedConv(nn.Conv2d):
    """2D conv applied per frame to [..., H, W, C] tensors (reference
    InflatedConv3d), torch-style symmetric zero padding. Under `rows` a conv
    with H padding (1, the 3x3 convs) takes the neighbour ranks' halo rows
    in its place: at stride 2 a rank's even row count keeps its output rows
    aligned with the whole tensor's."""

    def forward(self, x, rows=None):
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:])
        padding = self.padding
        if rows is not None and padding[0]:
            if padding[0] != 1:
                raise ValueError(f"a halo of one row serves H padding 1, not {padding[0]}")
            x, padding = halo_rows(x, rows, 1), (0, padding[1])
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias, self.stride, padding)
        y = y.permute(0, 2, 3, 1)
        return y.reshape(*lead, *y.shape[1:])


class GroupNorm(nn.Module):
    """GroupNorm over [B, F, H, W, C]: inflated=True normalizes each frame on
    its own (reference InflatedGroupNorm); otherwise statistics span the
    frames too.

    A float32 input takes its statistics and the normalization in float64,
    rounded once at the end: the result then depends on no summation order,
    so a row-sharded run (`rows`) equals one process bit for bit (the
    float32 parity runs on the CPU sit at the rounding floor of their
    randomly weighted models). A lower-precision input takes `F.group_norm`,
    or under `rows` float32 statistics over this rank's rows merged over the
    ranks (merge_var_mean), then the affine."""

    def __init__(self, num_groups: int, channels: int, eps: float, inflated: bool = True):
        super().__init__()
        self.num_groups, self.eps, self.inflated = num_groups, eps, inflated
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, rows=None):
        C, G = x.shape[-1], self.num_groups
        n = x.shape[0] * x.shape[1] if (self.inflated and x.dim() == 5) else x.shape[0]
        if rows is None and x.dtype != torch.float32:
            h = F.group_norm(x.reshape(n, -1, C).transpose(1, 2), G, self.weight, self.bias,
                             self.eps)
            return h.transpose(1, 2).reshape(x.shape)
        acc = torch.float64 if x.dtype == torch.float32 else torch.float32
        h = x.reshape(n, -1, G, C // G).to(acc)
        var, mean = torch.var_mean(h, dim=(1, 3), unbiased=False)
        if rows is not None:
            var, mean = merge_var_mean(var, mean, rows)
        h = (h - mean[:, None, :, None]) * torch.rsqrt(var + self.eps)[:, None, :, None]
        h = h.reshape(n, -1, C) * self.weight.to(acc) + self.bias.to(acc)
        return h.to(x.dtype).reshape(x.shape)


def LayerNorm(dim: int) -> nn.LayerNorm:
    """LayerNorm with torch's default epsilon, 1e-5 (as the JAX package sets
    it; flax's own default is 1e-6)."""
    return nn.LayerNorm(dim, eps=1e-5)


def _heads(x, heads):
    B, S, C = x.shape
    return x.reshape(B, S, heads, C // heads)


class Attention(nn.Module):
    """Multi-head (cross-)attention with diffusers' Attention semantics: no
    qkv bias, output projection `to_out.0` with bias. `bias` is an additive
    logit bias broadcastable to [B, H, Sq, Sk]."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None, out_bias: bool = True):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, bias=out_bias)])

    def forward(self, x, context=None, bias=None):
        context = x if context is None else context
        q = _heads(self.to_q(x), self.heads)
        k = _heads(self.to_k(context), self.heads)
        v = _heads(self.to_v(context), self.heads)
        out = dot_product_attention(q, k, v, bias=bias)
        return self.to_out[0](out.flatten(2))


class IPCrossAttention(nn.Module):
    """Text cross-attention plus the decoupled image-prompt K/V path
    (reference IPCrossAttention): attn(q, text) + scale * attn(q, ip), both
    through one `to_out.0`."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int,
                 scale: float = 1.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.scale = heads, scale
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_k_ip = nn.Linear(context_dim, inner, bias=False)
        self.to_v_ip = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, text_context, ip_context):
        q = _heads(self.to_q(x), self.heads)

        def attend(kk, vv):
            return dot_product_attention(q, _heads(kk, self.heads),
                                         _heads(vv, self.heads)).flatten(2)

        out = (attend(self.to_k(text_context), self.to_v(text_context))
               + self.scale * attend(self.to_k_ip(ip_context), self.to_v_ip(ip_context)))
        return self.to_out[0](out)


class MMDense(nn.Linear):
    """`nn.Linear` whose product goes through the matmul kernel K7 when the
    `pallas_dense` switch is on (counterpart of
    imagine360_tpu/models/layers.py:MMDense; used at the proj_in / proj_out
    of the spatial transformers and the motion modules). Parameter names and
    shapes are `nn.Linear`'s, so a `state_dict` loads into either.

    With the switch off this is `nn.Linear`. With it on, the tokens are
    flattened to [N, K] and multiplied with the [M, K] weight as it is
    stored: K7 on a CUDA tensor, its plain version on a CPU tensor; the bias
    is added afterwards in the module's dtype. The switch is read at every
    call. K7 has no backward (the JAX kernel has no VJP rule either), so
    with the switch on a call that needs a gradient raises instead of
    quietly taking `F.linear`."""

    def forward(self, x):
        if not kernel_config().pallas_dense:
            return super().forward(x)
        if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad
                                        or (self.bias is not None and self.bias.requires_grad)):
            raise RuntimeError("MMDense under pallas_dense has no backward: run it without "
                               "grad, or turn the switch off")
        y = kernels.dense_matmul(x.reshape(-1, x.shape[-1]).contiguous(), self.weight,
                                 linear_layout=True).reshape(*x.shape[:-1], self.out_features)
        return y if self.bias is None else y + self.bias


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward (diffusers FeedForward, activation 'geglu', exact
    gelu): net.0 = GEGLU, net.1 = dropout (identity at inference), net.2 =
    output Linear."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


def sinusoidal_position_table(max_len: int, d_model: int,
                              device=None) -> torch.Tensor:
    """AnimateDiff temporal PositionalEncoding table: pe[pos, 0::2] = sin,
    pe[pos, 1::2] = cos. [max_len, d_model] float32."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                         * (-math.log(10000.0) / d_model))
    pe = torch.zeros(max_len, d_model, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe
