"""Attention entry points used by every attention site of the port.

`dot_product_attention` (q/k/v [B, S, H, D]) and `temporal_attention`
(q/k/v [B, F, HW, C]) keep the JAX package's layouts
(imagine360_tpu/ops/attention.py). On CUDA tensors they call the kernel
chosen by ops/dispatch.py; on CPU tensors without grad they run the plain
einsum and count one `plain_calls`, so a run on the card can show that no
site took the plain path.

Under grad (grad mode on and q, k or v requires it) they go through the
`torch.autograd.Function`s below, which differentiate each route as the JAX
package's custom VJPs do:

| route         | forward           | backward                           |
|---------------|-------------------|------------------------------------|
| "shared_bias" | K3 writing lse    | K5b + K5c with the shared bias     |
| "flash_lse"   | K5a (out and lse) | K5b + K5c                          |
| "single"      | K1                | einsum-reference VJP, no kernel    |
| temporal      | K4                | einsum-reference VJP, no kernel    |

The einsum-reference VJPs recompute the probabilities from the saved q, k,
v with stock PyTorch ops, batch-chunked under LOGITS_BYTES_LIMIT, where the
JAX package leaves the same VJP to XLA; they count in
`einsum_backward_calls`, not as plain-path calls. A bias is a constant (the
WarpAttn masks are geometry): one that requires grad raises, and it gets no
gradient.

Without grad and with the `attn_v2` switch on (ops/dispatch.py), the long
sites with a head dim below 128 take the route "flash_t": q, k and v are
copied to the sequence-minor [B, H, D, S] layout, K6a runs, and its
[B, H, Sq, D] result is permuted back (counterpart of
pallas_attention.py:flash_attention's `use_t` branch). The copies are part
of the site's time.
"""
from __future__ import annotations

import torch

from . import kernels
from .dispatch import log_route, select_attention_route


# torch.profiler range around every einsum-reference backward
EINSUM_BACKWARD_RANGE = "i360::einsum_backward"


class _StreamingAttention(torch.autograd.Function):
    """Long-sequence sites. Forward: K3 with its lse when `shared` (bias is
    one [Sq, Sk] matrix), else K5a (bias None or [1|B, 1|H, Sq, Sk]).
    Backward: delta = rowsum(g * out) in float32 with stock ops, then K5b
    (dq) and K5c (dk, dv), counterparts of _shared_attention_trainable and
    _mh_attention_trainable / _flash_attention_trainable."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, shared):
        if shared:
            out, lse = kernels.shared_bias_attention(q, k, v, bias, scale=scale, with_lse=True)
            bias = bias[None, None]
        else:
            out, lse = kernels.flash_attention_lse(q, k, v, bias, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.bias, ctx.scale = bias, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        delta = kernels.attention_delta(g, out)
        dq = kernels.flash_bwd_dq(q, k, v, ctx.bias, g, lse, delta, scale=ctx.scale)
        dk, dv = kernels.flash_bwd_dkv(q, k, v, ctx.bias, g, lse, delta, scale=ctx.scale)
        return dq, dk, dv, None, None, None


class _TinyAttention(torch.autograd.Function):
    """Sites of at most 1024 keys, no bias, q/k/v [B, S, H, D]. Forward: K1.
    Backward: the einsum-reference VJP recomputed from q, k, v (counterpart
    of _kernel_attention)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        B, Sq, H, D = q.shape
        Sk = k.shape[1]
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        out = kernels.tiny_attention(q.reshape(B, Sq, H * D), k.reshape(B, Sk, H * D),
                                     v.reshape(B, Sk, H * D), scale=scale, heads=H)
        return out.reshape(B, Sq, H, D)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        einsum_backward_calls.count += 1
        with torch.profiler.record_function(EINSUM_BACKWARD_RANGE):
            dq, dk, dv = kernels.reference_attention_vjp(q, k, v, None, g, ctx.scale)
        return dq, dk, dv, None


def _fold_frames(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, F, HW, C] -> [B*HW, F, heads, D]."""
    B, F, HW, C = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * HW, F, heads, C // heads)


class _FrameAttention(torch.autograd.Function):
    """Frame-axis attention, q/k/v [B, F, HW, C]. Forward: K4. Backward: the
    einsum-reference VJP on the frame-folded tensors (counterpart of
    _temporal_kernel_attention)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, heads):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.heads = scale, heads
        return kernels.frame_attention(q, k, v, scale=scale, heads=heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        B, F, HW, C = q.shape
        einsum_backward_calls.count += 1
        with torch.profiler.record_function(EINSUM_BACKWARD_RANGE):
            grads = kernels.reference_attention_vjp(
                _fold_frames(q, ctx.heads), _fold_frames(k, ctx.heads),
                _fold_frames(v, ctx.heads), None, _fold_frames(g, ctx.heads), ctx.scale)
        return (*(d.reshape(B, HW, F, C).permute(0, 2, 1, 3) for d in grads), None, None)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """Multi-head attention; q [B, Sq, H, D], k/v [B, Sk, H, D], bias
    broadcastable to [B, H, Sq, Sk]. Returns [B, Sq, H, D] in q.dtype."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    fscale = float(D ** -0.5 if scale is None else scale)
    needs_grad = _needs_grad(q, k, v)
    if bias is not None and bias.requires_grad:
        raise ValueError("the attention bias is a constant: it must not require grad")
    shared = bias is not None and bias.dim() == 4 and bias.shape[0] == 1 and bias.shape[1] == 1
    route = select_attention_route(B, Sq, Sk, H, D, bias is not None,
                                   q.device.type == "cuda", needs_grad, shared)
    log_route(route, B, Sq, Sk, H, D, bias is not None)
    if route == "flash_t":
        if bias is not None:
            if bias.dim() != 4:
                raise ValueError("the sequence-minor kernel takes a [1|B, 1|H, Sq, Sk] bias, "
                                 f"got {tuple(bias.shape)}")
            bias = bias.float().contiguous()
        out = kernels.flash_attention_t(
            q.permute(0, 2, 3, 1).contiguous(), k.permute(0, 2, 3, 1).contiguous(),
            v.permute(0, 2, 3, 1).contiguous(), bias, scale=fscale)
        return out.permute(0, 2, 1, 3)
    if route == "shared_bias":
        if not shared:
            raise ValueError("the shared-bias kernel takes a [1, 1, Sq, Sk] bias, "
                             f"got {tuple(bias.shape)}")
        if needs_grad:
            return _StreamingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                             bias[0, 0].float().contiguous(), fscale, True)
        return kernels.shared_bias_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), bias[0, 0], scale=fscale)
    if route == "flash_lse":
        if bias is not None:
            if bias.dim() != 4:
                raise ValueError("the streaming kernels take a [1|B, 1|H, Sq, Sk] bias, "
                                 f"got {tuple(bias.shape)}")
            bias = bias.float().contiguous()
        return _StreamingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), bias,
                                         fscale, False)
    if route == "single" and needs_grad:
        return _TinyAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), fscale)
    if route in ("single", "mh_flash"):
        fn = kernels.tiny_attention if route == "single" else kernels.mh_flash_attention
        out = fn(q.reshape(B, Sq, H * D).contiguous(),
                 k.reshape(B, Sk, H * D).contiguous(),
                 v.reshape(B, Sk, H * D).contiguous(), scale=fscale, heads=H)
        return out.reshape(B, Sq, H, D)
    dot_product_attention.plain_calls += 1
    return kernels.reference_attention(q, k, v, bias=bias, scale=fscale)


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int, scale: float | None = None) -> torch.Tensor:
    """Attention over the frame axis: q/k/v [B, F, HW, C]; every spatial
    location attends over its own F frames (the AnimateDiff motion-module
    pattern). Returns [B, F, HW, C]."""
    B, F, HW, C = q.shape
    D = C // heads
    fscale = float(D ** -0.5 if scale is None else scale)
    log_route("temporal", B * HW, F, F, heads, D, False)
    if _needs_grad(q, k, v):
        return _FrameAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), fscale,
                                     heads)
    if q.device.type == "cuda":
        return kernels.frame_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                       scale=fscale, heads=heads)
    temporal_attention.plain_calls += 1
    return kernels.frame_attention_plain(q, k, v, scale=fscale, heads=heads)


def reset_counts() -> None:
    """Zero every kernel launch count, plain-path count and the count of
    einsum-reference backward passes."""
    kernels.reset_counts()
    dot_product_attention.plain_calls = 0
    temporal_attention.plain_calls = 0
    einsum_backward_calls.count = 0


def plain_path_calls() -> int:
    """Attention calls that ran a plain version since the last reset."""
    return (dot_product_attention.plain_calls + temporal_attention.plain_calls
            + sum(fn.plain_calls for fn in kernels.KERNELS))


def einsum_backward_calls() -> int:
    """Backward passes of K1 and K4 sites since the last reset: each one an
    einsum-reference VJP in stock PyTorch ops (the JAX package has no
    backward kernel for these sites either)."""
    return einsum_backward_calls.count


reset_counts()
