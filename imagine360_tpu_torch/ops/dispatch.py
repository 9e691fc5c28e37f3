"""The kernel switchboard and attention route selection.

Counterpart of imagine360_tpu/ops/dispatch.py. `KernelConfig` holds the
opt-in kernel switches, read from the environment variable `I360_KERNELS`
at first use and overridden for a block of code by `configure()`.
`select_attention_route` is a pure function of the call's shape and the
config, with Hopper's reasons instead of the TPU's VMEM budgets. On a CUDA
tensor every attention site goes to one of the kernels in ops/kernels.py.
Without grad, under the default config:

- "shared_bias" (K3): any site with a bias, head dim up to 160. The biased
  sites are the WarpAttn correspondence masks, one [Sq, Sk] matrix shared
  by every batch row and head, at every resolution (r2, r4 and r8), and the
  CLIP text encoder's causal mask (77 x 77, -inf above the diagonal).
- "single" (K1): no bias and Sk <= 1024. A 16-row tile of f32 logits over
  the whole key row is at most 64 KB and fits in shared memory beside the
  K/V tile, so the softmax is exact in two passes with no running rescale.
  This covers perspective spatial self-attention at every stage, pano
  spatial attention at 512/128 tokens, text/IP cross-attention on both
  branches, the resampler, the TemporalProjection frame attention, and
  the VAE mid-block attention on 256 x 256 views (1024 tokens, one head
  of 512).
- "mh_flash" (K2): no bias and Sk > 1024 (pano spatial self-attention at
  8192 and 2048 tokens, and the VAE mid-block attention on panoramas:
  8192 tokens encoding, 8704 decoding, one head of 512): the row no longer
  fits, so keys stream through an online softmax.

K1 and K2 take head dims up to 512 (above 160 through their wide kernels:
bfloat16 on the tensor cores, csrc/attn_mma_wide.cuh, float32 on the CUDA
cores, csrc/attn_wide.cuh); beyond that, or above 160 with a bias, no
kernel exists and the selector raises. Inside the route, the wrapper picks
the body: in bfloat16 at D = 64 without a bias, "mh_flash", "flash_lse",
"flash_t" (query and key counts multiples of 8) and "single" above 32
queries and 128 keys run the `wgmma` body of csrc/attn_wgmma.cuh
(`kernels.wgmma_route`), the rest the `mma.sync` body of attn_mma.cuh.

Under grad (`needs_grad`: grad mode is on and q, k or v requires it) the
forward must leave what the backward needs:

- "shared_bias" stays K3, which then also writes its lse; the backward is
  K5b + K5c reading the same shared bias.
- "mh_flash" becomes "flash_lse": K2 keeps no lse, so the long no-bias
  sites (pano spatial self-attention at 8192 and 2048 tokens) take K5a
  forward, K5b + K5c backward. A bias that is not one shared [Sq, Sk]
  matrix ([B, H, Sq, Sk] or broadcast on one axis only) takes "flash_lse"
  too: K3 reads only a shared matrix, K5a-c take a pair of bias strides.
- "single" stays K1: a site of at most 1024 keys has no backward kernel,
  as in the JAX package; its backward recomputes the einsum reference from
  q, k, v (ops/attention.py), batch-chunked under LOGITS_BYTES_LIMIT.
- K5a-c take head dims up to 160 only: beyond that the selector raises.

With `attn_v2` on (default off), a call without grad that would take
"mh_flash" or "shared_bias", has a head dim below 128 and at least 256
queries and 256 keys takes "flash_t" (K6a, `flash_attention_t`): q, k and v
are permuted to the sequence-minor [B, H, D, S] layout and the result
[B, H, Sq, D] is permuted back (ops/attention.py). That covers pano spatial
self-attention at 8192 and 2048 tokens and the WarpAttn sites at r2 and r4
in both directions; the CLIP text encoder's 77 x 77 site and the WarpAttn r8
sites (128 x 320) stay on K3, every site of at most 1024 keys without a bias
on K1. Under grad `attn_v2` changes nothing: K6a writes no lse and has no
backward. In the JAX package the switch also reorders the grid of the
[B, H, S, D] streaming kernel and keeps its bias block resident in VMEM;
that is TPU scheduling of the function K5a computes, not another kernel,
and has no counterpart here. On the CPU a "flash_t" call runs K6a's plain
version, so a CPU run under `attn_v2` walks the same branch.

The motion modules' frame attention has its own entry point
(ops/attention.py:temporal_attention) and always takes K4 on CUDA, with the
einsum-reference backward under grad.

On the CPU without grad the plain einsum runs: "einsum", or "chunked" when
the f32 logits would exceed LOGITS_BYTES_LIMIT. Under grad a CPU call takes
the same routes as a CUDA one, so the same autograd functions run there with
each wrapper's plain version in the kernel's place (a head dim no kernel
takes falls to the plain einsum and PyTorch's own autograd). The two plain
exits exist for CPU tensors only.

`log_route` writes each (route, shape) decision once per process at INFO on
this module's logger, as the JAX package's does, so that a silent re-route
shows in a run's log; the entry points call it for every call.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading

from .kernels import LOGITS_BYTES_LIMIT, MAX_HEAD_DIM, TINY_MAX_SK, WIDE_MAX_HEAD_DIM

logger = logging.getLogger("imagine360_tpu_torch.dispatch")

FLASH_T_MAX_HEAD_DIM = 127   # K6a is for head dims that fill no 128-wide row
FLASH_T_MIN_SEQ = 256        # ... at sites of at least this many queries and keys


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """The opt-in kernel switches, under the JAX package's names. Both are
    off by default.

    The JAX package's other switches have no field here, and naming one in
    `I360_KERNELS` or `configure()` raises:
    - `pallas`, `interpret`: a CUDA tensor always takes a kernel, a CPU
      tensor always a plain version; there is no interpret mode.
    - `packed`, `mh_flash`, `shared_bias`: they turn K1, K2 and K3 off in
      favour of XLA's einsum; the port has no second path on the card.
    - `einsum_bwd`: K1 and K4 sites always take the einsum backward, the
      streaming sites always K5b + K5c.
    - `attn_v1`: forces a [S, D]-block layout that pads D = 32 to 128 TPU
      lanes; no kernel here pads the head dim in memory.
    - `flat_dense`, `flat_proj`, `conv1x1_matmul`: they flatten tokens so
      XLA lowers a Dense as a matmul, not a convolution; `nn.Linear` and
      `F.conv2d` already go to cuBLAS and cuDNN on flattened views.
    - `gn_mmstats`, `flax_gn`: GroupNorm layouts for the TPU's lanes;
      GroupNorm is `F.group_norm`.
    """
    # long attention sites with head dim < 128 take the sequence-minor
    # kernel K6a in place of K2 and K3 (inference only)
    attn_v2: bool = False
    # MMDense (proj_in / proj_out of the spatial transformers and the motion
    # modules) takes the matmul kernel K7 in place of cuBLAS (inference only)
    pallas_dense: bool = False


_FIELDS = {f.name for f in dataclasses.fields(KernelConfig)}
_lock = threading.Lock()
_active: KernelConfig | None = None


def _from_env() -> KernelConfig:
    """`I360_KERNELS`: a comma list of switches, each with `-` (off) or `+`
    or nothing (on) before it, e.g. `+attn_v2,+pallas_dense`."""
    spec = os.environ.get("I360_KERNELS", "")
    overrides: dict[str, bool] = {}
    for tok in filter(None, (t.strip() for t in spec.split(","))):
        name = tok.lstrip("+-")
        if name not in _FIELDS:
            raise ValueError(f"I360_KERNELS: unknown kernel switch {name!r} "
                             f"(valid: {sorted(_FIELDS)})")
        overrides[name] = not tok.startswith("-")
    if overrides:
        logger.info("kernel config overrides from I360_KERNELS: %s", overrides)
    return KernelConfig(**overrides)


def kernel_config() -> KernelConfig:
    """The active config: `I360_KERNELS` parsed at first use, unless a
    `configure()` block is open. Callers read it at call time and keep no
    copy, so a `configure()` block changes the calls inside it and no
    others."""
    global _active
    if _active is None:
        with _lock:
            if _active is None:
                _active = _from_env()
    return _active


def reset_kernel_config() -> None:
    """Drop the parsed config: the next access reads `I360_KERNELS` again."""
    global _active
    with _lock:
        _active = None


@contextlib.contextmanager
def configure(**fields: bool):
    """Override switches inside a `with` block; the previous config is back
    when the block ends, also when it raises."""
    global _active
    unknown = set(fields) - _FIELDS
    if unknown:
        raise ValueError(f"unknown kernel switch(es): {sorted(unknown)} "
                         f"(valid: {sorted(_FIELDS)})")
    prev = kernel_config()
    with _lock:
        _active = dataclasses.replace(prev, **fields)
    try:
        yield _active
    finally:
        with _lock:
            _active = prev


def select_attention_route(B: int, Sq: int, Sk: int, H: int, D: int,
                           has_bias: bool, on_cuda: bool, needs_grad: bool = False,
                           bias_is_shared: bool = True,
                           cfg: KernelConfig | None = None) -> str:
    """Which path `dot_product_attention` takes for a call of this shape.
    `bias_is_shared`: the bias is one [1, 1, Sq, Sk] matrix. `cfg`: the
    kernel switches, the active config unless given."""
    cfg = cfg or kernel_config()
    plain = "chunked" if B * H * Sq * Sk * 4 > LOGITS_BYTES_LIMIT else "einsum"
    if (cfg.attn_v2 and not needs_grad and (has_bias or Sk > TINY_MAX_SK)
            and D <= FLASH_T_MAX_HEAD_DIM and min(Sq, Sk) >= FLASH_T_MIN_SEQ):
        return "flash_t"
    if not on_cuda and not needs_grad:
        return plain
    streams = has_bias or Sk > TINY_MAX_SK
    max_dim = MAX_HEAD_DIM if has_bias or (needs_grad and streams) else WIDE_MAX_HEAD_DIM
    if D > max_dim:
        if not on_cuda:
            return plain
        raise ValueError(f"no attention kernel takes head dim {D} "
                         f"{'with' if has_bias else 'without'} a bias"
                         f"{' under grad' if needs_grad else ''} (max {max_dim})")
    if has_bias:
        return "shared_bias" if bias_is_shared or not needs_grad else "flash_lse"
    if Sk <= TINY_MAX_SK:
        return "single"
    return "flash_lse" if needs_grad else "mh_flash"


_logged_routes: set[tuple] = set()


def log_route(route: str, B: int, Sq: int, Sk: int, H: int, D: int,
              has_bias: bool) -> None:
    """One INFO line per unique (shape signature -> route) per process."""
    key = (route, B, Sq, Sk, H, D, has_bias)
    if key in _logged_routes:
        return
    _logged_routes.add(key)
    logger.info("attention route %-16s B=%d Sq=%d Sk=%d H=%d D=%d bias=%s",
                route, B, Sq, Sk, H, D, has_bias)
