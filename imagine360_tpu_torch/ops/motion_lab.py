"""The motion-attention lab: the variants of the frame-axis attention kernel
held against K4 and timed beside it.

Counterpart of scripts/kernel_lab.py:main and scripts/motion_fused_micro.py:
main together. The motion modules attend over the frame axis at every
spatial location (K4, `kernels.frame_attention`). The lab variants compute
the same function by other ownerships of the work:

- L1 `striped_v2_attention(G, R)`: a block owns R packs of G neighbouring
  locations and all heads;
- L2 `fused_motion_attention(G, exp_bf16)`: a pack of G locations attends as
  one G*F-token sequence under an additive bias; with `block_diag_bias` that
  is K4's function, at G times its arithmetic;
- L3 `diag_motion_attention(G)`: one warp per (location, head), no bias, a
  block owning G locations and walking their heads.

In bfloat16 all four run on the tensor cores: L2 on its own streaming
tile, L1 and L3 on K4's tile under their own ownerships.

`run_lab` holds every variant that fits a site against K4's plain version
(and, on the card, against the K4 kernel) and times it with CUDA events. The
long/short chain differencing of the JAX lab (`chain_time`) cancelled a
remote device's fetch latency; events on the card's own stream have none, so
it has no counterpart here. The bias helpers equal the JAX package's bit
for bit; the port packs nothing on its main path, so only the lab uses them.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kernels

PACK_TARGET = 512     # tokens of one packed sequence (imagine360_tpu/ops/dispatch.py)

# L1: the (G, R) of the JAX lab's sweep, then small packs walked a few at a
# time: on this card a pack must fit a block's shared memory and the grid
# wants many blocks
V2_PACKS = ((16, 8), (8, 16), (8, 32), (4, 32), (4, 64), (2, 64),
            (4, 8), (4, 1), (2, 8), (2, 1), (1, 8), (1, 1))
FUSED_PACKS = ((8, False), (16, False), (32, False), (32, True))   # L2: (G, exp_bf16)
DIAG_PACKS = (16, 32, 8, 4)                                        # L3: G
BASELINE = "frame_attention"


def block_diag_bias(G: int, Sq: int, Sk: int) -> np.ndarray:
    """[1, 1, G*Sq, G*Sk] additive float32 bias: 0 on the G diagonal
    (Sq x Sk) blocks, -1e9 elsewhere, so that a softmax over the packed axis
    equals G independent ones (exp(-1e9 - m) is 0 in float32)."""
    m = np.full((G * Sq, G * Sk), -1e9, np.float32)
    for i in range(G):
        m[i * Sq:(i + 1) * Sq, i * Sk:(i + 1) * Sk] = 0.0
    return m[None, None]


def striped_bias(G: int, F: int) -> np.ndarray:
    """[1, F*G, F*G] additive float32 bias: 0 where row and column agree
    modulo G, -1e9 elsewhere: the block-diagonal mask for rows interleaved as
    f*G + g."""
    idx = np.arange(F * G)
    return np.where((idx[:, None] - idx[None, :]) % G == 0, 0.0, -1e9).astype(np.float32)[None]


def temporal_group(F: int, HW: int) -> int:
    """The pack size the JAX package gives its frame-axis kernel: the most
    locations whose F frames stay within PACK_TARGET tokens, halved until it
    divides HW."""
    G = max(1, PACK_TARGET // F)
    while G > 1 and HW % G:
        G //= 2
    return G


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over `iters` calls after one warm-up, CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def lab_variants(shape, itemsize: int = 2):
    """[(variant name, wrapper, keyword arguments)] of the lab at a site
    (B, F, HW, C, heads): K4 first, then every pack of V2_PACKS, FUSED_PACKS
    and DIAG_PACKS that divides the site and fits a block's shared memory
    for tensors of `itemsize` bytes (2: the bfloat16 plans of L1, L2 and L3
    on the tensor cores, where L2 streams and fits every pack; 4: the
    float32 kernels). A fused variant's keyword arguments lack the bias, which
    `run_lab` builds on the site's device."""
    B, F, HW, C, heads = shape
    D = C // heads
    bf16 = itemsize == 2
    out = [(BASELINE, kernels.frame_attention, {})]
    for G, R in V2_PACKS:
        if HW % G or (HW // G) % R:
            continue
        if bf16:
            try:
                kernels.striped_v2_mma_plan(G, F, D, heads)
            except ValueError:
                continue
        elif kernels.striped_v2_smem_bytes(G, F, C, heads, itemsize) > kernels.SMEM_LIMIT:
            continue
        out.append((f"striped_v2_G{G}_R{R}", kernels.striped_v2_attention, dict(G=G, R=R)))
    for G, exp_bf16 in FUSED_PACKS:
        if HW % G == 0 and (bf16 or kernels.fused_motion_smem_bytes(G, F, D, itemsize)
                             <= kernels.SMEM_LIMIT):
            out.append((f"fused_G{G}" + ("_expbf16" if exp_bf16 else ""),
                        kernels.fused_motion_attention, dict(G=G, exp_bf16=exp_bf16)))
    for G in DIAG_PACKS:
        if HW % G or F > kernels.DIAG_MAX_F:
            continue
        try:
            if bf16:
                kernels.diag_motion_mma_plan(G, F, D, heads)
            else:
                kernels.diag_motion_plan(G, F, D, heads, itemsize)
        except ValueError:
            continue
        out.append((f"diag_G{G}", kernels.diag_motion_attention, dict(G=G)))
    return out


def run_lab(device, sites, *, variants=None, iters: int = 10, check: bool = True,
            dtype=torch.bfloat16) -> list[dict]:
    """The lab at every site of `sites` ([(site name, (B, F, HW, C, heads))]),
    on seeded unit-scale random q, k, v of `dtype` on `device`. `variants`
    keeps only the named variants (names as `lab_variants` gives them).

    One row per (site, variant): `variant`, `kernel` (the wrapper's name),
    `params`, `launches` and `plain_calls` of that variant at that site, and
    with `check` its largest absolute difference from K4's plain version
    (`max_abs_err`, beside `peak`, the plain version's largest element) and,
    on a card, from the K4 kernel (`k4_max_abs_err`). On a card also `ms`
    (mean of `iters` calls, CUDA events) beside `k4_ms`, K4's time at the
    site in the same run; on the CPU both are None: not measured."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for site, shape in sites:
        B, F, HW, C, heads = shape
        scale = (C // heads) ** -0.5
        q, k, v = (torch.randn(B, F, HW, C, generator=gen, device=device,
                               dtype=torch.float32).to(dtype) for _ in range(3))
        want = prod = None
        if check:
            want = kernels.frame_attention_plain(q, k, v, scale=scale, heads=heads).float()
            if on_card:
                prod = kernels.frame_attention(q, k, v, scale=scale, heads=heads).float()
        k4_ms = None
        for name, fn, kw in lab_variants(shape, q.element_size()):
            if variants is not None and name not in variants:
                continue
            args = (q, k, v)
            if fn is kernels.fused_motion_attention:
                args += (torch.from_numpy(block_diag_bias(kw["G"], F, F)[0]).to(device),)
            call = lambda: fn(*args, scale=scale, heads=heads, **kw)
            before = (fn.launches, fn.plain_calls)
            row = dict(site=site, shape=list(shape), variant=name, kernel=fn.__name__,
                       params=dict(kw), ms=None, k4_ms=None)
            if check:
                got = call().float()
                row["max_abs_err"] = (got - want).abs().max().item()
                row["peak"] = want.abs().max().item()
                row["k4_max_abs_err"] = (got - prod).abs().max().item() if on_card else None
                del got
            if on_card:
                row["ms"] = cuda_ms(call, iters)
                if name == BASELINE:
                    k4_ms = row["ms"]
                row["k4_ms"] = k4_ms
            row["launches"] = fn.launches - before[0]
            row["plain_calls"] = fn.plain_calls - before[1]
            rows.append(row)
    return rows
