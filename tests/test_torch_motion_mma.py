"""The arithmetic of L2's and L3's tensor-core tiles, emulated on the CPU.

In bfloat16, L2 (`kernels.fused_motion_attention`) runs the streaming tile of
csrc/motion_fused.cu on each pack's gathered sequence (row g*F + f): the
head dim padded with zero columns to its bucket, S = Q·Kᵀ in float32 over
k-steps of 16 columns taken in order, then per 64-key tile an online
softmax in log2 units (logit × scale·log2 e plus the bias × log2 e),
P = 2^(x - m) rounded once to bfloat16 and multiplied by V in 16-key steps,
the sum taken over the unrounded P, the division at the end.
With `exp_bf16` a first pass over the key tiles gives each row's final max
m of s·scale + bias, and the second takes bf16(e^bf16(x - m)), sums those
bfloat16 values in float32, multiplies them by V as they are and divides
at the end. `emulate_fused` repeats that order. L3
(`kernels.diag_motion_attention`) runs K4's tile (csrc/frame_mma.cuh) on
each (location, head) of a block's G locations: frames padded with zero
rows to a multiple of 16, keys past F at the finite -1e30, an exact softmax
of the whole row in log2 units, P normalised and rounded once to bfloat16.
`emulate_diag` repeats that order, head group by head group as the block
walks them.

Both are held against the port's plain versions and the JAX lab's Pallas
kernels in interpret mode (scripts/exp_motion_kernels.py) on the same
seeded inputs, under a block-diagonal, a random float32, a random bfloat16
and a partly -inf bias: float32 inputs within 1e-5; bfloat16 outputs, and
every output of L2 with exp_bf16 (its probabilities are bfloat16 values in
any dtype), within a quarter of chip_smoke.py's limit (phase 2's min(2e-2,
2**-5 x max|plain|), with exp_bf16 chip_smoke.EXP_BF16_TOL), but never
less than one bfloat16 step at the output's largest element, and never
more than the limit itself: two roundings of nearly equal numbers to
bfloat16 may land a step apart, and a quarter of the limit (5e-3, with
exp_bf16 1.25e-2) is less than a step above 1 (2**-7), or above 2 (2**-6).
L2 without exp_bf16 rounds each probability before the division where the
plain version rounds it after.
Also the bfloat16 plans of L1, L2 and L3 at the eight full-width motion
sites, and that the lab lists at least the variants the CUDA-core kernels
fit.
"""
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as nnf

from imagine360_tpu_torch.ops import kernels, motion_lab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
import chip_smoke  # noqa: E402
import exp_motion_kernels as jexp  # noqa: E402

K_STEP = 16                    # head-dim columns (or keys) of one mma.sync k-step
KEY_TILE = 64                  # csrc/attn_mma.cuh kMmaBK
LOG2E = 1.4426950408889634
NEG_INF = -1e30                # csrc/attn_common.cuh kNegInf
F32_TOL = 1e-5


def _kstep_dots(a, b, width):
    """a @ b^T in float32, summed over k-steps of 16 of `width` columns in
    order, as mma.sync accumulates them (a, b zero-padded to width)."""
    a = nnf.pad(a, (0, width - a.shape[-1]))
    b = nnf.pad(b, (0, width - b.shape[-1]))
    s = torch.zeros(*a.shape[:-1], b.shape[-2])
    for c in range(0, width, K_STEP):
        s = s + a[..., c:c + K_STEP] @ b[..., c:c + K_STEP].transpose(-1, -2)
    return s


def _pv(p, v):
    """p @ v in float32 over 16-key steps in order."""
    o = torch.zeros(*p.shape[:-1], v.shape[-1])
    for j in range(0, p.shape[-1], K_STEP):
        o = o + p[..., j:j + K_STEP] @ v[..., j:j + K_STEP, :]
    return o


def _round(x, dtype):
    return x.to(dtype).float()


def emulate_fused(q, k, v, bias, scale, heads, G, exp_bf16):
    """csrc/motion_fused.cu's tensor-core order on q/k/v [B, F, HW, C] under
    bias [1, G*F, G*F]; returns [B, F, HW, C] in q.dtype."""
    B, F, HW, C = q.shape
    D, T, S = C // heads, HW // G, G * F
    dp = next(b for b in kernels.FUSED_MMA_DP if D <= b)

    def pack(x):    # [B, F, T*G, C] -> [B*T, heads, G*F, D], row g*F + f
        return x.float().reshape(B, F, T, G, heads, D).permute(0, 2, 4, 3, 1, 5).reshape(
            B * T, heads, S, D)

    qp, kp, vp = pack(q), pack(k), pack(v)
    s = _kstep_dots(qp, kp, dp)
    b = bias[0].float()
    if exp_bf16:
        x = s * scale + b
        m = x.amax(dim=-1, keepdim=True)
        p = _round(torch.exp2(_round(x - m, torch.bfloat16) * LOG2E), torch.bfloat16)
        o = _pv(p, vp) * (1.0 / p.sum(dim=-1, keepdim=True))
    else:
        m = torch.full(s.shape[:-1], NEG_INF)
        l = torch.zeros(s.shape[:-1])
        o = torch.zeros(*s.shape[:-1], D)
        for k0 in range(0, S, KEY_TILE):
            x = b[:, k0:k0 + KEY_TILE] * LOG2E + s[..., k0:k0 + KEY_TILE] * (scale * LOG2E)
            m_new = torch.maximum(m, x.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + _pv(_round(p, v.dtype), vp[..., k0:k0 + KEY_TILE, :])
            m = m_new
        o = o * (1.0 / l)[..., None]
    o = o.to(q.dtype)
    return o.reshape(B, T, heads, G, F, D).permute(0, 4, 1, 3, 2, 5).reshape(B, F, HW, C)


def emulate_diag(q, k, v, scale, heads, G, HG):
    """K4's tile order (csrc/frame_mma.cuh) under L3's ownership: each block
    of G locations walks its heads HG at a time; returns [B, F, HW, C] in
    q.dtype."""
    B, F, HW, C = q.shape
    D = C // heads
    FP, dp = -(-F // 16) * 16, -(-D // 16) * 16
    out = torch.empty(B, F, HW, C, dtype=q.dtype)
    for h0 in range(0, heads, HG):
        cols = slice(h0 * D, (h0 + HG) * D)

        def problems(x):     # [B, HW, HG, FP, D], frames past F zero
            x = x[..., cols].float().reshape(B, F, HW, HG, D).permute(0, 2, 3, 1, 4)
            return nnf.pad(x, (0, 0, 0, FP - F))

        qf, kf, vf = problems(q), problems(k), problems(v)
        s = _kstep_dots(qf, kf, dp) * (scale * LOG2E)
        s[..., F:] = NEG_INF
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        p = _round(p * (1.0 / p.sum(dim=-1, keepdim=True)), v.dtype)
        o = _pv(p, vf)[..., :F, :].to(q.dtype)
        out[..., cols] = o.permute(0, 3, 1, 2, 4).reshape(B, F, HW, HG * D)
    return out


def _tensor(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _from_jax(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


def _limit(want, exp_bf16=False):
    """A quarter of chip_smoke.py's limit of a bfloat16 output (or of one
    with bfloat16 probabilities), but at least one bfloat16 step at the
    output's largest element, and at most the limit itself."""
    peak = want.float().abs().max().item()
    limit = chip_smoke.EXP_BF16_TOL if exp_bf16 else chip_smoke.bf16_tol(
        "fused_motion_attention", peak)
    return min(limit, max(0.25 * limit, 2.0 ** (math.floor(math.log2(peak)) - 7)))


def _check(got, want, dtype, exp_bf16=False):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= (F32_TOL if dtype == torch.float32 and not exp_bf16
                   else _limit(want, exp_bf16)), err


def _bias(kind, G, F, seed):
    """A [1, G*F, G*F] bias: block-diagonal (float32), seeded uniform in
    [-1, 1) (float32 or bfloat16), or uniform with about 30% of the entries
    -inf off the diagonal (no row is fully masked)."""
    S = G * F
    if kind == "block_diag":
        return torch.from_numpy(motion_lab.block_diag_bias(G, F, F)[0])
    rng = np.random.default_rng(seed)
    vals = rng.uniform(-1, 1, (1, S, S)).astype(np.float32)
    if kind == "minus_inf":
        drop = (rng.uniform(size=(S, S)) < 0.3) & ~np.eye(S, dtype=bool)
        vals[0][drop] = -np.inf
    bias = torch.from_numpy(vals)
    return bias.bfloat16() if kind == "random_bf16" else bias


@pytest.fixture(scope="module")
def jax_lab():
    """The JAX lab's Pallas kernels in interpret mode, one call per case,
    kept for the module (each new shape or dtype is one more jit)."""
    cache = {}

    def run(fn, key, *args, **kw):
        if key not in cache:
            cache[key] = _from_jax(fn(*args, interpret=True, **kw))
        return cache[key]
    return run


# (B, F, HW, C, heads, G): one ragged key tile (S = 20, D = 40), and S = 72:
# two key tiles and two query tiles, both ragged, at D = 24 (padded to 32)
SHAPE_ONE_TILE = (1, 5, 8, 2 * 40, 2, 4)
SHAPE_TWO_TILES = (1, 9, 16, 2 * 24, 2, 8)
FUSED_CASES = (
    [(SHAPE_ONE_TILE, kind, e, torch.bfloat16)
     for kind in ("block_diag", "random", "random_bf16", "minus_inf") for e in (False, True)]
    + [(SHAPE_TWO_TILES, kind, e, torch.bfloat16)
       for kind in ("random", "minus_inf") for e in (False, True)]
    + [(SHAPE_TWO_TILES, kind, e, torch.float32)
       for kind in ("block_diag", "random") for e in (False, True)])


@pytest.mark.parametrize("shape,kind,exp_bf16,dtype", FUSED_CASES)
def test_fused_tile_order_matches_plain_and_jax(jax_lab, shape, kind, exp_bf16, dtype):
    B, F, HW, C, heads, G = shape
    rng = np.random.default_rng(F * 100 + C)
    q, k, v = (_tensor(rng, (B, F, HW, C), dtype) for _ in range(3))
    bias = _bias(kind, G, F, seed=F + G)
    scale = (C // heads) ** -0.5
    got = emulate_fused(q, k, v, bias, scale, heads, G, exp_bf16)
    plain = kernels.fused_motion_attention_plain(q, k, v, bias, scale=scale, heads=heads, G=G,
                                                 exp_bf16=exp_bf16)
    want = jax_lab(jexp.fused_motion_attention, (shape, kind, exp_bf16, dtype), _jnp(q), _jnp(k),
                   _jnp(v), _jnp(bias), scale, heads, G=G, exp_bf16=exp_bf16)
    assert bool(torch.isfinite(got).all())
    _check(got, plain, dtype, exp_bf16)
    _check(got, want, dtype, exp_bf16)


# (B, F, HW, C, heads, G, HG): heads walked one and two at a time, frames on
# both sides of a 16-row tile, a padded head dim (24 -> 32)
DIAG_CASES = [((1, 16, 8, 4 * 40, 4), 4, 2, torch.bfloat16),
              ((1, 5, 8, 2 * 24, 2), 2, 1, torch.bfloat16),
              ((1, 20, 4, 2 * 40, 2), 4, 1, torch.bfloat16),
              ((1, 5, 8, 2 * 24, 2), 2, 2, torch.float32)]


@pytest.mark.parametrize("shape,G,HG,dtype", DIAG_CASES)
def test_diag_tile_order_matches_plain_and_jax(jax_lab, shape, G, HG, dtype):
    B, F, HW, C, heads = shape
    rng = np.random.default_rng(F * 100 + C + G)
    q, k, v = (_tensor(rng, (B, F, HW, C), dtype) for _ in range(3))
    scale = (C // heads) ** -0.5
    got = emulate_diag(q, k, v, scale, heads, G, HG)
    plain = kernels.diag_motion_attention_plain(q, k, v, scale=scale, heads=heads, G=G)
    want = jax_lab(jexp.diag_motion_attention, (shape, G, dtype), _jnp(q), _jnp(k), _jnp(v),
                   scale, heads, G=G)
    _check(got, plain, dtype)
    _check(got, want, dtype)


def test_exp_bf16_tile_rounds_as_the_plain_version():
    """With the max pass first, the emulated exp_bf16 tile rounds the same
    numbers as the plain version: at float32 inputs their outputs agree to
    float32 noise. Rounding bf16(x - m) against the running max of the key
    tiles seen so far (and rescaling by 2^(m_old - m_new) in float) would
    round other numbers and miss it by far more."""
    B, F, HW, C, heads, G = SHAPE_TWO_TILES
    rng = np.random.default_rng(5)
    q, k, v = (_tensor(rng, (B, F, HW, C), torch.float32) for _ in range(3))
    bias = _bias("random", G, F, seed=3)
    scale = (C // heads) ** -0.5
    got = emulate_fused(q, k, v, bias, scale, heads, G, True)
    plain = kernels.fused_motion_attention_plain(q, k, v, bias, scale=scale, heads=heads, G=G,
                                                 exp_bf16=True)
    assert (got - plain).abs().max().item() <= F32_TOL

    def pack(x):
        return x.reshape(B, F, HW // G, G, heads, C // heads).permute(0, 2, 4, 3, 1, 5).reshape(
            -1, heads, G * F, C // heads)

    x = pack(q) @ pack(k).transpose(-1, -2) * scale + bias[0]
    m = torch.full(x.shape[:-1], NEG_INF)
    l = torch.zeros(x.shape[:-1])
    o = torch.zeros(*x.shape[:-1], C // heads)
    for k0 in range(0, G * F, KEY_TILE):
        xt = x[..., k0:k0 + KEY_TILE]
        m_new = torch.maximum(m, xt.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = _round(torch.exp(_round(xt - m_new[..., None], torch.bfloat16)), torch.bfloat16)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + p @ pack(v)[..., k0:k0 + KEY_TILE, :]
        m = m_new
    running = (o / l[..., None]).reshape(B, HW // G, heads, G, F, C // heads).permute(
        0, 4, 1, 3, 2, 5).reshape(B, F, HW, C)
    assert (running - plain).abs().max().item() > 100 * F32_TOL


# the bf16 plans at the eight full-width motion sites (chip_smoke.LAB_SITES):
# L2 (heads a block, threads) by head dim; L3 heads staged at a time by G
FUSED_PLANS = {40: (2, 256), 80: (2, 256), 160: (1, 128)}
DIAG_PLANS = {40: {16: 1, 32: 1, 8: 2, 4: 4},
              80: {16: 1, 8: 1, 4: 2},
              160: {8: 1, 4: 1}}


@pytest.mark.parametrize("site,shape", chip_smoke.LAB_SITES)
def test_bf16_plans_at_motion_sites(site, shape):
    B, F, HW, C, heads = shape
    D = C // heads
    for bias_itemsize in (4, 2):
        hb, threads, smem = kernels.fused_motion_mma_plan(D, heads, bias_itemsize)
        assert (hb, threads) == FUSED_PLANS[D] and heads % hb == 0
        assert smem <= kernels.SMEM_LIMIT
    for G in motion_lab.DIAG_PACKS:
        if G not in DIAG_PLANS[D]:
            with pytest.raises(ValueError, match="shared memory"):
                kernels.diag_motion_mma_plan(G, F, D, heads)
            continue
        hg, smem = kernels.diag_motion_mma_plan(G, F, D, heads)
        assert hg == DIAG_PLANS[D][G] and heads % hg == 0
        assert smem == kernels._frame_stage_bytes(F, D, G, hg) <= kernels.SMEM_LIMIT


def _cuda_core_variants(shape):
    """The lab's variants at a site as the CUDA-core kernels of L2 and L3 fit
    a bfloat16 pack (the rule before L2 and L3 took the tensor cores)."""
    B, F, HW, C, heads = shape
    D = C // heads
    names = [n for n, _, _ in motion_lab.lab_variants(shape, 2)
             if not n.startswith(("fused", "diag"))]
    for G, e in motion_lab.FUSED_PACKS:
        if HW % G == 0 and kernels.fused_motion_smem_bytes(G, F, D, 2) <= kernels.SMEM_LIMIT:
            names.append(f"fused_G{G}" + ("_expbf16" if e else ""))
    for G in motion_lab.DIAG_PACKS:
        try:
            if HW % G == 0:
                kernels.diag_motion_plan(G, F, D, heads, 2)
                names.append(f"diag_G{G}")
        except ValueError:
            pass
    return names


@pytest.mark.parametrize("site,shape", chip_smoke.LAB_SITES)
def test_lab_keeps_every_variant_at_motion_sites(site, shape):
    got = [n for n, _, _ in motion_lab.lab_variants(shape, 2)]
    assert set(_cuda_core_variants(shape)) <= set(got)
    assert got[0] == motion_lab.BASELINE and len(got) == len(set(got))


@pytest.mark.parametrize("site,shape", chip_smoke.LAB_SITES)
def test_striped_v2_mma_plan_at_motion_sites(site, shape):
    """L1's bfloat16 plan admits every (G, R) of the lab that the CUDA-core
    bfloat16 kernel fit (its pack and float logits within a block's shared
    memory): one stage of the pack's q, k and v tiles with every head, the
    lab listing exactly the packs whose stage fits a block."""
    B, F, HW, C, heads = shape
    D = C // heads
    listed = {n for n, _, _ in motion_lab.lab_variants(shape, 2) if n.startswith("striped")}
    for G, R in motion_lab.V2_PACKS:
        if HW % G or (HW // G) % R:
            continue
        name = f"striped_v2_G{G}_R{R}"
        if kernels.striped_v2_smem_bytes(G, F, C, heads, 2) <= kernels.SMEM_LIMIT:
            assert name in listed
        stage = kernels._frame_stage_bytes(F, D, G, heads)
        if stage > kernels.SMEM_LIMIT:
            with pytest.raises(ValueError, match="shared memory"):
                kernels.striped_v2_mma_plan(G, F, D, heads)
            assert name not in listed
        else:
            assert kernels.striped_v2_mma_plan(G, F, D, heads) == stage and name in listed
    with pytest.raises(ValueError, match="frames"):
        kernels.striped_v2_mma_plan(1, kernels.FRAME_MAX_F + 1, D, heads)
