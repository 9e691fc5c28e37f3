"""The arithmetic of K4's and K6b's tensor-core tiles, emulated on the CPU.

In bfloat16, K4 (`kernels.frame_attention`) runs csrc/frame_attention.cu:
each (location, head) problem's frames padded with zero rows to FP (a
multiple of 16) and its head dim with zero columns to DP (a multiple of 16),
S = Q·Kᵀ in float32 over k-steps of 16 columns taken in order, keys past F
at the finite -1e30, an exact softmax of the whole row in log2 units, P
normalised and rounded once to bfloat16, O = P·V in float32. `emulate_frame`
repeats that order. K6b (`kernels.shared_bias_attention_folded`) runs
csrc/attn_mma.cuh:flash_tile_mma with SPLIT_P on folded rows: an online
softmax per 64-key tile in log2 units with the bias (float32 or bfloat16,
widened) times log2(e), P split exactly into bfloat16 hi + lo and both
multiplied by V each 16-key step, divided by the unrounded sum at the end,
lse = (m + log2 l) ln 2. `emulate_folded` repeats that order.

Both are held against the port's plain versions and the JAX package's
Pallas kernels in interpret mode (`temporal_packed_attention`,
`_flash_shared_bias`) on the same seeded inputs: float32 inputs within 1e-5,
bfloat16 outputs within a quarter of chip_smoke.py's phase-2 limit,
min(2e-2, 2**-5 x max|plain|); the float32 lse within 1e-5. K6b's
emulated bfloat16 output equals the plain version's in at least
chip_smoke.K5A_MATCH of the elements, the share phase 2 asks of the kernel.
Also K4's pack plan (`kernels.frame_attention_plan`) at the motion sites.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as nnf

from imagine360_tpu.ops.pallas_attention import _flash_shared_bias, temporal_packed_attention

from imagine360_tpu_torch.ops import kernels

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

K_STEP = 16                    # head-dim columns of one mma.sync k-step
KEY_TILE = 64                  # csrc/attn_mma.cuh kMmaBK
LOG2E = 1.4426950408889634
NEG_INF = -1e30                # csrc/attn_common.cuh kNegInf
F32_TOL = 1e-5
LSE_TOL = 1e-5


def _ceil16(n):
    return -(-n // 16) * 16


def _limit(want):
    """A quarter of chip_smoke.py's phase-2 limit of a bf16 output."""
    return 0.25 * chip_smoke.bf16_tol("frame_attention", want.float().abs().max().item())


def _kstep_dots(a, b, width):
    """a @ b^T in float32, summed over k-steps of 16 of `width` columns in
    order, as mma.sync accumulates them (a, b zero-padded to width)."""
    a = nnf.pad(a, (0, width - a.shape[-1]))
    b = nnf.pad(b, (0, width - b.shape[-1]))
    s = torch.zeros(*a.shape[:-1], b.shape[-2])
    for c in range(0, width, K_STEP):
        s = s + a[..., c:c + K_STEP] @ b[..., c:c + K_STEP].transpose(-1, -2)
    return s


def emulate_frame(q, k, v, scale, heads):
    """csrc/frame_attention.cu's order on q/k/v [B, F, HW, C]; returns
    [B, F, HW, C] in q.dtype."""
    B, F, HW, C = q.shape
    D = C // heads
    FP = _ceil16(F)

    def problems(x):     # [B, HW, heads, FP, D], frames past F zero
        x = x.float().reshape(B, F, HW, heads, D).permute(0, 2, 3, 1, 4)
        return nnf.pad(x, (0, 0, 0, FP - F))

    qf, kf, vf = problems(q), problems(k), problems(v)
    s = _kstep_dots(qf, kf, _ceil16(D)) * (scale * LOG2E)
    s[..., F:] = NEG_INF
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    p = p * (1.0 / p.sum(dim=-1, keepdim=True))
    p = p.to(v.dtype).float()
    o = (p @ vf)[..., :F, :].to(q.dtype)
    return o.permute(0, 3, 1, 2, 4).reshape(B, F, HW, C)


def emulate_folded(q, k, v, bias, scale):
    """flash_tile_mma<SPLIT_P>'s order on folded rows q [BH, Sq, D], k/v
    [BH, Sk, D] under bias [Sq, Sk]; returns (out in q.dtype, lse float32)."""
    D, Sk = q.shape[-1], k.shape[1]
    dp = next(b for b in (16, 32, 64, 96, 128, 160) if D <= b)
    s = _kstep_dots(q.float(), k.float(), dp)
    vf = v.float()
    m = torch.full(s.shape[:-1], NEG_INF)
    l = torch.zeros(s.shape[:-1])
    o = torch.zeros(*s.shape[:-1], D)
    for k0 in range(0, Sk, KEY_TILE):
        x = s[..., k0:k0 + KEY_TILE] * (scale * LOG2E) + bias[:, k0:k0 + KEY_TILE].float() * LOG2E
        m_new = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None]
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        for j in range(0, p.shape[-1], K_STEP):
            vj = vf[:, k0 + j:k0 + j + K_STEP]
            o = o + lo[..., j:j + K_STEP] @ vj
            o = o + hi[..., j:j + K_STEP] @ vj
        m = m_new
    l = torch.where(l == 0, torch.ones_like(l), l)
    lse = torch.where(m == NEG_INF, torch.full_like(m, NEG_INF), (m + torch.log2(l)) / LOG2E)
    return (o * (1.0 / l)[..., None]).to(q.dtype), lse


def _tensor(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _check(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= (F32_TOL if dtype == torch.float32 else _limit(want)), err


# (F, D, dtype): the motion modules' head dims, frame counts on both sides of
# a 16-key tile; float32 once per head dim
FRAME_CASES = ([(F, D, torch.bfloat16) for F in (5, 16, 33) for D in (40, 80, 160)]
               + [(F, D, torch.float32) for F, D in ((5, 40), (16, 80), (33, 160))])


@pytest.mark.parametrize("F,D,dtype", FRAME_CASES)
def test_frame_tile_order_matches_plain_and_jax(F, D, dtype):
    """One batch row of 4 locations, 2 heads; JAX packs 2 locations a grid
    step under its striped bias."""
    rng = np.random.default_rng(F * 1000 + D)
    heads, shape = 2, (1, F, 4, 2 * D)
    q, k, v = (_tensor(rng, shape, dtype) for _ in range(3))
    scale = D ** -0.5
    got = emulate_frame(q, k, v, scale, heads)
    plain = kernels.frame_attention_plain(q, k, v, scale=scale, heads=heads)
    jax_out = temporal_packed_attention(_jnp(q), _jnp(k), _jnp(v), scale, heads, 2,
                                        interpret=True)
    _check(got, plain, dtype)
    _check(got, torch.from_numpy(np.array(jax_out.astype(jnp.float32))), dtype)


# (BH, Sq, Sk, D): ragged tails of the 64-key tile at the WarpAttn head dim,
# a padded one (40 -> 64)
FOLDED_SHAPES = [(2, 64, 512, 32), (3, 70, 150, 40)]


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,Sq,Sk,D", FOLDED_SHAPES)
def test_folded_tile_order_matches_plain_and_jax(BH, Sq, Sk, D, bias_dtype):
    rng = np.random.default_rng(BH * Sq + Sk)
    q = _tensor(rng, (BH, Sq, D), torch.bfloat16)
    k, v = (_tensor(rng, (BH, Sk, D), torch.bfloat16) for _ in range(2))
    bias = torch.from_numpy(rng.uniform(-1, 1, (Sq, Sk)).astype(np.float32)).to(bias_dtype)
    scale = D ** -0.5
    got, got_lse = emulate_folded(q, k, v, bias, scale)
    plain, plain_lse = kernels.shared_bias_attention_folded_plain(q, k, v, bias, scale=scale,
                                                                  with_lse=True)
    assert torch.equal(plain, kernels.shared_bias_attention_folded_plain(q, k, v, bias,
                                                                         scale=scale))
    jax_out, jax_lse = _flash_shared_bias(_jnp(q), _jnp(k), _jnp(v), _jnp(bias), scale,
                                          block_q=128, block_k=128, interpret=True,
                                          with_lse=True)
    jax_out = torch.from_numpy(np.array(jax_out.astype(jnp.float32)))
    jax_lse = torch.from_numpy(np.array(jax_lse))[:, :Sq, 0]
    _check(got, plain, torch.bfloat16)
    _check(got, jax_out, torch.bfloat16)
    assert (got_lse - plain_lse).abs().max().item() <= LSE_TOL
    assert (got_lse - jax_lse).abs().max().item() <= LSE_TOL
    assert (got == plain).float().mean().item() >= chip_smoke.K5A_MATCH


@pytest.mark.parametrize("site,shape,plan", [
    ("motion_pers_s0", (40, 16, 1024, 320, 8), (1, 8)),
    ("motion_pano_s0", (2, 16, 8192, 320, 8), (1, 8)),
    ("motion_pers_s1", (40, 16, 256, 640, 8), (1, 4)),
    ("motion_pers_s2", (40, 16, 64, 1280, 8), (1, 2)),
    ("tiny", (2, 5, 17, 3, 3), (8, 3)),
    ("frames_64", (1, 64, 9, 1280, 8), (1, 1))])
def test_frame_attention_plan(site, shape, plan):
    """The plan packs all heads of a location before more locations and
    stays within FRAME_STAGE_BYTES a stage where any pack does; the blocks
    cover every pack, and a block slot takes at most FRAME_WAVES + 1 of
    them in turn."""
    B, F, HW, C, heads = shape
    D = C // heads
    G, HG, R = kernels.frame_attention_plan(B, F, HW, heads, D, 132)
    assert (G, HG) == plan and heads % HG == 0
    stage = 3 * _ceil16(F) * (G * HG * _ceil16(D) + 8) * 2
    assert stage <= kernels.FRAME_STAGE_BYTES or (G, HG) == (1, 1)
    packs = B * -(-HW // G) * (heads // HG)
    blocks = -(-packs // R)
    assert blocks * R >= packs > (blocks - 1) * R
    slots = 132 * min(16, kernels.SM_SHARED_BYTES // (2 * stage + 1024))
    assert blocks <= slots * (kernels.FRAME_WAVES + 1)
