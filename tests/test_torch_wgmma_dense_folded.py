"""K7's persistent `wgmma` GEMM and K6b's biased D = 32 `wgmma` body,
emulated on the CPU, their plans and the rules that send launches to them.

In bfloat16 with nn.Linear's [M, K] weight, K and M multiples of 8 and
16-byte-aligned pointers, `kernels.dense_matmul` (K7) runs
csrc/dense_matmul.cu:dense_matmul_wgmma_kernel: 128 x 160 output tiles
(`kernels.dense_wgmma_plan`), walked by a persistent grid
(`kernels.dense_wgmma_walk`), each summing x·wᵀ over K in 64-element slabs
in float32 and rounding once to bfloat16. At head dim 32 under a bias TMA
can take, `kernels.shared_bias_attention_folded` (K6b) runs
csrc/attn_wgmma_bias.cuh: 64-key tiles, the logit and the bias in one FFMA
(x = s·scale + bias, natural units), the row max there, p = 2^(x·log2 e -
m·log2 e) (ex2.approx.ftz: results below 2**-126 flushed), the sum over the
unrounded p, P·V on the exact split hi = bf16(p), lo = bf16(p - hi), four
folded rows under one bias tile. `emulate_dense` and `emulate_folded`
repeat those orders in torch.

They are held, on seeded inputs made with numpy, against the JAX package's
Pallas kernels in interpret mode (`_pallas_matmul`, `_flash_shared_bias`),
as the JAX package's tests run them, and against the port's plain versions:
float32 inputs (bfloat16-representable, as the kernels read them) within
1e-5 x max|out| for K7 and 1e-4 x max|out| for K6b (whose P is split into
two bfloat16 parts), the lse within 1e-4; K6b's bfloat16 output equals the
plain version's in at least chip_smoke.K5A_MATCH of its elements, with a
float32 and a bfloat16 bias, with and without the lse. They also pin the
plan at every K7 shape of chip_smoke.py and of a phase-7 step, the rules at
every K6b and K7 site and their refusals, the CPU path (no launch) and
chip_smoke's check of the rules by shape.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagine360_tpu.ops.pallas_attention import _flash_shared_bias
from imagine360_tpu.ops.pallas_dense import _pallas_matmul

from imagine360_tpu_torch.ops import kernels
from imagine360_tpu_torch.presets import full_dual_config

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

K_SLAB = 64                    # csrc/dense_matmul.cu K7W_BK: K elements of a slab
KEY_TILE = 64                  # csrc/attn_wgmma_bias.cuh kFbBK
T_ROWS = 4                     # csrc/attn_wgmma_bias.cuh kFbT
LOG2E = 1.4426950408889634
NEG_INF = -1e30                # csrc/attn_common.cuh kNegInf
FTZ = 2.0 ** -126              # ex2.approx.ftz flushes results below this to 0
DENSE_F32_REL = 1e-5           # K7, float32 inputs: another summation order
FOLDED_F32_REL = 1e-4          # K6b, float32 inputs: P split into two bf16 parts
LSE_TOL = 1e-4                 # chip_smoke.LSE_TOL


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()


def _np(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# ---- K7 --------------------------------------------------------------------


def phase7_dense_shapes():
    """{(N, K, M)}: MMDense's shapes in one opt-in step of full_dual_config,
    proj_in / proj_out of the spatial transformers and motion modules at
    every stage: N = CFG 2 x views x 16 frames x tokens (the pano: 2 x 16 x
    tokens), K = M = the stage's channels."""
    cfg = full_dual_config("bfloat16")
    views, frames = 20, 16
    shapes = set()
    for (h, w), batch in (((32, 32), 2 * views * frames), ((64, 128), 2 * frames)):
        for s, c in enumerate(cfg.pers.block_out_channels):
            shapes.add((batch * (h >> s) * (w >> s), c, c))
    return shapes


DENSE_SITES = {shape: site for name, site, shape in chip_smoke.SITES if name == "dense_matmul"}
PLAN_SHAPES = sorted(phase7_dense_shapes() | set(DENSE_SITES) | {(1, 8, 8), (300, 72, 200),
                                                                 (2000, 320, 1000)})


def test_phase7_shapes_are_phase2_sites():
    """Every K7 shape of a phase-7 step has a phase-2 site (the four with
    the most time and the four that carry the step's other 48 launches)."""
    assert phase7_dense_shapes() <= set(DENSE_SITES)
    assert len(phase7_dense_shapes()) == 8


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("N,K,M", PLAN_SHAPES)
def test_dense_plan_walks_every_tile_once(N, K, M, sms):
    """The blocks of the plan's grid take every (row tile, column tile)
    exactly once; the tile order is row major, so the column tiles of a row
    tile come consecutively (the blocks in flight share its x rows); the
    tile's 160 columns divide M at every model shape (no padded column
    tile)."""
    plan = kernels.dense_wgmma_plan(N, K, M, sms)
    bm = kernels.DENSE_WGMMA_BM
    if (N, K, M) in phase7_dense_shapes() or (N, K, M) in DENSE_SITES:
        assert M % bm == 0 or DENSE_SITES.get((N, K, M)) == "dense_ragged"
    assert plan["row_tiles"] == -(-N // kernels.DENSE_WGMMA_BN)
    assert plan["col_tiles"] == -(-M // bm) and plan["grid"] == min(plan["tiles"], sms)
    seen = []
    for b in range(plan["grid"]):
        walk = kernels.dense_wgmma_walk(plan, b)
        assert walk == sorted(walk)
        seen += walk
    assert sorted(seen) == [(r, c) for r in range(plan["row_tiles"])
                            for c in range(plan["col_tiles"])]
    order = sorted(seen, key=lambda rc: rc[0] * plan["col_tiles"] + rc[1])
    assert all(b == (a[0], a[1] + 1) or b == (a[0] + 1, 0) for a, b in zip(order, order[1:]))


def emulate_dense(x, w):
    """dense_matmul_wgmma_kernel's order: x [N, K] @ w[M, K]ᵀ summed in
    float32 over 64-element K slabs taken in order (zeros past K), rounded
    once to x.dtype."""
    acc = torch.zeros(x.shape[0], w.shape[0])
    for k0 in range(0, x.shape[1], K_SLAB):
        acc = acc + x[:, k0:k0 + K_SLAB].float() @ w[:, k0:k0 + K_SLAB].float().t()
    return acc.to(x.dtype)


@pytest.fixture(scope="module")
def jax_dense():
    """{(N, K, M): (x, w [M, K] bf16, Pallas out f32 inputs, out bf16 inputs)},
    `_pallas_matmul` (x @ [K, M]) in interpret mode."""
    outs = {}
    for N, K, M in DENSE_CASES:
        rng = np.random.default_rng(N + K + M)
        x, w = _bf16(rng, N, K), _bf16(rng, M, K)
        wt = w.float().t().contiguous()
        f32 = _pallas_matmul(jnp.asarray(x.float().numpy()), jnp.asarray(wt.numpy()),
                             interpret=True)
        b16 = _pallas_matmul(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                             jnp.asarray(wt.numpy()).astype(jnp.bfloat16), interpret=True)
        outs[(N, K, M)] = x, w, _np(f32), _np(b16)
    return outs


# (N, K, M): K one slab and several, a partial last slab (72 is no multiple
# of 64); N a multiple of 128 (the Pallas plan's rows)
DENSE_CASES = [(256, 320, 320), (128, 72, 160), (384, 640, 256)]


@pytest.mark.parametrize("N,K,M", DENSE_CASES)
def test_dense_slab_order_matches_plain_and_jax(N, K, M, jax_dense):
    """float32 inputs: the emulated slab order, the plain version and the
    Pallas kernel within 1e-5 x max|out| of each other; bfloat16 inputs: the
    emulated output within one bf16 ulp of the largest output (phase 2's
    limit) of the plain version's and the Pallas kernel's."""
    x, w, ref32, ref16 = jax_dense[(N, K, M)]
    got32 = emulate_dense(x.float(), w.float())
    want32 = kernels.dense_matmul_plain(x.float(), w.float(), linear_layout=True)
    assert _rel_err(got32, want32) <= DENSE_F32_REL and _rel_err(got32, ref32) <= DENSE_F32_REL
    got = emulate_dense(x, w)
    want = kernels.dense_matmul_plain(x, w, linear_layout=True)
    assert got.dtype == torch.bfloat16 and got.shape == (N, M)
    assert _rel_err(got, want) <= chip_smoke.DENSE_BF16_REL
    assert _rel_err(got, ref16) <= chip_smoke.DENSE_BF16_REL


# ---- K6b -------------------------------------------------------------------


def _fma(a, b, c):
    """a·b + c rounded once to float32 (the product of two floats is exact
    in float64)."""
    return (a.double() * b + c.double()).float()


def _ex2(x):
    p = torch.exp2(x)
    return torch.where(p < FTZ, torch.zeros_like(p), p)


def emulate_folded(q, k, v, bias, scale, with_lse=False, split_p=True):
    """attn_wgmma_bias_tile's order on folded rows q [BH, Sq, 32], k/v
    [BH, Sk, 32] under bias [Sq, Sk], T_ROWS rows a block (rows are
    independent: the grouping moves no rounding); returns out in q.dtype
    (and the float32 lse). Without `split_p` P·V takes hi alone (P rounded
    once to bf16: the body's SPLIT_P off, as K3 instantiates it)."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    outs, lses = [], []
    for g0 in range(0, BH, T_ROWS):
        qf, kf, vf = (x[g0:g0 + T_ROWS].float() for x in (q, k, v))
        s = qf @ kf.transpose(1, 2)
        m = torch.full(s.shape[:-1], NEG_INF)
        l = torch.zeros(s.shape[:-1])
        o = torch.zeros(*s.shape[:-1], D)
        for k0 in range(0, Sk, KEY_TILE):
            x = _fma(s[..., k0:k0 + KEY_TILE], scale, bias[:, k0:k0 + KEY_TILE].float())
            m_new = torch.maximum(m, x.amax(dim=-1))
            alpha = _ex2((m - m_new) * LOG2E)
            p = _ex2(_fma(x, LOG2E, -(m_new * LOG2E)[..., None]))
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None]
            hi = p.bfloat16().float()
            lo = (p - hi).bfloat16().float()
            for j in range(0, p.shape[-1], 16):
                vj = vf[:, k0 + j:k0 + j + 16]
                if split_p:
                    o = o + lo[..., j:j + 16] @ vj
                o = o + hi[..., j:j + 16] @ vj
            m = m_new
        l = torch.where(l == 0, torch.ones_like(l), l)
        outs.append((o * (1.0 / l)[..., None]).to(q.dtype))
        lses.append(torch.where(m == NEG_INF, torch.full_like(m, NEG_INF),
                                m + torch.log2(l) * 0.6931471805599453))
    out, lse = torch.cat(outs), torch.cat(lses)
    return (out, lse) if with_lse else out


# (BH, Sq, Sk): ragged BH against four rows a block, ragged query and key
# tails against the 128-row and 64-key tiles
FOLDED_CASES = [(5, 70, 200), (4, 130, 64), (2, 33, 336)]


@pytest.fixture(scope="module")
def jax_folded():
    """{(BH, Sq, Sk, bias dtype): (q, k, v, bias, Pallas out, lse)} on
    float32 inputs (bfloat16-representable) in interpret mode."""
    outs = {}
    for BH, Sq, Sk in FOLDED_CASES:
        for bias_dtype in (torch.float32, torch.bfloat16):
            rng = np.random.default_rng(BH * Sq + Sk)
            q, k, v = (_bf16(rng, BH, S, 32).float() for S in (Sq, Sk, Sk))
            bias = torch.from_numpy(rng.uniform(-1, 1, (Sq, Sk)).astype(np.float32)).to(
                bias_dtype)
            jb = jnp.asarray(bias.float().numpy())
            if bias_dtype == torch.bfloat16:
                jb = jb.astype(jnp.bfloat16)
            out, lse = _flash_shared_bias(*(jnp.asarray(x.numpy()) for x in (q, k, v)), jb,
                                          32 ** -0.5, block_q=128, block_k=128,
                                          interpret=True, with_lse=True)
            outs[(BH, Sq, Sk, bias_dtype)] = (q, k, v, bias, _np(out),
                                              torch.from_numpy(np.array(lse))[:, :Sq, 0])
    return outs


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,Sq,Sk", FOLDED_CASES)
def test_folded_order_matches_plain_and_jax(BH, Sq, Sk, bias_dtype, jax_folded):
    """float32 inputs: the emulated order within 1e-4 x max|out| of the
    Pallas kernel's and the plain version's output, the lse within 1e-4 of
    both; and the same inputs in bfloat16 within chip_smoke.py's phase-2
    limit of the plain version's."""
    q, k, v, bias, ref, ref_lse = jax_folded[(BH, Sq, Sk, bias_dtype)]
    scale = 32 ** -0.5
    got, lse = emulate_folded(q, k, v, bias, scale, with_lse=True)
    want, want_lse = kernels.shared_bias_attention_folded_plain(q, k, v, bias, scale=scale,
                                                                with_lse=True)
    assert got.shape == q.shape and lse.shape == (BH, Sq)
    assert _rel_err(got, want) <= FOLDED_F32_REL and _rel_err(got, ref) <= FOLDED_F32_REL
    assert (lse - want_lse).abs().max().item() <= LSE_TOL
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    got16 = emulate_folded(qb, kb, vb, bias, scale)
    want16 = kernels.shared_bias_attention_folded_plain(qb, kb, vb, bias, scale=scale)
    err = (got16.float() - want16.float()).abs().max().item()
    assert got16.dtype == torch.bfloat16
    assert err <= chip_smoke.bf16_tol("shared_bias_attention_folded",
                                      want16.float().abs().max().item())


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_folded_bf16_matches_plain_bit_for_bit(bias_dtype, with_lse):
    """4 folded rows of 64 queries against 2048 keys (the r2 sites' keys
    reduced), bfloat16: the emulated body's output equals the plain
    version's bit for bit in at least K5A_MATCH of its elements, the share
    phase 2 asks of the kernel; its lse (with_lse) within 1e-4."""
    rng = np.random.default_rng(2048 + with_lse)
    q, k, v = _bf16(rng, 4, 64, 32), _bf16(rng, 4, 2048, 32), _bf16(rng, 4, 2048, 32)
    bias = torch.from_numpy(rng.uniform(-1, 1, (64, 2048)).astype(np.float32)).to(bias_dtype)
    kw = dict(scale=32 ** -0.5, with_lse=with_lse)
    got = emulate_folded(q, k, v, bias, **kw)
    want = kernels.shared_bias_attention_folded_plain(q, k, v, bias, **kw)
    if with_lse:
        (got, lse), (want, want_lse) = got, want
        assert (lse - want_lse).abs().max().item() <= LSE_TOL
    assert (got == want).float().mean().item() >= chip_smoke.K5A_MATCH


# ---- routes ----------------------------------------------------------------


def test_routes_at_every_site():
    """K7: every phase-2 site but the ragged one (K = 77, M = 321) and every
    phase-7 shape takes the wgmma GEMM; K6b: every phase-2 site (float32 and
    bfloat16 bias) and the six masks phase 7 drives its entry point on
    (r2, r4, r8, both directions, bfloat16) take the wgmma body."""
    for name, site, shape in chip_smoke.SITES:
        if name == "dense_matmul":
            N, K, M = shape
            assert kernels.dense_wgmma_route(torch.bfloat16, K, M, True) == (site != "dense_ragged")
            assert chip_smoke.shape_routed(kernels, name, shape) == (site != "dense_ragged")
        if name == "shared_bias_attention_folded":
            BH, Sq, Sk, D = shape
            assert kernels.folded_wgmma_route(torch.bfloat16, Sk, D,
                                              chip_smoke.site_bias_dtype(site))
            assert chip_smoke.shape_routed(kernels, name, shape,
                                           bias_dtype=chip_smoke.site_bias_dtype(site))
    for N, K, M in phase7_dense_shapes():
        assert chip_smoke.shape_routed(kernels, "dense_matmul", (N, K, M))
    for Sq, Sk in ((2048, 5120), (5120, 2048), (512, 1280), (1280, 512), (128, 320), (320, 128)):
        assert kernels.folded_wgmma_route(torch.bfloat16, Sk, 32, torch.bfloat16,
                                          (0, 0, 0, 0, 0))
        assert chip_smoke.shape_routed(kernels, "shared_bias_attention_folded", (320, Sq, Sk, 32))


def test_routes_refuse_what_the_bodies_do_not_take():
    """float32, another head dim, a bias row that is no multiple of 16
    bytes, an unaligned pointer (K6b); float32, a [K, M] weight, K or M no
    multiple of 8, an unaligned pointer (K7): the mma.sync bodies or the
    CUDA cores."""
    bf, f32 = torch.bfloat16, torch.float32
    assert not kernels.folded_wgmma_route(f32, 2048, 32, f32)
    assert not kernels.folded_wgmma_route(bf, 2048, 64, f32)
    assert not kernels.folded_wgmma_route(bf, 2046, 32, f32)
    assert kernels.folded_wgmma_route(bf, 2044, 32, f32)
    assert not kernels.folded_wgmma_route(bf, 2044, 32, bf)
    assert not kernels.folded_wgmma_route(bf, 2048, 32, bf, (0, 0, 0, 0, 2))
    assert not kernels.dense_wgmma_route(f32, 320, 320, True)
    assert not kernels.dense_wgmma_route(bf, 320, 320, False)
    assert not kernels.dense_wgmma_route(bf, 77, 320, True)
    assert not kernels.dense_wgmma_route(bf, 320, 321, True)
    assert not kernels.dense_wgmma_route(bf, 320, 320, True, (0, 8, 0))
    assert kernels.dense_wgmma_route(bf, 8, 8, True, (16, 32, 48))
    assert not chip_smoke.shape_routed(kernels, "dense_matmul", (1000, 77, 321))
    assert not chip_smoke.shape_routed(kernels, "shared_bias_attention_folded", (8, 64, 333, 32))
    assert not chip_smoke.shape_routed(kernels, "shared_bias_attention_folded", (8, 64, 330, 32),
                                       bias_dtype=f32)


def test_plain_path_counts_no_wgmma_launch_k6b_k7():
    """On the CPU K6b and K7 run their plain versions: one plain call each,
    no launch, no wgmma launch."""
    rng = np.random.default_rng(5)
    q, k = _bf16(rng, 2, 64, 32), _bf16(rng, 2, 128, 32)
    bias = torch.zeros(64, 128)
    kernels.reset_counts()
    kernels.shared_bias_attention_folded(q, k, k, bias, scale=0.2)
    kernels.dense_matmul(_bf16(rng, 64, 320), _bf16(rng, 320, 320), linear_layout=True)
    assert set(kernels.wgmma_counts().values()) == {0}
    assert kernels.shared_bias_attention_folded.plain_calls == kernels.dense_matmul.plain_calls == 1
    assert kernels.shared_bias_attention_folded.launches == kernels.dense_matmul.launches == 0


def test_chip_smoke_rule_by_shape_k6b_k7():
    """chip_smoke.wgmma_expected counts, from the launches by shape, K7's at
    the model shapes (all of them) and none at the ragged one, K6b's at the
    WarpAttn shapes."""
    kernels.reset_counts()
    try:
        kernels.dense_matmul.shape_launches.update({(655360, 320, 320): 20,
                                                    (4096, 1280, 1280): 4,
                                                    (1000, 77, 321): 3})
        kernels.shared_bias_attention_folded.shape_launches.update({(320, 2048, 5120, 32): 1,
                                                                    (1280, 128, 320, 32): 2})
        assert chip_smoke.wgmma_expected(kernels) == {"tiny_attention": 0,
                                                      "mh_flash_attention": 0,
                                                      "flash_attention_lse": 0,
                                                      "flash_attention_t": 0,
                                                      "shared_bias_attention_folded": 3,
                                                      "dense_matmul": 24, "flash_bwd_dq": 0,
                                                      "flash_bwd_dkv": 0,
                                                      "shared_bias_attention": 0}
    finally:
        kernels.reset_counts()
