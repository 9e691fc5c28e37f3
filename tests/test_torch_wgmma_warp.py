"""K3's and K6a's WarpAttn launches on the biased D = 32 `wgmma` body,
emulated on the CPU, and the rules that send them there.

In bfloat16 at head dim 32 under one float32 bias whose rows are
multiples of 16 bytes, with 16-byte-aligned pointers,
`kernels.shared_bias_attention` (K3, `kernels.shared_bias_wgmma_route`) runs
csrc/attn_wgmma_bias.cuh in its natural layout: q [B, Sq, H, 32] read
through 4-D tensor maps {32, H, S, B}, row slot g = b·H + h at coordinates
(0, g % H, s, g / H), the lse [B, H, Sq]. Under a bias shared by every
batch row and head, with Sq and Sk multiples of 8,
`kernels.flash_attention_t` (K6a, `kernels.flash_t_bias_wgmma_route`) runs
the same body on sequence-minor tiles: q [B, H, 32, Sq], row slot g the
(g // H, g % H) slab, Q and K MN-major. Both take K6b's arithmetic
(`test_torch_wgmma_dense_folded.emulate_folded`): 64-key tiles, the logit
and the bias in one FFMA, p = 2^(x·log2 e - m·log2 e) flushed below
2**-126, the sum over the unrounded p, four rows a block; K6a's P·V on the
exact split hi = bf16(p), lo = bf16(p - hi) (its TPU kernel keeps P in
float32), K3's on hi alone (its TPU kernel, `_shared_bias_kernel_t`, rounds
P to the inputs' bfloat16 before P·V). `emulate_natural` and
`emulate_seq_minor` gather the rows as the kernels' maps address them and
apply that order.

They are held, on seeded inputs made with numpy, against the JAX package's
Pallas kernels in interpret mode, as the JAX package's tests run them
(`_flash_shared_bias_t` with its lse for K3 on bfloat16 inputs,
`_flash_bhds` for K6a), and against the port's plain versions: bfloat16
inputs within chip_smoke.py's phase-2 limit, the lse within 1e-4; K6a's
float32 inputs (bfloat16-representable, as the kernels read them) within
1e-4 x max|out|, and its bfloat16 output equal to the plain version's bit
for bit in at least chip_smoke.K5A_MATCH of the elements at 2048 keys. K3's
plain version rounds the normalised P to bfloat16, the body the
unnormalised one, so no K3 body keeps K5A_MATCH of its bits; the test says
so with the shares. They pin both rules at every WarpAttn shape of
full_dual_config (the denoise step, the training step, a rank's views at
W = 2, 4, 5, 10 and 20 and a rank's pano rows at W = 2 and 4, the bias a
row block of the whole one), the refusals, the CPU path and chip_smoke's
rule by shape.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagine360_tpu.ops.pallas_attention import _flash_bhds, _flash_shared_bias_t

from imagine360_tpu_torch.models.dual import warp_sites
from imagine360_tpu_torch.ops import kernels
from imagine360_tpu_torch.presets import full_dual_config

from test_torch_wgmma_dense_folded import emulate_folded

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

D = 32                         # csrc/attn_wgmma_bias.cuh kFbD
SCALE = D ** -0.5
F32_REL = 1e-4                 # float32 inputs: P split into two bf16 parts
LSE_TOL = 1e-4                 # chip_smoke.LSE_TOL


def _f32(rng, *shape):
    """float32 values that bfloat16 holds exactly (the kernels read bf16)."""
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16().float()


def _bias(rng, Sq, Sk):
    return torch.from_numpy(rng.uniform(-1, 1, (Sq, Sk)).astype(np.float32))


def _np(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _err(got, want):
    return (got.float() - want.float()).abs().max().item()


def emulate_natural(q, k, v, bias, scale, with_lse=False, split_p=False):
    """shared_bias_wgmma_kernel's order on q [B, Sq, H, 32], k/v
    [B, Sk, H, 32]: row slot g reads head g % H of batch row g // H (its
    4-D maps' coordinates (0, g % H, s, g / H)), each slot's arithmetic
    emulate_folded's with P rounded once (`split_p` False, as K3 builds it);
    returns out [B, Sq, H, 32] (and the lse [B, H, Sq])."""
    B, Sq, H, _ = q.shape
    rows = lambda x: torch.stack([x[g // H, :, g % H] for g in range(B * H)])
    res = emulate_folded(rows(q), rows(k), rows(v), bias, scale, with_lse, split_p)
    out, lse = res if with_lse else (res, None)
    out = out.view(B, H, Sq, D).permute(0, 2, 1, 3)
    return (out, lse.view(B, H, Sq)) if with_lse else out


def emulate_seq_minor(q, k, v, bias, scale):
    """flash_t_bias_wgmma_kernel's order on q [B, H, 32, Sq], k/v
    [B, H, 32, Sk]: row slot g is slab g of the [B·H, 32, S] maps, its
    tiles read MN-major (each logit stays one float32 sum of 32 products:
    the operands' majorness moves no rounding); returns [B, H, Sq, 32]."""
    B, H, _, Sq = q.shape
    rows = lambda x: x.reshape(B * H, D, -1).transpose(1, 2)
    return emulate_folded(rows(q), rows(k), rows(v), bias, scale).view(B, H, Sq, D)


# (B, H, Sq, Sk): B·H against the body's four rows a block (5, 9, 4), ragged
# query tails against its 128-row tiles and key tails against its 64-key
# tiles; K3's Sk multiples of 4 (float32 bias rows of 16 bytes), K6a's Sq
# and Sk multiples of 8
K3_CASES = [(1, 5, 70, 200), (3, 3, 130, 336), (2, 2, 33, 64)]
K6A_CASES = [(1, 3, 72, 200), (3, 3, 136, 64), (1, 5, 8, 336)]


@pytest.fixture(scope="module")
def jax_k3():
    """{case: (q, k, v [B, S, H, 32] bfloat16, bias, Pallas out
    [B, Sq, H, 32], lse [B, H, Sq])}: `_flash_shared_bias_t` on the
    [B·H, 32, S] fold with the transposed bias, bfloat16, in interpret
    mode."""
    outs = {}
    for B, H, Sq, Sk in K3_CASES:
        rng = np.random.default_rng(B * Sq + Sk)
        q, k, v = (_f32(rng, B, S, H, D).bfloat16() for S in (Sq, Sk, Sk))
        bias = _bias(rng, Sq, Sk)
        fold = lambda x: jnp.asarray(x.float().permute(0, 2, 3, 1).reshape(B * H, D, -1)
                                     .numpy()).astype(jnp.bfloat16)
        out, lse = _flash_shared_bias_t(fold(q), fold(k), fold(v), jnp.asarray(bias.T.numpy()),
                                        SCALE, block_q=128, block_k=128, t_rows=4,
                                        interpret=True, with_lse=True)
        outs[(B, H, Sq, Sk)] = (q, k, v, bias,
                                _np(out).view(B, H, D, Sq).permute(0, 3, 1, 2),
                                _np(lse)[:, 0, :Sq].view(B, H, Sq))
    return outs


@pytest.fixture(scope="module")
def jax_k6a():
    """{case: (q, k, v [B, H, 32, S], bias [1, 1, Sq, Sk], Pallas out
    [B, H, Sq, 32])}: `_flash_bhds` in interpret mode."""
    outs = {}
    for B, H, Sq, Sk in K6A_CASES:
        rng = np.random.default_rng(3 * Sq + Sk)
        q, k, v = _f32(rng, B, H, D, Sq), _f32(rng, B, H, D, Sk), _f32(rng, B, H, D, Sk)
        bias = _bias(rng, Sq, Sk)[None, None]
        out = _flash_bhds(*(jnp.asarray(x.numpy()) for x in (q, k, v, bias)), SCALE,
                          block_q=128, block_k=128, interpret=True)
        outs[(B, H, Sq, Sk)] = (q, k, v, bias, _np(out))
    return outs


@pytest.mark.parametrize("B,H,Sq,Sk", K3_CASES)
def test_k3_natural_order_matches_plain_and_jax(B, H, Sq, Sk, jax_k3):
    """K3, bfloat16: the emulated order (P rounded once) within
    chip_smoke.py's phase-2 limit of the Pallas kernel's and the plain
    version's output, the lse within 1e-4 of both; the output is the same
    with and without the lse."""
    q, k, v, bias, ref, ref_lse = jax_k3[(B, H, Sq, Sk)]
    got, lse = emulate_natural(q, k, v, bias, SCALE, with_lse=True)
    want, want_lse = kernels.shared_bias_attention_plain(q, k, v, bias, scale=SCALE,
                                                         with_lse=True)
    assert got.shape == q.shape and got.dtype == torch.bfloat16 and lse.shape == (B, H, Sq)
    for w in (want, ref):
        assert _err(got, w) <= chip_smoke.bf16_tol("shared_bias_attention",
                                                   w.float().abs().max().item())
    assert _err(lse, want_lse) <= LSE_TOL and _err(lse, ref_lse) <= LSE_TOL
    assert torch.equal(got, emulate_natural(q, k, v, bias, SCALE))


@pytest.mark.parametrize("B,H,Sq,Sk", K6A_CASES)
def test_k6a_seq_minor_order_matches_plain_and_jax(B, H, Sq, Sk, jax_k6a):
    """K6a: float32 inputs, the emulated order within 1e-4 x max|out| of
    `_flash_bhds`'s and the plain version's output; in bfloat16 within the
    phase-2 limit of the plain version's."""
    q, k, v, bias, ref = jax_k6a[(B, H, Sq, Sk)]
    got = emulate_seq_minor(q, k, v, bias[0, 0], SCALE)
    want = kernels.flash_attention_t_plain(q, k, v, bias, scale=SCALE)
    assert got.shape == (B, H, Sq, D)
    assert _rel_err(got, want) <= F32_REL and _rel_err(got, ref) <= F32_REL
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    got16 = emulate_seq_minor(qb, kb, vb, bias[0, 0], SCALE)
    want16 = kernels.flash_attention_t_plain(qb, kb, vb, bias, scale=SCALE)
    assert got16.dtype == torch.bfloat16
    assert _err(got16, want16) <= chip_smoke.bf16_tol("flash_attention_t",
                                                      want16.float().abs().max().item())


def test_k6a_bf16_matches_plain_bit_for_bit():
    """3 (batch, head) rows of 64 queries against 2048 keys (the r2 sites'
    keys reduced), bfloat16: K6a's emulated body (P split) equals its plain
    version (P float32) bit for bit in at least K5A_MATCH of its elements,
    the share phase 2 asks of it."""
    rng = np.random.default_rng(2048)
    bias = _bias(rng, 64, 2048)
    q, k, v = (_f32(rng, 1, 3, D, S).bfloat16() for S in (64, 2048, 2048))
    got = emulate_seq_minor(q, k, v, bias, SCALE)
    want = kernels.flash_attention_t_plain(q, k, v, bias[None, None], scale=SCALE)
    assert (got == want).float().mean().item() >= chip_smoke.K5A_MATCH


@pytest.mark.parametrize("Sk", [320, 2048, 5120])
def test_k3_share_of_equal_bits(Sk):
    """Why phase 2 logs K3's share and does not hold it to K5A_MATCH: K3's
    plain version (and its TPU kernel) round P to bfloat16, the normalised
    P, before P·V; the body rounds the unnormalised P. At the WarpAttn keys
    the body (P rounded once) keeps 45-60% of the plain version's bits, a
    split P no more than 65%, while the split keeps K5A_MATCH against
    the same function with P in float32 (K5a's plain version); every output
    stays within the phase-2 limit."""
    rng = np.random.default_rng(Sk)
    q, k, v = (_f32(rng, 1, S, 4, D).bfloat16() for S in (128, Sk, Sk))
    bias = _bias(rng, 128, Sk)
    want = kernels.shared_bias_attention_plain(q, k, v, bias, scale=SCALE)
    once, split = (emulate_natural(q, k, v, bias, SCALE, split_p=s) for s in (False, True))
    share = lambda got, w: (got == w).float().mean().item()
    assert 0.45 <= share(once, want) <= 0.6 and share(split, want) <= 0.65
    f32_p, _ = kernels.flash_attention_lse_plain(q, k, v, bias[None, None], scale=SCALE)
    assert share(split, f32_p) >= chip_smoke.K5A_MATCH
    assert _err(once, want) <= chip_smoke.bf16_tol("shared_bias_attention",
                                                   want.float().abs().max().item())


# ---- routes ----------------------------------------------------------------

PERS_HW, PANO_HW, VIEWS = (32, 32), (64, 128), 20   # full_dual_config's latents


def warp_shapes(batch, views_world=1, rows_world=1):
    """{(B, Sq, Sk, H, 32)}: K3's (and under attn_v2 K6a's) shapes at the
    WarpAttn sites of full_dual_config (models/dual.py:warp_sites; r{s}: the
    perspective and pano latents / s; the widths models/dual.py gives the
    sites: encoder i block_out_channels[i], mid the last, decoder i the
    reversed list's i-th; heads of 32) on one rank of a mesh: its views'
    perspective queries (VIEWS / views_world) against every pano key, its
    pano rows (1 / rows_world) against every view's keys."""
    boc = full_dual_config("bfloat16").pers.block_out_channels
    shapes = set()
    for site, rkey in warp_sites(len(boc)):
        kind, _, i = site.partition("_")
        width = {"enc": boc[int(i or 0)], "mid": boc[-1],
                 "dec": boc[-1 - int(i or 0)]}[kind]
        s = int(rkey[1:])
        pers = VIEWS * (PERS_HW[0] // s) * (PERS_HW[1] // s)
        pano = (PANO_HW[0] // s) * (PANO_HW[1] // s)
        shapes.add((batch, pano // rows_world, pers, width // D, D))
        shapes.add((batch, pers // views_world, pano, width // D, D))
    return shapes


DENOISE_SHAPES = warp_shapes(32)     # CFG 2 x 16 frames
TRAIN_SHAPES = warp_shapes(16)       # 16 frames
SHARD_SHAPES = ({(w, s) for w in (2, 4, 5, 10, 20) for s in warp_shapes(32, views_world=w)}
                | {(w, s) for w in (2, 4) for s in warp_shapes(32, w, rows_world=w)})


def test_warp_shapes_are_the_sites():
    """The model's WarpAttn shapes (10 a denoise step, as phase 4 of
    chip_smoke.py logs them on the card: r2 at 10 and 20 heads, r4 at 20 and
    40, r8 at 40, both directions) are K3's sites of chip_smoke.SITES, so
    phase 2 times every K3 shape of a step; the training step's r2 and r8
    ones and K6a's r2 and r4 ones are among them."""
    k3 = {shape for name, _, shape in chip_smoke.SITES if name == "shared_bias_attention"
          and shape[4] == D}
    assert k3 == DENOISE_SHAPES and len(DENOISE_SHAPES) == 10
    assert {(32, 2048, 5120, 20, D), (32, 1280, 512, 40, D), (32, 320, 128, 40, D)} <= \
        DENOISE_SHAPES
    train = {shape for name, _, shape in chip_smoke.SITES
             if name == "shared_bias_attention_lse"}
    assert train < TRAIN_SHAPES
    k6a = {shape for name, site, shape in chip_smoke.SITES
           if name == "flash_attention_t" and chip_smoke.site_has_bias(site)}
    assert k6a < DENOISE_SHAPES


@pytest.mark.parametrize("world,shape", sorted(
    {(1, s) for s in DENOISE_SHAPES | TRAIN_SHAPES} | SHARD_SHAPES))
def test_routes_at_every_warp_shape(world, shape):
    """Every WarpAttn shape of the denoise step, the training step and a
    rank's share of a 2- to 20-rank mesh takes the biased body: K3 under
    its bias, or a row block of it at the rank's row offset (16-byte
    aligned: rows of Sk float32 are); K6a under the bias shared by every
    row. chip_smoke's rule by shape says the same."""
    B, Sq, Sk, H, Dh = shape
    for r in range(world):     # rank r's bias rows: a view Sq·Sk float32 on
        offset = r * Sq * Sk * 4
        assert kernels.shared_bias_wgmma_route(torch.bfloat16, Sk, Dh,
                                               (0, 1024, 2048, 4096, offset))
    assert kernels.flash_t_bias_wgmma_route(torch.bfloat16, Sq, Sk, Dh, True)
    assert chip_smoke.shape_routed(kernels, "shared_bias_attention", shape)
    assert chip_smoke.shape_routed(kernels, "shared_bias_attention_lse", shape)
    assert chip_smoke.shape_routed(kernels, "flash_attention_t", shape)
    assert chip_smoke.shape_routed(kernels, "flash_attention_t", shape, True)


def test_routes_at_every_phase2_site():
    """Every K3 site of chip_smoke.SITES but the CLIP one (D = 64, a -inf
    bias) and every K6a WarpAttn site takes the biased body; K6a's pano
    sites (D = 64, no bias) are wgmma_route's."""
    for name, site, shape in chip_smoke.SITES:
        if name not in ("shared_bias_attention", "shared_bias_attention_lse",
                        "flash_attention_t"):
            continue
        B, Sq, Sk, H, Dh = shape
        if name != "flash_attention_t":
            assert kernels.shared_bias_wgmma_route(torch.bfloat16, Sk, Dh) == (
                site != chip_smoke.CLIP_SITE)
            assert chip_smoke.shape_routed(kernels, name, shape) == (site != chip_smoke.CLIP_SITE)
        else:
            warp = chip_smoke.site_has_bias(site)
            assert kernels.flash_t_bias_wgmma_route(torch.bfloat16, Sq, Sk, Dh, warp) == warp
            assert kernels.wgmma_route(name, torch.bfloat16, Sq, Sk, H, Dh, warp) == (not warp)
            assert chip_smoke.shape_routed(kernels, name, shape, warp)


def test_routes_refuse_what_the_body_does_not_take():
    """K3: float32, the CLIP site (D = 64), a bias row that is no multiple
    of 16 bytes (77, 330 keys), any of q, k, v, out or the bias off a
    16-byte boundary. K6a: float32, a per-batch or per-head bias or none,
    Sq or Sk no multiple of 8, D = 64 under a bias, an unaligned pointer."""
    bf, f32 = torch.bfloat16, torch.float32
    ptrs = (0, 16, 4096, 2 ** 40, 2 ** 20)
    assert kernels.shared_bias_wgmma_route(bf, 2048, D, ptrs)
    assert not kernels.shared_bias_wgmma_route(f32, 2048, D)
    assert not kernels.shared_bias_wgmma_route(bf, 77, 64)
    assert not chip_smoke.shape_routed(kernels, "shared_bias_attention", (2, 77, 77, 16, 64))
    for Sk in (77, 330, 2050):
        assert not kernels.shared_bias_wgmma_route(bf, Sk, D)
    assert kernels.shared_bias_wgmma_route(bf, 332, D)
    for i in range(len(ptrs)):
        off = tuple(p + 8 * (j == i) for j, p in enumerate(ptrs))
        assert not kernels.shared_bias_wgmma_route(bf, 2048, D, off)
        assert not kernels.flash_t_bias_wgmma_route(bf, 2048, 5120, D, True, off)
    assert kernels.flash_t_bias_wgmma_route(bf, 2048, 5120, D, True, ptrs)
    assert not kernels.flash_t_bias_wgmma_route(f32, 2048, 5120, D, True)
    assert not kernels.flash_t_bias_wgmma_route(bf, 2048, 5120, D, False)
    assert not kernels.flash_t_bias_wgmma_route(bf, 2048, 5120, 64, True)
    for Sq, Sk in ((333, 1000), (2048, 5124), (8, 8)):
        assert kernels.flash_t_bias_wgmma_route(bf, Sq, Sk, D, True) == (
            Sq % 8 == 0 and Sk % 8 == 0)
    assert not chip_smoke.shape_routed(kernels, "flash_attention_t", (32, 2048, 5120, 10, D),
                                       False)


def test_plain_path_counts_no_wgmma_launch_k3_k6a():
    """On the CPU K3 and K6a at the WarpAttn head dim run their plain
    versions: one plain call each, no launch, no wgmma launch."""
    rng = np.random.default_rng(6)
    q, k = _f32(rng, 2, 64, 2, D).bfloat16(), _f32(rng, 2, 128, 2, D).bfloat16()
    bias = _bias(rng, 64, 128)
    kernels.reset_counts()
    kernels.shared_bias_attention(q, k, k, bias, scale=SCALE, with_lse=True)
    qt, kt = (x.permute(0, 2, 3, 1) for x in (q, k))
    kernels.flash_attention_t(qt, kt, kt, bias[None, None], scale=SCALE)
    assert set(kernels.wgmma_counts().values()) == {0}
    assert kernels.shared_bias_attention.plain_calls == kernels.flash_attention_t.plain_calls == 1
    assert kernels.shared_bias_attention.launches == kernels.flash_attention_t.launches == 0


def test_chip_smoke_rule_by_shape_k3_k6a():
    """chip_smoke.wgmma_expected counts, from the launches by shape, K3's
    14 WarpAttn launches of a denoise step (each r2 and r4 shape once, the
    r8 ones three times) and none of the CLIP encoder's 23; K6a's at its
    WarpAttn sites (D = 32) and its pano sites (D = 64); and path_launches
    names K6a's launches on the biased body apart."""
    kernels.reset_counts()
    try:
        for shape in DENOISE_SHAPES:     # r8: 128 pano and 320 perspective tokens
            kernels.shared_bias_attention.shape_launches[shape] += 3 if 128 in shape[1:3] else 1
        kernels.shared_bias_attention.shape_launches[(2, 77, 77, 16, 64)] += 23
        kernels.flash_attention_t.shape_launches.update({(32, 2048, 5120, 10, D): 2,
                                                         (32, 512, 1280, 20, D): 2,
                                                         (32, 8192, 8192, 5, 64): 5})
        want = {name: 0 for name in kernels.wgmma_counts()}
        want.update(shared_bias_attention=14, flash_attention_t=9)
        assert chip_smoke.wgmma_expected(kernels) == want
        assert chip_smoke.path_launches(kernels)["flash_attention_t_wgmma_bias"] == 4
    finally:
        kernels.reset_counts()


def test_chip_smoke_tables_name_the_biased_body():
    """chip_smoke runs K3 on both bodies at its routed sites and logs its
    share of equal bits (MATCH_LOGGED, not gated: test_k3_share_of_equal_bits),
    holds K6a's to K5A_MATCH, names K3's and K6a's biased body (its source
    exists), and counts the two new wgmma kernels' HGMMA in phase 1."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert "shared_bias_attention" in chip_smoke.TWO_BODY_KERNELS
    assert "shared_bias_attention" in chip_smoke.SPLIT_BODY_KERNELS
    assert set(chip_smoke.MATCH_LOGGED) == {"shared_bias_attention", "shared_bias_attention_lse"}
    assert not set(chip_smoke.MATCH_LOGGED) & set(chip_smoke.MATCH_KERNELS)
    assert "flash_attention_t" in chip_smoke.MATCH_KERNELS
    for name, body in (("shared_bias_attention", "wgmma"), ("flash_attention_t", "wgmma_bias")):
        src = chip_smoke.KERNEL_BODY_SOURCES[name][body]
        assert src.endswith("csrc/attn_wgmma_bias.cuh")
        assert os.path.isfile(os.path.join(root, src))
    assert chip_smoke.WGMMA_KERNEL_NAMES["shared_bias_wgmma_kernel"] == 1
    assert chip_smoke.WGMMA_KERNEL_NAMES["flash_t_bias_wgmma_kernel"] == 1
