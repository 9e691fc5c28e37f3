"""K5b's and K5c's WarpAttn launches on the biased D = 32 `wgmma` backward
bodies, emulated on the CPU, and the rule that sends them there.

In bfloat16 at head dim 32 under one float32 bias shared by every batch row
and head (`_bias_strides` 0, 0), its rows multiples of 16 bytes (Sk a
multiple of 4), with 16-byte-aligned pointers and, for K5c, Sq a multiple
of 4, `kernels.flash_bwd_dq` (K5b) and `kernels.flash_bwd_dkv` (K5c) run
csrc/attn_wgmma_bwd_bias.cuh (`kernels.bwd_bias_wgmma_route`). Row slot
g = b·H + h reads head g % H of batch row g // H; a block takes
kernels.BWD_BIAS_DQ_ROWS (K5b) or BWD_BIAS_DKV_ROWS (K5c) row slots under
each staged bias tile, the last group's slots past B·H repeating its last
row (computed, not stored). Per slot, K5b walks tiles of 64 keys and sums
dq = scale · Σ dS·K tile by tile; K5c walks tiles of 64 queries and sums
dv = Σ Pᵀ·dO and dk = scale · Σ dSᵀ·Q tile by tile; x = S·scale + bias in
one FFMA, P = 2^(x·log2 e − lse·log2 e) by ex2.approx.ftz (results below
2**-126 flushed to 0), dS = P ∘ (dP − delta), and every product that takes
P or dS takes its exact split hi = bf16(x), lo = bf16(x − hi), the lo
product first. `emulate_bwd_dq_bias` and `emulate_bwd_dkv_bias` repeat that
order in torch, slot by slot in the blocks' order.

These tests hold them, on seeded bfloat16 inputs made with numpy and a
uniform [-1, 1) float32 bias, with ragged query and key counts (77, 200,
333, 1000; H = 2), against

- the JAX package's backward as `_shared_trainable_bwd` calls it
  (`flash_attention_bwd` with the [1, 1, Sq, Sk] bias, the two pallas_calls
  of `_flash_bhsd_bwd`) in interpret mode on the out and lse of its own
  `_shared_bias_call` forward;
- the port's plain versions on the plain forward's lse and delta;

within chip_smoke.py's phase-2 limit, GRAD_BF16_REL = 2**-7 x the
gradient's largest element, and hold the share of the emulated output equal
bit for bit to the plain version's (chip_smoke.match_share) at K5A_MATCH or
more, which dS and P rounded once miss. They emulate the shared-memory
addresses of the bias reads (a warp's reads on distinct banks), and pin
`kernels.bwd_bias_wgmma_route` at every K5b / K5c WarpAttn shape of the
training step and of a rank's share of 2- to 20-rank meshes, its refusals,
the CPU path, and chip_smoke's rule by shape and tables.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagine360_tpu.ops.attention import _shared_bias_call
from imagine360_tpu.ops.dispatch import configure
from imagine360_tpu.ops.pallas_attention import flash_attention_bwd

from imagine360_tpu_torch.ops import kernels

from test_torch_wgmma_warp import SHARD_SHAPES, TRAIN_SHAPES

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

D = 32                       # csrc/attn_wgmma_bias.cuh kFbD
H = 2
SCALE = D ** -0.5
KEY_TILE = 64                # csrc/attn_wgmma_bias.cuh kFbBK: K5b's key tiles
QUERY_TILE = 64              # csrc/attn_wgmma_bwd_bias.cuh kBkbBQ: K5c's query tiles
LOG2E = 1.4426950408889634
FTZ = 2.0 ** -126            # ex2.approx.ftz flushes results below this to 0
F32 = lambda x: torch.tensor(x, dtype=torch.float32)
# (Sq, Sk): ragged query and key counts, one and several tiles
CASES = [(77, 200), (200, 333), (333, 1000), (1000, 77)]
BWD = ("flash_bwd_dq", "flash_bwd_dkv")


def _inputs(Sq, Sk, seed, B=1, Hs=H):
    """q, k, v, dO bfloat16 [B, S, Hs, 32] of unit scale and a uniform
    [-1, 1) float32 bias [Sq, Sk]."""
    rng = np.random.default_rng(seed)
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).bfloat16()
    q, k, v, g = bf(B, Sq, Hs, D), bf(B, Sk, Hs, D), bf(B, Sk, Hs, D), bf(B, Sq, Hs, D)
    return q, k, v, g, torch.from_numpy(rng.uniform(-1, 1, (Sq, Sk)).astype(np.float32))


def _rows(q, k, v, g, bias):
    """The plain forward's lse and delta = rowsum(dO ∘ O) under the bias,
    [B, H, Sq]."""
    out, lse = kernels.flash_attention_lse_plain(q, k, v, bias[None, None], scale=SCALE)
    return lse, kernels.attention_delta(g, out)


def _split(x):
    """The bf16 hi + lo split of float32 x, as float32 tensors."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _round_once(x):
    """dS or P rounded once to bf16: the split without its lo part."""
    return x.bfloat16().float(), torch.zeros_like(x)


def _probs(s, bias, l2):
    """P as the bodies form it: x = fma(s, scale, bias) (one rounding),
    2^fma(x, log2 e, −l2) (one rounding), ex2.approx.ftz's flush."""
    x = (s.double() * F32(SCALE).double() + bias.double()).float()
    p = torch.exp2((x.double() * F32(LOG2E).double() - l2.double()).float())
    return torch.where(p < FTZ, torch.zeros_like(p), p)


def slot_groups(BH, T):
    """The row slots of each block's row group, in the kernels' order:
    group rg takes rows rg·T .. rg·T + T − 1, the last group's slots past
    BH repeating its last row (computed, not stored); [(rows, stored)]."""
    out = []
    for g0 in range(0, BH, T):
        nv = min(T, BH - g0)
        out.append(([g0 + min(j, nv - 1) for j in range(T)], nv))
    return out


def _slots(x):
    """[B, S, H, 32] -> [B·H, S, 32] float32: row slot g = b·H + h."""
    B, S, Hs, _ = x.shape
    return x.float().permute(0, 2, 1, 3).reshape(B * Hs, S, D)


def emulate_bwd_dq_bias(q, k, v, g, bias, lse, delta, T=kernels.BWD_BIAS_DQ_ROWS,
                        key_tile=KEY_TILE, split=_split):
    """K5b's biased body: dq [B, Sq, H, 32] bfloat16. Per row slot, in the
    blocks' order, tile by tile of `key_tile` keys: S = Q·Kᵀ and dP = dO·Vᵀ
    (bf16 operands, float32 sums), P under the bias tile, dS = P ∘ (dP −
    delta), dq += lo(dS)·K then += hi(dS)·K in float32; dq·scale rounded to
    bf16 once, stored for the group's slots in range."""
    B, Sq, Hs, _ = q.shape
    qf, kf, vf, gf = map(_slots, (q, k, v, g))
    l2 = (lse.float() * F32(LOG2E)).reshape(B * Hs, Sq)
    de = delta.float().reshape(B * Hs, Sq)
    out = torch.full((B * Hs, Sq, D), float("nan"), dtype=torch.bfloat16)
    for rows, nv in slot_groups(B * Hs, T):
        for j, r in enumerate(rows):
            acc = torch.zeros(Sq, D)
            for k0 in range(0, kf.shape[1], key_tile):
                kt, vt = kf[r, k0:k0 + key_tile], vf[r, k0:k0 + key_tile]
                p = _probs(qf[r] @ kt.T, bias[:, k0:k0 + key_tile], l2[r][:, None])
                ds = p * (gf[r] @ vt.T - de[r][:, None])
                hi, lo = split(ds)
                acc = acc + lo @ kt
                acc = acc + hi @ kt
            if j < nv:
                out[r] = (acc * F32(SCALE)).bfloat16()
    return out.view(B, Hs, Sq, D).permute(0, 2, 1, 3)


def emulate_bwd_dkv_bias(q, k, v, g, bias, lse, delta, T=kernels.BWD_BIAS_DKV_ROWS,
                         query_tile=QUERY_TILE, split=_split):
    """K5c's biased body: (dk, dv) [B, Sk, H, 32] bfloat16. Per row slot,
    in the blocks' order, tile by tile of `query_tile` queries, on the
    transposed tiles: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, Pᵀ under the transposed bias
    tile with the lse of each column, dSᵀ = Pᵀ ∘ (dPᵀ − delta of each
    column), dv += lo(Pᵀ)·dO then += hi(Pᵀ)·dO, dk += lo(dSᵀ)·Q then +=
    hi(dSᵀ)·Q in float32; dk·scale and dv rounded to bf16 once."""
    B, Sq, Hs, _ = q.shape
    Sk = k.shape[1]
    qf, kf, vf, gf = map(_slots, (q, k, v, g))
    l2 = (lse.float() * F32(LOG2E)).reshape(B * Hs, Sq)
    de = delta.float().reshape(B * Hs, Sq)
    dk_out = torch.full((B * Hs, Sk, D), float("nan"), dtype=torch.bfloat16)
    dv_out = dk_out.clone()
    for rows, nv in slot_groups(B * Hs, T):
        for j, r in enumerate(rows):
            dk, dv = torch.zeros(Sk, D), torch.zeros(Sk, D)
            for q0 in range(0, Sq, query_tile):
                cols = slice(q0, q0 + query_tile)
                qt, gt = qf[r, cols], gf[r, cols]
                pt = _probs(kf[r] @ qt.T, bias[cols].T, l2[r, cols][None])
                dst = pt * (vf[r] @ gt.T - de[r, cols][None])
                for acc, x, b in ((dv, pt, gt), (dk, dst, qt)):
                    hi, lo = split(x)
                    acc += lo @ b
                    acc += hi @ b
            if j < nv:
                dk_out[r], dv_out[r] = (dk * F32(SCALE)).bfloat16(), dv.bfloat16()
    shape = lambda x: x.view(B, Hs, Sk, D).permute(0, 2, 1, 3)
    return shape(dk_out), shape(dv_out)


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


@pytest.fixture(scope="module")
def jax_bwd():
    """{(Sq, Sk): (q, k, v, dO, bias, (dq, dk, dv))}: `flash_attention_bwd`
    with the [1, 1, Sq, Sk] bias in interpret mode on the out and lse of its
    own `_shared_bias_call` forward, as `_shared_trainable_bwd` calls it."""
    outs = {}
    with configure(interpret=True):
        for Sq, Sk in CASES:
            q, k, v, g, bias = _inputs(Sq, Sk, seed=3 * Sq + Sk)
            jq, jk, jv, jg = map(_jnp, (q, k, v, g))
            jb = jnp.asarray(bias.numpy())[None, None]
            out, lse = _shared_bias_call(jq, jk, jv, jb, SCALE, with_lse=True)
            grads = flash_attention_bwd(jq, jk, jv, jb, out, lse, jg, scale=SCALE,
                                        interpret=True)
            outs[(Sq, Sk)] = (q, k, v, g, bias), tuple(map(_np, grads))
    return outs


def _limit(want):
    return chip_smoke.GRAD_BF16_REL * want.float().abs().max().item()


def _err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _emulate(name, *args, **kw):
    got = (emulate_bwd_dq_bias if name == "flash_bwd_dq" else emulate_bwd_dkv_bias)(*args, **kw)
    return got if isinstance(got, tuple) else (got,)


def _plain(name, q, k, v, g, bias, lse, delta):
    want = getattr(kernels, name + "_plain")(q, k, v, bias[None, None], g, lse, delta,
                                             scale=SCALE)
    return want if isinstance(want, tuple) else (want,)


@pytest.mark.parametrize("name", BWD)
@pytest.mark.parametrize("Sq,Sk", CASES)
def test_emulated_body_matches_jax_and_plain(Sq, Sk, name, jax_bwd):
    """K5b's dq (64-key tiles, four row slots) and K5c's dk, dv (64-query
    tiles, two row slots) as the biased bodies sum them, against the Pallas
    backward in interpret mode and the plain versions, each within the
    phase-2 limit of the reference; the plain version and the Pallas kernel
    agree within the same limit."""
    (q, k, v, g, bias), (jdq, jdk, jdv) = jax_bwd[(Sq, Sk)]
    lse, delta = _rows(q, k, v, g, bias)
    got = _emulate(name, q, k, v, g, bias, lse, delta)
    want = _plain(name, q, k, v, g, bias, lse, delta)
    ref = (jdq,) if name == "flash_bwd_dq" else (jdk, jdv)
    for a, b, r in zip(got, want, ref):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape == r.shape
        assert bool(torch.isfinite(a.float()).all())
        assert _err(a, b) <= _limit(b) and _err(a, r) <= _limit(r)
        assert _err(b, r) <= _limit(r)


@pytest.mark.parametrize("name", BWD)
@pytest.mark.parametrize("Sq,Sk", CASES)
def test_emulated_body_keeps_plain_bits(Sq, Sk, name):
    """The share phase 2 asks of the biased bodies' output (dq; dk and dv
    together), chip_smoke.match_share against the plain version: with dS
    (and P) split hi + lo it is at least chip_smoke.K5A_MATCH, with them
    rounded once to bf16 it is below 0.7, so the share tells the two apart
    where the phase-2 limit alone does not."""
    q, k, v, g, bias = _inputs(Sq, Sk, seed=Sq + 7 * Sk)
    lse, delta = _rows(q, k, v, g, bias)
    want = _plain(name, q, k, v, g, bias, lse, delta)
    split = _emulate(name, q, k, v, g, bias, lse, delta)
    once = _emulate(name, q, k, v, g, bias, lse, delta, split=_round_once)
    unpack = lambda r: r if name == "flash_bwd_dkv" else r[0]
    assert chip_smoke.match_share(name, unpack(split), unpack(want)) >= chip_smoke.K5A_MATCH
    assert chip_smoke.match_share(name, unpack(once), unpack(want)) < 0.7


@pytest.mark.parametrize("name", BWD)
@pytest.mark.parametrize("B,Hs", [(1, 5), (3, 3), (2, 1)])
def test_row_slots_move_no_bit(name, B, Hs):
    """B·H of 5, 9 and 2 row slots against four (K5b) or two (K5c) a block,
    and one a block: the ragged last group repeats its last row and stores
    it once, and each slot's arithmetic is its own, so the outputs are the
    same bit for bit and every row is written."""
    q, k, v, g, bias = _inputs(130, 200, seed=B * 10 + Hs, B=B, Hs=Hs)
    lse, delta = _rows(q, k, v, g, bias)
    args = (q, k, v, g, bias, lse, delta)
    for a, b in zip(_emulate(name, *args), _emulate(name, *args, T=1)):
        assert torch.equal(a, b) and bool(torch.isfinite(a.float()).all())
    T = kernels.BWD_BIAS_DQ_ROWS if name == "flash_bwd_dq" else kernels.BWD_BIAS_DKV_ROWS
    stored = [r for rows, nv in slot_groups(B * Hs, T) for r in rows[:nv]]
    assert stored == list(range(B * Hs))


def test_row_slot_counts_are_the_kernels():
    """The row slots a block of the two bodies takes, as their headers set
    them (kBqbT, kBkbT)."""
    text = (kernels.CSRC / "attn_wgmma_bwd_bias.cuh").read_text()
    assert f"constexpr int kBqbT = {kernels.BWD_BIAS_DQ_ROWS};" in text
    assert f"constexpr int kBkbT = {kernels.BWD_BIAS_DKV_ROWS};" in text


# ---- the bias tile in shared memory ------------------------------------------


def k5b_bias_words(r, i, tg):
    """The two 4-byte words K5b's thread reads of row r of the staged
    [128, 64] float32 bias tile, keys 8i + 2tg and + 1
    (attn_wgmma_bias.cuh fb_bias: boxes of 32 keys, 128-byte rows, chunk
    c ^ (r % 8) under the 128-byte swizzle)."""
    chunk = 2 * (i % 4) + (tg >> 1)
    byte = (i // 4) * 128 * 128 + r * 128 + ((chunk ^ (r & 7)) << 4) + (tg & 1) * 8
    return byte // 4, byte // 4 + 1


def k5c_bias_word(q, kr):
    """The 4-byte word K5c's thread reads at (query q, key kr) of the staged
    [64, 128] float32 bias tile (attn_wgmma_bwd_bias.cuh bkb_bias)."""
    chunk = ((kr % 32) >> 2) ^ (q & 7)
    return ((kr // 32) * 64 * 128 + q * 128 + (chunk << 4) + (kr & 3) * 4) // 4


def _tma_word(row, key, rows):
    """Where TMA's 128-byte swizzle puts float32 (row, key) of a tile of
    `rows` rows in boxes of 32 keys: the 16-byte chunk of a 128-byte row
    XOR the row's index mod 8."""
    chunk = ((key % 32) * 4 // 16) ^ (row % 8)
    return ((key // 32) * rows * 128 + row * 128 + chunk * 16 + (key * 4) % 16) // 4


def test_k5c_transposed_bias_reads_fall_on_distinct_banks():
    """K5c reads its bias transposed into Sᵀ's fragments: a warp's read of
    one element (its 8 key rows × 4 query pairs) falls on 32 distinct
    banks, one wavefront, for every element of every warp of both
    consumers; and each read is the element TMA wrote there."""
    for cw in range(2):
        for warp in range(4):
            for i in range(8):
                for e in range(4):
                    words = []
                    for lane in range(32):
                        g, tg = lane >> 2, lane & 3
                        q, kr = 8 * i + 2 * tg + (e & 1), 64 * cw + 16 * warp + g + 8 * (e >> 1)
                        words.append(k5c_bias_word(q, kr))
                        assert words[-1] == _tma_word(q, kr, 64)
                    assert len({w % 32 for w in words}) == 32


def test_k5b_bias_pair_reads_take_two_wavefronts():
    """K5b reads its bias as the forward does, a pair of keys a thread: a
    warp's 8-byte reads of one i cover every bank exactly twice (the two
    wavefronts 256 bytes need), and each word is the one TMA wrote there."""
    for cw in range(2):
        for warp in range(4):
            for hr in range(2):
                for i in range(8):
                    banks = []
                    for lane in range(32):
                        g, tg = lane >> 2, lane & 3
                        r = 64 * cw + 16 * warp + g + 8 * hr
                        w0, w1 = k5b_bias_words(r, i, tg)
                        assert w0 == _tma_word(r, 8 * i + 2 * tg, 128)
                        assert w1 == _tma_word(r, 8 * i + 2 * tg + 1, 128)
                        banks += [w0 % 32, w1 % 32]
                    assert sorted(banks) == sorted(list(range(32)) * 2)


# ---- the route ---------------------------------------------------------------


def _bias_offsets(world, Sq, Sk):
    """Byte offsets of every rank's row block of a W-rank mesh's bias."""
    return [r * Sq * Sk * 4 for r in range(world)]


@pytest.mark.parametrize("world,shape", sorted({(1, s) for s in TRAIN_SHAPES} | {
    (w, (16,) + s[1:]) for w, s in SHARD_SHAPES}))
def test_route_at_every_warp_shape(world, shape):
    """Every WarpAttn shape of the training step (16 frames) and a rank's
    share of a 2- to 20-rank mesh (its views' perspective queries, or its
    pano rows against every view's keys) takes the biased body, under the
    whole bias or any rank's row block of it (a view at a row offset:
    rows of Sk float32 keep it 16-byte aligned); chip_smoke's rule by shape
    says the same."""
    B, Sq, Sk, Hs, Ds = shape
    for name in BWD:
        for off in _bias_offsets(world, Sq, Sk):
            ptrs = (0, 4096, 2 ** 20, 2 ** 30, off, 2 ** 33)
            assert kernels.bwd_bias_wgmma_route(name, torch.bfloat16, Sq, Sk, Ds, (0, 0), ptrs)
        assert chip_smoke.shape_routed(kernels, name, shape)
        assert chip_smoke.shape_routed(kernels, name, shape, True)
        assert not chip_smoke.shape_routed(kernels, name, shape, False)
        assert not kernels.wgmma_route(name, torch.bfloat16, Sq, Sk, Hs, Ds, True)


def test_phase2_sites_are_every_warp_shape():
    """Phase 2 holds K5b and K5c at all ten WarpAttn shapes of a training
    step (chip_smoke.SITES), each on the biased body, the fourteen sites
    that hold the rest of them appended together after every earlier one
    (a later slice's sites come after them)."""
    for name in BWD:
        warp = {shape for n, site, shape in chip_smoke.SITES
                if n == name and chip_smoke.site_has_bias(site)}
        assert warp == TRAIN_SHAPES and len(warp) == 10
        assert all(chip_smoke.shape_routed(kernels, name, s, True) for s in warp)
    names = [(n, s) for n, s, _ in chip_smoke.SITES]
    first_new = names.index(("flash_bwd_dq", "train_warp_r2_pano_q_h20"))
    assert all(n in BWD for n, _ in names[first_new:first_new + 14])
    assert not any(n in BWD for n, _ in names[first_new + 14:])
    assert names[first_new - 1] == ("shared_bias_attention", "warp_r4_pers_q_h40")


@pytest.mark.parametrize("name", BWD)
def test_route_refuses_what_the_body_does_not_take(name):
    """A bias per batch row or per head, no bias at D = 32, float32, D = 64
    under a bias, a bias row that is no multiple of 16 bytes (Sk % 4), for
    K5c an Sq that is no multiple of 4 (its lse and delta rows' maps), and
    any pointer a tensor map reads off a 16-byte boundary stay off the
    biased body; K5b takes any Sq."""
    bf = torch.bfloat16
    n_ptrs = 6 if name == "flash_bwd_dq" else 9
    ptrs = tuple(16 * 1024 * (i + 1) for i in range(n_ptrs))
    route = lambda *a, **kw: kernels.bwd_bias_wgmma_route(name, *a, **kw)
    assert route(bf, 2048, 5120, D, (0, 0), ptrs)
    assert not route(bf, 2048, 5120, D, (0, 2048 * 5120))        # per head
    assert not route(bf, 2048, 5120, D, (10 * 2048 * 5120, 0))   # per batch row
    assert not route(bf, 2048, 5120, D, None)                    # no bias
    assert not route(torch.float32, 2048, 5120, D, (0, 0))
    assert not route(bf, 2048, 5120, 64, (0, 0))
    assert not kernels.wgmma_route(name, bf, 2048, 5120, 10, 64, True)
    for Sk in (77, 330, 5122):
        assert not route(bf, 2048, Sk, D, (0, 0))
    for Sq in (77, 333, 1000, 5120):
        assert route(bf, Sq, 5120, D, (0, 0)) == (name == "flash_bwd_dq" or Sq % 4 == 0)
    for i in range(n_ptrs):
        off = tuple(p + 4 * (j == i) for j, p in enumerate(ptrs))
        assert not route(bf, 2048, 5120, D, (0, 0), off)


def test_plain_path_counts_no_wgmma_launch_under_a_bias():
    """On the CPU K5b and K5c at D = 32 under a bias run their plain
    versions: one plain call each, no launch, no wgmma launch."""
    q, k, v, g, bias = _inputs(64, 128, seed=9)
    lse, delta = _rows(q, k, v, g, bias)
    kernels.reset_counts()
    kernels.flash_bwd_dq(q, k, v, bias[None, None], g, lse, delta, scale=SCALE)
    kernels.flash_bwd_dkv(q, k, v, bias[None, None], g, lse, delta, scale=SCALE)
    assert set(kernels.wgmma_counts().values()) == {0}
    assert kernels.flash_bwd_dq.plain_calls == kernels.flash_bwd_dkv.plain_calls == 1
    assert kernels.flash_bwd_dq.launches == kernels.flash_bwd_dkv.launches == 0


def test_chip_smoke_rule_by_shape_counts_a_training_step():
    """chip_smoke.wgmma_expected counts, from the launches by shape of a
    training step (the pano spatial sites five times each at D = 64; each
    r2 and r4 WarpAttn shape once and the r8 ones three times), every K5b
    and K5c launch on a wgmma body (TRAIN_BWD_WGMMA, 24 each), and
    path_launches the WarpAttn ones on the biased body apart
    (TRAIN_BWD_WGMMA_BIAS, 14 each), as phase 6 holds them."""
    kernels.reset_counts()
    try:
        for fn in (kernels.flash_bwd_dq, kernels.flash_bwd_dkv):
            fn.shape_launches.update({(16, 8192, 8192, 5, 64): 5, (16, 2048, 2048, 10, 64): 5})
            for shape in TRAIN_SHAPES:
                fn.shape_launches[shape] += 3 if 128 in shape[1:3] else 1
            fn.launches = sum(fn.shape_launches.values())
        want = {name: 0 for name in kernels.wgmma_counts()}
        want.update(chip_smoke.TRAIN_BWD_WGMMA)
        assert chip_smoke.wgmma_expected(kernels) == want
        assert chip_smoke.TRAIN_BWD_WGMMA == {name: 24 for name in BWD}
        launches = chip_smoke.path_launches(kernels)
        assert {n: launches[f"{n}_wgmma_bias"] for n in BWD} == chip_smoke.TRAIN_BWD_WGMMA_BIAS
        assert chip_smoke.TRAIN_BWD_WGMMA_BIAS == {name: 14 for name in BWD}
        assert all(launches[n] == chip_smoke.TRAIN_BWD_WGMMA[n] for n in BWD)
    finally:
        kernels.reset_counts()


def test_chip_smoke_tables_name_the_biased_backward_body():
    """chip_smoke names K5b's and K5c's biased body (its source exists),
    counts its two kernels' HGMMA in phase 1, runs both bodies at the
    routed sites and holds the biased one to K5A_MATCH (MATCH_KERNELS, not
    MATCH_LOGGED), and phase 2 times PyTorch's backward alone beside them
    at every K5b / K5c site (`library_bwd_ms`)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in BWD:
        src = chip_smoke.KERNEL_BODY_SOURCES[name]["wgmma_bias"]
        assert src.endswith("csrc/attn_wgmma_bwd_bias.cuh")
        assert os.path.isfile(os.path.join(root, src))
        assert chip_smoke.WGMMA_KERNEL_NAMES[f"{name}_bias_wgmma_kernel"] == 1
        assert name in chip_smoke.MATCH_KERNELS and name not in chip_smoke.MATCH_LOGGED
        assert name in chip_smoke.SPLIT_BODY_KERNELS and name in chip_smoke.BIAS_BODY_KERNELS


@pytest.mark.parametrize("variant", [
    "bqb_final", "bqb_overlap", "bqb_serial", "bqb_t2", "bqb_t1", "bqb_smem_bias", "bkb_final",
    "bkb_tile_overlap", "bkb_overlap", "bkb_t1", "bkb_t4", "bkb_smem_bias"])
def test_variants_script_edits_the_biased_header(variant):
    """scripts/torch_wgmma_variants.py builds the biased bodies' other forms
    by text edits of a copy of csrc/attn_wgmma_bwd_bias.cuh: each edit
    still finds its marker, once, and changes the text (the final forms
    are the header as it is)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "scripts"))
    import torch_wgmma_variants as variants

    header = (kernels.CSRC / "attn_wgmma_bwd_bias.cuh").read_text()
    family = "k5b_bias" if variant.startswith("bqb") else "k5c_bias"
    assert variants.VARIANTS[variant][0] == family
    text = variants.variant_header(variant)
    assert (text == header) == variant.endswith("_final")
