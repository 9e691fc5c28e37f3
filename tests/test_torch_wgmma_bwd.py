"""The arithmetic of the `wgmma` backward bodies of K5b and K5c, emulated on
the CPU, and the rule that sends their launches to them.

In bfloat16 at head dim 64 without a bias, `kernels.flash_bwd_dq` (K5b, with
16-byte-aligned q, k, v, dO and dq) and `kernels.flash_bwd_dkv` (K5c, every
pointer aligned, lse and delta included, and Sq a multiple of 4) run
csrc/attn_wgmma_bwd.cuh: K5b walks tiles of 64 keys and sums
dq = scale · Σ dS·K tile by tile; K5c walks tiles of 64 queries and sums
dv = Σ Pᵀ·dO and dk = scale · Σ dSᵀ·Q tile by tile; P = 2^(S·scale·log2 e −
lse·log2 e) by ex2.approx.ftz (results below 2**-126 flushed to 0), dS =
P ∘ (dP − delta), and every product that takes P or dS takes its exact
split hi = bf16(x), lo = bf16(x − hi), the lo product first.
`emulate_bwd_dq` and `emulate_bwd_dkv` repeat that order in torch. These
tests hold them, on seeded bfloat16 inputs with ragged query and key counts
(77, 200, 333, 1000; H = 2, D = 64), against

- the JAX package's backward (`flash_attention_bwd`, the two pallas_calls
  of `_flash_bhsd_bwd`) run in interpret mode on the CPU on its own
  forward's out and lse, as tests/test_torch_flash_bwd.py runs it;
- the port's plain versions (`flash_bwd_dq_plain`, `flash_bwd_dkv_plain`)
  on the plain forward's lse and delta;

within chip_smoke.py's phase-2 limit, GRAD_BF16_REL = 2**-7 x the
gradient's largest element, and hold the share of the emulated output
equal bit for bit to the plain version's (chip_smoke.match_share) at
K5A_MATCH or more, which dS and P rounded once miss. They pin `kernels.wgmma_route` at every K5b and
K5c site of chip_smoke.py (the WarpAttn ones, D = 32 under a bias, take
`kernels.bwd_bias_wgmma_route`'s body: tests/test_torch_wgmma_bwd_warp.py),
the per-shard shapes of 2 and 4 ranks, its refusals, and chip_smoke's rule
by shape and its tables of the bodies.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagine360_tpu.ops.pallas_attention import flash_attention_bwd, flash_attention_fwd_res

from imagine360_tpu_torch.ops import kernels

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

DQ_KEY_TILE = 64     # csrc/attn_wgmma_bwd.cuh kBqBK: K5b's key tiles
DKV_QUERY_TILE = 64  # csrc/attn_wgmma_bwd.cuh kBkBQ: K5c's query tiles
LOG2E = 1.4426950408889634
FTZ = 2.0 ** -126    # ex2.approx.ftz flushes results below this to 0
H, D = 2, 64
SCALE = D ** -0.5
# (Sq, Sk): ragged query and key counts, one and several tiles
CASES = [(77, 200), (200, 333), (333, 1000), (1000, 77)]
BWD = ("flash_bwd_dq", "flash_bwd_dkv")


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()


def _inputs(Sq, Sk, seed):
    """q, k, v, dO bfloat16 [1, S, H, D] of unit scale."""
    rng = np.random.default_rng(seed)
    return _bf16(rng, 1, Sq, H, D), _bf16(rng, 1, Sk, H, D), _bf16(rng, 1, Sk, H, D), \
        _bf16(rng, 1, Sq, H, D)


def _rows(q, k, v, g):
    """The plain forward's lse and delta = rowsum(dO ∘ O), [1, H, Sq]."""
    out, lse = kernels.flash_attention_lse_plain(q, k, v, scale=SCALE)
    return lse, kernels.attention_delta(g, out)


def _split(x):
    """The bf16 hi + lo split of float32 x, as float32 tensors."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _probs(s, l2):
    """2^(s·scale·log2 e − l2) as the kernels form it: one FFMA in float32,
    2^x by ex2.approx.ftz (results below 2**-126 flushed to 0)."""
    sl2 = torch.tensor(SCALE, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    x = (s.double() * sl2.double() - l2.double()).float()
    p = torch.exp2(x)
    return torch.where(p < FTZ, torch.zeros_like(p), p)


def _heads_first(*xs):
    return [x.float().permute(0, 2, 1, 3) for x in xs]


def _round_once(x):
    """dS or P rounded once to bf16: the split without its lo part."""
    return x.bfloat16().float(), torch.zeros_like(x)


def emulate_bwd_dq(q, k, v, g, lse, delta, key_tile=DQ_KEY_TILE, split=_split):
    """K5b's wgmma body: dq [1, Sq, H, D] bfloat16. Tile by tile of
    `key_tile` keys: S = Q·Kᵀ and dP = dO·Vᵀ (bf16 operands, float32 sums),
    P, dS = P ∘ (dP − delta), dq += lo(dS)·K then += hi(dS)·K in float32;
    dq·scale rounded to bf16 once. `split` makes hi and lo of dS."""
    qf, kf, vf, gf = _heads_first(q, k, v, g)
    l2 = (lse.float() * torch.tensor(LOG2E, dtype=torch.float32))[..., None]
    acc = torch.zeros_like(qf)
    for k0 in range(0, kf.shape[2], key_tile):
        kt, vt = kf[:, :, k0:k0 + key_tile], vf[:, :, k0:k0 + key_tile]
        p = _probs(qf @ kt.transpose(-1, -2), l2)
        ds = p * (gf @ vt.transpose(-1, -2) - delta[..., None])
        hi, lo = split(ds)
        acc = acc + lo @ kt
        acc = acc + hi @ kt
    return (acc * SCALE).bfloat16().permute(0, 2, 1, 3)


def emulate_bwd_dkv(q, k, v, g, lse, delta, query_tile=DKV_QUERY_TILE, split=_split):
    """K5c's wgmma body: (dk, dv) [1, Sk, H, D] bfloat16. Tile by tile of
    `query_tile` queries, on the transposed tiles: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ,
    Pᵀ with the lse of each column, dSᵀ = Pᵀ ∘ (dPᵀ − delta of each column),
    dv += lo(Pᵀ)·dO then += hi(Pᵀ)·dO, dk += lo(dSᵀ)·Q then += hi(dSᵀ)·Q in
    float32; dk·scale and dv rounded to bf16 once. `split` makes hi and lo
    of Pᵀ and dSᵀ."""
    qf, kf, vf, gf = _heads_first(q, k, v, g)
    l2 = lse.float() * torch.tensor(LOG2E, dtype=torch.float32)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, qf.shape[2], query_tile):
        qt, gt = qf[:, :, q0:q0 + query_tile], gf[:, :, q0:q0 + query_tile]
        pt = _probs(kf @ qt.transpose(-1, -2), l2[:, :, None, q0:q0 + query_tile])
        dst = pt * (vf @ gt.transpose(-1, -2) - delta[:, :, None, q0:q0 + query_tile])
        for acc, x, b in ((dv, pt, gt), (dk, dst, qt)):
            hi, lo = split(x)
            acc += lo @ b
            acc += hi @ b
    return ((dk * SCALE).bfloat16().permute(0, 2, 1, 3),
            dv.bfloat16().permute(0, 2, 1, 3))


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


@pytest.fixture(scope="module")
def jax_bwd():
    """{(Sq, Sk): (q, k, v, dO, (dq, dk, dv) of the Pallas backward in
    interpret mode on its own forward)}."""
    outs = {}
    for Sq, Sk in CASES:
        q, k, v, g = _inputs(Sq, Sk, seed=Sq + 5 * Sk)
        jq, jk, jv, jg = map(_jnp, (q, k, v, g))
        out, lse = flash_attention_fwd_res(jq, jk, jv, scale=SCALE, interpret=True)
        grads = flash_attention_bwd(jq, jk, jv, None, out, lse, jg, scale=SCALE, interpret=True)
        outs[(Sq, Sk)] = (q, k, v, g), tuple(map(_np, grads))
    return outs


def _limit(want):
    return chip_smoke.GRAD_BF16_REL * want.float().abs().max().item()


def _err(got, want):
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("name", BWD)
@pytest.mark.parametrize("Sq,Sk", CASES)
def test_emulated_body_matches_jax_and_plain(Sq, Sk, name, jax_bwd):
    """K5b's dq (64-key tiles) and K5c's dk, dv (64-query tiles) as the
    wgmma bodies sum them, against the Pallas backward in interpret mode and
    the plain versions, each within the phase-2 limit of the reference; the
    plain version and the Pallas kernel agree within the same limit."""
    (q, k, v, g), (jdq, jdk, jdv) = jax_bwd[(Sq, Sk)]
    lse, delta = _rows(q, k, v, g)
    args = (q, k, v, None, g, lse, delta)
    if name == "flash_bwd_dq":
        got, want, ref = (emulate_bwd_dq(q, k, v, g, lse, delta),), \
            (kernels.flash_bwd_dq_plain(*args, scale=SCALE),), (jdq,)
    else:
        got, want, ref = emulate_bwd_dkv(q, k, v, g, lse, delta), \
            kernels.flash_bwd_dkv_plain(*args, scale=SCALE), (jdk, jdv)
    for a, b, r in zip(got, want, ref):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape == r.shape
        assert bool(torch.isfinite(a.float()).all())
        assert _err(a, b) <= _limit(b) and _err(a, r) <= _limit(r)
        assert _err(b, r) <= _limit(r)


@pytest.mark.parametrize("name", BWD)
@pytest.mark.parametrize("Sq,Sk", CASES)
def test_emulated_body_keeps_plain_bits(Sq, Sk, name):
    """The share phase 2 asks of the wgmma bodies' output (dq; dk and dv
    together), chip_smoke.match_share against the plain version: with dS
    (and P) split hi + lo it is at least chip_smoke.K5A_MATCH (99.7-99.8%),
    with them rounded once to bf16, or their lo products left out, it is
    below 0.7 (57-59%), so the share tells the two apart where the phase-2
    limit alone does not."""
    q, k, v, g = _inputs(Sq, Sk, seed=Sq + 5 * Sk)
    lse, delta = _rows(q, k, v, g)
    emulate = emulate_bwd_dq if name == "flash_bwd_dq" else emulate_bwd_dkv
    want = getattr(kernels, name + "_plain")(q, k, v, None, g, lse, delta, scale=SCALE)
    split = emulate(q, k, v, g, lse, delta)
    once = emulate(q, k, v, g, lse, delta, split=_round_once)
    assert chip_smoke.match_share(name, split, want) >= chip_smoke.K5A_MATCH
    assert chip_smoke.match_share(name, once, want) < 0.7


def test_match_share_takes_dk_and_dv_together():
    """K5c's share is over dk and dv together; K5a's over its output, not
    its lse."""
    a, b = torch.ones(4, dtype=torch.bfloat16), torch.zeros(4, dtype=torch.bfloat16)
    assert chip_smoke.match_share("flash_bwd_dkv", (a, a), (a, b)) == 0.5
    assert chip_smoke.match_share("flash_bwd_dq", a, a) == 1.0
    assert chip_smoke.match_share("flash_attention_lse", (a, a), (a, b)) == 1.0


def test_chip_smoke_bwd_inputs():
    """chip_smoke.bwd_inputs, the set-up of phase 2's two bodies and the
    variants script: bfloat16 q, k, v, dO of the site's shape and the plain
    forward's float32 lse and delta on them."""
    gen = torch.Generator().manual_seed(7)
    q, k, v, g, lse, delta = chip_smoke.bwd_inputs(kernels, (1, 77, 200, H, D), gen, "cpu")
    assert q.shape == g.shape == (1, 77, H, D) and k.shape == v.shape == (1, 200, H, D)
    assert {x.dtype for x in (q, k, v, g)} == {torch.bfloat16}
    want_lse, want_delta = _rows(q, k, v, g)
    assert torch.equal(lse, want_lse) and torch.equal(delta, want_delta)


@pytest.mark.parametrize("Sq,Sk", [(333, 1000), (1000, 77)])
def test_tile_sizes_move_only_roundings(Sq, Sk):
    """128-key tiles for K5b (the variants script's other form) and
    128-query tiles for K5c against the 64-row ones the bodies build: the
    sums move only by float32 roundings, within a quarter of the phase-2
    limit."""
    q, k, v, g = _inputs(Sq, Sk, seed=Sq * Sk)
    lse, delta = _rows(q, k, v, g)
    a = emulate_bwd_dq(q, k, v, g, lse, delta, 64)
    b = emulate_bwd_dq(q, k, v, g, lse, delta, 128)
    assert _err(a, b) <= _limit(a) / 4
    for x, y in zip(emulate_bwd_dkv(q, k, v, g, lse, delta, 64),
                    emulate_bwd_dkv(q, k, v, g, lse, delta, 128)):
        assert _err(x, y) <= _limit(x) / 4


# whether each bf16 K5b / K5c site of chip_smoke.py takes a wgmma body: the
# training step's pano spatial sites the one of csrc/attn_wgmma_bwd.cuh, the
# WarpAttn ones (D = 32, a bias) the biased one of
# csrc/attn_wgmma_bwd_bias.cuh; none stays on mma.sync
ROUTE = {(name, site): True for name in BWD for site in (
    "train_pano_spatial_s0", "train_pano_spatial_s1", "train_warp_r2_pano_q",
    "train_warp_r2_pers_q", "train_warp_r8_pano_q", "train_warp_r2_pano_q_h20",
    "train_warp_r2_pers_q_h20", "train_warp_r4_pano_q", "train_warp_r4_pers_q",
    "train_warp_r4_pano_q_h40", "train_warp_r4_pers_q_h40", "train_warp_r8_pers_q")}


def test_route_at_every_k5b_k5c_site():
    """Every K5b and K5c site of chip_smoke.SITES is in ROUTE and takes a
    wgmma body as named there (a WarpAttn site carries its bias): the one
    of `kernels.wgmma_route` at D = 64, the biased one of
    `kernels.bwd_bias_wgmma_route` at the WarpAttn sites; and so does
    chip_smoke's rule by shape."""
    sites = {(n, s): shape for n, s, shape in chip_smoke.SITES if n in BWD}
    assert set(sites) == set(ROUTE)
    for (name, site), shape in sites.items():
        B, Sq, Sk, Hs, Ds = shape
        bias = chip_smoke.site_has_bias(site)
        assert kernels.wgmma_route(name, torch.bfloat16, Sq, Sk, Hs, Ds, bias) == (
            ROUTE[(name, site)] and not bias), (name, site)
        assert kernels.bwd_bias_wgmma_route(name, torch.bfloat16, Sq, Sk, Ds,
                                            (0, 0) if bias else None) == (
            ROUTE[(name, site)] and bias), (name, site)
        assert chip_smoke.shape_routed(kernels, name, shape, bias) == ROUTE[(name, site)]


@pytest.mark.parametrize("world", [2, 4])
def test_route_at_per_shard_k5b_k5c_shapes(world):
    """The per-shard shapes of chip_smoke.SHARD_SITES and of 4 ranks: a
    rank's pano rows (Sq = 8192 / W against every key) take the wgmma body,
    a rank's perspective-query rows at a WarpAttn site (D = 32, a bias) the
    biased one; chip_smoke's rule by shape routes both."""
    sites = {s: shape for _, s, shape in chip_smoke.SITES}
    shards = [(name, site, what) for name, site, what, _ in chip_smoke.SHARD_SITES
              if name in BWD]
    assert sorted(shards) == sorted((n, s, "queries") for n in BWD
                                    for s in ("train_pano_spatial_s0", "train_warp_r2_pers_q"))
    for name, site, what in shards:
        B, Sq, Sk, Hs, Ds = chip_smoke.shard_shape(sites[site], what, world)
        assert Sq == sites[site][1] // world
        bias = chip_smoke.site_has_bias(site)
        assert kernels.wgmma_route(name, torch.bfloat16, Sq, Sk, Hs, Ds, bias) == ("pano" in site)
        assert kernels.bwd_bias_wgmma_route(name, torch.bfloat16, Sq, Sk, Ds,
                                            (0, 0) if bias else None) == ("warp" in site)
        assert chip_smoke.shape_routed(kernels, name, (B, Sq, Sk, Hs, Ds), bias)


@pytest.mark.parametrize("name", BWD)
def test_route_refuses_off_rule_calls(name):
    """A bias, another head dim, float32, a pointer off a 16-byte boundary
    (each that a tensor map reads), and for K5c an Sq that is no multiple of
    4 stay on the `mma.sync` tile (or the CUDA cores); K5b takes any Sq."""
    args = (2048, 2048, 10, 64)
    n_ptrs = 5 if name == "flash_bwd_dq" else 8
    ptrs = tuple(16 * 1024 * (i + 1) for i in range(n_ptrs))
    assert kernels.wgmma_route(name, torch.bfloat16, *args, ptrs=ptrs)
    assert not kernels.wgmma_route(name, torch.bfloat16, *args, bias=True)
    assert not kernels.wgmma_route(name, torch.float32, *args)
    for d in (32, 40, 128):
        assert not kernels.wgmma_route(name, torch.bfloat16, *args[:3], d)
    for i in range(n_ptrs):
        off = tuple(p + 4 * (j == i) for j, p in enumerate(ptrs))
        assert not kernels.wgmma_route(name, torch.bfloat16, *args, ptrs=off)
    for Sq in (77, 333, 1000, 4098, 8192):
        assert kernels.wgmma_route(name, torch.bfloat16, Sq, 1000, 2, 64) == (
            name == "flash_bwd_dq" or Sq % 4 == 0)


def test_plain_path_counts_no_wgmma_launch_k5b_k5c():
    """On the CPU K5b and K5c run their plain versions: one plain call each,
    no launch, no wgmma launch."""
    q, k, v, g = _inputs(200, 333, seed=1)
    lse, delta = _rows(q, k, v, g)
    kernels.reset_counts()
    kernels.flash_bwd_dq(q, k, v, None, g, lse, delta, scale=SCALE)
    kernels.flash_bwd_dkv(q, k, v, None, g, lse, delta, scale=SCALE)
    assert set(kernels.wgmma_counts().values()) == {0}
    assert kernels.flash_bwd_dq.plain_calls == kernels.flash_bwd_dkv.plain_calls == 1
    assert kernels.flash_bwd_dq.launches == kernels.flash_bwd_dkv.launches == 0


def test_chip_smoke_rule_by_shape_k5b_k5c():
    """chip_smoke.wgmma_expected counts, from the launches by shape, K5b's
    and K5c's at the pano spatial sites of a training step (5 at s0 and 5 at
    s1) and at the WarpAttn sites (D = 32, the biased body: here r2 both
    ways once and r8 three times), all of them."""
    kernels.reset_counts()
    try:
        for fn in (kernels.flash_bwd_dq, kernels.flash_bwd_dkv):
            fn.shape_launches.update({(16, 8192, 8192, 5, 64): 5, (16, 2048, 2048, 10, 64): 5,
                                      (16, 2048, 5120, 10, 32): 1, (16, 5120, 2048, 10, 32): 1,
                                      (16, 128, 320, 40, 32): 3})
        want = {name: 0 for name in kernels.wgmma_counts()}
        want.update({name: 15 for name in BWD})
        assert chip_smoke.wgmma_expected(kernels) == want
    finally:
        kernels.reset_counts()


def test_chip_smoke_tables_name_both_bodies():
    """chip_smoke runs both bodies of K5b and K5c at the routed sites
    (TWO_BODY_KERNELS, SPLIT_BODY_KERNELS), names each body's source, which
    exists, counts the two wgmma kernels' HGMMA in phase 1 and holds their
    output to K5A_MATCH (MATCH_KERNELS)."""
    for name in BWD:
        assert name in chip_smoke.TWO_BODY_KERNELS and name in chip_smoke.SPLIT_BODY_KERNELS
        bodies = chip_smoke.KERNEL_BODY_SOURCES[name]
        assert bodies["wgmma"].endswith("csrc/attn_wgmma_bwd.cuh")
        assert bodies["mma_sync"].endswith("csrc/attn_mma_bwd.cuh")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert all(os.path.isfile(os.path.join(root, p)) for p in bodies.values())
        assert chip_smoke.WGMMA_KERNEL_NAMES[f"{name}_wgmma_kernel"] == 1
        assert name in chip_smoke.MATCH_KERNELS
