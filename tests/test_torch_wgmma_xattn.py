"""The arithmetic of K1's one-key-tile `wgmma` body, emulated on the CPU,
and the rule that sends launches to it.

In bfloat16 at head dim 64 without a bias, at most 128 keys and more than
32 queries, not both at most 64 (`kernels.xattn_route`: the text and image-prompt
cross-attention sites), `kernels.tiny_attention` runs
csrc/attn_wgmma_xattn.cuh: a persistent block walks work items of 128
query rows (two consumer warpgroups of 64) of one (batch, head); the keys,
rounded up to 64, 80 or 128 (`kernels.xattn_keys`), are one tile, so the
row is whole: S = Q·Kᵀ in float32 scaled to log2 units by scale·log2(e),
keys past Sk at the finite -1e30, the row max, P = 2^(S - m) (flushed to 0
below 2**-126: ex2.approx.ftz) rounded once to bfloat16 before P·V while
the sum takes the unrounded P, the output multiplied by the reciprocal of
the sum (a zero sum replaced by 1). `emulate_xattn` repeats that order in
torch. The tests hold it, on seeded bfloat16 inputs with ragged query
counts and the sites' key counts (13, 64, 77, 128; H = 2, D = 64), to
chip_smoke.py's phase-2 limit for a bfloat16 output (chip_smoke.bf16_limit)
against

- the port's plain version (`tiny_attention_plain`),
- the JAX package's Pallas kernel run in interpret mode on the CPU, as the
  JAX package's tests run it (`tiny_packed_attention`);

show that one key tile instead of the `mma.sync` body's 64-key tiles moves
only roundings; and pin `kernels.xattn_route` at every K1 site of
chip_smoke.py (the denoise loop's cross sites at every stage, the SR
stage's, the per-shard shapes of 2 and 4 ranks), its refusals, and
chip_smoke's check of the bodies by shape.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagine360_tpu.ops.pallas_attention import tiny_packed_attention

from imagine360_tpu_torch.ops import kernels

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from test_torch_wgmma_attention import emulate_wgmma_tile  # noqa: E402

torch.set_num_threads(2)

LOG2E = 1.4426950408889634
NEG_INF = -1e30                # csrc/attn_common.cuh kNegInf
FTZ = 2.0 ** -126              # ex2.approx.ftz gives 0 below the least normal float
H, D = 2, 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (Sq, Sk): ragged query counts at the sites' key counts (the SR pano
# engine's 13 text tokens, the image prompt's 64, the text's 77, a full tile)
CASES = [(333, 77), (200, 64), (129, 13), (77, 128), (33, 100)]


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()


def _inputs(Sq, Sk, seed, B=1):
    """q [B, Sq, H*D], k/v [B, Sk, H*D] bfloat16 of unit scale."""
    rng = np.random.default_rng(seed)
    return _bf16(rng, B, Sq, H * D), _bf16(rng, B, Sk, H * D), _bf16(rng, B, Sk, H * D)


def emulate_xattn(q, k, v, scale):
    """csrc/attn_wgmma_xattn.cuh:attn_xattn_body's order on bfloat16 q
    [B, Sq, H*D], k/v [B, Sk, H*D] (Sk <= 128): per (batch, head) the whole
    row at once. The key tile's N - Sk padding keys (N = xattn_keys(Sk))
    are zero rows masked to -1e30: they take part in the max as -1e30 and
    add 2^(-1e30 - m) = 0 to the sum, so they are left out here."""
    B, Sq, C = q.shape
    heads = lambda x: x.reshape(B, x.shape[1], C // D, D).permute(0, 2, 1, 3).float()
    qh, kh, vh = heads(q), heads(k), heads(v)
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    x = (qh @ kh.transpose(2, 3)) * sl2
    m = x.amax(dim=3, keepdim=True)
    p = torch.exp2(x - m)
    p = torch.where(p < FTZ, torch.zeros_like(p), p)
    l = p.sum(dim=3, keepdim=True)
    o = p.bfloat16().float() @ vh
    inv = 1.0 / torch.where(l == 0, torch.ones_like(l), l)
    return (o * inv).bfloat16().permute(0, 2, 1, 3).reshape(B, Sq, C)


def _jax(q, k, v, scale):
    """The JAX package's Pallas kernel in interpret mode, no bias."""
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    bias = jnp.zeros((1, q.shape[1], k.shape[1]), jnp.float32)
    out = tiny_packed_attention(j(q), j(k), j(v), bias, scale, H, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.fixture(scope="module")
def jax_outputs():
    """{(Sq, Sk): (inputs, the JAX kernel's output)} of CASES."""
    outs = {}
    for Sq, Sk in CASES:
        q, k, v = _inputs(Sq, Sk, seed=Sq + Sk)
        outs[(Sq, Sk)] = (q, k, v), _jax(q, k, v, D ** -0.5)
    return outs


def _err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _limit(want):
    return chip_smoke.bf16_limit(want.float().abs().max().item())


@pytest.mark.parametrize("Sq,Sk", CASES)
def test_emulated_xattn_matches_plain_and_jax(Sq, Sk, jax_outputs):
    """The body's order against the port's plain version and the JAX Pallas
    kernel (interpret mode), both within the phase-2 bf16 limit; the plain
    version and the JAX kernel agree within it too."""
    (q, k, v), ref = jax_outputs[(Sq, Sk)]
    scale = D ** -0.5
    got = emulate_xattn(q, k, v, scale)
    want = kernels.tiny_attention_plain(q, k, v, scale=scale, heads=H)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    assert _err(got, want) <= _limit(want)
    assert _err(got, ref) <= _limit(ref)
    assert _err(want, ref) <= _limit(ref)


@pytest.mark.parametrize("Sq,Sk", CASES)
def test_one_key_tile_moves_only_roundings(Sq, Sk):
    """One tile of all keys instead of the `mma.sync` body's 64-key tiles
    (emulated by the 128-key-tile order with 64-key tiles) moves only where
    the running max rescales, hence only roundings: within 2**-7 of the
    largest output (two bf16 ulps of it); with one tile of at most 128 keys
    the 128-key-tile order is this body's, within one bf16 ulp."""
    q, k, v = _inputs(Sq, Sk, seed=7 * Sq + Sk, B=2)
    scale = D ** -0.5
    new = emulate_xattn(q, k, v, scale)
    old = emulate_wgmma_tile(q, k, v, scale, 64)
    same = emulate_wgmma_tile(q, k, v, scale, 128)
    peak = new.float().abs().max().item()
    assert _err(new, old) <= 2 ** -7 * peak
    assert _err(new, same) <= chip_smoke.bf16_limit(peak)


def test_padding_keys_add_nothing():
    """The key tile's padding (Sk rounded up to N keys, zero rows masked to
    -1e30 in log2 units) leaves the row's max, sum and output as they are:
    the emulation with N - Sk masked zero keys equals the one without,
    bit for bit, at every instantiation's key count."""
    for Sk in (13, 64, 77, 100):
        N = kernels.xattn_keys(Sk)
        q, k, v = _inputs(40, Sk, seed=Sk)
        pad = lambda x: torch.cat([x, torch.zeros(1, N - Sk, H * D, dtype=x.dtype)], 1)
        scale = D ** -0.5
        qh = q.reshape(1, 40, H, D).permute(0, 2, 1, 3).float()
        kh = pad(k).reshape(1, N, H, D).permute(0, 2, 1, 3).float()
        x = (qh @ kh.transpose(2, 3)) * (torch.tensor(scale) * torch.tensor(LOG2E))
        x[..., Sk:] = NEG_INF
        m = x.amax(dim=3, keepdim=True)
        p = torch.exp2(x - m)
        assert bool((p[..., Sk:] == 0).all())
        assert torch.equal(m, x[..., :Sk].amax(dim=3, keepdim=True))


def test_xattn_keys_are_the_instantiations():
    """Sk rounded up to 64, 80 or 128: the three instantiations of
    tiny_attention_xattn_wgmma_kernel (chip_smoke.WGMMA_KERNEL_NAMES counts
    three)."""
    assert [kernels.xattn_keys(s) for s in (1, 13, 64, 65, 77, 80, 81, 100, 128)] == [
        64, 64, 64, 80, 80, 80, 128, 128, 128]
    assert kernels.XATTN_KEYS == (64, 80, 128) and kernels.XATTN_MAX_SK == 128
    assert chip_smoke.WGMMA_KERNEL_NAMES["tiny_attention_xattn_wgmma_kernel"] == 3
    assert os.path.isfile(os.path.join(ROOT, chip_smoke.XATTN_BODY_SOURCE))


# the body each K1 site of chip_smoke.SITES takes in bf16 (shape_body)
BODY = {
    "pers_spatial_s0": "wgmma", "pano_spatial_s2": "wgmma", "ragged_d64": "wgmma",
    "pers_text_cross_s0": "wgmma_xattn", "pano_text_cross_s0": "wgmma_xattn",
    "sr_pano_ip_cross_s0": "wgmma_xattn", "sr_text_cross_s0": "wgmma_xattn",
    "pers_ip_cross_s0": "wgmma_xattn", "pano_ip_cross_s0": "wgmma_xattn",
    "pers_text_cross_s1": "wgmma_xattn", "pers_ip_cross_s1": "wgmma_xattn",
    "pano_text_cross_s1": "wgmma_xattn", "pano_ip_cross_s1": "wgmma_xattn",
    "pers_text_cross_s2": "wgmma_xattn",
    "pers_ip_cross_s2": "mma_sync",          # 64 queries and 64 keys
    "pano_text_cross_s2": "wgmma_xattn", "pano_ip_cross_s2": "wgmma_xattn",
    "pano_text_cross_s3": "wgmma_xattn", "pano_ip_cross_s3": "wgmma_xattn",
    "pano_spatial_s3": "wgmma_xattn",        # 128 keys
    "pers_text_cross_s3": "mma_sync",        # 16 queries
    "pers_ip_cross_s3": "mma_sync",
    "temporal_proj_frames": "mma_sync",      # 16 queries
    "sr_v2v_temporal_s0": "mma_sync",
    "ragged_bias": "mma_sync",               # a bias, D = 40
    "vae_pers_encode": "wgmma_wide",         # D = 512
    "wide_ragged_bias": "wide_mma_sync",     # D = 200 under a bias
}


def test_body_at_every_k1_site():
    """Every K1 site of chip_smoke.SITES is in BODY and takes the body named
    there; xattn_route holds exactly at the `wgmma_xattn` ones."""
    sites = {s: shape for n, s, shape in chip_smoke.SITES if n == "tiny_attention"}
    assert set(sites) == set(BODY)
    for site, (B, Sq, Sk, Hs, Ds) in sites.items():
        bias = chip_smoke.site_has_bias(site)
        assert chip_smoke.shape_body(kernels, "tiny_attention", (B, Sq, Sk, Hs, Ds),
                                     bias) == BODY[site], site
        assert kernels.xattn_route(torch.bfloat16, Sq, Sk, Hs, Ds, bias) == (
            BODY[site] == "wgmma_xattn"), site
        assert chip_smoke.shape_routed(kernels, "tiny_attention", (B, Sq, Sk, Hs, Ds),
                                       bias) == BODY[site].startswith("wgmma"), site


@pytest.mark.parametrize("site,what", [("pers_text_cross_s0", "batch"),
                                       ("pers_ip_cross_s0", "batch"),
                                       ("pano_text_cross_s0", "queries"),
                                       ("pano_ip_cross_s1", "queries"),
                                       ("sr_text_cross_s0", "queries")])
def test_route_at_per_shard_shapes(site, what):
    """A rank's share of a cross site on a 2- or 4-rank mesh (the views'
    batch rows, or the pano's query rows) keeps the one-key-tile body."""
    shape = next(s for n, name, s in chip_smoke.SITES if name == site)
    for w in (2, 4):
        B, Sq, Sk, Hs, Ds = chip_smoke.shard_shape(shape, what, w)
        assert kernels.xattn_route(torch.bfloat16, Sq, Sk, Hs, Ds), (site, w)
        assert chip_smoke.shape_body(kernels, "tiny_attention", (B, Sq, Sk, Hs, Ds)) == \
            "wgmma_xattn"


def test_route_refuses_off_rule_calls():
    """float32, another head dim, a bias, at most 32 queries, more than 128
    keys, and a pointer off a 16-byte boundary (q, k, v or out) stay off
    the one-key-tile body."""
    args = (1024, 77, 5, 64)
    assert kernels.xattn_route(torch.bfloat16, *args, ptrs=(0, 16, 4096, 2 ** 40))
    assert not kernels.xattn_route(torch.float32, *args)
    assert not kernels.xattn_route(torch.bfloat16, 1024, 77, 5, 40)
    assert not kernels.xattn_route(torch.bfloat16, 1024, 77, 2, 128)
    assert not kernels.xattn_route(torch.bfloat16, *args, bias=True)
    assert not kernels.xattn_route(torch.bfloat16, 32, 77, 5, 64)
    assert kernels.xattn_route(torch.bfloat16, 33, 77, 5, 64)
    # one query tile and one key tile of the mma.sync body stay there
    assert not kernels.xattn_route(torch.bfloat16, 64, 64, 20, 64)
    assert not kernels.xattn_route(torch.bfloat16, 33, 13, 5, 64)
    assert kernels.xattn_route(torch.bfloat16, 65, 64, 20, 64)
    assert kernels.xattn_route(torch.bfloat16, 64, 65, 20, 64)
    assert kernels.xattn_route(torch.bfloat16, 1024, 128, 5, 64)
    assert not kernels.xattn_route(torch.bfloat16, 1024, 129, 5, 64)
    assert kernels.wgmma_route("tiny_attention", torch.bfloat16, 1024, 129, 5, 64)
    for ptrs in ((2, 0, 0, 0), (0, 8, 0, 0), (0, 0, 4, 0), (0, 0, 0, 8)):
        assert not kernels.xattn_route(torch.bfloat16, *args, ptrs=ptrs)
    # the two wgmma bodies of K1 never claim the same call
    for Sq in (16, 33, 1024):
        for Sk in (13, 77, 128, 129, 1024):
            assert not (kernels.xattn_route(torch.bfloat16, Sq, Sk, 5, 64)
                        and kernels.wgmma_route("tiny_attention", torch.bfloat16, Sq, Sk, 5, 64))


def test_plain_path_counts_no_body():
    """On the CPU the wrapper runs its plain version: one plain call, no
    launch, nothing counted by body."""
    q, k, v = _inputs(100, 77, seed=2)
    kernels.reset_counts()
    kernels.tiny_attention(q, k, v, scale=0.125, heads=H)
    assert kernels.tiny_attention.plain_calls == 1 and kernels.tiny_attention.launches == 0
    assert kernels.body_counts() == {"tiny_attention": {}, "mh_flash_attention": {}}
    assert kernels.wgmma_counts()["tiny_attention"] == 0


def test_chip_smoke_bodies_by_shape():
    """chip_smoke.body_expected (phases 4-13: every K1 and K2 launch the
    rules assign to a body took it, as the wrappers count them by body)
    names, from the launches by shape of a denoise step's K1, the
    one-key-tile body at the cross sites, the 128-key-tile one at the
    spatial sites and `mma.sync` at 16 queries; wgmma_expected counts both
    wgmma bodies; path_launches lists the one-key-tile launches apart."""
    kernels.reset_counts()
    try:
        shapes = {(640, 1024, 1024, 5, 64): 5, (640, 1024, 77, 5, 64): 5,
                  (640, 1024, 64, 5, 64): 5, (32, 8192, 77, 5, 64): 5,
                  (640, 16, 77, 20, 64): 1, (32, 128, 64, 20, 64): 1}
        kernels.tiny_attention.shape_launches.update(shapes)
        kernels.tiny_attention.tc_launches = kernels.tiny_attention.launches = 22
        kernels.tiny_attention.body_launches.update(wgmma=5, wgmma_xattn=16, mma_sync=1)
        want = {"tiny_attention": {"wgmma": 5, "wgmma_xattn": 16, "mma_sync": 1},
                "mh_flash_attention": {}}
        assert chip_smoke.body_expected(kernels) == want == kernels.body_counts()
        assert chip_smoke.wgmma_expected(kernels)["tiny_attention"] == 21
        launches = chip_smoke.path_launches(kernels)
        assert launches["tiny_attention_wgmma_xattn"] == 16
        assert launches["tiny_attention_wgmma_wide"] == 0
    finally:
        kernels.reset_counts()
