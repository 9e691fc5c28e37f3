"""The arithmetic of the `wgmma` attention body of K1 and K2, emulated on the
CPU, and the rule that sends launches to it.

In bfloat16 at head dim 64 without a bias, `kernels.tiny_attention` (K1,
more than 32 queries and 128 keys) and `kernels.mh_flash_attention` (K2)
run csrc/attn_wgmma.cuh: a block of 128 query rows (two consumer
warpgroups of 64) walks 128-key tiles; S = Q·Kᵀ in float32, scaled to log2
units by scale·log2(e), keys past the end at the finite -1e30, a running
max and sum, P = 2^(S - m) (flushed to 0 below 2**-126: ex2.approx.ftz)
rounded once to bfloat16 before P·V while the sum takes the unrounded P,
the output divided by the sum at the end. (Inside a warpgroup the body
runs a tile's softmax while the previous tile's P·V is on the tensor
cores; the order of the arithmetic is the one-tile-at-a-time order.)
`emulate_wgmma_tile` repeats that order in torch (with K5a's and K6a's
options too, the lse, P split and sequence-minor inputs, which
tests/test_torch_wgmma_lse.py holds to their references). The tests hold it, on
seeded bfloat16 inputs with ragged query and key counts (77, 200, 333,
1000; H = 2, D = 64), to chip_smoke.py's phase-2 limit for a bfloat16
output, min(2e-2, 2**-5 x max|plain|), against

- the port's plain versions (`tiny_attention_plain`, `mh_flash_attention_plain`),
- the JAX package's Pallas kernels run in interpret mode on the CPU, as the
  JAX package's tests run them (`tiny_packed_attention`,
  `mh_flash_attention`);

show that the 128-key tiles (the `mma.sync` body's are 64 keys) move only
roundings; and pin `kernels.wgmma_route` at every K1 and K2 site of
chip_smoke.py (the denoise loop's, the SR stage's and the per-shard shapes
of 2 and 4 ranks), and chip_smoke's check of the rule by shape.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagine360_tpu.ops.pallas_attention import mh_flash_attention, tiny_packed_attention

from imagine360_tpu_torch.ops import kernels

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

QUERY_TILE = 128               # csrc/attn_wgmma.cuh kWgBQ
KEY_TILE = 128                 # csrc/attn_wgmma.cuh kWgBK
LOG2E = 1.4426950408889634
LN2 = torch.tensor(0.6931471805599453, dtype=torch.float32)   # csrc/attn_mma.cuh kLn2
NEG_INF = -1e30                # csrc/attn_common.cuh kNegInf
FTZ = 2.0 ** -126              # ex2.approx.ftz gives 0 below the least normal float
BF16_TOL, BF16_REL = 2e-2, 2 ** -5   # chip_smoke.py BF16_TOL, BF16_REL
H, D = 2, 64

# (kernel, Sq, Sk): ragged query and key counts, one and several key tiles
CASES = [("tiny_attention", 333, 1000), ("tiny_attention", 77, 200),
         ("tiny_attention", 200, 333), ("mh_flash_attention", 1000, 333),
         ("mh_flash_attention", 77, 1000), ("mh_flash_attention", 200, 77)]


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()


def _inputs(Sq, Sk, seed):
    """q [1, Sq, H*D], k/v [1, Sk, H*D] bfloat16 of unit scale."""
    rng = np.random.default_rng(seed)
    return _bf16(rng, 1, Sq, H * D), _bf16(rng, 1, Sk, H * D), _bf16(rng, 1, Sk, H * D)


def emulate_wgmma_tile(q, k, v, scale, key_tile=KEY_TILE, split_p=False, lse=False,
                       layout="packed"):
    """csrc/attn_wgmma.cuh:attn_wgmma_tile's order on bfloat16 inputs in one
    of three layouts: "packed", K1's and K2's q [B, Sq, H*D], k/v
    [B, Sk, H*D], output [B, Sq, H*D]; "bshd", K5a's [B, S, H, D]; and
    "bhds", K6a's sequence-minor q/k/v [B, H, D, S] (SEQ_MINOR), output
    [B, H, Sq, D]. Per (batch, head) and 128-row query tile: S = Q·Kᵀ in
    float32 scaled to log2 units by scale·log2(e), a running max and sum,
    α and P = 2^(S - m) flushed to 0 below 2**-126 (ex2.approx.ftz), the sum
    over the unrounded P, P·V on P rounded once to bfloat16 or, with
    `split_p` (K5a, K6a), on the exact split hi = bf16(p), lo = bf16(p - hi),
    the lo product first; at the end a zero sum replaced by 1, the output
    divided by it and rounded to bfloat16, and with `lse` also the float32
    (m + log2 l)·ln 2 of each row, [B, H, Sq] (returned beside the output).
    Keys past Sk are dropped, which is what -1e30 gives them (2^(-1e30 - m) =
    0 once a real key set the max); `key_tile` 64 gives K5a's and K6a's
    64-key form and the `mma.sync` body's tiles."""
    if layout == "packed":
        B, Sq, C = q.shape
        heads = lambda x: x.reshape(B, x.shape[1], C // D, D).permute(0, 2, 1, 3)
    elif layout == "bshd":
        heads = lambda x: x.permute(0, 2, 1, 3)
    else:
        heads = lambda x: x.transpose(2, 3)
    qh, kh, vh = (heads(x).float() for x in (q, k, v))     # [B, H, S, D]
    B, Hs, Sq, _ = qh.shape
    Sk = kh.shape[2]
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    out = torch.empty(B, Hs, Sq, D, dtype=torch.bfloat16)
    lses = torch.empty(B, Hs, Sq)
    for b in range(B):
        for h in range(Hs):
            kf, vf = kh[b, h], vh[b, h]
            for q0 in range(0, Sq, QUERY_TILE):
                qf = qh[b, h, q0:q0 + QUERY_TILE]
                m = torch.full((qf.shape[0],), NEG_INF)
                l = torch.zeros(qf.shape[0])
                o = torch.zeros(qf.shape[0], D)
                for k0 in range(0, Sk, key_tile):
                    x = (qf @ kf[k0:k0 + key_tile].T) * sl2
                    m_new = torch.maximum(m, x.amax(dim=1))
                    alpha, p = torch.exp2(m - m_new), torch.exp2(x - m_new[:, None])
                    alpha, p = (torch.where(e < FTZ, torch.zeros_like(e), e) for e in (alpha, p))
                    l = l * alpha + p.sum(dim=1)
                    hi, vt = p.bfloat16().float(), vf[k0:k0 + key_tile]
                    o = o * alpha[:, None]
                    if split_p:
                        o = o + (p - hi).bfloat16().float() @ vt
                    o = o + hi @ vt
                    m = m_new
                l = torch.where(l == 0, torch.ones_like(l), l)
                out[b, h, q0:q0 + QUERY_TILE] = (o / l[:, None]).bfloat16()
                lses[b, h, q0:q0 + QUERY_TILE] = (m + torch.log2(l)) * LN2
    if layout == "packed":
        out = out.permute(0, 2, 1, 3).reshape(B, Sq, Hs * D)
    elif layout == "bshd":
        out = out.permute(0, 2, 1, 3).contiguous()
    return (out, lses) if lse else out


def _jax(name, q, k, v, scale):
    """The JAX package's Pallas kernel in interpret mode."""
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    if name == "tiny_attention":
        bias = jnp.zeros((1, q.shape[1], k.shape[1]), jnp.float32)
        out = tiny_packed_attention(j(q), j(k), j(v), bias, scale, H, interpret=True)
    else:
        out = mh_flash_attention(j(q), j(k), j(v), scale, H, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _outputs(name):
    """{(Sq, Sk): (inputs, the JAX kernel's output)} of this kernel's cases."""
    outs = {}
    for n, Sq, Sk in CASES:
        if n == name:
            q, k, v = _inputs(Sq, Sk, seed=Sq + Sk)
            outs[(Sq, Sk)] = (q, k, v), _jax(name, q, k, v, D ** -0.5)
    return outs


@pytest.fixture(scope="module")
def jax_tiny():
    return _outputs("tiny_attention")


@pytest.fixture(scope="module")
def jax_mh():
    return _outputs("mh_flash_attention")


def _limit(want):
    return min(BF16_TOL, BF16_REL * want.float().abs().max().item())


def _err(got, want):
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("name,Sq,Sk", CASES)
def test_emulated_tile_matches_plain_and_jax(name, Sq, Sk, jax_tiny, jax_mh):
    """The body's order against the port's plain version and the JAX Pallas
    kernel (interpret mode), both within the phase-2 bf16 limit; the plain
    version and the JAX kernel agree within it too."""
    (q, k, v), ref = (jax_tiny if name == "tiny_attention" else jax_mh)[(Sq, Sk)]
    scale = D ** -0.5
    got = emulate_wgmma_tile(q, k, v, scale)
    want = getattr(kernels, name + "_plain")(q, k, v, scale=scale, heads=H)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    assert _err(got, want) <= _limit(want)
    assert _err(got, ref) <= _limit(ref)
    assert _err(want, ref) <= _limit(ref)


@pytest.mark.parametrize("Sq,Sk", [(333, 1000), (200, 333)])
def test_key_tile_moves_only_roundings(Sq, Sk):
    """128-key tiles instead of the `mma.sync` body's 64 move only where the
    running max rescales, hence only roundings: the two orders agree within
    2**-7 of the largest output (two bfloat16 ulps of it), far inside the
    phase-2 limit, and each is within that limit of the plain version."""
    q, k, v = _inputs(Sq, Sk, seed=3 * Sq + Sk)
    scale = D ** -0.5
    new, old = emulate_wgmma_tile(q, k, v, scale), emulate_wgmma_tile(q, k, v, scale, 64)
    want = kernels.tiny_attention_plain(q, k, v, scale=scale, heads=H)
    peak = want.float().abs().max().item()
    assert _err(new, old) <= 2 ** -7 * peak
    assert _err(new, want) <= _limit(want) and _err(old, want) <= _limit(want)


# the body each bf16 K1 / K2 site of chip_smoke.py takes: the denoise loop's,
# the VAE's (D = 512: the wide kernels), the SR stage's and the per-shard
# shapes of 2 and 4 ranks
ROUTE = {
    ("tiny_attention", "pers_spatial_s0"): True,
    ("tiny_attention", "pers_text_cross_s0"): False,     # 77 keys: one key tile
    ("tiny_attention", "pano_spatial_s2"): True,
    ("tiny_attention", "pano_text_cross_s0"): False,     # 77 keys
    ("tiny_attention", "temporal_proj_frames"): False,   # 16 queries
    ("tiny_attention", "ragged_bias"): False,            # a bias, D = 40
    ("tiny_attention", "ragged_d64"): True,
    ("tiny_attention", "vae_pers_encode"): False,        # D = 512
    ("mh_flash_attention", "pano_spatial_s0"): True,
    ("mh_flash_attention", "pano_spatial_s1"): True,
    ("mh_flash_attention", "ragged"): True,
    ("mh_flash_attention", "ragged_d40"): False,         # D = 40
    ("mh_flash_attention", "vae_pano_encode"): False,
    ("mh_flash_attention", "vae_pano_decode"): False,
    ("mh_flash_attention", "sr_temporal_decode"): False,
    ("tiny_attention", "wide_ragged_bias"): False,
    ("mh_flash_attention", "wide_ragged"): False,
    ("mh_flash_attention", "sr_spatial_s0"): True,
    ("mh_flash_attention", "sr_spatial_s1"): True,
    ("mh_flash_attention", "sr_spatial_s2"): True,
    ("tiny_attention", "sr_pano_ip_cross_s0"): False,    # 64 keys
    ("tiny_attention", "sr_text_cross_s0"): False,       # 77 keys
    ("tiny_attention", "sr_v2v_temporal_s0"): False,     # 16 queries
    ("mh_flash_attention", "sr_vae_encode"): False,
    # the rest of a denoise step's cross-attention sites: one key tile
    # (tests/test_torch_wgmma_xattn.py pins their own body)
    ("tiny_attention", "pers_ip_cross_s0"): False,
    ("tiny_attention", "pano_ip_cross_s0"): False,
    ("tiny_attention", "pers_text_cross_s1"): False,
    ("tiny_attention", "pers_ip_cross_s1"): False,
    ("tiny_attention", "pano_text_cross_s1"): False,
    ("tiny_attention", "pano_ip_cross_s1"): False,
    ("tiny_attention", "pers_text_cross_s2"): False,
    ("tiny_attention", "pers_ip_cross_s2"): False,
    ("tiny_attention", "pano_text_cross_s2"): False,
    ("tiny_attention", "pano_ip_cross_s2"): False,
    ("tiny_attention", "pers_text_cross_s3"): False,
    ("tiny_attention", "pers_ip_cross_s3"): False,
    ("tiny_attention", "pano_text_cross_s3"): False,
    ("tiny_attention", "pano_ip_cross_s3"): False,
    ("tiny_attention", "pano_spatial_s3"): False,     # 128 keys: one key tile
}


def test_route_at_every_k1_k2_site():
    """Every K1 and K2 site of chip_smoke.SITES is in ROUTE and takes the
    body named there."""
    sites = {(n, s): shape for n, s, shape in chip_smoke.SITES
             if n in ("tiny_attention", "mh_flash_attention")}
    assert set(sites) == set(ROUTE)
    for (name, site), (B, Sq, Sk, Hs, Ds) in sites.items():
        got = kernels.wgmma_route(name, torch.bfloat16, Sq, Sk, Hs, Ds, site.endswith("_bias"))
        assert got == ROUTE[(name, site)], (name, site)


def test_route_at_per_shard_shapes():
    """The per-shard shapes of chip_smoke.SHARD_SITES (a rank's views or
    pano rows at 2 and 4 ranks, Sq != Sk for the pano rows) all take the
    wgmma body."""
    sites = {s: shape for _, s, shape in chip_smoke.SITES}
    shards = [(name, chip_smoke.shard_shape(sites[site], what, w))
              for name, site, what, worlds in chip_smoke.SHARD_SITES
              if name in ("tiny_attention", "mh_flash_attention") for w in worlds]
    assert len(shards) == 8
    for name, (B, Sq, Sk, Hs, Ds) in shards:
        assert kernels.wgmma_route(name, torch.bfloat16, Sq, Sk, Hs, Ds), (name, Sq, Sk)


@pytest.mark.parametrize("name", ["tiny_attention", "mh_flash_attention"])
def test_route_refuses_off_rule_calls(name):
    """float32, another head dim, a bias, a pointer off a 16-byte boundary
    (q, k, v or out), and for K1 at most 32 queries or 128 keys stay on the
    `mma.sync` body (or the CUDA cores)."""
    args = (2048, 2048 if name == "mh_flash_attention" else 1024, 5, 64)
    assert kernels.wgmma_route(name, torch.bfloat16, *args, ptrs=(0, 16, 4096, 2 ** 40))
    assert not kernels.wgmma_route(name, torch.float32, *args)
    assert not kernels.wgmma_route(name, torch.bfloat16, *args[:3], 32)
    assert not kernels.wgmma_route(name, torch.bfloat16, *args[:3], 128)
    assert not kernels.wgmma_route(name, torch.bfloat16, *args, bias=True)
    for ptrs in ((2, 0, 0, 0), (0, 0, 0, 8)):
        assert not kernels.wgmma_route(name, torch.bfloat16, *args, ptrs=ptrs)
    k1 = name == "tiny_attention"
    assert kernels.wgmma_route(name, torch.bfloat16, 32, 1024, 5, 64) == (not k1)
    assert kernels.wgmma_route(name, torch.bfloat16, 33, 129, 5, 64)
    assert kernels.wgmma_route(name, torch.bfloat16, 1024, 128, 5, 64) == (not k1)


def test_plain_path_counts_no_wgmma_launch():
    """On the CPU both wrappers run their plain versions: one plain call
    each, no launch, no wgmma launch."""
    q, k, v = _inputs(200, 333, seed=1)
    kernels.reset_counts()
    kernels.tiny_attention(q, k, v, scale=0.125, heads=H)
    kernels.mh_flash_attention(q, k, v, scale=0.125, heads=H)
    assert kernels.wgmma_counts() == {"tiny_attention": 0, "mh_flash_attention": 0,
                                      "flash_attention_lse": 0, "flash_attention_t": 0,
                                      "shared_bias_attention_folded": 0, "dense_matmul": 0,
                                      "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                                      "shared_bias_attention": 0}
    assert kernels.tiny_attention.plain_calls == kernels.mh_flash_attention.plain_calls == 1
    assert kernels.tiny_attention.launches == kernels.mh_flash_attention.launches == 0


def test_chip_smoke_rule_by_shape():
    """chip_smoke.wgmma_expected (phases 4-13: every launch the rules assign
    to a wgmma body took it) counts, from the launches by shape, those at
    the shapes the rules send there: here K1's 3 at pers s0 and its 4 at
    the text cross-attention (the one-key-tile body, `xattn_route`) and
    none at the temporal frames, K2's 2 at pano s0 and its 1 at the VAE's
    D = 512 (the wide body, `wide_wgmma_route`)."""
    kernels.reset_counts()
    try:
        kernels.tiny_attention.shape_launches.update({(640, 1024, 1024, 5, 64): 3,
                                                      (640, 1024, 77, 5, 64): 4,
                                                      (10240, 16, 16, 8, 64): 2})
        kernels.mh_flash_attention.shape_launches.update({(32, 8192, 8192, 5, 64): 2,
                                                          (16, 8192, 8192, 1, 512): 1})
        assert chip_smoke.wgmma_expected(kernels) == {"tiny_attention": 7,
                                                      "mh_flash_attention": 3,
                                                      "flash_attention_lse": 0,
                                                      "flash_attention_t": 0,
                                                      "shared_bias_attention_folded": 0,
                                                      "dense_matmul": 0, "flash_bwd_dq": 0,
                                                      "flash_bwd_dkv": 0,
                                                      "shared_bias_attention": 0}
    finally:
        kernels.reset_counts()
