"""The arithmetic of the wide K1's and K2's `wgmma` body at head dim 512,
emulated on the CPU, and the rule that sends launches to it.

In bfloat16 at D = 512 without a bias (`kernels.wide_wgmma_route`: the
VAE's mid-block attention, one head of 512, in the pipeline and the SR
stage) `kernels.mh_flash_attention` and `kernels.tiny_attention` run
csrc/attn_wgmma_wide.cuh: a block of 64 query rows and two consumer
warpgroups, consumer w owning O's columns 256·w .. 256·w + 255. Per tile of
64 keys each consumer computes the partial S_w = Q[:, 256w:]·K[:, 256w:]ᵀ in
float32 over its half of the head dim; the two partials are exchanged and
added, S = S_0 + S_1 (the same bits in both consumers: IEEE addition
commutes), scaled to log2 units by scale·log2(e), keys past Sk at the
finite -1e30; a running max and sum, α and P = 2^(S - m) flushed to 0
below 2**-126 (ex2.approx.ftz), P rounded once to bfloat16 before P·V while
the sum takes the unrounded P; the output multiplied by the reciprocal of
the sum at the end (a zero sum replaced by 1). `emulate_wide_wgmma`
repeats that order in torch, with 64- or 32-key tiles (the form measured
against it, PERF.md §6). The tests hold it, at D = 512 with
ragged query and key counts, to chip_smoke.py's phase-2 limit for a
bfloat16 output (chip_smoke.bf16_limit) against

- the port's plain versions (`mh_flash_attention_plain`,
  `tiny_attention_plain`),
- the JAX package's Pallas kernels run in interpret mode on the CPU, as the
  JAX package's tests run them (`mh_flash_attention`,
  `tiny_packed_attention`), on the same seeded bfloat16 inputs;

show that the split S and the key tiles move only roundings against the
wide `mma.sync` tile's order (tests/test_torch_wide_mma.py); and pin
`kernels.wide_wgmma_route` at every wide K1 and K2 site of chip_smoke.py
and its refusals.
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
from test_torch_wide_mma import emulate_tile  # noqa: E402

torch.set_num_threads(2)

QUERY_TILE = 64                # csrc/attn_wgmma_wide.cuh kWwBQ
KEY_TILE = 64                  # csrc/attn_wgmma_wide.cuh kWwBK
HALF = 256                     # head-dim columns a consumer owns
LOG2E = 1.4426950408889634
NEG_INF = -1e30                # csrc/attn_common.cuh kNegInf
FTZ = 2.0 ** -126              # ex2.approx.ftz gives 0 below the least normal float
D = 512
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (kernel, B, Sq, Sk, H): ragged query and key counts, one and several key
# tiles, one head (the VAE's) and two
CASES = [("mh_flash_attention", 1, 100, 77, 1), ("mh_flash_attention", 1, 64, 300, 1),
         ("mh_flash_attention", 2, 130, 257, 1), ("mh_flash_attention", 1, 33, 129, 2),
         ("tiny_attention", 1, 65, 300, 1), ("tiny_attention", 2, 100, 64, 1)]


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()


def _inputs(B, Sq, Sk, H, seed):
    """q [B, Sq, H*512], k/v [B, Sk, H*512] bfloat16 of unit scale."""
    rng = np.random.default_rng(seed)
    return (_bf16(rng, B, Sq, H * D), _bf16(rng, B, Sk, H * D), _bf16(rng, B, Sk, H * D))


def emulate_wide_wgmma(q, k, v, scale, key_tile=KEY_TILE, swap=False):
    """csrc/attn_wgmma_wide.cuh:attn_wide_wgmma_tile's order on bfloat16 q
    [B, Sq, H*512], k/v [B, Sk, H*512]: per (batch, head) and 64-row query
    tile, per `key_tile` keys the two half-head-dim partials in float32,
    added (S_1 + S_0 with `swap`: the other consumer's order), the online
    softmax in log2 units, P rounded once before P·V."""
    B, Sq, C = q.shape
    Hs = C // D
    heads = lambda x: x.reshape(B, x.shape[1], Hs, D).permute(0, 2, 1, 3).float()
    qh, kh, vh = heads(q), heads(k), heads(v)
    Sk = kh.shape[2]
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    out = torch.empty(B, Hs, Sq, D, dtype=torch.bfloat16)
    for b in range(B):
        for h in range(Hs):
            for q0 in range(0, Sq, QUERY_TILE):
                qf = qh[b, h, q0:q0 + QUERY_TILE]
                m = torch.full((qf.shape[0],), NEG_INF)
                l = torch.zeros(qf.shape[0])
                o = torch.zeros(qf.shape[0], D)
                for k0 in range(0, Sk, key_tile):
                    kt, vt = kh[b, h, k0:k0 + key_tile], vh[b, h, k0:k0 + key_tile]
                    s0 = qf[:, :HALF] @ kt[:, :HALF].T
                    s1 = qf[:, HALF:] @ kt[:, HALF:].T
                    x = ((s1 + s0) if swap else (s0 + s1)) * sl2
                    m_new = torch.maximum(m, x.amax(dim=1))
                    alpha, p = torch.exp2(m - m_new), torch.exp2(x - m_new[:, None])
                    alpha, p = (torch.where(e < FTZ, torch.zeros_like(e), e) for e in (alpha, p))
                    l = l * alpha + p.sum(dim=1)
                    o = o * alpha[:, None] + p.bfloat16().float() @ vt
                    m = m_new
                inv = 1.0 / torch.where(l == 0, torch.ones_like(l), l)
                out[b, h, q0:q0 + QUERY_TILE] = (o * inv[:, None]).bfloat16()
    return out.permute(0, 2, 1, 3).reshape(B, Sq, C)


def _jax(name, q, k, v, H, scale):
    """The JAX package's Pallas kernel in interpret mode, no bias."""
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    if name == "tiny_attention":
        bias = jnp.zeros((1, q.shape[1], k.shape[1]), jnp.float32)
        out = tiny_packed_attention(j(q), j(k), j(v), bias, scale, H, interpret=True)
    else:
        out = mh_flash_attention(j(q), j(k), j(v), scale, H, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.fixture(scope="module")
def jax_outputs():
    """{case: (inputs, the JAX kernel's output)} of CASES."""
    outs = {}
    for name, B, Sq, Sk, H in CASES:
        q, k, v = _inputs(B, Sq, Sk, H, seed=B + Sq + Sk + H)
        outs[(name, B, Sq, Sk, H)] = (q, k, v), _jax(name, q, k, v, H, D ** -0.5)
    return outs


def _err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _limit(want):
    return chip_smoke.bf16_limit(want.float().abs().max().item())


@pytest.mark.parametrize("case", CASES)
def test_emulated_wide_matches_plain_and_jax(case, jax_outputs):
    """The body's order against the port's plain version and the JAX Pallas
    kernel (interpret mode), both within the phase-2 bf16 limit; the plain
    version and the JAX kernel agree within it too."""
    name, B, Sq, Sk, H = case
    (q, k, v), ref = jax_outputs[case]
    scale = D ** -0.5
    got = emulate_wide_wgmma(q, k, v, scale)
    want = getattr(kernels, name + "_plain")(q, k, v, scale=scale, heads=H)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    assert _err(got, want) <= _limit(want)
    assert _err(got, ref) <= _limit(ref)
    assert _err(want, ref) <= _limit(ref)


def test_both_consumers_hold_the_same_logits():
    """Each consumer adds the other's partial to its own: S_0 + S_1 in one,
    S_1 + S_0 in the other. IEEE addition commutes, so the two hold the
    same logits bit for bit and their outputs, each half of the columns of
    one softmax, agree bit for bit too."""
    q, k, v = _inputs(1, 100, 200, 1, seed=5)
    qf, kf = q[0].float(), k[0].float()
    s0, s1 = qf[:, :HALF] @ kf[:, :HALF].T, qf[:, HALF:] @ kf[:, HALF:].T
    assert torch.equal(s0 + s1, s1 + s0)
    scale = D ** -0.5
    assert torch.equal(emulate_wide_wgmma(q, k, v, scale),
                       emulate_wide_wgmma(q, k, v, scale, swap=True))


@pytest.mark.parametrize("Sq,Sk", [(64, 1024), (130, 333)])
def test_split_and_tiles_move_only_roundings(Sq, Sk):
    """The split S and 64-key tiles against the wide `mma.sync` tile's
    order (S over the whole head dim in two chains of k-steps, 64-key
    tiles), and 64-key against 32-key tiles (the form measured against
    it): within 2**-7 of
    the largest output (two bf16 ulps of it), far inside the phase-2
    limit."""
    rng = np.random.default_rng(Sq + Sk)
    q, k, v = _bf16(rng, 1, Sq, D), _bf16(rng, 1, Sk, D), _bf16(rng, 1, Sk, D)
    scale = D ** -0.5
    new = emulate_wide_wgmma(q, k, v, scale)
    old = emulate_tile(q[0], k[0], v[0], None, scale)
    var = emulate_wide_wgmma(q, k, v, scale, key_tile=32)
    peak = new.float().abs().max().item()
    assert _err(new[0], old) <= 2 ** -7 * peak
    assert _err(new, var) <= 2 ** -7 * peak


# the body each wide K1 / K2 site of chip_smoke.SITES takes in bf16
BODY = {
    ("tiny_attention", "vae_pers_encode"): "wgmma_wide",
    ("mh_flash_attention", "vae_pano_encode"): "wgmma_wide",
    ("mh_flash_attention", "vae_pano_decode"): "wgmma_wide",
    ("mh_flash_attention", "sr_temporal_decode"): "wgmma_wide",
    ("mh_flash_attention", "sr_vae_encode"): "wgmma_wide",
    ("tiny_attention", "wide_ragged_bias"): "wide_mma_sync",    # D = 200, a bias
    ("mh_flash_attention", "wide_ragged"): "wide_mma_sync",     # D = 192
}


def test_body_at_every_wide_site():
    """Every K1 and K2 site of chip_smoke.SITES above D = 160 is in BODY and
    takes the body named there; wide_wgmma_route holds exactly at the
    `wgmma_wide` ones, and so do the SR phases' one-frame launches."""
    sites = {(n, s): shape for n, s, shape in chip_smoke.SITES
             if n in chip_smoke.WIDE_SOURCES and shape[4] > chip_smoke.WIDE_ABOVE}
    assert set(sites) == set(BODY)
    for (name, site), shape in sites.items():
        bias = chip_smoke.site_has_bias(site)
        assert chip_smoke.shape_body(kernels, name, shape, bias) == BODY[(name, site)], site
        assert kernels.wide_wgmma_route(torch.bfloat16, shape[4], bias) == (
            BODY[(name, site)] == "wgmma_wide"), site
    for (name, shape) in chip_smoke.SR_WIDE_LAUNCHES:
        assert chip_smoke.shape_body(kernels, name, shape) == "wgmma_wide"


def test_route_refuses_off_rule_calls():
    """float32, head dims of the 256 bucket and 161..511, a bias, and a
    pointer off a 16-byte boundary (q, k, v or out) stay on the wide
    `mma.sync` tile (or the CUDA cores)."""
    assert kernels.wide_wgmma_route(torch.bfloat16, 512, ptrs=(0, 16, 4096, 2 ** 40))
    assert not kernels.wide_wgmma_route(torch.float32, 512)
    for Dd in (192, 200, 256, 384, 511):
        assert not kernels.wide_wgmma_route(torch.bfloat16, Dd)
    assert not kernels.wide_wgmma_route(torch.bfloat16, 512, bias=True)
    for ptrs in ((2, 0, 0, 0), (0, 8, 0, 0), (0, 0, 4, 0), (0, 0, 0, 8)):
        assert not kernels.wide_wgmma_route(torch.bfloat16, 512, ptrs=ptrs)


def test_chip_smoke_tables_name_the_wide_body():
    """chip_smoke counts the two wide wgmma kernels' HGMMA in phase 1, names
    the body's source (which exists) and the tile it replaced, runs both at
    the routed sites (NEW_BODIES) and counts, from the launches by shape of
    a clip's VAE, the wide launches on the wgmma body (wgmma_expected,
    body_expected) and apart in path_launches."""
    assert chip_smoke.WGMMA_KERNEL_NAMES["mh_flash_wide_wgmma_kernel"] == 1
    assert chip_smoke.WGMMA_KERNEL_NAMES["tiny_attention_wide_wgmma_kernel"] == 1
    for src in (chip_smoke.WIDE_BODY_SOURCE, chip_smoke.WIDE_MMA_SOURCE):
        assert os.path.isfile(os.path.join(ROOT, src))
    assert set(chip_smoke.NEW_BODIES) == {"wgmma_xattn", "wgmma_wide"}
    kernels.reset_counts()
    try:
        kernels.tiny_attention.shape_launches[(80, 1024, 1024, 1, 512)] = 4
        kernels.mh_flash_attention.shape_launches.update({(16, 8192, 8192, 1, 512): 1,
                                                          (4, 8704, 8704, 1, 512): 4})
        for fn, n in ((kernels.tiny_attention, 4), (kernels.mh_flash_attention, 5)):
            fn.launches = fn.tc_launches = fn.wide_launches = fn.wgmma_launches = n
            fn.body_launches["wgmma_wide"] = n
        assert chip_smoke.wgmma_expected(kernels)["tiny_attention"] == 4
        assert chip_smoke.wgmma_expected(kernels)["mh_flash_attention"] == 5
        assert chip_smoke.body_expected(kernels) == kernels.body_counts() == {
            "tiny_attention": {"wgmma_wide": 4}, "mh_flash_attention": {"wgmma_wide": 5}}
        launches = chip_smoke.path_launches(kernels)
        assert launches["tiny_attention_wgmma_wide"] == 4
        assert launches["mh_flash_attention_wgmma_wide"] == 5
    finally:
        kernels.reset_counts()
