"""The arithmetic of the `wgmma` attention body of K5a and K6a, emulated on
the CPU, and the rule that sends their launches to it.

In bfloat16 at head dim 64 without a bias, `kernels.flash_attention_lse`
(K5a, with 16-byte-aligned q, k, v and out) and
`kernels.flash_attention_t` (K6a, also with Sq and Sk multiples of 8) run
csrc/attn_wgmma.cuh with P·V on the exact split hi = bf16(p), lo = bf16(p -
hi) (SPLIT_P), K5a also writing the lse (LSE) and K6a reading its
sequence-minor [B, H, D, S] tiles as they lie (SEQ_MINOR), in 128-key tiles
as K1 and K2 (csrc/attn_wgmma.cuh kWgBK).
`test_torch_wgmma_attention.emulate_wgmma_tile` repeats that order in
torch: log2 units, ex2.approx.ftz's flush below 2**-126, the sum over the
unrounded P, the split. These tests hold it, on seeded bfloat16 inputs with
ragged query and key counts (77, 200, 333, 1000; H = 2, D = 64), against

- the JAX package's Pallas kernels run in interpret mode on the CPU, as
  the JAX package's tests run them (`flash_attention_fwd_res`, out and lse,
  for K5a; `_flash_bhds` for K6a);
- the port's plain versions (`flash_attention_lse_plain`,
  `flash_attention_t_plain`);

within chip_smoke.py's phase-2 bfloat16 limit, min(2e-2, 2**-5 x
max|plain|), and 1e-3 for the lse; at the two training sites' keys the
split's output equals the plain version's bit for bit in at least
chip_smoke.K5A_MATCH of its elements, which P rounded once misses; 64- and
128-key tiles move only roundings. They pin `kernels.wgmma_route` at every
K5a and K6a site of chip_smoke.py, the per-shard shapes of 2 and 4 ranks,
its refusals, and chip_smoke's check of the rule by shape.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagine360_tpu.ops.pallas_attention import _flash_bhds, flash_attention_fwd_res

from imagine360_tpu_torch.ops import kernels

from test_torch_wgmma_attention import emulate_wgmma_tile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

SPLIT_KEY_TILE = 128           # csrc/attn_wgmma.cuh kWgBK: K5a's and K6a's key tiles
BF16_TOL, BF16_REL = 2e-2, 2 ** -5   # chip_smoke.py BF16_TOL, BF16_REL
EMU_LSE_TOL = 1e-3             # the emulated lse against the Pallas kernel's and the plain one
H, D = 2, 64
SCALE = D ** -0.5
# (Sq, Sk): ragged query and key counts, one and several key tiles
CASES = [(77, 200), (200, 333), (333, 1000), (1000, 77)]


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()


def _inputs(layout, Sq, Sk, seed):
    """q, k, v bfloat16 of unit scale: K5a's [1, S, H, D] ("bshd") or K6a's
    [1, H, D, S] ("bhds")."""
    rng = np.random.default_rng(seed)
    shape = (lambda S: (1, S, H, D)) if layout == "bshd" else (lambda S: (1, H, D, S))
    return _bf16(rng, *shape(Sq)), _bf16(rng, *shape(Sk)), _bf16(rng, *shape(Sk))


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


@pytest.fixture(scope="module")
def jax_k5a():
    """{(Sq, Sk): (inputs, Pallas out [1, Sq, H, D], lse [1, H, Sq])} in
    interpret mode."""
    outs = {}
    for Sq, Sk in CASES:
        q, k, v = _inputs("bshd", Sq, Sk, seed=Sq + 2 * Sk)
        out, lse = flash_attention_fwd_res(_jnp(q), _jnp(k), _jnp(v), scale=SCALE,
                                           interpret=True)
        outs[(Sq, Sk)] = (q, k, v), _np(out), _np(lse)[:, :, :Sq, 0]
    return outs


@pytest.fixture(scope="module")
def jax_k6a():
    """{(Sq, Sk): (inputs, Pallas out [1, H, Sq, D])} in interpret mode."""
    outs = {}
    for Sq, Sk in CASES:
        q, k, v = _inputs("bhds", Sq, Sk, seed=3 * Sq + Sk)
        out = _flash_bhds(_jnp(q), _jnp(k), _jnp(v), None, SCALE, block_q=128, block_k=128,
                          interpret=True)
        outs[(Sq, Sk)] = (q, k, v), _np(out)
    return outs


def _limit(want):
    return min(BF16_TOL, BF16_REL * want.float().abs().max().item())


def _err(got, want):
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("Sq,Sk", CASES)
def test_k5a_emulated_tile_matches_jax_and_plain(Sq, Sk, jax_k5a):
    """K5a's order (lse, P split, 128-key tiles) against the Pallas kernel in
    interpret mode and the plain version: the bfloat16 output within the
    phase-2 limit of each, the lse within 1e-3; the plain version and the
    Pallas kernel agree within the same limits."""
    (q, k, v), ref, ref_lse = jax_k5a[(Sq, Sk)]
    got, lse = emulate_wgmma_tile(q, k, v, SCALE, SPLIT_KEY_TILE, split_p=True, lse=True,
                                  layout="bshd")
    want, want_lse = kernels.flash_attention_lse_plain(q, k, v, scale=SCALE)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert lse.shape == (1, H, Sq) and bool(torch.isfinite(lse).all())
    assert _err(got, want) <= _limit(want) and _err(got, ref) <= _limit(ref)
    assert _err(want, ref) <= _limit(ref)
    assert _err(lse, want_lse) <= EMU_LSE_TOL and _err(lse, ref_lse) <= EMU_LSE_TOL
    assert _err(want_lse, ref_lse) <= EMU_LSE_TOL


@pytest.mark.parametrize("Sq,Sk", CASES)
def test_k6a_emulated_tile_matches_jax_and_plain(Sq, Sk, jax_k6a):
    """K6a's order (sequence-minor inputs, P split, 128-key tiles) against
    `_flash_bhds` in interpret mode and the plain version, within the
    phase-2 limit of each."""
    (q, k, v), ref = jax_k6a[(Sq, Sk)]
    got = emulate_wgmma_tile(q, k, v, SCALE, SPLIT_KEY_TILE, split_p=True, layout="bhds")
    want = kernels.flash_attention_t_plain(q, k, v, scale=SCALE)
    assert got.shape == (1, H, Sq, D) and got.dtype == torch.bfloat16
    assert _err(got, want) <= _limit(want) and _err(got, ref) <= _limit(ref)
    assert _err(want, ref) <= _limit(ref)


@pytest.mark.parametrize("layout", ["bshd", "bhds"])
@pytest.mark.parametrize("Sk", [8192, 2048])
def test_split_matches_plain_bit_for_bit_at_training_keys(Sk, layout):
    """64 query rows against the keys of the training sites (K5a) and of the
    opt-in pano sites (K6a), pano s0 and s1: the emulated body with P split
    gives the plain version's bfloat16 output in at least K5A_MATCH of the
    elements; with P rounded once (K2's order) in less than 0.7 of them. The
    lse does not depend on the rounding of P."""
    q, k, v = _inputs(layout, 64, Sk, seed=Sk + (layout == "bhds"))
    if layout == "bshd":
        want, want_lse = kernels.flash_attention_lse_plain(q, k, v, scale=SCALE)
    else:
        want = kernels.flash_attention_t_plain(q, k, v, scale=SCALE)
    split, lse = emulate_wgmma_tile(q, k, v, SCALE, SPLIT_KEY_TILE, split_p=True, lse=True,
                                    layout=layout)
    rounded = emulate_wgmma_tile(q, k, v, SCALE, SPLIT_KEY_TILE, layout=layout)
    match = lambda o: (o == want).float().mean().item()
    assert match(split) >= chip_smoke.K5A_MATCH
    assert match(rounded) < 0.7
    if layout == "bshd":
        assert _err(lse, want_lse) <= EMU_LSE_TOL


@pytest.mark.parametrize("Sq,Sk", [(333, 1000), (200, 333)])
def test_split_key_tile_moves_only_roundings(Sq, Sk):
    """With P split, 128-key tiles (K5a's and K6a's form) against 64-key ones
    (the other tile the body builds) move only where the running max
    rescales: the outputs agree within 2**-7 of the largest output and the
    lse within 1e-5."""
    q, k, v = _inputs("bshd", Sq, Sk, seed=Sq * Sk)
    a, lse_a = emulate_wgmma_tile(q, k, v, SCALE, 64, split_p=True, lse=True, layout="bshd")
    b, lse_b = emulate_wgmma_tile(q, k, v, SCALE, 128, split_p=True, lse=True, layout="bshd")
    assert _err(a, b) <= 2 ** -7 * a.float().abs().max().item()
    assert _err(lse_a, lse_b) <= 1e-5


# whether `kernels.wgmma_route` gives each bf16 K5a / K6a site of
# chip_smoke.py the D = 64 body of csrc/attn_wgmma.cuh: the training step's
# and the opt-in pano sites; not K6a's WarpAttn ones (D = 32, a bias), which
# take the biased body of csrc/attn_wgmma_bias.cuh by their own rule
# (`kernels.flash_t_bias_wgmma_route`, pinned in tests/test_torch_wgmma_warp.py)
ROUTE = {
    ("flash_attention_lse", "train_pano_spatial_s0"): True,
    ("flash_attention_lse", "train_pano_spatial_s1"): True,
    ("flash_attention_t", "v2_pano_spatial_s0"): True,
    ("flash_attention_t", "v2_pano_spatial_s1"): True,
    ("flash_attention_t", "v2_warp_r2_pano_q"): False,
    ("flash_attention_t", "v2_warp_r2_pers_q"): False,
    ("flash_attention_t", "v2_warp_r4_pano_q"): False,
}


def test_route_at_every_k5a_k6a_site():
    """Every K5a and K6a site of chip_smoke.SITES is in ROUTE and
    `wgmma_route` admits it or not as named there (a WarpAttn site carries
    its bias)."""
    sites = {(n, s): shape for n, s, shape in chip_smoke.SITES
             if n in ("flash_attention_lse", "flash_attention_t")}
    assert set(sites) == set(ROUTE)
    for (name, site), (B, Sq, Sk, Hs, Ds) in sites.items():
        got = kernels.wgmma_route(name, torch.bfloat16, Sq, Sk, Hs, Ds,
                                  chip_smoke.site_has_bias(site))
        assert got == ROUTE[(name, site)], (name, site)


def test_route_at_per_shard_k5a_shapes():
    """K5a's per-shard shapes of chip_smoke.SHARD_SITES (a rank's pano rows
    at 2 ranks, Sq != Sk) and of 4 ranks take the wgmma body."""
    sites = {s: shape for _, s, shape in chip_smoke.SITES}
    shards = [(site, what, worlds) for name, site, what, worlds in chip_smoke.SHARD_SITES
              if name == "flash_attention_lse"]
    assert shards == [("train_pano_spatial_s0", "queries", (2,))]
    for site, what, _ in shards:
        for w in (2, 4):
            B, Sq, Sk, Hs, Ds = chip_smoke.shard_shape(sites[site], what, w)
            assert Sq == 8192 // w and Sk == 8192
            assert kernels.wgmma_route("flash_attention_lse", torch.bfloat16, Sq, Sk, Hs, Ds)


@pytest.mark.parametrize("name", ["flash_attention_lse", "flash_attention_t"])
def test_route_refuses_off_rule_calls(name):
    """A bias, another head dim, float32, a pointer off a 16-byte boundary
    (q, k, v or out), and for K6a an Sq or Sk that is no multiple of 8 stay
    on the `mma.sync` body (or the CUDA cores)."""
    args = (2048, 2048, 10, 64)
    ptrs = (0, 16, 4096, 2 ** 40)
    assert kernels.wgmma_route(name, torch.bfloat16, *args, ptrs=ptrs)
    assert not kernels.wgmma_route(name, torch.bfloat16, *args, bias=True)
    assert not kernels.wgmma_route(name, torch.float32, *args)
    for d in (32, 40, 128):
        assert not kernels.wgmma_route(name, torch.bfloat16, *args[:3], d)
    for i in range(len(ptrs)):
        off = tuple(p + 8 * (j == i) for j, p in enumerate(ptrs))
        assert not kernels.wgmma_route(name, torch.bfloat16, *args, ptrs=off)
    k6a = name == "flash_attention_t"
    for Sq, Sk in ((77, 2048), (2048, 1000), (333, 333)):
        assert kernels.wgmma_route(name, torch.bfloat16, Sq, Sk, 10, 64) == (Sk % 8 == 0
                                                                            and Sq % 8 == 0
                                                                            or not k6a)
    assert kernels.wgmma_route(name, torch.bfloat16, 8, 8, 1, 64)


def test_plain_path_counts_no_wgmma_launch_k5a_k6a():
    """On the CPU K5a and K6a run their plain versions: one plain call each,
    no launch, no wgmma launch."""
    q, k, v = _inputs("bshd", 200, 333, seed=1)
    kernels.reset_counts()
    kernels.flash_attention_lse(q, k, v, scale=SCALE)
    kernels.flash_attention_t(*(x.permute(0, 2, 3, 1) for x in (q, k, v)), scale=SCALE)
    assert set(kernels.wgmma_counts().values()) == {0}
    assert kernels.flash_attention_lse.plain_calls == kernels.flash_attention_t.plain_calls == 1
    assert kernels.flash_attention_lse.launches == kernels.flash_attention_t.launches == 0


def test_chip_smoke_rule_by_shape_k5a_k6a():
    """chip_smoke.wgmma_expected counts, from the launches by shape, K5a's
    at the training sites (all of them), K6a's at the pano sites and at its
    WarpAttn sites (D = 32: the biased body, under the bias the models give
    every such launch)."""
    kernels.reset_counts()
    try:
        kernels.flash_attention_lse.shape_launches.update({(16, 8192, 8192, 5, 64): 10,
                                                           (16, 2048, 2048, 10, 64): 10})
        kernels.flash_attention_t.shape_launches.update({(32, 8192, 8192, 5, 64): 5,
                                                         (32, 2048, 5120, 10, 32): 1,
                                                         (32, 512, 1280, 20, 32): 1})
        assert chip_smoke.wgmma_expected(kernels) == {"tiny_attention": 0,
                                                      "mh_flash_attention": 0,
                                                      "flash_attention_lse": 20,
                                                      "flash_attention_t": 7,
                                                      "shared_bias_attention_folded": 0,
                                                      "dense_matmul": 0, "flash_bwd_dq": 0,
                                                      "flash_bwd_dkv": 0,
                                                      "shared_bias_attention": 0}
    finally:
        kernels.reset_counts()
