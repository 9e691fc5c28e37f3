"""The arithmetic of the wide tensor-core tile, emulated on the CPU.

In bfloat16 the wide K1 and K2 (`kernels.tiny_attention` and
`kernels.mh_flash_attention` above head dim 160, the VAE's one head of 512)
run csrc/attn_mma_wide.cuh: S = Q·Kᵀ over the whole head dim in float32
(`mma.sync` k-steps of 16 columns, even and odd ones in two chains, the four
warps of a row group splitting the keys, not the head dim, so no partial
sums of S are exchanged), an online softmax per 64-key tile in log2 units
with the finite -1e30 for keys past the end, P rounded once to bfloat16 and
P·V in float32, divided by the unrounded sum at the end. `emulate_tile`
repeats that order in torch. The tests hold it, at D = 512 and at 192 and
200 with ragged query and key counts, to chip_smoke.py's phase-2 limit for
a bfloat16 output, min(2e-2, 2**-5 x max|plain|), against

- the port's plain versions (`tiny_attention_plain`, `mh_flash_attention_plain`),
- the JAX package's Pallas kernels run in interpret mode on the CPU, as the
  JAX package's tests run them (`tiny_packed_attention`,
  `mh_flash_attention`), on the same seeded bfloat16 inputs;

and show that the JAX kernels round their probabilities once to bfloat16:
their output equals the one-block order with P rounded once in far more
elements than with P kept in float32, so the hi + lo split of P that K5a
and K6a take (their JAX bodies keep P in float32) is not wanted here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagine360_tpu.ops.pallas_attention import mh_flash_attention, tiny_packed_attention

from imagine360_tpu_torch.ops import kernels

KEY_TILE = 64                  # csrc/attn_mma.cuh kMmaBK
K_STEP = 16                    # head-dim columns of one mma.sync k-step
LOG2E = 1.4426950408889634
NEG_INF = -1e30                # csrc/attn_common.cuh kNegInf
BF16_TOL, BF16_REL = 2e-2, 2 ** -5   # chip_smoke.py BF16_TOL, BF16_REL

# (kernel, Sq, Sk, D, bias): the VAE's head of 512, the lower bucket (192)
# and a head dim no multiple of 8 (200); ragged query and key counts
CASES = [("tiny_attention", 100, 300, 512, True),
         ("tiny_attention", 65, 77, 200, False),
         ("tiny_attention", 130, 192, 192, True),
         ("mh_flash_attention", 64, 300, 512, None),
         ("mh_flash_attention", 130, 257, 192, None),
         ("mh_flash_attention", 33, 200, 200, None)]


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()


def _inputs(Sq, Sk, D, bias, seed):
    """One (batch, head) problem: q [Sq, D], k/v [Sk, D] bfloat16 of unit
    scale; a uniform [-1, 1) float32 bias [Sq, Sk] or None."""
    rng = np.random.default_rng(seed)
    q, k, v = _bf16(rng, Sq, D), _bf16(rng, Sk, D), _bf16(rng, Sk, D)
    b = torch.from_numpy(rng.uniform(-1, 1, (Sq, Sk)).astype(np.float32)) if bias else None
    return q, k, v, b


def emulate_tile(q, k, v, bias, scale, round_p=True):
    """csrc/attn_mma_wide.cuh:wide_tile_mma's order on one problem: returns
    the bfloat16 output [Sq, D]. With `round_p` False P stays float32
    through P·V."""
    qf, kf, vf = q.float(), k.float(), v.float()
    Sq, D = qf.shape
    chains = [torch.zeros(Sq, kf.shape[0]), torch.zeros(Sq, kf.shape[0])]
    for i, c in enumerate(range(0, D, K_STEP)):
        chains[i % 2] += qf[:, c:c + K_STEP] @ kf[:, c:c + K_STEP].T
    s = chains[0] + chains[1]
    m = torch.full((Sq,), NEG_INF)
    l = torch.zeros(Sq)
    o = torch.zeros(Sq, D)
    for k0 in range(0, kf.shape[0], KEY_TILE):
        x = s[:, k0:k0 + KEY_TILE] * (scale * LOG2E)
        if bias is not None:
            x = x + bias[:, k0:k0 + KEY_TILE] * LOG2E
        m_new = torch.maximum(m, x.amax(dim=1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[:, None])
        l = l * alpha + p.sum(dim=1)
        if round_p:
            p = p.bfloat16().float()
        o = o * alpha[:, None] + p @ vf[k0:k0 + KEY_TILE]
        m = m_new
    return (o / torch.where(l == 0, torch.ones_like(l), l)[:, None]).bfloat16()


def _one_block(q, k, v, bias, scale, name, round_p):
    """The JAX kernels' order over one key block (Sk <= 512): K1 rounds the
    normalised probabilities, K2 the unnormalised ones at the row max and
    divides after P·V; with `round_p` False P stays float32."""
    s = (q.float() @ k.float().T) * scale
    if bias is not None:
        s = s + bias
    p = torch.exp(s - s.amax(dim=1, keepdim=True))
    denom = p.sum(dim=1, keepdim=True)
    if name == "tiny_attention":
        p = p / denom
        p = p.bfloat16().float() if round_p else p
        return (p @ v.float()).bfloat16()
    p = p.bfloat16().float() if round_p else p
    return ((p @ v.float()) / denom).bfloat16()


def _jax(q, k, v, bias, scale, name):
    """The JAX package's Pallas kernel in interpret mode on [1, S, D]."""
    j = lambda t: jnp.asarray(t.float().numpy()[None]).astype(jnp.bfloat16)
    if name == "tiny_attention":
        b = bias if bias is not None else torch.zeros(q.shape[0], k.shape[0])
        out = tiny_packed_attention(j(q), j(k), j(v), jnp.asarray(b.numpy()[None]), scale, 1,
                                    interpret=True)
    else:
        out = mh_flash_attention(j(q), j(k), j(v), scale, 1, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32))[0])


def _limit(want):
    return min(BF16_TOL, BF16_REL * want.float().abs().max().item())


def _err(got, want):
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("name,Sq,Sk,D,bias", CASES)
def test_emulated_tile_matches_plain_and_jax(name, Sq, Sk, D, bias):
    """The tile's order against the port's plain version and the JAX Pallas
    kernel (interpret mode), both within the phase-2 bf16 limit; the plain
    version and the JAX kernel agree within it too."""
    q, k, v, b = _inputs(Sq, Sk, D, bias, seed=Sq + Sk + D)
    scale = D ** -0.5
    got = emulate_tile(q, k, v, b, scale)
    plain = getattr(kernels, name + "_plain")
    args = (q[None], k[None], v[None]) + ((b,) if name == "tiny_attention" else ())
    want = plain(*args, scale=scale, heads=1)[0]
    ref = _jax(q, k, v, b, scale, name)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    assert _err(got, want) <= _limit(want)
    assert _err(got, ref) <= _limit(ref)
    assert _err(want, ref) <= _limit(ref)


@pytest.mark.parametrize("name", ["tiny_attention", "mh_flash_attention"])
def test_jax_kernels_round_p_once(name):
    """At D = 512 and 256 keys (one key block in both JAX kernels) their
    bfloat16 output equals the one-block order with P rounded once to
    bfloat16 in at least 0.99 of the elements (0.99996 for K1, 0.9969 for K2
    on the CPU), and the same order with P kept in float32 (what a hi + lo
    split approaches) in less than 0.7 (0.593, 0.614): the JAX kernels take
    P in bfloat16, so the tile rounds it once. The tile's own order stays within the phase-2 limit of the
    JAX output, P rounded or not."""
    q, k, v, b = _inputs(96, 256, 512, name == "tiny_attention", seed=7)
    scale = 512 ** -0.5
    ref = _jax(q, k, v, b, scale, name)
    share = lambda x: (x.float() == ref).float().mean().item()
    once = share(_one_block(q, k, v, b, scale, name, round_p=True))
    f32 = share(_one_block(q, k, v, b, scale, name, round_p=False))
    assert once >= 0.99 and f32 < 0.7, (once, f32)
    for round_p in (True, False):
        assert _err(emulate_tile(q, k, v, b, scale, round_p), ref) <= _limit(ref)


def test_key_tiles_and_chains_change_only_rounding():
    """Streaming 64-key tiles with a running max, and S summed in two chains
    of k-steps, change the output only by bfloat16 roundings: against P kept
    in float32 over the whole row in one sum the tile is within 2**-7 of the
    largest output at D = 512 and 1024 keys (the VAE's perspective site,
    one view's worth of keys)."""
    q, k, v, b = _inputs(64, 1024, 512, None, seed=11)
    scale = 512 ** -0.5
    exact = _one_block(q, k, v, None, scale, "mh_flash_attention", round_p=False)
    got = emulate_tile(q, k, v, None, scale)
    assert _err(got, exact) <= 2 ** -7 * exact.float().abs().max().item()
