"""Why K6a, K5b and K5c split their float32 operands on the tensor cores, on the CPU.

K6a (`kernels.flash_attention_t`) keeps its probabilities float32 through
P·V, K5c (`kernels.flash_bwd_dkv`) keeps P and dS = P (dP - delta) float32
through dv = Pᵀ·dO and dk = dSᵀ·Q, and K5b (`kernels.flash_bwd_dq`) keeps dS
float32 through dq = dS·K, as their plain versions and the Pallas kernels
they replace do. In bfloat16 on `mma.sync` (csrc/attn_mma.cuh SPLIT_P,
csrc/attn_mma_bwd.cuh SPLIT) each such operand x is taken as the exact split
x = hi + lo of two bfloat16 values, two products per k-step.
These tests emulate those products at the kernels' phase-2 sites of
chip_smoke.py and hold them against the plain versions:

- K6a: the split's normalised bfloat16 output equals the plain version's
  bit for bit in at least `chip_smoke.K5A_MATCH` of the elements, with and
  without a bias, at D = 64 and at the WarpAttn sites' D = 32; P rounded
  once to bfloat16 misses that by far.
- K5c: on 64-key blocks of the training sites (every query of the site,
  the lse and delta of its full key range), dk and dv with P and dS split
  equal the plain version's bit for bit in at least K5A_MATCH of the
  elements and stay within half of phase 2's limit, GRAD_BF16_REL x
  max|plain| (at worst one bf16 rounding the other way at the largest
  element). With both rounded once, 55-61% of the elements are equal and the
  error reaches 0.2-0.96 of the limit (eight blocks of each site surveyed).
- K5b: on 64-query blocks of the same sites (every key of the site, the lse
  and delta of the full key range), dq with dS split equals the plain
  version's in at least K5A_MATCH of the elements (99.5-99.9% at the six
  blocks) and stays within phase 2's limit. One rounding of the float32 sum
  the other way at an element near the largest costs one bf16 ulp of it,
  0.5-1.0 of the limit (0.69 at one block), so the sharper check is the
  float32 dq before that rounding: within 2**-16 x max|plain| of the plain
  version's (2-4e-6 x max|plain|). With dS rounded once, 54-58% of the
  elements are equal and the float32 error is 1.3-2.7e-3 x max|plain|.
"""
import os
import sys

import numpy as np
import pytest
import torch

from imagine360_tpu_torch.ops import kernels

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

ROWS = 64        # query rows of a K6a case, key rows of a K5c case
QCHUNK = 1024    # query rows of one plain forward call (bounds the logits)


def _split(x):
    """The bf16 hi + lo split of float32 x, as float32 tensors."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _site(name, site):
    return next(shape for n, s, shape in chip_smoke.SITES if (n, s) == (name, site))


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()


K6A_SITES = ["v2_pano_spatial_s0", "v2_pano_spatial_s1", "v2_warp_r2_pano_q",
             "v2_warp_r2_pers_q", "v2_warp_r4_pano_q"]


@pytest.mark.parametrize("bias", ["none", "random"])
@pytest.mark.parametrize("site", K6A_SITES)
def test_k6a_split_output_matches_plain(site, bias):
    """ROWS seeded query rows of a K6a site on [1, 1, D, S] inputs
    (unit-normal bfloat16 q, k, v; no bias, or a uniform [-1, 1) float32
    one as at the WarpAttn sites): softmax(q k^T / sqrt(D) + bias) v with P
    split into hi + lo, normalised and rounded to bf16, equals
    kernels.flash_attention_t_plain's output in at least K5A_MATCH of the
    elements; with P rounded once to bf16 in less than 0.7 of them."""
    _, _, Sk, _, D = _site("flash_attention_t", site)
    rng = np.random.default_rng(Sk + D + (bias == "random"))
    q, k, v = _bf16(rng, 1, 1, D, ROWS), _bf16(rng, 1, 1, D, Sk), _bf16(rng, 1, 1, D, Sk)
    b = None
    if bias == "random":
        b = torch.from_numpy(rng.uniform(-1, 1, (1, 1, ROWS, Sk)).astype(np.float32))
    scale = D ** -0.5
    want = kernels.flash_attention_t_plain(q, k, v, b, scale=scale)[0, 0]
    s = (q[0, 0].float().T * scale) @ k[0, 0].float()
    if b is not None:
        s = s + b[0, 0]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    vf = v[0, 0].float().T
    hi, lo = _split(p)
    match = lambda o: (o.bfloat16() == want).float().mean().item()
    assert match((hi @ vf + lo @ vf) / denom) >= chip_smoke.K5A_MATCH
    assert match((hi @ vf) / denom) < 0.7


# the K5c sites, the WarpAttn ones with their uniform [-1, 1) bias; a block
# of ROWS keys at the first key and at the middle of the key range
K5C_SITES = ["train_pano_spatial_s0", "train_warp_r2_pano_q", "train_warp_r2_pers_q"]


@pytest.mark.parametrize("block", ["first", "middle"])
@pytest.mark.parametrize("site", K5C_SITES)
def test_k5c_split_gradients_within_limit(site, block):
    """One block of K5c, ROWS keys from k0, at a training site: every query
    of the site (unit-normal bfloat16 q, k, v, dO), the lse and out of the
    plain forward over all Sk keys, delta = rowsum(dO out). dk and dv
    emulated with P and dS split into bf16 hi + lo (float32 products, as
    mma.sync sums them) and rounded to bf16 equal
    kernels.flash_bwd_dkv_plain's in at least K5A_MATCH of the elements and
    are within GRAD_BF16_REL / 2 x max|plain| of them; with P and dS rounded
    once to bf16 less than 0.7 of the elements are equal."""
    _, Sq, Sk, _, D = _site("flash_bwd_dkv", site)
    k0 = 0 if block == "first" else Sk // 2
    rng = np.random.default_rng(Sq + Sk + D)
    q, k, v, do = (_bf16(rng, 1, n, 1, D) for n in (Sq, Sk, Sk, Sq))
    bias = None
    if "warp" in site:
        bias = torch.from_numpy(rng.uniform(-1, 1, (1, 1, Sq, Sk)).astype(np.float32))
    scale = D ** -0.5
    outs, lses = [], []
    for s in range(0, Sq, QCHUNK):       # the plain forward, a query slice at a time
        b = None if bias is None else bias[:, :, s:s + QCHUNK]
        o, l = kernels.flash_attention_lse_plain(q[:, s:s + QCHUNK], k, v, b, scale=scale)
        outs.append(o)
        lses.append(l)
    lse = torch.cat(lses, dim=2)
    delta = kernels.attention_delta(do, torch.cat(outs, dim=1))
    kb, vb = k[:, k0:k0 + ROWS], v[:, k0:k0 + ROWS]
    bb = None if bias is None else bias[:, :, :, k0:k0 + ROWS].contiguous()
    want = [w[0, :, 0] for w in kernels.flash_bwd_dkv_plain(q, kb, vb, bb, do, lse, delta,
                                                             scale=scale)]

    qf, dof = q[0, :, 0].float(), do[0, :, 0].float()
    sc = qf @ kb[0, :, 0].float().T * scale                  # [Sq, ROWS]
    if bb is not None:
        sc = sc + bb[0, 0]
    p = torch.exp(sc - lse[0, 0, :, None])
    ds = p * (dof @ vb[0, :, 0].float().T - delta[0, 0, :, None])
    ph, pl = _split(p)
    dh, dl = _split(ds)
    split = [((dh.T @ qf + dl.T @ qf) * scale).bfloat16(), (ph.T @ dof + pl.T @ dof).bfloat16()]
    rounded = [((dh.T @ qf) * scale).bfloat16(), (ph.T @ dof).bfloat16()]
    for got, w in zip(split, want):
        assert (got == w).float().mean().item() >= chip_smoke.K5A_MATCH
        limit = chip_smoke.GRAD_BF16_REL * w.float().abs().max().item()
        assert (got.float() - w.float()).abs().max().item() <= limit / 2
    for got, w in zip(rounded, want):
        assert (got == w).float().mean().item() < 0.7


@pytest.mark.parametrize("block", ["first", "middle"])
@pytest.mark.parametrize("site", K5C_SITES)
def test_k5b_split_gradient_within_limit(site, block):
    """One block of K5b, ROWS queries (seeded by their first row q0) at a
    training site: every key of the site (unit-normal bfloat16 q, k, v, dO;
    the WarpAttn sites' uniform [-1, 1) bias rows), the lse and out of the
    plain forward of those rows over all Sk keys, delta = rowsum(dO out). dq
    emulated with dS split into bf16 hi + lo (float32 products, as mma.sync
    sums them) and scaled is within 2**-16 x max|plain| of the plain
    version's float32 dq; rounded to bf16 it equals
    kernels.flash_bwd_dq_plain's in at least K5A_MATCH of the elements and is
    within GRAD_BF16_REL x max|plain| of it. With dS rounded once to bf16
    the float32 dq misses 2**-12 x max|plain| and less than 0.7 of the bf16
    elements are equal."""
    _, Sq, Sk, _, D = _site("flash_bwd_dq", site)
    q0 = 0 if block == "first" else Sq // 2
    rng = np.random.default_rng(Sq + Sk + D + q0 + 1)
    q, do = (_bf16(rng, 1, ROWS, 1, D) for _ in range(2))
    k, v = (_bf16(rng, 1, Sk, 1, D) for _ in range(2))
    bias = None
    if "warp" in site:
        bias = torch.from_numpy(rng.uniform(-1, 1, (1, 1, ROWS, Sk)).astype(np.float32))
    scale = D ** -0.5
    out, lse = kernels.flash_attention_lse_plain(q, k, v, bias, scale=scale)
    delta = kernels.attention_delta(do, out)
    want = kernels.flash_bwd_dq_plain(q, k, v, bias, do, lse, delta, scale=scale)[0, :, 0]
    want32 = kernels.flash_bwd_dq_plain(q.float(), k.float(), v.float(), bias, do.float(), lse,
                                        delta, scale=scale)[0, :, 0]

    qf, kf, dof = q[0, :, 0].float(), k[0, :, 0].float(), do[0, :, 0].float()
    sc = qf @ kf.T * scale                                    # [ROWS, Sk]
    if bias is not None:
        sc = sc + bias[0, 0]
    p = torch.exp(sc - lse[0, 0, :, None])
    ds = p * (dof @ v[0, :, 0].float().T - delta[0, 0, :, None])
    dh, dl = _split(ds)
    split, rounded = (dh @ kf + dl @ kf) * scale, (dh @ kf) * scale
    peak32 = want32.abs().max().item()
    assert (split - want32).abs().max().item() <= 2 ** -16 * peak32
    assert (rounded - want32).abs().max().item() > 2 ** -12 * peak32
    split, rounded = split.bfloat16(), rounded.bfloat16()
    assert (split == want).float().mean().item() >= chip_smoke.K5A_MATCH
    limit = chip_smoke.GRAD_BF16_REL * want.float().abs().max().item()
    assert (split.float() - want.float()).abs().max().item() <= limit
    assert (rounded == want).float().mean().item() < 0.7
