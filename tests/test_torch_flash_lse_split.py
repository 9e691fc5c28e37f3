"""Why K5a splits its probabilities on the tensor cores, on the CPU.

K5a (`kernels.flash_attention_lse`) keeps its probabilities float32 through
P·V, as its plain version and the Pallas kernel it replaces do. In bfloat16
on `mma.sync` (csrc/attn_mma.cuh, SPLIT_P) it takes them as the exact split
p = hi + lo of two bfloat16 values, two products per k-step. These tests
emulate that product at the training sites and hold its normalised bfloat16
output against the plain version's: the split gives the plain version's
output bit for bit in at least `chip_smoke.K5A_MATCH` of the elements, the
share phase 2 of chip_smoke.py demands of the kernel on the card; one
bfloat16 rounding of P misses it by far.
"""
import os
import sys

import numpy as np
import pytest
import torch

from imagine360_tpu_torch.ops import kernels

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# the K5a sites of chip_smoke.py phase 2: keys and head dim
SITES = {"train_pano_spatial_s0": (8192, 64), "train_pano_spatial_s1": (2048, 64)}
ROWS = 64      # query rows a case


def _split(p):
    """The bf16 hi + lo split of float32 p, as float32 tensors."""
    hi = p.bfloat16().float()
    return hi, (p - hi).bfloat16().float()


def test_split_is_exact_and_keeps_16_bits():
    """p - hi is exact in float32, and hi + lo is within 2**-16 of p, against
    2**-8 for hi alone, over probabilities from 1 down to 2**-60."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy(np.exp2(-rng.uniform(0, 60, 100_000)).astype(np.float32))
    p[0] = 1.0
    hi, lo = _split(p)
    assert torch.equal(p - hi, (p.double() - hi.double()).float())
    rel = ((p.double() - hi.double() - lo.double()).abs() / p.double()).max().item()
    assert rel <= 2 ** -16
    assert ((p - hi).abs() / p).max().item() <= 2 ** -8


@pytest.mark.parametrize("bias", ["none", "random"])
@pytest.mark.parametrize("site", sorted(SITES))
def test_split_output_matches_plain(site, bias):
    """ROWS seeded query rows of a training site (unit-normal bfloat16 q, k,
    v; no bias, as at the production sites, or a uniform [-1, 1) float32
    one): softmax(q k^T / 8 + bias) v with P split into hi + lo, normalised
    and rounded to bf16, equals kernels.flash_attention_lse_plain's output
    in at least K5A_MATCH of the elements; with P rounded once to bf16 in
    less than 0.7 of them. Before the normalisation the split product is
    within 2**-12 of max |float32 P·V|. The lse does not depend on the
    rounding of P."""
    Sk, D = SITES[site]
    rng = np.random.default_rng(Sk + (bias == "random"))
    q, k, v = (torch.from_numpy(rng.standard_normal((1, n, 1, D), dtype=np.float32)).bfloat16()
               for n in (ROWS, Sk, Sk))
    b = None
    if bias == "random":
        b = torch.from_numpy(rng.uniform(-1, 1, (1, 1, ROWS, Sk)).astype(np.float32))
    scale = D ** -0.5
    want, want_lse = kernels.flash_attention_lse_plain(q, k, v, b, scale=scale)
    s = (q[0, :, 0].float() * scale) @ k[0, :, 0].float().T
    if b is not None:
        s = s + b[0, 0]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    vf = v[0, :, 0].float()
    hi, lo = _split(p)
    pv = p.double() @ vf.double()
    assert (hi @ vf + lo @ vf - pv).abs().max().item() <= 2 ** -12 * pv.abs().max().item()
    split = ((hi @ vf + lo @ vf) / denom).bfloat16()
    rounded = ((hi @ vf) / denom).bfloat16()
    plain = want[0, :, 0]
    match = lambda o: (o == plain).float().mean().item()
    assert match(split) >= chip_smoke.K5A_MATCH
    assert match(rounded) < 0.7
    assert (m[:, 0] + torch.log(denom[:, 0]) - want_lse[0, 0]).abs().max().item() <= 1e-5
