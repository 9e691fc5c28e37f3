"""chip_smoke.py's bf16 limit never falls below one bf16 rounding.

Phase 2 holds a bf16 output to min(BF16_TOL, BF16_REL x max|plain|) =
min(2e-2, 2**-5 x peak) (`chip_smoke.bf16_tol`), and phase 13 holds the
latents under the mesh to the same rule. From a peak of 4 on, one bf16 ulp
of the largest output (2**-5 at 4-8, 2**-4 at 8-16) is above 2e-2, so a
kernel whose float32 result is exact fails when it and the plain version
fall on the two sides of one rounding. `chip_smoke.bf16_limit` keeps the
rule but never goes below that ulp, 2**(floor(log2 peak) - 7). These tests
hold outputs one rounding apart at magnitudes 4 to 8 and beyond: the old
rule fails them and the new one passes them; two roundings still fail; and
below a peak of 4 the limit is the old rule's.
"""
import math
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def _old_limit(peak):
    return min(chip_smoke.BF16_TOL, chip_smoke.BF16_REL * peak)


def _ulps_up(x, n):
    """bf16 x moved n units in the last place away from zero."""
    bits = x.view(torch.int16) + n
    return bits.view(torch.bfloat16)


def _outputs(peak, seed):
    """A bf16 'plain' output of unit-normal values scaled so its largest
    magnitude is `peak` (exact in bf16), as a float32 tensor."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(4096, generator=g)
    x = (x / x.abs().max() * peak).bfloat16()
    x[0] = peak
    return x


@pytest.mark.parametrize("peak", [4.0, 5.5, 7.75, 12.0, 40.0])
def test_one_rounding_passes_the_new_limit_and_failed_the_old(peak):
    """The plain version's largest element and the kernel's one bf16 ulp
    apart (a float32 result on the other side of one rounding): past the
    old limit, within the new one."""
    want = _outputs(peak, seed=int(peak * 4))
    got = want.clone()
    got[0] = _ulps_up(want[0:1], 1)[0]
    err = (got.float() - want.float()).abs().max().item()
    pk = want.float().abs().max().item()
    assert err == 2.0 ** (math.floor(math.log2(pk)) - 7)
    assert err > _old_limit(pk)
    assert err <= chip_smoke.bf16_limit(pk)
    assert err <= chip_smoke.bf16_tol("shared_bias_attention", pk)


@pytest.mark.parametrize("peak", [4.0, 5.5, 7.75, 12.0])
def test_two_roundings_still_fail(peak):
    """Two bf16 ulps of the largest element stay past the limit."""
    want = _outputs(peak, seed=int(peak * 8))
    got = want.clone()
    got[0] = _ulps_up(want[0:1], 2)[0]
    err = (got.float() - want.float()).abs().max().item()
    assert err > chip_smoke.bf16_limit(want.float().abs().max().item())


@pytest.mark.parametrize("peak", [0.0, 1e-3, 0.3, 0.64, 1.0, 1.5, 2.0, 3.0, 3.99])
def test_limit_unchanged_below_four(peak):
    """Below a peak of 4 the ulp is under min(2e-2, 2**-5 x peak): the
    limit is the old rule's, bit for bit."""
    assert chip_smoke.bf16_limit(peak) == _old_limit(peak)
    assert chip_smoke.bf16_tol("tiny_attention", peak) == _old_limit(peak)


def test_gradient_and_dense_limits_untouched():
    """K5b's and K5c's gradients (GRAD_BF16_REL x peak) and K7's sums
    (DENSE_BF16_REL x peak) keep their own rules, which already cover one
    ulp of the peak."""
    for peak in (0.5, 6.0, 90.0):
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            assert chip_smoke.bf16_tol(name, peak) == chip_smoke.GRAD_BF16_REL * peak
        assert chip_smoke.bf16_tol("dense_matmul", peak) == chip_smoke.DENSE_BF16_REL * peak
        assert chip_smoke.GRAD_BF16_REL * peak >= 2.0 ** (math.floor(math.log2(peak)) - 7)
