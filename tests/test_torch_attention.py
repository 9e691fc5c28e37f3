"""The plain PyTorch version of each attention kernel against the JAX
package's Pallas kernel, run in interpret mode on the CPU as
tests/test_pallas_attention.py runs it, at small shapes including ragged
key lengths; and the CPU dispatch of the port's attention entry points.

Tolerance: float32 inputs of unit scale on both sides, 1e-4 absolute
(sums in another order in the two frameworks). The kernels themselves are
held against these plain versions on the card by tests/test_torch_cuda.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from imagine360_tpu.ops.attention import _block_diag_bias, _kpad_bias
from imagine360_tpu.ops.pallas_attention import (_flash_shared_bias_t, mh_flash_attention,
                                                 temporal_packed_attention,
                                                 tiny_packed_attention)

from imagine360_tpu_torch.ops import attention as tattn
from imagine360_tpu_torch.ops import kernels

ATOL = 1e-4


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _check(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,G,S,H,D", [(8, 4, 16, 2, 8), (6, 2, 4, 3, 16)])
def test_tiny_plain_matches_packed_kernel(B, G, S, H, D):
    """K1 with the block-diagonal packing bias of the `packed` route."""
    rng = np.random.default_rng(0)
    Sp = G * S
    q, k, v = (_rand(rng, B, Sp, H * D) for _ in range(3))
    bias = _block_diag_bias(G, S, S)[0, 0]
    scale = D ** -0.5
    want = tiny_packed_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(bias[None]), scale, H, interpret=True)
    got = kernels.tiny_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(bias),
                                 scale=scale, heads=H)
    _check(got, want)


@pytest.mark.parametrize("Sq,Sk", [(64, 13), (32, 77), (16, 130)])
def test_tiny_plain_ragged_keys_matches_single_route(Sq, Sk):
    """K1 unpadded against the `single` route's lane-padded call with its
    key-pad bias: the port masks by Sk instead of padding."""
    rng = np.random.default_rng(1)
    B, H, D = 3, 2, 16
    q = _rand(rng, B, Sq, H * D)
    k, v = _rand(rng, B, Sk, H * D), _rand(rng, B, Sk, H * D)
    Skp = -(-Sk // 128) * 128
    pad = ((0, 0), (0, Skp - Sk), (0, 0))
    scale = D ** -0.5
    want = tiny_packed_attention(jnp.asarray(q), jnp.pad(jnp.asarray(k), pad),
                                 jnp.pad(jnp.asarray(v), pad),
                                 jnp.asarray(_kpad_bias(Sq, Sk, Skp)), scale, H,
                                 interpret=True)
    got = kernels.tiny_attention(*(torch.from_numpy(a) for a in (q, k, v)), scale=scale,
                                 heads=H)
    _check(got, want)


@pytest.mark.parametrize("Sq,Sk,H,D", [(256, 384, 2, 32), (200, 300, 3, 16)])
def test_mh_flash_plain_matches_kernel(Sq, Sk, H, D):
    rng = np.random.default_rng(2)
    B = 2
    q = _rand(rng, B, Sq, H * D)
    k, v = _rand(rng, B, Sk, H * D), _rand(rng, B, Sk, H * D)
    scale = D ** -0.5
    want = mh_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, H,
                              interpret=True)
    got = kernels.mh_flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                     scale=scale, heads=H)
    _check(got, want)


@pytest.mark.parametrize("Sq,Sk", [(160, 272), (128, 320)])
def test_shared_bias_plain_matches_kernel(Sq, Sk):
    rng = np.random.default_rng(3)
    B, H, D = 2, 2, 32
    q = _rand(rng, B, Sq, H, D)
    k, v = _rand(rng, B, Sk, H, D), _rand(rng, B, Sk, H, D)
    bias = _rand(rng, Sq, Sk)
    scale = D ** -0.5

    def fold(x):                      # [B, S, H, D] -> [B*H, D, S]
        return jnp.asarray(x.transpose(0, 2, 3, 1).reshape(B * H, D, -1))

    out = _flash_shared_bias_t(fold(q), fold(k), fold(v), jnp.asarray(bias.T), scale,
                               block_q=128, block_k=128, t_rows=2, interpret=True)
    want = np.asarray(out).reshape(B, H, D, Sq).transpose(0, 3, 1, 2)
    got = kernels.shared_bias_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                        torch.from_numpy(bias), scale=scale)
    _check(got, want)


@pytest.mark.parametrize("F,HW,C,H,G", [(8, 64, 64, 4, 8), (16, 32, 40, 8, 4)])
def test_frame_plain_matches_striped_kernel(F, HW, C, H, G):
    rng = np.random.default_rng(4)
    B = 2
    q, k, v = (_rand(rng, B, F, HW, C) for _ in range(3))
    scale = (C // H) ** -0.5
    want = temporal_packed_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                     H, G, interpret=True)
    got = kernels.frame_attention(*(torch.from_numpy(a) for a in (q, k, v)), scale=scale,
                                  heads=H)
    _check(got, want)


def test_cpu_dispatch_counts_plain_calls():
    """On CPU tensors the entry points run the plain einsum and count it;
    the wrappers count their plain versions, never a launch."""
    rng = np.random.default_rng(5)
    tattn.reset_counts()
    q = torch.from_numpy(_rand(rng, 2, 8, 2, 4))
    bias = torch.from_numpy(_rand(rng, 1, 1, 8, 8))
    out = tattn.dot_product_attention(q, q, q, bias=bias)
    ref = kernels.reference_attention(q, q, q, bias=bias)
    assert torch.equal(out, ref)
    x = torch.from_numpy(_rand(rng, 1, 4, 6, 8))
    tattn.temporal_attention(x, x, x, heads=2)
    kernels.tiny_attention(q.flatten(2), q.flatten(2), q.flatten(2), scale=0.5, heads=2)
    assert tattn.plain_path_calls() == 3
    assert all(c["launches"] == 0 for c in kernels.counts().values())
    tattn.reset_counts()
    assert tattn.plain_path_calls() == 0


def test_reference_attention_chunks_batch(monkeypatch):
    """The plain einsum splits the batch when the logits would exceed the
    byte limit, with the same result."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(_rand(rng, 5, 8, 2, 4)) for _ in range(3))
    whole = kernels.reference_attention(q, k, v)
    monkeypatch.setattr(kernels, "LOGITS_BYTES_LIMIT", 2 * 8 * 8 * 4 * 2)
    torch.testing.assert_close(kernels.reference_attention(q, k, v), whole, rtol=0, atol=0)
