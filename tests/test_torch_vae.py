"""The PyTorch port's VAE against the JAX package on the CPU, f32.

Inputs and every parameter (all nonzero) come from numpy.random.default_rng
and go to both packages; the port runs its plain attention version here.
Tolerance 1e-4 abs on encode mean/logvar, the posterior sample and decode:
both sides are f32 and differ only in summation order.

The mid-block attention site (one head of 512) is also held against the JAX
package's Pallas kernels K1 and K2 in interpret mode, at a small sequence
length: 2e-5 abs, the tolerance tests/test_pallas_attention.py uses.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imagine360_tpu.models.vae import AutoencoderKL, VAEConfig
from imagine360_tpu.ops.attention import _single_block_attention
from imagine360_tpu.ops.pallas_attention import mh_flash_attention
from imagine360_tpu.pipeline.conditioning import (downsample_mask_nearest,
                                                  prepare_masked_latents)

from imagine360_tpu_torch.models.vae import AutoencoderKL as TAutoencoderKL
from imagine360_tpu_torch.models.vae import VAEConfig as TVAEConfig
from imagine360_tpu_torch.ops import attention as tattn
from imagine360_tpu_torch.pipeline.conditioning import (
    downsample_mask_nearest as t_downsample_mask_nearest,
    prepare_masked_latents as t_prepare_masked_latents)

from torch_parity import jax_params, load_into, max_abs_err, random_flat_params

TOL = 1e-4
KW = dict(block_out_channels=(32, 64, 64, 64), layers_per_block=1)


@pytest.fixture(scope="module")
def vaes():
    vae = AutoencoderKL(VAEConfig(**KW))
    x = np.random.default_rng(0).uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    flat = random_flat_params(vae, (jnp.asarray(x), jax.random.PRNGKey(1)), seed=1)
    tvae = load_into(TAutoencoderKL(TVAEConfig(**KW)), flat)
    return vae, jax_params(flat), tvae, x


def test_vae_encode_matches_jax(vaes):
    vae, params, tvae, x = vaes
    mean, logvar = vae.apply(params, jnp.asarray(x), method=vae.encode)
    with torch.no_grad():
        tmean, tlogvar = tvae.encode(torch.from_numpy(x))
    assert tuple(tmean.shape) == mean.shape == (2, 4, 6, 4)
    assert max_abs_err(tmean, mean) <= TOL
    assert max_abs_err(tlogvar, logvar) <= TOL


def test_vae_decode_matches_jax(vaes):
    vae, params, tvae, _ = vaes
    z = np.random.default_rng(2).standard_normal((2, 4, 6, 4)).astype(np.float32)
    want = vae.apply(params, jnp.asarray(z), method=vae.decode)
    with torch.no_grad():
        got = tvae.decode(torch.from_numpy(z))
    assert tuple(got.shape) == want.shape == (2, 32, 48, 3)
    assert max_abs_err(got, want) <= TOL


def test_vae_sample_with_noise_passed_in(vaes):
    """mean + exp(logvar / 2) * noise with the JAX package's own noise."""
    vae, params, tvae, x = vaes
    key = jax.random.PRNGKey(5)
    want = vae.apply(params, jnp.asarray(x), key, method=vae.sample)
    noise = np.array(jax.random.normal(key, (2, 4, 6, 4), jnp.float32))
    with torch.no_grad():
        got = tvae.sample(torch.from_numpy(x), noise=torch.from_numpy(noise))
        drawn = tvae.sample(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert max_abs_err(got, want) <= TOL
    assert drawn.shape == got.shape and not torch.equal(drawn, got)
    with pytest.raises(ValueError, match="one of them"):
        tvae.sample(torch.from_numpy(x))


@pytest.mark.parametrize("chunk", [None, 2])
def test_prepare_masked_latents_deterministic_matches_jax(vaes, chunk):
    vae, params, tvae, _ = vaes
    px = np.random.default_rng(3).uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    want = prepare_masked_latents(vae, params, jnp.asarray(px), jax.random.PRNGKey(0),
                                  chunk=chunk, deterministic=True)
    got = t_prepare_masked_latents(tvae, torch.from_numpy(px), chunk=chunk,
                                   deterministic=True)
    assert max_abs_err(got, want) <= TOL
    with pytest.raises(ValueError, match="do not divide"):
        t_prepare_masked_latents(tvae, torch.from_numpy(px), chunk=3, deterministic=True)


def test_downsample_mask_nearest_matches_jax():
    m = (np.random.default_rng(4).random((2, 3, 16, 32, 1)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(t_downsample_mask_nearest(torch.from_numpy(m)).numpy(),
                                  np.asarray(downsample_mask_nearest(jnp.asarray(m))))


@pytest.mark.parametrize("route,S", [("single", 96), ("mh_flash", 640)])
def test_wide_head_attention_matches_pallas_interpret(route, S):
    """The VAE's attention site, (B, S, S, 1 head, D = 512), through the
    port's entry point (plain version on the CPU) against the Pallas kernel
    the JAX package runs there: K1 (`single`) or K2 (`mh_flash`)."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, S, 1, 512)).astype(np.float32) for _ in range(3))
    if route == "single":
        want = _single_block_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       interpret=True)
    else:
        want = mh_flash_attention(*(jnp.asarray(t).reshape(2, S, 512) for t in (q, k, v)),
                                  512 ** -0.5, 1, block_q=128, block_k=128,
                                  interpret=True).reshape(2, S, 1, 512)
    tattn.reset_counts()
    got = tattn.dot_product_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert tattn.plain_path_calls() == 1
    assert max_abs_err(got, want) <= 2e-5
