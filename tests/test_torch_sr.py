"""The port's SR pieces against the JAX package on the CPU, f32: the 5x5
gaussian blur, the wavelet colour fix, the tiled and chunked decode, and the
temporal-decoder VAE.

Inputs come from numpy.random.default_rng and go to both packages; the port
is channel-first ([F, C, H, W]), the JAX package channel-last
([F, H, W, C]), so the tests transpose. Tolerances: blur and wavelet 1e-6
abs (the same float32 sums in the same order); gaussian weights exact (the
same numpy code); the tiled decode 1e-5 abs (blended sums of many tiles);
the temporal VAE 1e-4 of the output's largest element (convolutions summed
in another order).

The temporal VAE's parameters are one random state dict under diffusers'
`AutoencoderKLTemporalDecoder` names: loaded into the port as it stands and
into the JAX module through imagine360_tpu/utils/convert.py:
convert_temporal_vae_state_dict. The identity-collapse case of
tests/test_temporal_vae_golden.py (temporal conv2s zeroed, time_conv_out the
identity) is held against the port's standard VAE Decoder.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagine360_tpu.models.vae import VAEConfig
from imagine360_tpu.models.vae_temporal import AutoencoderKLTemporalDecoder
from imagine360_tpu.ops.blur import gaussian_blur_5x5
from imagine360_tpu.sr import tiled_decode as jtiled
from imagine360_tpu.sr.wavelet_fix import wavelet_color_fix, wavelet_decompose
from imagine360_tpu.utils.convert import (apply_converted, convert_temporal_vae_state_dict,
                                          flatten_params)

from imagine360_tpu_torch.models import vae_temporal as tvt
from imagine360_tpu_torch.models.vae import AutoencoderKL as TAutoencoderKL
from imagine360_tpu_torch.models.vae import VAEConfig as TVAEConfig
from imagine360_tpu_torch.ops import blur as tblur
from imagine360_tpu_torch.sr import tiled_decode as ttiled
from imagine360_tpu_torch.sr import wavelet_fix as twave
from imagine360_tpu_torch.utils.convert import from_jax_params

from torch_parity import jax_params, max_abs_err, random_flat_params

EXACT_TOL = 1e-6
TILED_TOL = 1e-5
VAE_REL = 1e-4
KW = dict(block_out_channels=(32, 32), layers_per_block=1)    # tests/test_sr.py:84


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the tier-1 run
    puts six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    """[..., H, W, C] numpy -> [..., C, H, W] torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _nhwc(t):
    """[..., C, H, W] torch -> [..., H, W, C] numpy."""
    return np.moveaxis(t.detach().numpy(), -3, -1)


def _uniform(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


# ---- blur -------------------------------------------------------------------


@pytest.mark.parametrize("wrap_w", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 9, 14), (1, 5, 4)])
def test_blur_matches_jax(wrap_w, shape):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    want = gaussian_blur_5x5(jnp.asarray(x), sigma=1.3, wrap_w=wrap_w)
    got = tblur.gaussian_blur_5x5(torch.from_numpy(x), sigma=1.3, wrap_w=wrap_w)
    assert got.shape == want.shape and max_abs_err(got, want) <= EXACT_TOL


# ---- wavelet colour fix -----------------------------------------------------

# [F, H, W, C]: a frame taller than the largest radius, and one of 10 rows
# and 12 columns, where the radius-16 level pads past both axes
WAVELET_SHAPES = [(2, 24, 40, 3), (1, 10, 12, 3)]


@pytest.mark.parametrize("shape", WAVELET_SHAPES)
def test_wavelet_decompose_matches_jax(shape):
    x = _uniform(1, shape)
    want_hi, want_lo = wavelet_decompose(jnp.asarray(x))
    hi, lo = twave.wavelet_decompose(_nchw(x))
    assert max_abs_err(_nhwc(hi), want_hi) <= EXACT_TOL
    assert max_abs_err(_nhwc(lo), want_lo) <= EXACT_TOL


@pytest.mark.parametrize("shape", WAVELET_SHAPES)
def test_wavelet_color_fix_matches_jax(shape):
    target, source = _uniform(2, shape), _uniform(3, shape)
    want = wavelet_color_fix(jnp.asarray(target), jnp.asarray(source))
    got = twave.wavelet_color_fix(_nchw(target), _nchw(source))
    assert max_abs_err(_nhwc(got), want) <= EXACT_TOL
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


# ---- tiled decode -----------------------------------------------------------


@pytest.mark.parametrize("hw", [(16, 24), (9, 128), (1, 1)])
def test_gaussian_weights_exact(hw):
    np.testing.assert_array_equal(ttiled.gaussian_weights_2d(*hw),
                                  jtiled.gaussian_weights_2d(*hw))
    np.testing.assert_array_equal(ttiled.gaussian_weights_1d(hw[1]),
                                  jtiled.gaussian_weights_1d(hw[1]))


# a fixed linear map of the 4 latent channels to 3, then an 8x nearest upsample
MIX = np.random.default_rng(4).standard_normal((4, 3)).astype(np.float32)


def _jax_standin(z):          # [N, th, tw, 4] -> [N, 8th, 8tw, 3]
    y = z @ jnp.asarray(MIX)
    return jnp.repeat(jnp.repeat(y, 8, axis=1), 8, axis=2)


def _port_standin(z):         # [N, 4, th, tw] -> [N, 3, 8th, 8tw]
    y = torch.einsum("nchw,cd->ndhw", z, torch.from_numpy(MIX))
    return y.repeat_interleave(8, dim=2).repeat_interleave(8, dim=3)


# (latents [F, h, w, 4], tile_hw): ragged last tiles on both axes; and a
# latent 3 wide under a pano pad of tw // 8 = 3, which takes the whole axis
# on each side, the tile clipped to the padded width
TILED_CASES = [((5, 11, 19, 4), (6, 8)), ((5, 7, 3, 4), (4, 24))]


@pytest.mark.parametrize("pano_wrap", [False, True])
@pytest.mark.parametrize("shape,tile_hw", TILED_CASES)
def test_tiled_decode_matches_jax(pano_wrap, shape, tile_hw):
    lat = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    want = jtiled.tiled_chunked_decode(_jax_standin, jnp.asarray(lat), tile_hw=tile_hw,
                                       overlap=0.25, chunk=2, pano_wrap=pano_wrap)
    got = ttiled.tiled_chunked_decode(_port_standin, _nchw(lat), tile_hw=tile_hw,
                                      overlap=0.25, chunk=2, pano_wrap=pano_wrap)
    assert got.dtype == torch.float32 and got.shape == (shape[0], 3, shape[1] * 8,
                                                        shape[2] * 8)
    assert max_abs_err(_nhwc(got), want) <= TILED_TOL


def test_tiled_decode_refuses_a_pad_wider_than_the_latent():
    """A circular pad wider than the width would wrap more than once; the
    JAX function fails there on mismatched shapes, the port says why."""
    lat = torch.zeros(2, 4, 7, 2)
    with pytest.raises(ValueError, match="wider than"):
        ttiled.tiled_chunked_decode(_port_standin, lat, tile_hw=(4, 24), pano_wrap=True)


# ---- the temporal-decoder VAE -----------------------------------------------


def _random_state_dict(module, seed):
    """Nonzero random tensors under `module`'s own names: weights of two or
    more dims ~ N(0, 1/fan_in), other weights 1 + N(0, 0.1), the rest
    N(0, 0.1) (the mix factors too)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in module.state_dict().items():
        x = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        if v.dim() >= 2:
            x = x / np.sqrt(np.prod(v.shape[1:]))
        elif k.endswith(".weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        sd[k] = torch.from_numpy(x.astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def temporal_vaes():
    """(JAX module, its params, the port's module, the diffusers-named state
    dict both were loaded from, the load results)."""
    port = tvt.AutoencoderKLTemporalDecoder(TVAEConfig(**KW))
    sd = _random_state_dict(port, 6)
    loaded = port.load_state_dict(sd, strict=True)
    jvae = AutoencoderKLTemporalDecoder(VAEConfig(**KW))
    params = jvae.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)), jax.random.PRNGKey(1))
    params, missing, unexpected = apply_converted(params, convert_temporal_vae_state_dict(sd))
    return jvae, params, port.eval(), sd, (loaded, missing, unexpected)


def _rel_err(got, want):
    return max_abs_err(got, want) / float(np.abs(np.asarray(want)).max())


def test_temporal_vae_state_dict_loads_in_both(temporal_vaes):
    *_, sd, (loaded, missing, unexpected) = temporal_vaes
    assert not loaded.missing_keys and not loaded.unexpected_keys
    assert not missing and not unexpected, (missing[:5], unexpected[:5])
    assert sd["decoder.mid_block.resnets.0.temporal_res_block.conv1.weight"].shape == \
        (32, 32, 3, 1, 1)
    assert sd["decoder.up_blocks.1.resnets.1.time_mixer.mix_factor"].shape == (1,)
    assert "decoder.time_conv_out.weight" in sd and not any("post_quant" in k for k in sd)


def test_from_jax_params_gives_the_same_tensors(temporal_vaes):
    _, params, _, sd, _ = temporal_vaes
    back = from_jax_params(flatten_params(params["params"]))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # the mix factor is negated on the way in and again on the way back
    flat = flatten_params(params["params"])
    assert float(flat["decoder.mid_block_resnets_0.mix_factor"]) == \
        -float(sd["decoder.mid_block.resnets.0.time_mixer.mix_factor"])


@pytest.fixture(scope="module")
def encoded(temporal_vaes):
    jvae, params, port, _, _ = temporal_vaes
    x = np.random.default_rng(7).uniform(-1, 1, (3, 16, 24, 3)).astype(np.float32)
    want = jvae.apply(params, jnp.asarray(x), method=jvae.encode)
    with torch.no_grad():
        got = port.encode(_nchw(x))
    return want, got


def test_temporal_vae_encode_matches_jax(encoded):
    (want_mean, want_logvar), (mean, logvar) = encoded
    assert mean.shape == (3, 4, 8, 12)
    assert _rel_err(_nhwc(mean), want_mean) <= VAE_REL
    assert _rel_err(_nhwc(logvar), want_logvar) <= VAE_REL


def test_temporal_vae_sample_with_noise_passed_in(temporal_vaes):
    """mean + exp(logvar / 2) * noise, with the JAX module's own noise."""
    jvae, params, port, _, _ = temporal_vaes
    x = np.random.default_rng(19).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jvae.apply(params, jnp.asarray(x), key, method=jvae.sample)
    noise = np.array(jax.random.normal(key, want.shape, jnp.float32))
    with torch.no_grad():
        got = port.sample(_nchw(x), noise=_nchw(noise))
    assert _rel_err(_nhwc(got), want) <= VAE_REL
    with pytest.raises(ValueError, match="one of them"):
        port.sample(_nchw(x))


# one video of 4 frames, and one of a single frame (the last chunk of 16
# frames at chunk 5): its temporal convs see zeros on both sides
@pytest.mark.parametrize("frames", [4, 1])
def test_temporal_vae_decode_video_matches_jax(temporal_vaes, frames):
    jvae, params, port, _, _ = temporal_vaes
    z = np.random.default_rng(frames).standard_normal((frames, 6, 10, 4)).astype(np.float32)
    want = jvae.apply(params, jnp.asarray(z), method=jvae.decode)
    with torch.no_grad():
        got = port.decode(_nchw(z))
    assert got.shape == (frames, 3, 12, 20)
    assert _rel_err(_nhwc(got), want) <= VAE_REL


def test_temporal_vae_decode_batch_matches_jax(temporal_vaes):
    jvae, params, port, _, _ = temporal_vaes
    z = np.random.default_rng(8).standard_normal((2, 3, 6, 10, 4)).astype(np.float32)
    want = jvae.apply(params, jnp.asarray(z), method=jvae.decode)
    with torch.no_grad():
        got = port.decode(_nchw(z))
        single = port.decode(_nchw(z[1]))
    assert got.shape == (2, 3, 3, 12, 20)
    assert _rel_err(_nhwc(got), want) <= VAE_REL
    assert torch.allclose(got[1], single, atol=1e-5)


def _blocks(port, cls):
    return [m for m in port.modules() if isinstance(m, cls)]


def test_temporal_norms_eps(temporal_vaes):
    """The temporal resnets' GroupNorms take eps 1e-5, every other one in
    the decoder 1e-6 (imagine360_tpu/models/vae_temporal.py:59-63)."""
    port = temporal_vaes[2]
    temporal = _blocks(port, tvt.TemporalResnetBlock)
    assert temporal and all(b.norm1.eps == b.norm2.eps == 1e-5 for b in temporal)
    others = [m for n, m in port.decoder.named_modules()
              if isinstance(m, torch.nn.GroupNorm) and "temporal_res_block" not in n]
    assert others and all(m.eps == 1e-6 for m in others)


def test_mix_is_diffusers_alpha_blend(temporal_vaes):
    """out = (1 - σ(m))·spatial + σ(m)·temporal with diffusers' m."""
    blender = _blocks(temporal_vaes[2], tvt._AlphaBlender)[0]
    s, t = torch.full((2,), 3.0), torch.full((2,), -1.0)
    a = torch.sigmoid(blender.mix_factor.detach())
    with torch.no_grad():
        assert torch.allclose(blender(s, t), (1 - a) * s + a * t)


def test_temporal_resnet_with_shortcut_matches_jax():
    """A temporal resnet that widens 32 -> 64 channels (no decoder block
    does): its 1x1x1 shortcut, a Dense [Ci, Co] in the JAX module, loads
    through from_jax_params as a Conv3d [Co, Ci, 1, 1, 1]."""
    from imagine360_tpu.models.vae_temporal import TemporalResnetBlock

    x = np.random.default_rng(17).standard_normal((2, 3, 4, 5, 32)).astype(np.float32)
    block = TemporalResnetBlock(64)
    flat = random_flat_params(block, (jnp.asarray(x),), seed=18)
    port = tvt.TemporalResnetBlock(32, 64)
    res = port.load_state_dict(from_jax_params(flat), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    assert port.conv_shortcut.weight.shape == (64, 32, 1, 1, 1)
    want = block.apply(jax_params(flat), jnp.asarray(x))
    with torch.no_grad():       # [B, F, H, W, C] -> [B, C, F, H, W] and back
        got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert _rel_err(got, want) <= VAE_REL


def test_conv_norm_out_is_per_frame(temporal_vaes):
    """The output GroupNorm folds frames into the batch: each frame is
    normalised on its own statistics, so a constant offset on one frame's
    features before it leaves the other frames as they were."""
    norm = temporal_vaes[2].decoder.conv_norm_out
    h = torch.from_numpy(np.random.default_rng(9).standard_normal((3, 32, 4, 5))
                         .astype(np.float32))
    shifted = h.clone()
    shifted[0] += 5.0
    with torch.no_grad():
        a, b = norm(h), norm(shifted)
    assert torch.allclose(a[1:], b[1:]) and torch.allclose(a[0], b[0], atol=1e-4)


def test_tiled_decode_with_temporal_vae(temporal_vaes):
    """tiled_chunked_decode with the tiny temporal VAE as decode_fn (scale 2:
    two blocks), 5 frames at chunk 2, ragged tiles, with the pano wrap."""
    jvae, params, port, _, _ = temporal_vaes
    lat = np.random.default_rng(10).standard_normal((5, 7, 11, 4)).astype(np.float32)
    decode = jax.jit(lambda z: jvae.apply(params, z, method=jvae.decode))
    want = jtiled.tiled_chunked_decode(decode, jnp.asarray(lat), tile_hw=(4, 6), chunk=2,
                                       scale=2, pano_wrap=True)
    with torch.no_grad():
        got = ttiled.tiled_chunked_decode(port.decode, _nchw(lat), tile_hw=(4, 6), chunk=2,
                                          scale=2, pano_wrap=True)
    assert got.shape == (5, 3, 14, 22)
    assert _rel_err(_nhwc(got), want) <= VAE_REL


def _svd_state_dict(vae_sd, seed):
    """A standard AutoencoderKL state dict in the temporal VAE's names, as
    tests/test_temporal_vae_golden.py builds it: the decoder resnets gain the
    `spatial_res_block` level and temporal siblings whose conv2 is zero;
    time_conv_out is the identity centre tap; post_quant_conv is dropped."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in vae_sd.items():
        if k.startswith("post_quant_conv"):
            continue
        m = re.match(r"(decoder\..*resnets\.\d+)\.(.*)", k)
        if not m:
            sd[k] = v
            continue
        base, rest = m.groups()
        sd[f"{base}.spatial_res_block.{rest}"] = v
        if f"{base}.time_mixer.mix_factor" in sd:
            continue
        c = 32
        t = f"{base}.temporal_res_block"
        sd[f"{t}.conv1.weight"] = torch.from_numpy(
            rng.standard_normal((c, c, 3, 1, 1)).astype(np.float32) * 0.02)
        sd[f"{t}.conv1.bias"] = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.02)
        sd[f"{t}.conv2.weight"] = torch.zeros(c, c, 3, 1, 1)
        sd[f"{t}.conv2.bias"] = torch.zeros(c)
        for norm in ("norm1", "norm2"):
            sd[f"{t}.{norm}.weight"], sd[f"{t}.{norm}.bias"] = torch.ones(c), torch.zeros(c)
        sd[f"{base}.time_mixer.mix_factor"] = torch.from_numpy(
            rng.standard_normal(1).astype(np.float32))
    w = torch.zeros(3, 3, 3, 1, 1)
    w[:, :, 1, 0, 0] = torch.eye(3)
    sd["decoder.time_conv_out.weight"], sd["decoder.time_conv_out.bias"] = w, torch.zeros(3)
    return sd


def test_identity_collapse_matches_standard_decoder():
    """Temporal conv2s zeroed and time_conv_out the identity: the temporal
    decoder is the standard Decoder with the same spatial weights, whatever
    the mix (tests/test_temporal_vae_golden.py:138, 2e-5 abs)."""
    cfg = TVAEConfig(block_out_channels=(32, 32, 32, 32), layers_per_block=1)
    std = TAutoencoderKL(cfg)
    std.load_state_dict(_random_state_dict(std, 11), strict=True)
    temporal = tvt.AutoencoderKLTemporalDecoder(cfg)
    res = temporal.load_state_dict(_svd_state_dict(std.state_dict(), 12), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    z = torch.from_numpy(np.random.default_rng(13).standard_normal((4, 4, 4, 8))
                         .astype(np.float32) * 0.4)
    x = torch.from_numpy(np.random.default_rng(14).uniform(-1, 1, (2, 32, 64, 3))
                         .astype(np.float32))
    with torch.no_grad():
        got, want = temporal.decode(z), std.eval().decoder(z)
        mean_t, logvar_t = temporal.encode(x.permute(0, 3, 1, 2))
        mean_s, logvar_s = std.encode(x)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
    torch.testing.assert_close(mean_t, mean_s.permute(0, 3, 1, 2), atol=1e-6, rtol=0)
    torch.testing.assert_close(logvar_t, logvar_s.permute(0, 3, 1, 2), atol=1e-6, rtol=0)
