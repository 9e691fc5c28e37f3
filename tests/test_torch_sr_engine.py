"""The port's SR engine (imagine360_tpu_torch/sr/enhance.py, sr/refiner.py,
sr/cli.py) against the JAX package's on the CPU, f32.

The enhancer's randomness goes in as tensors: the JAX draws are rebuilt
here from its key splits (imagine360_tpu/sr/enhance.py:81, 104 and the
posterior's normal draw, models/vae.py:175) and handed to the port as an
EnhancerNoise; the two packages' generators are never compared. The
refiner's parity runs on micro_unet_config, whose JAX tree goes to the port
through from_jax_params; the JAX refiners are built once (one jit each) and
shared by the refiner and end-to-end cases. Outputs agree within 1e-4 of
their largest element; the upsample equals cv2.resize INTER_LINEAR within
1e-6, and the chunked encode the whole-clip encode within 1e-5 of the
latents' largest element (convolutions of other batch sizes). Inputs come from numpy.random.default_rng.
"""
import logging

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagine360_tpu.models.unet3d import UNet3DConditionModel as JUNet
from imagine360_tpu.models.vae import AutoencoderKL as JVAE, VAEConfig as JVAEConfig
from imagine360_tpu.models.vae_temporal import AutoencoderKLTemporalDecoder as JTVAE
from imagine360_tpu.presets import micro_unet_config
from imagine360_tpu.sr import enhance as jenh
from imagine360_tpu.sr.refiner import PanoRefiner as JRefiner, PanoRefinerConfig as JRefinerCfg
from imagine360_tpu.utils.convert import (apply_converted, convert_temporal_vae_state_dict,
                                          flatten_params, unflatten)

from imagine360_tpu_torch.models.unet3d import UNet3DConditionModel as TUNet
from imagine360_tpu_torch.models.vae import AutoencoderKL as TVAE, VAEConfig as TVAEConfig
from imagine360_tpu_torch.models.vae_temporal import AutoencoderKLTemporalDecoder as TTVAE
from imagine360_tpu_torch.presets import micro_unet_config as t_micro
from imagine360_tpu_torch.sr import cli as sr_cli
from imagine360_tpu_torch.sr.enhance import EnhancerConfig, EnhancerNoise, Video360Enhancer
from imagine360_tpu_torch.sr.refiner import PanoRefiner, PanoRefinerConfig
from imagine360_tpu_torch.utils.convert import from_jax_params

from torch_parity import (jax_params, load_into, max_abs_err, random_flat_params,
                          random_state_dict)

REL_TOL = 1e-4
VAE_KW = dict(block_out_channels=(16, 16, 16, 16), layers_per_block=1,
              norm_num_groups=16)                              # tests/test_sr.py:158
FRAMES = (3, 16, 32)
ENH_KW = dict(up_scale=2, num_steps=6, noise_aug=600, tile_hw=(3, 6))
# the pano UNet as refiner: latents of 2 frames, 16 x 24 (tests/test_sr.py:139 at 2
# frames)
RF, RH, RW, TEXT_LEN = 2, 16, 24, 77
# the UNet parameters a single-branch JAX init without reference features
# or relative positions leaves out (the port builds them)
UNUSED = ("add_cond_embedding.", "cond_rp_proj.", "add_cond_embedding2.", "temporal_proj.",
          "image_proj_model.")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the tier-1 run
    puts six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=REL_TOL):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    assert max_abs_err(got, want) <= tol * np.abs(want).max(), (
        max_abs_err(got, want), np.abs(want).max())


def _jax_noise(seed, shape, steps, sde):
    """The JAX enhancer's draws for PRNGKey(seed), as an EnhancerNoise."""
    rng = jax.random.PRNGKey(seed)
    rng, k_enc, k_aug = jax.random.split(rng, 3)
    post = jax.random.normal(k_enc, shape, jnp.float32)
    aug = jax.random.normal(k_aug, shape)
    sdes = []
    for _ in range(steps):
        rng, _, k_n = jax.random.split(rng, 3)
        sdes.append(jax.random.normal(k_n, shape))
    t = lambda a: torch.from_numpy(np.array(a))
    return EnhancerNoise(t(post), t(aug), t(jnp.stack(sdes)) if sde else None)


class _JitVAE:
    """A JAX VAE whose `apply(params, ..., method=...)`, as the JAX enhancer
    calls it, runs jitted: the same functions, compiled once a shape."""

    sample, decode = "sample", "decode"

    def __init__(self, vae):
        self.cfg = vae.cfg
        self._fns = {"sample": jax.jit(lambda p, x, r: vae.apply(p, x, r, method=vae.sample)),
                     "decode": jax.jit(lambda p, z: vae.apply(p, z, method=vae.decode))}

    def apply(self, params, *args, method):
        return self._fns[method](params, *args)


def _jax_standin(z, t, rng):
    return 0.5 * z + 1e-3 * t[0]


def _port_standin(z, t):
    return 0.5 * z + 1e-3 * float(t[0])


@pytest.fixture(scope="module")
def vaes():
    jvae = JVAE(JVAEConfig(**VAE_KW))
    flat = random_flat_params(jvae, (jnp.zeros((1, 32, 32, 3)), jax.random.PRNGKey(1)), 21)
    return _JitVAE(jvae), jax_params(flat), load_into(TVAE(TVAEConfig(**VAE_KW)), flat)


def _frames(seed, shape=FRAMES, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape + (3,)).astype(np.float32)


def _run_both(jvae, jparams, tvae, kw, frames, jax_fn=_jax_standin, port_fn=_port_standin,
              seed=7):
    want = jenh.Video360Enhancer(jax_fn, jvae, jparams, jenh.EnhancerConfig(**kw))(
        frames, jax.random.PRNGKey(seed))
    enh = Video360Enhancer(port_fn, tvae, EnhancerConfig(**kw))
    noise = _jax_noise(seed, enh.latent_shape(frames.shape), enh.refine_steps,
                       kw.get("solver_mode", "sde") == "sde")
    return enh(frames, noise=noise), want


# (solver, circular pad in px, frames an encode / decode call takes, colour fix)
CASES = [("ode", 8, 2, True), ("sde", 8, 2, False), ("sde", 16, 3, True)]


@pytest.mark.parametrize("solver,pad,chunk,color_fix", CASES)
def test_enhancer_matches_jax(vaes, solver, pad, chunk, color_fix):
    kw = dict(ENH_KW, solver_mode=solver, pano_pad_px=pad, chunk_frames=chunk,
              color_fix=color_fix)
    got, want = _run_both(*vaes, kw, _frames(pad + chunk))
    assert got.shape == (3, 32, 64, 3)
    # most values inside (0, 1): the clip to [0, 1] hides little
    assert 0.5 < float(((want > 0) & (want < 1)).mean())
    _close(got, want)


def test_enhancer_without_a_pad(vaes):
    """pano_pad_px 0 pads nothing (the JAX enhancer concatenates the whole
    width twice more there: x[:, :, -0:] is all of x)."""
    enh = Video360Enhancer(_port_standin, vaes[2], EnhancerConfig(**ENH_KW, pano_pad_px=0))
    frames = _frames(8)
    assert enh.latent_shape(frames.shape) == (3, 4, 8, 4)
    out = enh(frames, generator=torch.Generator().manual_seed(0))
    assert out.shape == (3, 32, 64, 3) and bool(torch.isfinite(out).all())


def test_enhancer_with_temporal_vae_matches_jax():
    """The SVD temporal-decoder VAE (channel-first) as encode and decode."""
    kw = dict(block_out_channels=(32, 32, 32, 32), layers_per_block=1)   # tests/test_sr.py:115
    port = TTVAE(TVAEConfig(**kw))
    sd = random_state_dict(port, 8)
    port.load_state_dict(sd, strict=True)
    jvae = JTVAE(JVAEConfig(**kw))
    shapes = jax.eval_shape(lambda: jvae.init({"params": jax.random.PRNGKey(0)},
                                              jnp.zeros((2, 16, 16, 3)), jax.random.PRNGKey(1)))
    params, missing, unexpected = apply_converted(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes),
        convert_temporal_vae_state_dict(sd))
    assert not missing and not unexpected
    enh_kw = dict(ENH_KW, solver_mode="ode", pano_pad_px=8, chunk_frames=2, color_fix=False)
    got, want = _run_both(_JitVAE(jvae), params, port.eval(), enh_kw, _frames(4))
    _close(got, want)


def test_upsample_is_cv2_linear(vaes):
    frames = _frames(5, (2, 9, 14))
    got = Video360Enhancer(_port_standin, vaes[2]).upsample(frames).permute(0, 2, 3, 1)
    want = np.stack([cv2.resize(f, (28, 18), interpolation=cv2.INTER_LINEAR) for f in frames])
    assert max_abs_err(got, want) <= 1e-6


class _Captured(Exception):
    """Raised by _Capture with the clean latents it is handed, which ends
    the enhancer's call after its encode."""


class _Capture:
    def prepare(self, z):
        raise _Captured(z)


def test_chunked_encode_equals_whole_clip_encode(vaes):
    frames = _frames(6)
    latents = {}
    for chunk in (1, 2, FRAMES[0]):
        enh = Video360Enhancer(_Capture(), vaes[2], EnhancerConfig(**ENH_KW, chunk_frames=chunk))
        noise = _jax_noise(3, enh.latent_shape(frames.shape), enh.refine_steps, True)
        with pytest.raises(_Captured) as got:
            enh(frames, noise=noise)
        latents[chunk] = got.value.args[0]
    whole = latents[FRAMES[0]]
    for chunk in (1, 2):
        assert max_abs_err(latents[chunk], whole.numpy()) <= 1e-5 * whole.abs().max()


def test_enhancer_takes_a_generator_or_noise(vaes):
    enh = Video360Enhancer(_port_standin, vaes[2], EnhancerConfig(**ENH_KW))
    frames = _frames(7)
    noise = _jax_noise(1, enh.latent_shape(frames.shape), enh.refine_steps, True)
    with pytest.raises(ValueError, match="one of them"):
        enh(frames)
    with pytest.raises(ValueError, match="one of them"):
        enh(frames, generator=torch.Generator(), noise=noise)
    with pytest.raises(ValueError, match="shape"):
        enh(frames, noise=noise._replace(augment=noise.augment[:1]))
    a = enh(frames, generator=torch.Generator().manual_seed(5))
    b = enh(frames, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.shape == (3, 32, 64, 3)
    assert enh.refine_steps == 4            # steps from t = 499 of 831, 665, 499, ..., 1


def test_default_refines_four_of_fifteen_steps(vaes):
    enh = Video360Enhancer(_port_standin, vaes[2])
    assert (enh.start, enh.refine_steps) == (11, 4)
    assert enh.schedule.timesteps[enh.start] == 199


# ---- the pano UNet as refiner -----------------------------------------------


@pytest.fixture(scope="module")
def refiners():
    """{cfg_active: (JAX refiner, port refiner)} on one micro UNet."""
    unet = JUNet(micro_unet_config())
    shapes = jax.eval_shape(lambda: unet.init(
        {"params": jax.random.PRNGKey(0), "ip_noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, RF, RH, RW, 9)), jnp.zeros((1,)), jnp.zeros((1, TEXT_LEN, 32)),
        jnp.zeros((1,))))["params"]
    rng = np.random.default_rng(31)
    flat = {}
    for k, s in flatten_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                            shapes)).items():
        x = rng.standard_normal(s.shape)
        leaf = k.split(".")[-1]
        x = (x / np.sqrt(np.prod(s.shape[:-1])) if leaf == "kernel"
             else 1.0 + 0.1 * x if leaf == "scale" else 0.1 * x)
        flat[k] = x.astype(np.float32)
    tunet = TUNet(t_micro())
    res = tunet.load_state_dict(from_jax_params(flat), strict=False)
    assert not res.unexpected_keys and all(k.startswith(UNUSED) for k in res.missing_keys)
    tunet.eval()
    params = {"params": unflatten(flat)}
    pos = rng.standard_normal((TEXT_LEN, 32)).astype(np.float32)
    zeros = np.zeros_like(pos)
    out = {}
    for active, text in ((False, dict(text_pos=zeros)), (True, dict(text_pos=pos, text_neg=zeros))):
        jr = JRefiner(unet, params, cfg=JRefinerCfg(guidance_scale=3.0),
                      **{k: jnp.asarray(v) for k, v in text.items()})
        tr = PanoRefiner(tunet, cfg=PanoRefinerConfig(guidance_scale=3.0),
                         **{k: torch.from_numpy(v) for k, v in text.items()})
        out[active] = (jr, tr)
    return out


def _latents(seed):
    return np.random.default_rng(seed).standard_normal((RF, RH, RW, 4)).astype(np.float32)


@pytest.mark.parametrize("active", [False, True])
def test_pano_refiner_step_matches_jax(refiners, active):
    jr, tr = refiners[active]
    assert tr.cfg_active == active
    z, zc = _latents(1), _latents(2)
    t = 500.0
    want = jr.prepare(jnp.asarray(zc))(jnp.asarray(z), jnp.array([t]), None)
    got = tr.prepare(torch.from_numpy(zc))(torch.from_numpy(z), torch.tensor([t]))
    _close(got, want)
    # without prepare: conditioned on zeros
    _close(tr(torch.from_numpy(z), torch.tensor([t])), jr(jnp.asarray(z), jnp.array([t]), None))


def test_pano_refiner_cfg_rule(refiners):
    """CFG only when g != 1 and the prompts differ; else one pass on the
    positive prompt."""
    tunet = refiners[False][1].unet
    pos = torch.from_numpy(np.random.default_rng(4).standard_normal((TEXT_LEN, 32))
                           .astype(np.float32))
    neg = torch.zeros_like(pos)
    assert PanoRefiner(tunet, pos, neg).cfg_active
    assert not PanoRefiner(tunet, pos, neg, PanoRefinerConfig(guidance_scale=1.0)).cfg_active
    assert not PanoRefiner(tunet, pos, pos.clone()).cfg_active
    assert not PanoRefiner(tunet).cfg_active
    # the single pass conditions on the positive prompt
    one = PanoRefiner(tunet, pos, neg, PanoRefinerConfig(guidance_scale=1.0))
    both = PanoRefiner(tunet, pos, neg, PanoRefinerConfig(guidance_scale=1.0 + 1e-9))
    z = torch.from_numpy(_latents(3))
    assert max_abs_err(one(z, torch.tensor([300.0])),
                       both(z, torch.tensor([300.0])).numpy()) <= 1e-4


def test_pano_engine_end_to_end_matches_jax(refiners, vaes):
    """The default engine through the enhancer (tests/test_sr.py:139 at
    micro width, 2 frames): the 9-channel outpaint conditioning on the clean
    upsampled clip, the circular pad, ODE steps, the colour fix."""
    jr, tr = refiners[False]
    jvae, jparams, tvae = vaes
    kw = dict(up_scale=2, num_steps=4, noise_aug=600, solver_mode="ode", pano_pad_px=32,
              chunk_frames=2, tile_hw=(8, 8), color_fix=True)
    frames = _frames(9, (RF, 64, 64), 0.2, 0.8)
    got, want = _run_both(jvae, jparams, tvae, kw, frames, jr, tr, seed=1)
    assert got.shape == (RF, 128, 128, 3) and float(want.std()) > 1e-4
    _close(got, want)


# ---- the command line ---------------------------------------------------------


@pytest.mark.parametrize("engine", ["pano", "v2v"])
def test_sr_cli_writes_the_enhanced_clip(tmp_path, engine):
    clip = (np.random.default_rng(0).random((1, 32, 64, 3)) * 255).astype(np.uint8)
    np.save(tmp_path / "clip.npy", clip)
    out = tmp_path / f"{engine}.npy"
    assert sr_cli.main(["--input", str(tmp_path / "clip.npy"), "--output", str(out), "--tiny",
                        "--device", "cpu", "--engine", engine]) == 0
    back = np.load(out)
    assert back.shape == (1, 64, 128, 3) and back.dtype == np.uint8


def test_sr_cli_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sr_cli.main(["--input", str(tmp_path / "none.npy"), "--output", str(tmp_path / "o")])


def test_build_sr_modules_seeded_tiny():
    args = sr_cli.parse_args(["--input", "-", "--output", "-", "--tiny", "--guidance", "2.5"])
    refiner, vae = sr_cli.build_sr_modules(args, "cpu", seed=3)
    assert isinstance(refiner, PanoRefiner) and refiner.cfg.guidance_scale == 2.5
    assert refiner.unet.cfg.block_out_channels == (32, 64, 64, 64)
    assert vae.quant_conv.weight.dtype == torch.float32 and vae.quant_conv.weight.any()
    assert not refiner.cfg_active
    zero, _ = sr_cli.build_sr_modules(args, "cpu")
    assert not any(p.any() for p in zero.unet.parameters())


def _capture(logger):
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    h = Capture()
    logger.addHandler(h)
    return records, h


@pytest.mark.parametrize("prompt", [None, "a dog"])
def test_prompt_without_encoder_runs_unconditioned(prompt):
    argv = ["--input", "-", "--output", "-"] + (["--prompt", prompt] if prompt else [])
    records, h = _capture(sr_cli.log)
    try:
        out = sr_cli._encode_sr_prompts(sr_cli.parse_args(argv), None, "cpu")
    finally:
        sr_cli.log.removeHandler(h)
    assert out == (None, None)
    assert any("running unconditioned" in m for m in records) == bool(prompt)


def test_sr_sites_are_inside_the_kernels_index_range():
    """K1, K2 and K4 hold their block counts and (batch, head) indices in
    32 bits: every SR site of chip_smoke.py is inside, a product past 2**31
    raises before a launch."""
    from imagine360_tpu_torch.ops import kernels

    # the largest: K2 (16, 33792, 33792, 5, 64), K1 (33792, 16, 16, 5, 64),
    # K4 (1, 16, 33792, 320, 8)
    kernels.check_index_range("mh_flash_attention", rows=16 * 5 * 33792)
    kernels.check_index_range("tiny_attention", rows=33792 * 5 * 16)
    kernels.check_index_range("frame_attention", problems=1 * 33792 * 8)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        kernels.check_index_range("tiny_attention", rows=2 ** 31)
