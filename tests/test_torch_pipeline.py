"""The PyTorch port's pipeline against the JAX package on the CPU, f32:
`generate_core` (masked-latent VAE encodes, IP tokens, 2 CFG DDIM steps,
circular-pad VAE decode) on micro_dual_config and a small VAE, pano 64 x 128.

Every input and parameter (all nonzero) comes from numpy.random.default_rng
and goes to both packages. The randomness of the loop enters as tensors: the
initial noise is pinned, the VAE takes posterior means, and the per-step
antipodal choices and IP-token noise are the JAX package's own draws,
re-derived from its key schedule and passed to the port. Tolerance 1e-3 abs
on the [0, 1] video and 1e-3 of the latents' max: two UNet steps and two VAE
passes in f32, in another summation order.

Also: the entry points default to the card and raise without one, and
`Imagine360Pipeline.__call__` runs the whole path on the CPU when asked.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imagine360_tpu.config import RunConfig
from imagine360_tpu.geometry import CameraRig
from imagine360_tpu.models.dual import DualUNet, warp_sites
from imagine360_tpu.models.vae import AutoencoderKL, VAEConfig
from imagine360_tpu.pipeline.generate import Imagine360Pipeline, PipelineModules
from imagine360_tpu.pipeline.sampler import build_dual_warp_geoms
from imagine360_tpu.presets import micro_dual_config

from imagine360_tpu_torch import cli as tcli
from imagine360_tpu_torch.config import RunConfig as TRunConfig
from imagine360_tpu_torch.models.clip_text import CLIPTextConfig as TCLIPTextConfig
from imagine360_tpu_torch.models.dual import DualUNet as TDualUNet
from imagine360_tpu_torch.models.sam import SAMConfig as TSAMConfig
from imagine360_tpu_torch.models.vae import AutoencoderKL as TAutoencoderKL
from imagine360_tpu_torch.models.vae import VAEConfig as TVAEConfig
from imagine360_tpu_torch.ops import attention as tattn
from imagine360_tpu_torch.pipeline.generate import Imagine360Pipeline as TPipeline
from imagine360_tpu_torch.pipeline.generate import PipelineModules as TModules
from imagine360_tpu_torch.pipeline.sampler import build_dual_warp_geoms as t_build_geoms
from imagine360_tpu_torch.presets import micro_dual_config as t_micro
from imagine360_tpu_torch.presets import tiny_dual_config as t_tiny

from torch_parity import jax_params, load_into, max_abs_err, random_flat_params

M, F = 4, 2
H, W = 64, 128
PS = H // 2
VAE_KW = dict(block_out_channels=(32, 32, 32, 32), layers_per_block=1)
RUN_KW = dict(pano_H=H, pano_W=W, num_inference_steps=2, video_sample_length=F,
              angle_adapt="none", dtype="float32")


def _jax_step_draws(model, params, kd, steps, n_sites, prob, shapes):
    """The antipodal choices and the IP noise that the JAX sampler draws in
    each step of denoise(rng=kd): its key schedule, followed by hand."""
    use_opp, ip_noise = [], []
    for key in jax.random.split(kd, steps):
        k_opp, k_ip = jax.random.split(key)
        use_opp.append(np.asarray(jax.random.bernoulli(k_opp, prob, (n_sites,))).tolist())
        # DualUNet.__call__ asks for the pano noise first, then the pers noise
        k_pano, k_pers = model.apply(
            params, rngs={"ip_noise": k_ip},
            method=lambda m: (m.make_rng("ip_noise"), m.make_rng("ip_noise")))
        ip_noise.append(tuple(
            torch.from_numpy(np.array(jax.random.normal(k, s, jnp.float32)))
            for k, s in ((k_pers, shapes[0]), (k_pano, shapes[1]))))
    return use_opp, ip_noise


def test_generate_core_matches_jax():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    dual_cfg = micro_dual_config(num_views=M)
    rig = CameraRig.icosahedron(image_size=PS).take(M)
    geoms = build_dual_warp_geoms(dual_cfg, rig, (PS // 8, PS // 8), (H // 8, W // 8))
    n_sites = len(warp_sites(len(dual_cfg.pers.block_out_channels)))
    x = dict(
        pano_frames=rng.uniform(-1, 1, (F, H, W, 3)).astype(np.float32),
        pano_masks=(rng.random((F, H, W, 1)) > 0.5).astype(np.float32),
        views=rng.uniform(-1, 1, (F, M, PS, PS, 3)).astype(np.float32),
        vmasks=(rng.random((F, M, PS, PS, 1)) > 0.5).astype(np.float32),
        pano_text=f32(2, 7, 32), pers_text=f32(2 * M, 7, 32),
        ref_pano=f32(2, 4, 16, 8), ref_pers=f32(2 * M, 4, 16, 8),
        rel=rng.integers(0, 50, (F, 6)).astype(np.float32),
        pitch=rng.integers(0, 90, (F,)).astype(np.float32),
        noise=(f32(1, F, H // 8, W // 8, 4), f32(1, M, F, PS // 8, PS // 8, 4)))
    j = jnp.asarray

    model = DualUNet(dual_cfg)
    rep2 = lambda a: j(np.concatenate([a[None], a[None]]))
    dual_flat = random_flat_params(model, (
        jnp.zeros((2, M, F, PS // 8, PS // 8, 9)), jnp.zeros((2, F, H // 8, W // 8, 9)),
        jnp.zeros((2,)), j(x["pers_text"]), j(x["pano_text"]), jnp.zeros((2,)),
        j(x["ref_pers"]), j(x["ref_pano"]), rep2(x["rel"]), rep2(x["pitch"]), geoms,
        jnp.zeros((n_sites,), bool)), seed=1)
    vae = AutoencoderKL(VAEConfig(**VAE_KW))
    vae_flat = random_flat_params(vae, (jnp.zeros((1, 32, 32, 3)), jax.random.PRNGKey(1)),
                                  seed=2)
    dual_params = jax_params(dual_flat)
    pipe = Imagine360Pipeline(
        PipelineModules(dual=model, dual_params=dual_params, vae=vae,
                        vae_params=jax_params(vae_flat)),
        RunConfig(use_mesh="off", **RUN_KW), dual_cfg)
    rng0 = jax.random.PRNGKey(3)
    want_video, want_lat = pipe.generate_core(
        x["pano_frames"], x["pano_masks"], x["views"], x["vmasks"], j(x["pano_text"]),
        j(x["pers_text"]), j(x["ref_pano"]), j(x["ref_pers"]), j(x["rel"]), j(x["pitch"]),
        rng0, init_noise=tuple(j(n) for n in x["noise"]), deterministic_vae=True)

    # generate_core's key schedule down to the denoise key
    r1, _, _ = jax.random.split(rng0, 3)
    _, _, kd = jax.random.split(r1, 3)
    ip_pers, ip_pano = pipe.sampler.compute_ip(dual_params, j(x["ref_pers"]), j(x["ref_pano"]),
                                               rep2(x["rel"]), rep2(x["pitch"]))
    use_opp, ip_noise = _jax_step_draws(model, dual_params, kd, 2, n_sites, 0.4,
                                        (ip_pers.shape, ip_pano.shape))

    t_cfg = t_micro(num_views=M)
    tpipe = TPipeline(
        TModules(dual=load_into(TDualUNet(t_cfg), dual_flat),
                 vae=load_into(TAutoencoderKL(TVAEConfig(**VAE_KW)), vae_flat)),
        TRunConfig(**RUN_KW), t_cfg, device="cpu")
    got_video, got_lat = tpipe.generate_core(
        x["pano_frames"], x["pano_masks"], x["views"], x["vmasks"], x["pano_text"],
        x["pers_text"], x["ref_pano"], x["ref_pers"], x["rel"], x["pitch"],
        init_noise=x["noise"], deterministic_vae=True, use_opp=use_opp, ip_noise=ip_noise)

    assert got_video.shape == want_video.shape == (F, H, W, 3)
    lat_scale = float(np.abs(np.asarray(want_lat)).max())
    assert max_abs_err(got_lat, want_lat) <= 1e-3 * lat_scale
    assert np.abs(got_video - want_video).max() <= 1e-3
    # the noise matters: without it the port's latents move well beyond the tolerance
    _, plain_lat = tpipe.generate_core(
        x["pano_frames"], x["pano_masks"], x["views"], x["vmasks"], x["pano_text"],
        x["pers_text"], x["ref_pano"], x["ref_pers"], x["rel"], x["pitch"],
        init_noise=x["noise"], deterministic_vae=True, use_opp=use_opp,
        ip_noise=[(None, None)] * 2)
    assert max_abs_err(plain_lat, want_lat) > 1e-3 * lat_scale


# ---- entry points ---------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pipe():
    """The whole port pipeline on the CPU: tiny DualUNet, small VAE, a
    2-layer CLIP text encoder with a seeded stand-in tokenizer, no SAM (the
    tiny UNet's image features are 8 wide, not SAM's 256)."""
    cfg = TRunConfig(pano_H=128, pano_W=256, num_inference_steps=1, video_sample_length=4,
                     angle_adapt="linear_fit", dtype="float32")
    dual_cfg = t_tiny(num_views=4)
    modules = tcli.build_modules(
        cfg, dual_cfg, device="cpu", seed=0, vae_cfg=TVAEConfig(**VAE_KW),
        text_cfg=TCLIPTextConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                                 intermediate_size=64))
    modules.tokenizer = lambda s: np.random.default_rng(len(s)).integers(0, 64, 77)
    return TPipeline(modules, cfg, dual_cfg, device="cpu")


def test_pipeline_call_end_to_end_on_cpu(tiny_pipe):
    frames = np.random.default_rng(5).integers(0, 255, (4, 48, 48, 3), dtype=np.uint8)
    tattn.reset_counts()
    out = tiny_pipe(frames, prompt="a lake at sunset", raw_pitches=[3.0, 4.0, 6.0, 7.0],
                    generator=torch.Generator().manual_seed(1))
    assert out["videos"].shape == (4, 128, 256, 3)
    assert np.isfinite(out["videos"]).all()
    assert out["videos"].min() >= 0.0 and out["videos"].max() <= 1.0
    assert out["videos"].std() > 0.0            # seeded weights: not a constant image
    assert out["masks"].shape == (4, 128, 256, 1)
    assert out["pano_input"].shape == (4, 128, 256, 3)
    np.testing.assert_allclose(out["pitches"], [2.9, 4.3, 5.7, 7.1], atol=1e-5)
    # on the CPU every attention call takes a plain version, the VAE's and CLIP's included
    assert tattn.plain_path_calls() > 0
    assert all(c["launches"] == 0 for c in tattn.kernels.counts().values())


def test_pipeline_is_seeded_by_its_generator(tiny_pipe):
    frames = np.random.default_rng(6).integers(0, 255, (4, 32, 32, 3), dtype=np.uint8)
    run = lambda seed: tiny_pipe(frames, generator=torch.Generator().manual_seed(seed))
    a, b, c = run(1)["videos"], run(1)["videos"], run(2)["videos"]
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0


def test_encode_prompt_and_sam_shapes(tiny_pipe):
    pano_text, pers_text = tiny_pipe.encode_prompt("a", "b c", 4)
    assert tuple(pano_text.shape) == (2, 77, 32) and tuple(pers_text.shape) == (8, 77, 32)
    assert torch.equal(pers_text[:4], pano_text[:1].expand(4, -1, -1))
    assert torch.equal(pers_text[4:], pano_text[1:].expand(4, -1, -1))
    feats = tiny_pipe.encode_sam(np.zeros((4, 16, 16, 3), np.float32))
    assert tuple(feats.shape) == (4, 16, 8) and not feats.any()


def test_encode_sam_resizes_long_side_and_pads():
    """With a SAM encoder: long side to img_size, zero pad, [F, tokens, C]."""
    cfg = TRunConfig(pano_H=128, pano_W=256, dtype="float32")
    dual_cfg = t_tiny(num_views=4)
    modules = tcli.build_modules(
        cfg, dual_cfg, device="cpu", seed=0, vae_cfg=TVAEConfig(**VAE_KW),
        sam_cfg=TSAMConfig(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=2,
                           out_chans=8, window_size=2, global_attn_indexes=(1,),
                           global_q_rows=2))
    pipe = TPipeline(modules, cfg, dual_cfg, device="cpu")
    frames = np.random.default_rng(7).uniform(-1, 1, (3, 20, 40, 3)).astype(np.float32)
    feats = pipe.encode_sam(frames)
    assert tuple(feats.shape) == (3, 16, 8) and torch.isfinite(feats).all()


def test_entry_points_default_to_the_card_and_raise_without_one(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TRunConfig(pano_H=128, pano_W=256, dtype="float32")
    dual_cfg = t_tiny(num_views=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.build_modules(cfg, dual_cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_build_geoms(dual_cfg, None, (8, 8), (16, 32))
    modules = tcli.build_modules(cfg, dual_cfg, device="cpu", vae_cfg=TVAEConfig(**VAE_KW))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPipeline(modules, cfg, dual_cfg)
    cfgp = tmp_path / "run.yaml"
    cfgp.write_text("video_path: examples/\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--config", str(cfgp)])


def test_zero_init_dev_mode_and_checkpoint_refusal(tmp_path):
    """Without checkpoints every weight is zero. A configured checkpoint that
    exists is no longer refused: a per-branch UNet file is loaded over the
    zeros; a SAM file is not read while the UNet's image features are not
    SAM's 256 wide; an absent path is passed over."""
    cfg = TRunConfig(pano_H=128, pano_W=256, dtype="float32")
    modules = tcli.build_modules(cfg, t_tiny(num_views=4), device="cpu",
                                 vae_cfg=TVAEConfig(**VAE_KW))
    assert modules.text_encoder is None and modules.sam is None
    assert all(not p.any() for m in (modules.dual, modules.vae) for p in m.parameters())
    w = torch.ones_like(modules.dual.unet.conv_in.weight)
    torch.save({"epoch": 1, "global_step": 2, "state_dict": {"module.conv_in.weight": w}},
               tmp_path / "pers.ckpt")
    sam = tmp_path / "sam_vit_b.pth"
    sam.write_bytes(b"x")
    cfg.pers_unet_pretrained_model_path = str(tmp_path / "pers.ckpt")
    cfg.image_pretrained_model_path = str(sam)
    modules = tcli.build_modules(cfg, t_tiny(num_views=4), device="cpu",
                                 vae_cfg=TVAEConfig(**VAE_KW))
    assert torch.equal(modules.dual.unet.conv_in.weight, w) and modules.sam is None
    assert not modules.dual.pano_unet.conv_in.weight.any()
    cfg.image_pretrained_model_path = str(tmp_path / "absent.pth")
    tcli.build_modules(cfg, t_tiny(num_views=4), device="cpu", vae_cfg=TVAEConfig(**VAE_KW))


def test_pipeline_refuses_other_solvers():
    """DDIM and the two DPM-Solver++ 2M variants are ported; any other name
    is refused when the pipeline is built."""
    cfg = TRunConfig(pano_H=128, pano_W=256, dtype="float32", solver="euler")
    modules = tcli.build_modules(cfg, t_tiny(num_views=4), device="cpu",
                                 vae_cfg=TVAEConfig(**VAE_KW))
    with pytest.raises(ValueError, match="solver 'euler'"):
        TPipeline(modules, cfg, t_tiny(num_views=4), device="cpu")
