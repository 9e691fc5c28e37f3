"""Parity of the port's small modules against the JAX package on the CPU:
cubemap conversions, PSNR / SSIM, the prompt provider, the feathered
composite and the mask-boundary overlay, the trace context, the DDIM
options and inversion, TemporalConvBlock, the DualUNet's bisection switches
(`pano_only`, `disable_warp`) and `entry()`.

The same numpy inputs from a seed go to both packages. Tolerances: e2c /
c2e 1e-5 (float32 resampling, the same grids); the cube layouts, the DDIM
schedules, the prompts and the drawn boundary exact; PSNR / SSIM 1e-10
(the same float64 numpy and scipy); the feathered composite 1e-5 against
cv2.GaussianBlur; a DDIM step 1e-6; TemporalConvBlock 1e-5 and the
DualUNet forwards 1e-4 of the output's largest element (float32 sums in
another order).
"""
import dataclasses
import json
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imagine360_tpu.diffusion import ddim as jddim
from imagine360_tpu.geometry import CameraRig, cubemap as jcube
from imagine360_tpu.models.dual import DualUNet
from imagine360_tpu.models.resnet import TemporalConvBlock as JTemporalConvBlock
from imagine360_tpu.pipeline.captioner import PromptProvider as JPromptProvider
from imagine360_tpu.pipeline import sampler as jsampler
from imagine360_tpu.pipeline.sampler import build_dual_warp_geoms
from imagine360_tpu.presets import micro_dual_config
from imagine360_tpu.utils import metrics as jmetrics, video_io as jvio
from imagine360_tpu.utils.convert import unflatten

from imagine360_tpu_torch import entry as tentry
from imagine360_tpu_torch.diffusion import ddim as tddim
from imagine360_tpu_torch.geometry import cubemap as tcube
from imagine360_tpu_torch.geometry.cameras import CameraRig as TCameraRig
from imagine360_tpu_torch.models.dual import DualUNet as TDualUNet
from imagine360_tpu_torch.models.resnet import TemporalConvBlock
from imagine360_tpu_torch.pipeline import captioner as tcaptioner
from imagine360_tpu_torch.pipeline.sampler import (DualDiffusionSampler as TSampler,
                                                   SamplerConfig as TSamplerConfig,
                                                   build_dual_warp_geoms as t_build_geoms)
from imagine360_tpu_torch.presets import full_dual_config, micro_dual_config as t_micro
from imagine360_tpu_torch.utils import metrics as tmetrics, video_io as tvio
from imagine360_tpu_torch.utils.convert import from_jax_params
from imagine360_tpu_torch.utils.observability import profile_trace

from test_torch_dual import random_params
from torch_parity import jax_params, load_into, random_flat_params


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the tier-1 run
    puts six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


# ---- cubemap ------------------------------------------------------------------


def _smooth_erp(h, w):
    yy, xx = np.meshgrid(np.linspace(0, 3, h), np.linspace(0, 3, w), indexing="ij")
    return np.stack([np.sin(xx), np.cos(yy), np.sin(xx + yy)], -1).astype(np.float32)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_e2c_c2e_match_jax(mode):
    erp = np.random.default_rng(0).standard_normal((32, 64, 3)).astype(np.float32)
    cube = tcube.e2c(erp, face_w=16, mode=mode, device="cpu")
    want = jcube.e2c(erp, face_w=16, mode=mode)
    assert cube.shape == want.shape == (16, 96, 3)
    assert np.abs(cube - want).max() <= 1e-5
    back = tcube.c2e(want, 24, 48, mode=mode, device="cpu")
    want_back = jcube.c2e(want, 24, 48, mode=mode)
    assert back.shape == want_back.shape == (24, 48, 3)
    assert np.abs(back - want_back).max() <= 1e-5


def test_cubemap_round_trip_and_layouts():
    erp = _smooth_erp(64, 128)
    cube = tcube.e2c(erp, face_w=64, device="cpu")
    back = tcube.c2e(cube, 64, 128, device="cpu")
    assert np.median(np.abs(back - erp)[8:-8]) < 0.03      # tests/test_cubemap.py
    c = np.random.default_rng(1).standard_normal((8, 48, 2)).astype(np.float32)
    faces, jfaces = tcube.cube_h2list(c), jcube.cube_h2list(c)
    assert len(faces) == 6 and all(np.array_equal(a, b) for a, b in zip(faces, jfaces))
    np.testing.assert_array_equal(tcube.cube_list2h(faces), jcube.cube_list2h(jfaces))
    d, jd = tcube.cube_h2dict(c), jcube.cube_h2dict(c)
    assert list(d) == list(jd) == ["F", "R", "B", "L", "U", "D"]
    assert all(np.array_equal(d[k], jd[k]) for k in d)
    np.testing.assert_array_equal(tcube.cube_dict2h(d), c)
    np.testing.assert_array_equal(tcube.cube_dict2h(d), jcube.cube_dict2h(jd))
    with pytest.raises(ValueError, match="6\\*fw"):
        tcube.c2e(c[:, :40], 8, 16, device="cpu")


# ---- metrics ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(24, 30), (24, 30, 3), (3, 20, 26, 3)])
def test_psnr_ssim_match_jax(shape):
    rng = np.random.default_rng(2)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    assert abs(tmetrics.psnr(a, b) - jmetrics.psnr(a, b)) <= 1e-10
    assert abs(tmetrics.ssim(a, b) - jmetrics.ssim(a, b)) <= 1e-10
    assert abs(tmetrics.ssim(a, b, 2.0, 5) - jmetrics.ssim(a, b, 2.0, 5)) <= 1e-10
    assert tmetrics.psnr(a, a) == jmetrics.psnr(a, a) == float("inf")


# ---- the prompt provider ------------------------------------------------------


def test_prompt_provider_branches_match_jax(tmp_path):
    frames = np.random.default_rng(3).integers(0, 256, (6, 8, 8, 3), dtype=np.uint8)
    video = tmp_path / "clip.mp4"
    seen = []

    def captioner(frame):
        seen.append(frame)
        return f"a frame of mean {frame.mean():.3f}"

    cases = [dict(default_prompt="default"),                               # the default
             dict(default_prompt="default", lmm_path=str(tmp_path / "no-model")),
             dict(default_prompt="default", captioner=captioner,
                  lmm_path=str(tmp_path / "no-model"))]                   # the captioner
    for kw in cases:
        assert tcaptioner.PromptProvider(**kw)(str(video), frames) == \
            JPromptProvider(**kw)(str(video), frames)
    assert len(seen) == 2 and np.array_equal(seen[0], frames[4])
    # the LMM's guard: no local directory, no load, no caption
    assert tcaptioner.PromptProvider(lmm_path=str(tmp_path / "no-model"))._lmm_caption(
        frames[4]) is None
    # a sidecar .txt wins over everything
    (tmp_path / "clip.txt").write_text("  a sidecar prompt\n")
    for kw in cases:
        got = tcaptioner.PromptProvider(**kw)(str(video), frames)
        assert got == JPromptProvider(**kw)(str(video), frames) == "a sidecar prompt"
    # fewer than five frames: the last one is captioned
    assert tcaptioner.PromptProvider(captioner=lambda f: str(f[0, 0, 0]))(
        str(tmp_path / "short.mp4"), frames[:2]) == str(frames[1, 0, 0, 0])


# ---- video helpers ------------------------------------------------------------


def _composite_inputs(seed, shape=(2, 40, 72)):
    rng = np.random.default_rng(seed)
    gen = rng.random((*shape, 3)).astype(np.float32)
    src = rng.random((*shape, 3)).astype(np.float32)
    mask = np.zeros((*shape, 1), np.float32)
    mask[:, 5:30, 10:50] = 1.0
    mask[1, :, 60:] = 1.0
    return gen, src, mask


@pytest.mark.parametrize("sigma", [8.0, 3.0])
def test_feathered_replace_matches_jax_cv2(sigma):
    pytest.importorskip("cv2")
    gen, src, mask = _composite_inputs(4)
    got = tvio.feathered_replace(gen, src, mask, sigma=sigma, device="cpu")
    want = jvio.feathered_replace(gen, src, mask, sigma=sigma)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5
    assert len(tvio.gaussian_taps(8.0)) == 65


def test_draw_mask_boundary_matches_jax(monkeypatch):
    frames, _, mask = _composite_inputs(5)
    try:
        import cv2  # noqa: F401
        have_cv2 = True
    except ImportError:
        have_cv2 = False
    if have_cv2:
        got = tvio.draw_mask_boundary(frames, mask, thickness=2)
        np.testing.assert_array_equal(got, jvio.draw_mask_boundary(frames, mask, thickness=2))
        assert not np.array_equal(got, frames)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        tvio.draw_mask_boundary(frames, mask)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(prof.trace_path) as f:
        trace = json.load(f)
    assert prof.trace_path.startswith(str(tmp_path / "trace"))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


# ---- DDIM ---------------------------------------------------------------------


@pytest.mark.parametrize("set_alpha_to_one", [True, False])
@pytest.mark.parametrize("prediction_type", tddim.PREDICTION_TYPES)
@pytest.mark.parametrize("beta_schedule", ["linear", "scaled_linear"])
def test_ddim_schedule_options_match_jax(beta_schedule, prediction_type, set_alpha_to_one):
    kw = dict(beta_schedule=beta_schedule, prediction_type=prediction_type,
              set_alpha_to_one=set_alpha_to_one, clip_sample=prediction_type == "sample",
              rescale_betas_zero_snr=beta_schedule == "linear", steps_offset=1)
    got, want = tddim.make_ddim_schedule(25, **kw), jddim.make_ddim_schedule(25, **kw)
    np.testing.assert_array_equal(got.timesteps, want.timesteps)
    np.testing.assert_array_equal(got.alphas_cumprod, want.alphas_cumprod)
    for k in ("final_alpha_cumprod", "num_train_timesteps", "num_inference_steps",
              "prediction_type", "clip_sample"):
        assert getattr(got, k) == getattr(want, k), k
    gc, wc = got.step_coeffs(), want.step_coeffs()
    assert gc.keys() == wc.keys()
    for k in gc:
        np.testing.assert_array_equal(gc[k], wc[k], err_msg=k)
    with pytest.raises(ValueError, match="beta_schedule"):
        tddim.make_ddim_schedule(10, beta_schedule="cosine")


@pytest.mark.parametrize("clip_sample", [False, True])
@pytest.mark.parametrize("prediction_type", tddim.PREDICTION_TYPES)
def test_ddim_step_and_inverse_match_jax(prediction_type, clip_sample):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    out = rng.standard_normal(x.shape).astype(np.float32)
    c = jddim.make_ddim_schedule(20, rescale_betas_zero_snr=False).step_coeffs()
    for i in (0, 9, 18):      # not the last: its next alpha is 1, where "sample" divides by 0
        a_t, a_prev = float(c["alpha_prod_t"][i]), float(c["alpha_prod_t_prev"][i])
        want = jddim.ddim_step(jnp.asarray(out), jnp.asarray(x), a_t, a_prev, prediction_type,
                               clip_sample)
        got = tddim.ddim_step(torch.from_numpy(out), torch.from_numpy(x), a_t, a_prev,
                              prediction_type, clip_sample)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6 * max(
            1.0, float(np.abs(np.asarray(want)).max())), i
        inv = jddim.ddim_inverse_step(jnp.asarray(out), jnp.asarray(x), a_prev, a_t,
                                      prediction_type)
        t_inv = tddim.ddim_inverse_step(torch.from_numpy(out), torch.from_numpy(x), a_prev, a_t,
                                        prediction_type)
        assert np.abs(t_inv.numpy() - np.asarray(inv)).max() <= 1e-6 * max(
            1.0, float(np.abs(np.asarray(inv)).max())), i
    with pytest.raises(ValueError, match="prediction_type"):
        tddim.ddim_step(torch.from_numpy(out), torch.from_numpy(x), 0.5, 0.6, "x0")


class _StubDual(torch.nn.Module):
    """A DualUNet stand-in: one micro config, outputs a fixed function of its
    inputs (CFG halves differ)."""

    def __init__(self):
        super().__init__()
        self.cfg = t_micro(num_views=2)

    def forward(self, pers_in, pano_in, t, *args):
        scale = torch.tensor([0.5, 1.5]).view(2, *([1] * (pano_in.dim() - 1)))
        return (pers_in[..., :4] * scale.unsqueeze(-1) + 0.1,
                pano_in[..., :4] * scale - 0.2)


@pytest.mark.parametrize("solver", ["ddim", "dpmpp_2m"])
def test_sampler_prediction_type_reaches_the_update(solver):
    """SamplerConfig.prediction_type reaches the DDIM and DPM-Solver++
    schedules and updates; v_prediction stays the default."""
    from imagine360_tpu_torch.diffusion.dpm import dpmpp_2m_step

    assert TSamplerConfig().prediction_type == "v_prediction"
    gen = torch.Generator().manual_seed(0)
    pano = torch.randn(1, 2, 4, 8, 4, generator=gen)
    pers = torch.randn(1, 2, 2, 4, 4, 4, generator=gen)
    pano_m, pers_m = torch.zeros(*pano.shape[:-1], 1), torch.zeros(*pers.shape[:-1], 1)
    for pt in tddim.PREDICTION_TYPES:
        sampler = TSampler(_StubDual(), TSamplerConfig(num_steps=10, guidance_scale=2.0,
                                                       antipodal_prob=0.0, add_ip_noise=False,
                                                       prediction_type=pt, solver=solver))
        sched = sampler.dpm_schedule if solver != "ddim" else sampler.schedule
        assert sched.prediction_type == pt
        got, _ = sampler.denoise(pano, pers, pano_m, pano, pers_m, pers, None, None, None,
                                 num_steps=1)
        c = sched.step_coeffs()
        guided = (pano * 0.5 - 0.2) + 2.0 * ((pano * 1.5 - 0.2) - (pano * 0.5 - 0.2))
        if solver == "ddim":
            want = tddim.ddim_step(guided, pano, float(c["alpha_prod_t"][0]),
                                   float(c["alpha_prod_t_prev"][0]), pt)
        else:
            want, _ = dpmpp_2m_step(pano, guided, 0, c, None, pt)
        assert torch.equal(got, want), pt
    with pytest.raises(ValueError, match="prediction_type"):
        TSampler(_StubDual(), TSamplerConfig(prediction_type="x0"))


# ---- TemporalConvBlock --------------------------------------------------------


def test_temporal_conv_block_matches_jax():
    x = np.random.default_rng(7).standard_normal((2, 5, 3, 4, 32)).astype(np.float32)
    jm = JTemporalConvBlock()
    flat = random_flat_params(jm, (jnp.asarray(x),), seed=8)
    want = np.asarray(jm.apply(jax_params(flat), jnp.asarray(x)))
    tm = load_into(TemporalConvBlock(32), flat)
    assert [k for k in tm.state_dict()] == [
        "conv1.0.weight", "conv1.0.bias", "conv1.2.weight", "conv1.2.bias",
        *[f"conv{n}.{i}.{w}" for n in (2, 3, 4) for i in (0, 3) for w in ("weight", "bias")]]
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert _rel_err(got, want) <= 1e-5
    assert float((got - torch.from_numpy(x)).abs().max()) > 0.1     # the block does work
    # the last conv is zero at construction: the block starts as the identity
    with torch.no_grad():
        assert torch.equal(TemporalConvBlock(32)(torch.from_numpy(x)), torch.from_numpy(x))


# ---- the DualUNet's bisection switches and entry() ------------------------------

M, F, PH, PW, EH, EW = 4, 2, 8, 8, 8, 16


@pytest.fixture(scope="module")
def micro_inputs():
    cfg = micro_dual_config(num_views=M)
    rng = np.random.default_rng(9)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    ctx, hid = cfg.pers.cross_attention_dim, cfg.pers.image_hidden_size
    x = dict(pers=f32(1, M, F, PH, PW, 9), pano=f32(1, F, EH, EW, 9),
             t=np.full((1,), 321.0, np.float32), pers_text=f32(M, 7, ctx),
             pano_text=f32(1, 7, ctx), fps=np.full((1,), 8.0, np.float32),
             ref_pers=f32(M, 4, 16, hid), ref_pano=f32(1, 4, 16, hid),
             rel=rng.integers(0, 50, (1, F, 6)).astype(np.float32),
             pitch=rng.integers(0, 90, (1, F)).astype(np.float32))
    geoms = build_dual_warp_geoms(cfg, CameraRig.icosahedron(image_size=16).take(M), (PH, PW),
                                  (EH, EW), bias_dtype=np.float32)
    t_geoms = t_build_geoms(t_micro(num_views=M), TCameraRig.icosahedron(16).take(M),
                            (PH, PW), (EH, EW), device="cpu")
    return cfg, x, geoms, t_geoms


@pytest.fixture(scope="module")
def jax_uncoupled(micro_inputs):
    """One jitted JAX forward under disable_warp: (flat params, args,
    use_opp, pers_out, pano_out). With no WarpAttn nothing couples the
    branches, so its pano output is also the JAX pano_only forward's on
    the same pano weights; one compile serves both switches."""
    base, x, geoms, _ = micro_inputs
    model = DualUNet(dataclasses.replace(base, disable_warp=True))
    j = jnp.asarray
    use_opp = np.array([True, False, True])
    args = (j(x["pers"]), j(x["pano"]), j(x["t"]), j(x["pers_text"]), j(x["pano_text"]),
            j(x["fps"]), j(x["ref_pers"]), j(x["ref_pano"]), j(x["rel"]), j(x["pitch"]), geoms,
            jnp.asarray(use_opp))
    flat = random_params(model, args, seed=10)
    want_pers, want_pano = jax.jit(lambda p, *a: model.apply(p, *a, add_ip_noise=False))(
        {"params": unflatten(flat)}, *args)
    return flat, args, use_opp, np.asarray(want_pers), np.asarray(want_pano)


@pytest.mark.parametrize("switch", ["pano_only", "disable_warp"])
def test_dual_unet_switches_match_jax(micro_inputs, jax_uncoupled, switch):
    base, x, _, t_geoms = micro_inputs
    flat, args, use_opp, want_pers, want_pano = jax_uncoupled
    if switch == "pano_only":
        # the JAX pano_only module builds the pano UNet alone
        # (imagine360_tpu/models/dual.py setup): its part of the tree
        flat = {k: v for k, v in flat.items() if k.startswith("pano_unet.")}
    assert not any(k.startswith("cp_blocks") for k in flat)

    tm = TDualUNet(dataclasses.replace(t_micro(num_views=M), **{switch: True}))
    res = tm.load_state_dict(from_jax_params(flat), strict=False)
    # the JAX tree holds no WarpAttn weights when no site runs; the port
    # keeps the blocks, so one checkpoint serves with the switch on or off
    assert not res.unexpected_keys
    assert all(k.startswith("cp_blocks") for k in res.missing_keys)
    assert bool(res.missing_keys) == (switch == "disable_warp")
    tm.eval()
    T = torch.from_numpy
    pers = None if switch == "pano_only" else T(x["pers"])
    with torch.no_grad():
        ip_pers, ip_pano = tm.compute_ip_tokens(T(x["ref_pers"]), T(x["ref_pano"]), T(x["rel"]),
                                                T(x["pitch"]))
        got_pers, got_pano = tm(pers, T(x["pano"]), T(x["t"]), T(x["pers_text"]),
                                T(x["pano_text"]), T(x["fps"]), t_geoms, use_opp.tolist(),
                                ip_pers, ip_pano)
    assert _rel_err(got_pano, want_pano) <= 1e-4
    if switch == "pano_only":
        assert got_pers is None and ip_pers is None
    else:
        assert _rel_err(got_pers, want_pers) <= 1e-4


def test_entry_runs_and_has_the_flagship_shapes(monkeypatch):
    from __graft_entry__ import _flagship

    # the tensor arguments' shapes only: the WarpAttn geometry is not built
    monkeypatch.setattr(jsampler, "build_dual_warp_geoms", lambda *a, **k: None)
    want = jax.eval_shape(lambda: _flagship()[1][:10])
    got = tentry.flagship_shapes(full_dual_config())
    assert list(got.values()) == [tuple(w.shape) for w in want]
    # one forward of a micro config on the CPU, its arguments as named
    kw = dict(frames=F, sam_frames=4, pers_latent_hw=(PH, PW), pano_latent_hw=(EH, EW),
              text_len=7, sam_tokens=16)
    cfg = t_micro(num_views=M, dtype="float32")
    fn, args = tentry.entry("cpu", cfg, **kw)
    assert [tuple(a.shape) for a in args[:10]] == list(tentry.flagship_shapes(cfg, **kw).values())
    assert isinstance(args[10], dict) and args[11] == [False] * 3
    pers_out, pano_out = fn(*args)
    assert tuple(pers_out.shape) == (2, M, F, PH, PW, 4)
    assert tuple(pano_out.shape) == (2, F, EH, EW, 4)
    assert torch.isfinite(pers_out).all() and torch.isfinite(pano_out).all()
    assert float(pano_out.std()) > 0
    # seeded: the same seed gives the same forward
    fn2, args2 = tentry.entry("cpu", cfg, **kw)
    assert torch.equal(fn2(*args2)[1], pano_out)
