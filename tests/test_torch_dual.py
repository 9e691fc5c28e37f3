"""Parity of the PyTorch port's dual-branch path against the JAX package on
the CPU: one DualUNet forward (tiny config), a 2-step CFG DDIM denoise
(micro config), the shared initial noise, and the WarpAttn geometry.

Inputs and every parameter (all nonzero, so zero-initialised output
projections cannot hide a path) come from numpy.random.default_rng and go
to both packages. The port runs its plain attention versions here.

Tolerance: f32 on both sides; outputs agree to 1e-4 of the output's max
abs (sums run in another order in the two frameworks; nothing else
differs). The WarpAttn masks and PEs are equal bit for bit; both packages
get them in float32, the dtype the port keeps them in.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imagine360_tpu.geometry import CameraRig
from imagine360_tpu.diffusion.ddim import make_ddim_schedule
from imagine360_tpu.geometry.corr_masks import warp_geometry
from imagine360_tpu.models.dual import DualUNet
from imagine360_tpu.pipeline.conditioning import init_shared_noise
from imagine360_tpu.pipeline.sampler import (DualDiffusionSampler, SamplerConfig,
                                             build_dual_warp_geoms)
from imagine360_tpu.presets import micro_dual_config, tiny_dual_config
from imagine360_tpu.utils.convert import flatten_params, unflatten

from imagine360_tpu_torch.diffusion.ddim import make_ddim_schedule as t_make_ddim_schedule
from imagine360_tpu_torch.geometry.cameras import CameraRig as TCameraRig
from imagine360_tpu_torch.geometry.corr_masks import warp_geometry as t_warp_geometry
from imagine360_tpu_torch.models.dual import DualUNet as TDualUNet
from imagine360_tpu_torch.pipeline.conditioning import project_shared_noise
from imagine360_tpu_torch.pipeline.sampler import (DualDiffusionSampler as TSampler,
                                                   SamplerConfig as TSamplerConfig,
                                                   build_dual_warp_geoms as t_build_geoms)
from imagine360_tpu_torch.presets import (micro_dual_config as t_micro,
                                          tiny_dual_config as t_tiny)
from imagine360_tpu_torch.utils.convert import from_jax_params

REL_TOL = 1e-4
M, F = 4, 2
PH = PW = 16
EH, EW = 16, 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the tier-1 run
    puts six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_params(model, init_args, seed):
    """Nonzero random values for every parameter of a Flax module: kernels
    ~ N(0, 1/fan_in), norm scales 1 + N(0, 0.1), biases and the rest
    N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "ip_noise": jax.random.PRNGKey(1)},
        *init_args))["params"]
    rng = np.random.default_rng(seed)
    flat = {}
    for k, s in flatten_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                            shapes)).items():
        leaf = k.split(".")[-1]
        x = rng.standard_normal(s.shape).astype(np.float32)
        if leaf.endswith("kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            x = x / np.sqrt(fan_in)
        elif leaf == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        flat[k] = x
    return flat


def _rig(m):
    return CameraRig.icosahedron(image_size=16).take(m)


def _inputs(rng, B, cfg, sam_frames=16, sam_tokens=16):
    ctx = cfg.pers.cross_attention_dim
    hid = cfg.pers.image_hidden_size
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        pers=f32(B, M, F, PH, PW, 9), pano=f32(B, F, EH, EW, 9),
        t=np.full((B,), 321.0, np.float32),
        pers_text=f32(B * M, 7, ctx), pano_text=f32(B, 7, ctx),
        fps=np.full((B,), 8.0, np.float32),
        ref_pers=f32(B * M, sam_frames, sam_tokens, hid),
        ref_pano=f32(B, sam_frames, sam_tokens, hid),
        rel=rng.integers(0, 50, (B, F, 6)).astype(np.float32),
        pitch=rng.integers(0, 90, (B, F)).astype(np.float32))


def _init_args(x, geoms, n_sites):
    j = jnp.asarray
    return (j(x["pers"]), j(x["pano"]), j(x["t"]), j(x["pers_text"]), j(x["pano_text"]),
            j(x["fps"]), j(x["ref_pers"]), j(x["ref_pano"]), j(x["rel"]), j(x["pitch"]),
            geoms, jnp.zeros((n_sites,), bool))


def _torch_model(t_cfg, flat):
    model = TDualUNet(t_cfg)
    model.load_state_dict(from_jax_params(flat), strict=True)
    return model.eval()


def _close(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_dual_unet_forward_matches_jax():
    cfg = tiny_dual_config(num_views=M)
    rig = _rig(M)
    geoms = build_dual_warp_geoms(cfg, rig, (PH, PW), (EH, EW), bias_dtype=np.float32)
    model = DualUNet(cfg)
    x = _inputs(np.random.default_rng(0), 1, cfg)
    flat = random_params(model, _init_args(x, geoms, 7), seed=1)
    use_opp = np.array([True, False, True, False, False, True, False])

    want_pers, want_pano = jax.jit(lambda p, *a: model.apply(p, *a, add_ip_noise=False))(
        {"params": unflatten(flat)}, *_init_args(x, geoms, 7)[:-1], jnp.asarray(use_opp))

    tm = _torch_model(t_tiny(num_views=M), flat)
    t_geoms = t_build_geoms(t_tiny(num_views=M), TCameraRig.icosahedron(16).take(M),
                            (PH, PW), (EH, EW), device="cpu")
    T = torch.from_numpy
    with torch.no_grad():
        ip_pers, ip_pano = tm.compute_ip_tokens(T(x["ref_pers"]), T(x["ref_pano"]),
                                                T(x["rel"]), T(x["pitch"]))
        got_pers, got_pano = tm(T(x["pers"]), T(x["pano"]), T(x["t"]), T(x["pers_text"]),
                                T(x["pano_text"]), T(x["fps"]), t_geoms, use_opp.tolist(),
                                ip_pers, ip_pano)
    assert got_pers.shape == want_pers.shape and got_pano.shape == want_pano.shape
    _close(got_pers, want_pers)
    _close(got_pano, want_pano)


def test_denoise_two_steps_matches_jax():
    Mm = 8
    cfg = micro_dual_config(num_views=Mm)
    rig = _rig(Mm)
    geoms = build_dual_warp_geoms(cfg, rig, (PH, PW), (EH, EW), bias_dtype=np.float32)
    model = DualUNet(cfg)
    rng = np.random.default_rng(2)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    ctx, hid = 32, 8
    lat = dict(pano=f32(1, F, EH, EW, 4), pers=f32(1, Mm, F, PH, PW, 4),
               pano_mask=(rng.random((1, F, EH, EW, 1)) > 0.5).astype(np.float32),
               pano_masked=f32(1, F, EH, EW, 4),
               pers_mask=(rng.random((1, Mm, F, PH, PW, 1)) > 0.5).astype(np.float32),
               pers_masked=f32(1, Mm, F, PH, PW, 4),
               pano_text=f32(2, 7, ctx), pers_text=f32(2 * Mm, 7, ctx),
               ref_pano=f32(2, 4, 16, hid), ref_pers=f32(2 * Mm, 4, 16, hid),
               rel=rng.integers(0, 50, (2, F, 6)).astype(np.float32),
               pitch=rng.integers(0, 90, (2, F)).astype(np.float32),
               fps=np.full((2,), 8.0, np.float32))
    j = jnp.asarray
    init_args = (j(np.concatenate([lat["pers"], lat["pers_mask"], lat["pers_masked"]], -1)
                   .repeat(2, 0)),
                 j(np.concatenate([lat["pano"], lat["pano_mask"], lat["pano_masked"]], -1)
                   .repeat(2, 0)),
                 jnp.zeros((2,)), j(lat["pers_text"]), j(lat["pano_text"]), j(lat["fps"]),
                 j(lat["ref_pers"]), j(lat["ref_pano"]), j(lat["rel"]), j(lat["pitch"]),
                 geoms, jnp.zeros((3,), bool))
    flat = random_params(model, init_args, seed=3)
    params = {"params": unflatten(flat)}
    sampler = DualDiffusionSampler(
        model, SamplerConfig(num_steps=2, add_ip_noise=False, antipodal_prob=0.0))
    ip_pers, ip_pano = sampler.compute_ip(params, j(lat["ref_pers"]), j(lat["ref_pano"]),
                                          j(lat["rel"]), j(lat["pitch"]))
    want_pano, want_pers = sampler.denoise(
        params, jax.random.PRNGKey(0), j(lat["pano"]), j(lat["pers"]),
        j(lat["pano_mask"]), j(lat["pano_masked"]), j(lat["pers_mask"]),
        j(lat["pers_masked"]), j(lat["pano_text"]), j(lat["pers_text"]), geoms,
        j(lat["fps"]), rel_pos=j(lat["rel"]), pitch=j(lat["pitch"]),
        ip_tokens_pers=ip_pers, ip_tokens_pano=ip_pano)

    t_cfg = t_micro(num_views=Mm)
    tm = _torch_model(t_cfg, flat)
    t_sampler = TSampler(tm, TSamplerConfig(num_steps=2, add_ip_noise=False,
                                            antipodal_prob=0.0))
    T = torch.from_numpy
    t_geoms = t_build_geoms(t_cfg, TCameraRig.icosahedron(16).take(Mm), (PH, PW), (EH, EW),
                            device="cpu")
    tip_pers, tip_pano = t_sampler.compute_ip(T(lat["ref_pers"]), T(lat["ref_pano"]),
                                              T(lat["rel"]), T(lat["pitch"]))
    got_pano, got_pers = t_sampler.denoise(
        T(lat["pano"]), T(lat["pers"]), T(lat["pano_mask"]), T(lat["pano_masked"]),
        T(lat["pers_mask"]), T(lat["pers_masked"]), T(lat["pano_text"]),
        T(lat["pers_text"]), t_geoms, T(lat["fps"]), tip_pers, tip_pano)
    _close(got_pano, want_pano)
    _close(got_pers, want_pers)


@pytest.mark.parametrize("pers_hw,equi_hw,dim", [((8, 8), (8, 16), 32),
                                                 ((4, 4), (4, 8), 64)])
def test_warp_geometry_bit_exact(pers_hw, equi_hw, dim):
    want = warp_geometry(_rig(M), pers_hw, equi_hw, dim)
    got = t_warp_geometry(TCameraRig.icosahedron(16).take(M), pers_hw, equi_hw, dim)
    assert set(got) == {k for k in want if not k.endswith("_T")}
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_shared_noise_projection_matches_jax():
    rig = _rig(M)
    pano, pers = init_shared_noise(jax.random.PRNGKey(0), 1, F, (EH, EW), (8, 8), rig)
    got = project_shared_noise(torch.from_numpy(np.array(pano)),
                               TCameraRig.icosahedron(16).take(M), (8, 8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pers))


@pytest.mark.parametrize("steps", [2, 25, 50])
def test_ddim_schedule_matches_jax(steps):
    """The denoise test runs 2 steps; the product runs 50."""
    want = make_ddim_schedule(steps).step_coeffs()
    got = t_make_ddim_schedule(steps).step_coeffs()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_denoise_random_draws_need_a_generator():
    """The antipodal choice and the IP noise come from an explicit
    torch.Generator; without one, denoise refuses to draw them."""
    cfg = t_micro(num_views=2)
    sampler = TSampler(TDualUNet(cfg), TSamplerConfig(num_steps=2))
    z = torch.zeros(1)
    with pytest.raises(ValueError, match="torch.Generator"):
        sampler.denoise(z, z, z, z, z, z, z, z, {}, ip_tokens_pers=torch.zeros(2, 8, 32))
