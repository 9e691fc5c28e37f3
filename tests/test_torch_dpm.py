"""DPM-Solver++ 2M of the PyTorch port against the JAX package on the CPU:
the schedule, `dpmpp_2m_step` over a whole 8-step schedule (both prediction
types, with and without SDE noise), and this slice as a whole: the 2-step
micro denoise with `solver="dpmpp_2m"` under
`configure(attn_v2=True, pallas_dense=True)` against the JAX sampler with
the same solver.

Inputs, noise and parameters come from numpy.random.default_rng and go to
both packages. Tolerances: one solver step 1e-6 of the output's max abs
(float32 scalars from two libms, the same float32 update), a state carried
through all 8 steps 1e-5; the denoise 1e-4
of the output's max abs (sums run in another order in the two frameworks).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imagine360_tpu.diffusion.dpm import dpmpp_2m_step, make_dpm_schedule
from imagine360_tpu.geometry import CameraRig
from imagine360_tpu.models.dual import DualUNet
from imagine360_tpu.pipeline.sampler import (DualDiffusionSampler, SamplerConfig,
                                             build_dual_warp_geoms)
from imagine360_tpu.presets import micro_dual_config
from imagine360_tpu.utils.convert import unflatten

from imagine360_tpu_torch import cli as tcli
from imagine360_tpu_torch.config import RunConfig as TRunConfig
from imagine360_tpu_torch.diffusion.dpm import (dpmpp_2m_step as t_dpmpp_2m_step,
                                                make_dpm_schedule as t_make_dpm_schedule)
from imagine360_tpu_torch.geometry.cameras import CameraRig as TCameraRig
from imagine360_tpu_torch.models.dual import DualUNet as TDualUNet
from imagine360_tpu_torch.models.vae import VAEConfig as TVAEConfig
from imagine360_tpu_torch.ops import attention as tattn
from imagine360_tpu_torch.ops.dispatch import KernelConfig, configure, kernel_config
from imagine360_tpu_torch.pipeline.generate import Imagine360Pipeline as TPipeline
from imagine360_tpu_torch.pipeline.sampler import (DualDiffusionSampler as TSampler,
                                                   SamplerConfig as TSamplerConfig,
                                                   build_dual_warp_geoms as t_build_geoms)
from imagine360_tpu_torch.presets import micro_dual_config as t_micro, tiny_dual_config as t_tiny
from imagine360_tpu_torch.utils.convert import from_jax_params

from test_torch_dual import random_params

STEP_TOL = 1e-6
TRAJECTORY_TOL = 1e-5
DENOISE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the tier-1 run
    puts six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("steps", [2, 8, 25])
def test_dpm_schedule_matches_jax(steps):
    want, got = make_dpm_schedule(steps), t_make_dpm_schedule(steps)
    assert got.prediction_type == want.prediction_type == "v_prediction"
    for a, b in ((got.alpha, want.alpha), (got.sigma, want.sigma)):
        assert a.dtype == b.dtype == np.float64 and a.shape == (steps + 1,)
        np.testing.assert_array_equal(a, b)
    wc, gc = want.step_coeffs(), got.step_coeffs()
    assert set(gc) == set(wc)
    for k in wc:
        assert gc[k].dtype == wc[k].dtype, k
        np.testing.assert_array_equal(gc[k], wc[k], err_msg=k)
    # the appended target: sigma about 1e-6, not 0
    assert 0 < gc["sigma"][-1] < 1e-5


@pytest.mark.parametrize("sde", [False, True], ids=["ode", "sde"])
@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon"])
def test_dpmpp_2m_step_matches_jax_over_a_schedule(prediction_type, sde):
    """All 8 steps (step 0 is first order, the last lands on sigma about
    1e-6). Each step is compared from the JAX side's state, to STEP_TOL; the
    port also carries a state of its own through the schedule, which has to
    stay within TRAJECTORY_TOL (one-ulp differences compound over 8 steps,
    most under epsilon prediction, which divides by a small alpha)."""
    steps = 8
    rng = np.random.default_rng(0)
    shape = (2, 3, 8, 8, 4)
    x0 = rng.standard_normal(shape).astype(np.float32)
    outs = [rng.standard_normal(shape).astype(np.float32) for _ in range(steps)]
    noise = [rng.standard_normal(shape).astype(np.float32) for _ in range(steps)]
    jc = {k: jnp.asarray(v) for k, v in
          make_dpm_schedule(steps, prediction_type=prediction_type).step_coeffs().items()}
    tc = t_make_dpm_schedule(steps, prediction_type).step_coeffs()
    jx, jprev = jnp.asarray(x0), jnp.zeros(shape, jnp.float32)
    fx, fprev = torch.from_numpy(x0), None
    T = lambda a: torch.from_numpy(np.array(a))
    for i in range(steps):
        out_i = torch.from_numpy(outs[i])
        noise_i = torch.from_numpy(noise[i]) if sde else None
        tx, tprev = t_dpmpp_2m_step(T(jx), out_i, i, tc, T(jprev), prediction_type, noise_i)
        fx, fprev = t_dpmpp_2m_step(fx, out_i, i, tc, fprev, prediction_type, noise_i)
        jx, jprev = dpmpp_2m_step(jx, jnp.asarray(outs[i]), jnp.asarray(i), jc, jprev,
                                  prediction_type,
                                  sde_noise=jnp.asarray(noise[i]) if sde else None)
        assert tx.dtype == torch.float32 and tprev.dtype == torch.float32
        _close(tx, jx, STEP_TOL)
        _close(tprev, jprev, STEP_TOL)
        _close(fx, jx, TRAJECTORY_TOL)
        _close(fprev, jprev, TRAJECTORY_TOL)
    assert torch.isfinite(fx).all()


def test_dpmpp_2m_step_keeps_the_latent_dtype():
    """The update runs in float32 and is cast back; x0 stays float32."""
    tc = t_make_dpm_schedule(4).step_coeffs()
    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(0)).bfloat16()
    nxt, x0 = t_dpmpp_2m_step(x, x, 0, tc, None, "v_prediction")
    assert nxt.dtype == torch.bfloat16 and x0.dtype == torch.float32
    nxt2, _ = t_dpmpp_2m_step(nxt, x, 1, tc, x0, "v_prediction")
    assert nxt2.dtype == torch.bfloat16 and torch.isfinite(nxt2).all()
    with pytest.raises(ValueError, match="flow"):
        t_dpmpp_2m_step(x, x, 0, tc, None, "flow")


# ---- the slice as a whole ---------------------------------------------------

F = 2
PH = PW = 16
EH, EW = 32, 64     # 2048 pano tokens at stage 0: a "flash_t" site under attn_v2


def test_denoise_dpmpp_2m_under_opt_in_kernels_matches_jax():
    """2 DPM++ 2M steps of the micro config. The port runs under
    configure(attn_v2=True, pallas_dense=True): the 2048-token pano sites
    and the r2 WarpAttn sites (512 x 512) take K6a's plain version through
    the permutes, proj_in / proj_out take K7's plain version."""
    Mm = 8
    cfg = micro_dual_config(num_views=Mm)
    rig = CameraRig.icosahedron(image_size=16).take(Mm)
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
        model, SamplerConfig(num_steps=2, add_ip_noise=False, antipodal_prob=0.0,
                             solver="dpmpp_2m"))
    ip_pers, ip_pano = sampler.compute_ip(params, j(lat["ref_pers"]), j(lat["ref_pano"]),
                                          j(lat["rel"]), j(lat["pitch"]))
    want_pano, want_pers = jax.jit(
        lambda p: sampler.denoise(
            p, jax.random.PRNGKey(0), j(lat["pano"]), j(lat["pers"]),
            j(lat["pano_mask"]), j(lat["pano_masked"]), j(lat["pers_mask"]),
            j(lat["pers_masked"]), j(lat["pano_text"]), j(lat["pers_text"]), geoms,
            j(lat["fps"]), rel_pos=j(lat["rel"]), pitch=j(lat["pitch"]),
            ip_tokens_pers=ip_pers, ip_tokens_pano=ip_pano))(params)

    t_cfg = t_micro(num_views=Mm)
    tm = TDualUNet(t_cfg)
    tm.load_state_dict(from_jax_params(flat), strict=True)
    tm.eval()
    t_sampler = TSampler(tm, TSamplerConfig(num_steps=2, add_ip_noise=False,
                                            antipodal_prob=0.0, solver="dpmpp_2m"))
    T = torch.from_numpy
    t_geoms = t_build_geoms(t_cfg, TCameraRig.icosahedron(16).take(Mm), (PH, PW), (EH, EW),
                            device="cpu")
    tip_pers, tip_pano = t_sampler.compute_ip(T(lat["ref_pers"]), T(lat["ref_pano"]),
                                              T(lat["rel"]), T(lat["pitch"]))
    tattn.reset_counts()
    with configure(attn_v2=True, pallas_dense=True):
        got_pano, got_pers = t_sampler.denoise(
            T(lat["pano"]), T(lat["pers"]), T(lat["pano_mask"]), T(lat["pano_masked"]),
            T(lat["pers_mask"]), T(lat["pers_masked"]), T(lat["pano_text"]),
            T(lat["pers_text"]), t_geoms, T(lat["fps"]), tip_pers, tip_pano)
    assert kernel_config() == KernelConfig()
    counts = tattn.kernels.counts()
    assert counts["flash_attention_t"]["plain_calls"] > 0
    assert counts["dense_matmul"]["plain_calls"] > 0
    _close(got_pano, want_pano, DENOISE_TOL)
    _close(got_pers, want_pers, DENOISE_TOL)


def test_sde_solver_draws_from_the_generator_or_takes_the_noise():
    """Without a generator the SDE solver refuses to draw its noise; with
    the noise passed in it is deterministic, differs from the ODE solver,
    and the ODE solver ignores a noise it is handed."""
    Mm = 2
    cfg = t_micro(num_views=Mm)
    model = TDualUNet(cfg).eval()
    z = torch.zeros(1)
    kw = dict(num_steps=2, add_ip_noise=False, antipodal_prob=0.0)
    sde = TSampler(model, TSamplerConfig(solver="dpmpp_2m_sde", **kw))
    with pytest.raises(ValueError, match="SDE noise"):
        sde.denoise(z, z, z, z, z, z, z, z, {})

    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g)
    geoms = t_build_geoms(cfg, TCameraRig.icosahedron(16).take(Mm), (8, 8), (8, 16),
                          device="cpu")
    args = (rnd(1, F, 8, 16, 4), rnd(1, Mm, F, 8, 8, 4), rnd(1, F, 8, 16, 1),
            rnd(1, F, 8, 16, 4), rnd(1, Mm, F, 8, 8, 1), rnd(1, Mm, F, 8, 8, 4),
            rnd(2, 7, 32), rnd(2 * Mm, 7, 32), geoms)
    noise = [(rnd(1, F, 8, 16, 4), rnd(1, Mm, F, 8, 8, 4)) for _ in range(2)]
    ode = TSampler(model, TSamplerConfig(solver="dpmpp_2m", **kw))
    a = sde.denoise(*args, sde_noise=noise)
    b = sde.denoise(*args, sde_noise=noise)
    c = ode.denoise(*args)
    d = ode.denoise(*args, sde_noise=noise)
    drawn = sde.denoise(*args, generator=torch.Generator().manual_seed(1))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for x, y in zip(c, d):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0]) and not torch.equal(drawn[0], a[0])
    assert all(torch.isfinite(x).all() for x in (*a, *c, *drawn))
    with pytest.raises(ValueError, match="solver 'euler'"):
        TSampler(TDualUNet(cfg), TSamplerConfig(solver="euler"))


@pytest.mark.parametrize("solver", ["dpmpp_2m", "dpmpp_2m_sde"])
def test_pipeline_takes_the_dpm_solvers(solver):
    cfg = TRunConfig.from_dict(dict(pano_H=128, pano_W=256, dtype="float32", solver=solver,
                                    num_inference_steps=3))
    modules = tcli.build_modules(cfg, t_tiny(num_views=4), device="cpu",
                                 vae_cfg=TVAEConfig(block_out_channels=(32, 32, 32, 32),
                                                    layers_per_block=1))
    pipe = TPipeline(modules, cfg, t_tiny(num_views=4), device="cpu")
    assert pipe.sampler.cfg.solver == solver
    assert pipe.sampler.dpm_schedule.step_coeffs()["alpha"].shape == (4,)


def test_cli_honours_the_kernel_switches_and_the_solver(tmp_path, monkeypatch):
    """`I360_KERNELS` from the environment (read at first use) and `solver`
    from the YAML reach a tiny CLI run on the CPU: MMDense takes K7's plain
    version, the sampler is DPM++ 2M, and the outputs are written."""
    import os

    from imagine360_tpu_torch.ops.dispatch import reset_kernel_config

    yaml = pytest.importorskip("yaml")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = dict(output_dir=str(tmp_path / "out"), video_path=os.path.join(repo, "examples"),
               pano_H=128, pano_W=256, num_inference_steps=2, video_sample_length=2,
               dtype="float32", solver="dpmpp_2m")
    (tmp_path / "run.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.setenv("I360_KERNELS", "+attn_v2,+pallas_dense")
    reset_kernel_config()
    tattn.reset_counts()
    try:
        assert tcli.main(["--config", str(tmp_path / "run.yaml"), "--tiny",
                          "--device", "cpu"]) == 0
        assert kernel_config() == KernelConfig(attn_v2=True, pallas_dense=True)
    finally:
        monkeypatch.delenv("I360_KERNELS")
        reset_kernel_config()
    assert tattn.kernels.dense_matmul.plain_calls > 0
    written = {os.path.splitext(f)[0] for f in os.listdir(tmp_path / "out")}
    assert written == {"config", "synthetic_input", "synthetic_mask", "synthetic_output"}
    assert yaml.safe_load((tmp_path / "out" / "config.yaml").read_text())["solver"] == "dpmpp_2m"
