"""Parity of the PyTorch port's training layer against the JAX package on the
CPU: the noising helpers, the mask and dataset modules, the optimizer
against optax, and the training step as a whole on one micro DualUNet (the
set-up of tests/test_training.py, single device).

Inputs, weights and every random draw of a step (timestep, noises,
antipodal choice, IP-token noise) are made once, by numpy or by the JAX
package's own keys, and handed to both packages. The port runs on the CPU
through its plain attention versions and the autograd functions of
ops/attention.py. One JAX train step is jitted, once.

Tolerances (float32 on both sides; sums run in another order in the two
frameworks): the loss 1e-5 relative; every gradient 1e-4 of the largest
gradient; the weights after 2 AdamW steps 1e-5 abs (lr 1e-4: a step moves a
weight by about lr, so a sign error would show as 2e-4) on every element
but those whose JAX gradient is at rounding level, under 1e-6 of the step's
largest (see the test); the optimizer on a toy parameter 1e-6.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from imagine360_tpu.data.youtube360 import load_youtube360_csv
from imagine360_tpu.diffusion.ddim import add_noise, get_velocity, make_ddim_schedule
from imagine360_tpu.geometry import CameraRig
from imagine360_tpu.models.dual import DualUNet, warp_sites
from imagine360_tpu.pipeline.sampler import build_dual_warp_geoms
from imagine360_tpu.pipeline.train_masks import erp_coverage_mask, video_mask
from imagine360_tpu.presets import micro_dual_config
from imagine360_tpu.training.train import (TrainConfig, TrainState, make_dual_batch,
                                           make_optimizer, make_train_step)
from imagine360_tpu.utils.convert import unflatten

from imagine360_tpu_torch.data import youtube360 as t_youtube360
from imagine360_tpu_torch.data.youtube360 import (ClipRecord as TClipRecord,
                                                  YouTube360Dataset as TDataset,
                                                  load_youtube360_csv as t_load_csv)
from imagine360_tpu_torch.diffusion.ddim import (add_noise as t_add_noise,
                                                 get_velocity as t_get_velocity,
                                                 make_ddim_schedule as t_make_ddim_schedule)
from imagine360_tpu_torch.geometry.cameras import CameraRig as TCameraRig
from imagine360_tpu_torch.models.dual import DualUNet as TDualUNet
from imagine360_tpu_torch.ops import attention as tattn
from imagine360_tpu_torch.pipeline.sampler import build_dual_warp_geoms as t_build_geoms
from imagine360_tpu_torch.pipeline.train_masks import (erp_coverage_mask as t_erp_coverage_mask,
                                                       video_mask as t_video_mask)
from imagine360_tpu_torch.presets import micro_dual_config as t_micro_dual
from imagine360_tpu_torch.training import train as ttrain
from imagine360_tpu_torch.utils.convert import from_jax_params, from_jax_tree
from imagine360_tpu_torch.utils.init import seeded_init_

from test_torch_dual import random_params

VIEWS, FRAMES = 4, 2
PERS_HW, EQUI_HW = (8, 8), (8, 16)
BATCH_KW = dict(text_len=4, sam_tokens=16, sam_frames=4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the tier-1 run
    puts six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (e) the small modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn,t_fn", [(add_noise, t_add_noise), (get_velocity, t_get_velocity)],
                         ids=["add_noise", "get_velocity"])
def test_noising_matches_jax(fn, t_fn):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 4, 5, 4)).astype(np.float32)
    eps = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([7, 993])
    acp = make_ddim_schedule(50).alphas_cumprod
    np.testing.assert_array_equal(t_make_ddim_schedule(50).alphas_cumprod, acp)
    want = fn(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(acp),
              jnp.asarray(t)[:, None, None, None, None])
    got = t_fn(torch.from_numpy(x), torch.from_numpy(eps), torch.from_numpy(acp),
               torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # bf16 in, bf16 out, the arithmetic in float32
    assert t_fn(torch.from_numpy(x).bfloat16(), torch.from_numpy(eps),
                torch.from_numpy(acp), torch.from_numpy(t)).dtype == torch.bfloat16


@pytest.mark.parametrize("mode", [None, "horizontal", "vertical", "float"])
def test_video_mask_equals_jax(mode):
    for seed in range(5):
        want = video_mask(np.random.default_rng(seed), (24, 40), mode)
        got = t_video_mask(np.random.default_rng(seed), (24, 40), mode)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (24, 40, 1) and 0 < got.mean() < 1


def test_erp_coverage_mask_equals_jax():
    want = erp_coverage_mask((32, 64), 16)
    got = t_erp_coverage_mask((32, 64), 16)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[3][0] > 0 and got[3][1] > 0        # the forward view leaves a hole


def test_youtube360_csv_and_dataset(tmp_path, monkeypatch):
    csv_path = tmp_path / "clips.csv"
    csv_path.write_text("youtubeid,videoid,caption,fps,tstart,tend,totalframes\n"
                        'abc,abc_0,"a beach, at dusk",29.97,1.5,11.5,300.0\n'
                        "def,def_3,street,,0,4,\n"
                        "ghi,ghi_1,broken file,30,0,1,30\n")
    want = load_youtube360_csv(str(csv_path))
    got = t_load_csv(str(csv_path))
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    assert isinstance(got[0], TClipRecord) and got[0].duration == 10.0
    assert got[1].fps == 0.0 and got[1].totalframes == 0
    # abc_0 exists and decodes (the decoder is replaced: no video codec is
    # needed here), def_3 is missing, ghi_1 exists and fails to decode
    frames = np.random.default_rng(0).integers(0, 255, (6, 16, 32, 3), dtype=np.uint8)
    (tmp_path / "abc_0.mp4").write_bytes(b"stand-in")
    (tmp_path / "ghi_1.mp4").write_bytes(b"stand-in")

    def fake_read_video(path, num_frames=None):
        if "ghi_1" in path:
            raise ValueError("cannot decode")
        return frames[:num_frames]

    monkeypatch.setattr(t_youtube360, "read_video", fake_read_video)
    ds = TDataset(str(csv_path), str(tmp_path), num_frames=4, size_hw=(8, 16), shuffle=False)
    for items in (list(ds), list(ds.prefetch(buffer=1))):
        (clip, caption), = items
        assert clip.shape == (4, 8, 16, 3) and clip.dtype == np.uint8
        assert caption == "a beach, at dusk"
    shuffled = TDataset(str(csv_path), str(tmp_path), num_frames=4, size_hw=(8, 16), seed=3)
    assert [c for _, c in shuffled] == ["a beach, at dusk"]


# ---------------------------------------------------------------------------
# (f) the optimizer against optax
# ---------------------------------------------------------------------------


OPTIMIZER_CASES = {
    "warmup_cosine_clip_accum_ema": dict(lr=1e-2, ema_decay=0.9, accum_steps=2, grad_clip=1.0,
                                         warmup_steps=2, total_steps=10),
    "plain_adamw": dict(lr=3e-3, weight_decay=0.1),
    "warmup_only_clip": dict(lr=1e-2, warmup_steps=3, grad_clip=0.5),
    "cosine_no_clip_trigger": dict(lr=1e-2, total_steps=4, grad_clip=100.0),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZER_CASES))
def test_optimizer_matches_optax(case):
    """6 calls on a toy parameter, as tests/test_training.py drives optax:
    the weights and the EMA after every call."""
    cfg_kw = OPTIMIZER_CASES[case]
    cfg, t_cfg = TrainConfig(**cfg_kw), ttrain.TrainConfig(**cfg_kw)
    rng = np.random.default_rng(3)
    w0 = {"w": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: (3.0 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in w0.items()}
             for _ in range(6)]

    tx = make_optimizer(cfg)
    params = {k: jnp.asarray(v) for k, v in w0.items()}
    opt_state, ema = tx.init(params), dict(params)

    t_opt = ttrain.make_optimizer(t_cfg)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in w0.items()}
    t_state = t_opt.init(t_params)
    t_ema = {k: v.clone() for k, v in t_params.items()}
    for i, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                       params)
        params = optax.apply_updates(params, updates)
        ema = {k: ema[k] * cfg.ema_decay + (1 - cfg.ema_decay) * params[k] for k in params}

        t_moved = t_opt.update({k: torch.from_numpy(v) for k, v in g.items()}, t_state, t_params)
        for k in t_ema:
            t_ema[k].mul_(t_cfg.ema_decay).add_(t_params[k], alpha=1 - t_cfg.ema_decay)
        assert t_moved == ((i + 1) % cfg.accum_steps == 0)     # an AdamW step was taken
        for k in params:
            np.testing.assert_allclose(t_params[k].numpy(), np.asarray(params[k]), atol=1e-6)
            np.testing.assert_allclose(t_ema[k].numpy(), np.asarray(ema[k]), atol=1e-6)


@pytest.mark.parametrize("cfg_kw", [dict(lr=1e-3, warmup_steps=5, total_steps=50),
                                    dict(lr=2e-4, warmup_steps=4), dict(lr=1e-4),
                                    dict(lr=1e-3, total_steps=20)],
                         ids=["warmup_cosine", "warmup", "constant", "cosine"])
def test_learning_rate_schedule_matches_optax(cfg_kw):
    cfg = TrainConfig(**cfg_kw)
    if cfg.total_steps:
        want = optax.warmup_cosine_decay_schedule(0.0, cfg.lr, max(cfg.warmup_steps, 1),
                                                  cfg.total_steps, end_value=cfg.lr * 0.1)
    elif cfg.warmup_steps:
        want = optax.linear_schedule(0.0, cfg.lr, cfg.warmup_steps)
    else:
        want = lambda count: cfg.lr
    opt = ttrain.make_optimizer(ttrain.TrainConfig(**cfg_kw))
    for count in range(0, 70, 3):
        np.testing.assert_allclose(opt.learning_rate(count), float(want(count)),
                                   rtol=1e-5, atol=1e-10)


# ---------------------------------------------------------------------------
# (g) the slice as a whole: one micro DualUNet, two AdamW steps
# ---------------------------------------------------------------------------


def _capture_grads():
    """An optax transformation that passes the gradients through and keeps
    the last ones in its state, so the one jitted train step also returns
    them."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _jax_draws(model, params, rng, batch, n_sites, antipodal_prob):
    """The draws imagine360_tpu.training.train.loss_fn makes from `rng`, as
    numpy: t, the two noises, use_opp, and the unit-variance IP-token noise
    (pers, pano) the model draws from the 'ip_noise' stream."""
    k_t, k_np, k_na, k_opp, k_ip = jax.random.split(rng, 5)
    cfg = model.cfg

    def both(mdl, pano, pers):      # the model draws the pano noise first
        return mdl._maybe_noise(pano, True), mdl._maybe_noise(pers, True)

    n, c = cfg.pers.num_ip_tokens, cfg.pers.image_cross_attention_dim
    noise_pano, noise_pers = jax.jit(lambda: flax_apply(both, model)(
        params, jnp.zeros((1, n, c)), jnp.zeros((cfg.num_views, n, c)),
        rngs={"ip_noise": k_ip}))()
    lvl = cfg.ip_noise_level
    return dict(
        t=np.asarray(jax.random.randint(k_t, (1,), 0, 1000)),
        noise_pers=np.asarray(jax.random.normal(k_np, batch["pers_latents"].shape)),
        noise_pano=np.asarray(jax.random.normal(k_na, batch["pano_latents"].shape)),
        use_opp=np.asarray(jax.random.bernoulli(k_opp, antipodal_prob, (n_sites,))).tolist(),
        ip_noise=(np.asarray(noise_pers) / lvl, np.asarray(noise_pano) / lvl))


def flax_apply(fn, module):
    import flax.linen as nn
    return nn.apply(fn, module)


def test_train_step_matches_jax():
    cfg = micro_dual_config(num_views=VIEWS)
    model = DualUNet(cfg)
    rig = CameraRig.icosahedron(image_size=16).take(VIEWS)
    geoms = build_dual_warp_geoms(cfg, rig, PERS_HW, EQUI_HW, bias_dtype=np.float32)
    batch = make_dual_batch(jax.random.PRNGKey(0), cfg, FRAMES, PERS_HW, EQUI_HW, **BATCH_KW)
    # nonzero masks and masked latents, so the 9 input channels all count
    rng = np.random.default_rng(11)
    for k in ("pers_mask", "pano_mask"):
        batch[k] = jnp.asarray((rng.random(batch[k].shape) > 0.5).astype(np.float32))
    for k in ("pers_masked", "pano_masked"):
        batch[k] = jnp.asarray(rng.standard_normal(batch[k].shape).astype(np.float32))
    n_sites = len(warp_sites(len(cfg.pers.block_out_channels)))
    pers_in = jnp.concatenate([batch["pers_latents"], batch["pers_mask"],
                               batch["pers_masked"]], axis=-1)
    pano_in = jnp.concatenate([batch["pano_latents"], batch["pano_mask"],
                               batch["pano_masked"]], axis=-1)
    init_args = (pers_in, pano_in, jnp.zeros((1,)), batch["pers_text"], batch["pano_text"],
                 batch["fps"], batch["ref_feats_pers"], batch["ref_feats_pano"],
                 batch["rel_pos"], batch["pitch"], geoms, jnp.zeros((n_sites,), bool))
    flat = random_params(model, init_args, seed=12)
    params = {"params": unflatten({k: jnp.asarray(v) for k, v in flat.items()})}

    kw = dict(lr=1e-4, weight_decay=1e-2, antipodal_prob=0.5)
    tx = optax.chain(_capture_grads(), make_optimizer(TrainConfig(**kw)))
    train_step, _ = make_train_step(model, geoms, optimizer=tx, train_cfg=TrainConfig(**kw))
    step = jax.jit(train_step)
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))

    t_cfg = t_micro_dual(num_views=VIEWS)
    t_model = TDualUNet(t_cfg)
    t_model.load_state_dict(from_jax_params(flat), strict=True)
    t_model.train()
    t_geoms = t_build_geoms(t_cfg, TCameraRig.icosahedron(16).take(VIEWS), PERS_HW, EQUI_HW,
                            device="cpu")
    t_batch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    t_step, t_opt = ttrain.make_train_step(t_model, t_geoms,
                                           train_cfg=ttrain.TrainConfig(**kw), device="cpu")
    t_state = ttrain.TrainState.create(t_model, t_opt)

    grad_share = []      # per step: |JAX gradient| / the step's largest, by parameter
    for i, seed in enumerate((5, 6)):
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(model, state.params, key, batch, n_sites, kw["antipodal_prob"])
        state, metrics = step(state, batch, key)
        want_grads = from_jax_tree(state.opt_state[0])

        seen = {}
        hooks = [p.register_hook(lambda g, n=n: seen.__setitem__(n, g.clone()))
                 for n, p in t_model.named_parameters()]
        tattn.reset_counts()
        t_state, t_metrics = t_step(
            t_state, t_batch, t=torch.from_numpy(draws["t"]),
            noise_pers=torch.from_numpy(draws["noise_pers"]),
            noise_pano=torch.from_numpy(draws["noise_pano"]), use_opp=draws["use_opp"],
            ip_noise=tuple(torch.from_numpy(x) for x in draws["ip_noise"]))
        for h in hooks:
            h.remove()

        np.testing.assert_allclose(t_metrics["loss"].item(), float(metrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(t_metrics["grad_norm"].item(), float(metrics["grad_norm"]),
                                   rtol=1e-4)
        assert seen.keys() == want_grads.keys()
        top = max(float(g.abs().max()) for g in want_grads.values())
        assert top > 0
        for n, want in want_grads.items():
            assert float((seen[n] - want).abs().max()) <= 1e-4 * top, (i, n)
        grad_share.append({n: g.abs() / top for n, g in want_grads.items()})
        # the step went through the autograd functions: K3 with lse and the
        # streaming backward at the WarpAttn sites, the einsum backward at the
        # K1 and K4 sites (CPU: each wrapper's plain version)
        counts = {n: c["plain_calls"] for n, c in tattn.kernels.counts().items()}
        assert counts["shared_bias_attention"] == 6 and counts["flash_bwd_dq"] == 6
        assert counts["flash_bwd_dkv"] == 6 and counts["mh_flash_attention"] == 0
        assert tattn.einsum_backward_calls() > 0

    # AdamW divides a gradient by its own running magnitude, so where a
    # gradient element is at rounding level (every bias ahead of a GroupNorm
    # with one channel per group, which removes it; single elements
    # elsewhere) the noise's sign becomes a step of +-lr and two frameworks
    # cannot agree. The rule is on the reference: an element is exempt only
    # if its JAX gradient was under 1e-6 of the step's largest in one of the
    # two steps and not exactly zero in both (a parameter no loss reaches
    # decays alike on both sides). Every other element agrees to 1e-5, and an
    # exempt one differs by no more than two steps can move it apart.
    want_params = from_jax_tree(state.params)
    init_params = from_jax_params(flat)
    moved, n_exempt, n_all = 0.0, 0, 0
    for n, p in t_model.named_parameters():
        assert p.data_ptr() == t_state.params[n].data_ptr()      # float32: no master copy
        d = (p.detach() - want_params[n]).abs()
        share = torch.stack([g[n] for g in grad_share])
        exempt = (share.amin(0) < 1e-6) & (share.amax(0) > 0)
        assert float((d * ~exempt).max()) <= 1e-5, n
        assert float(d.max()) <= 2 * 2 * kw["lr"] * 1.01, n
        n_exempt, n_all = n_exempt + int(exempt.sum()), n_all + d.numel()
        moved = max(moved, float((p.detach() - init_params[n]).abs().max()))
    assert n_exempt <= 0.03 * n_all, (n_exempt, n_all)
    assert moved > 1e-4 and t_state.step == 2


# ---------------------------------------------------------------------------
# (h), (i) and the rest of the training layer
# ---------------------------------------------------------------------------


def _torch_setup(train_cfg, remat=False, dtype="float32", seed=0):
    cfg = t_micro_dual(num_views=VIEWS, dtype=dtype)
    unet = dataclasses.replace(cfg.pers, remat=remat)
    cfg = dataclasses.replace(cfg, pers=unet, pano=unet)
    gen = torch.Generator().manual_seed(seed)
    model = TDualUNet(cfg).to(unet.torch_dtype).train()
    seeded_init_(model, gen)
    geoms = t_build_geoms(cfg, TCameraRig.icosahedron(16).take(VIEWS), PERS_HW, EQUI_HW,
                          device="cpu")
    batch = ttrain.make_dual_batch(gen, cfg, FRAMES, PERS_HW, EQUI_HW, device="cpu", **BATCH_KW)
    step, opt = ttrain.make_train_step(model, geoms, train_cfg=train_cfg, device="cpu")
    return model, batch, step, opt


def test_dual_batch_has_the_jax_shapes():
    want = make_dual_batch(jax.random.PRNGKey(0), micro_dual_config(VIEWS), FRAMES, PERS_HW,
                           EQUI_HW, **BATCH_KW)
    got = ttrain.make_dual_batch(torch.Generator().manual_seed(0), t_micro_dual(VIEWS), FRAMES,
                                 PERS_HW, EQUI_HW, device="cpu", **BATCH_KW)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())
    assert float(got["rel_pos"].min()) >= 0 and float(got["fps"][0]) == 8.0


def test_train_ema_and_accumulation():
    """The first call of an accumulation pair does not move the weights; the
    second does, and the EMA lags them."""
    tc = ttrain.TrainConfig(lr=1e-3, ema_decay=0.9, accum_steps=2, antipodal_prob=0.0)
    model, batch, step, opt = _torch_setup(tc)
    state = ttrain.TrainState.create(model, opt, ema=True)
    w0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, m1 = step(state, batch, torch.Generator().manual_seed(3))
    assert all(torch.equal(p, w0[n]) for n, p in model.named_parameters())
    state, m2 = step(state, batch, torch.Generator().manual_seed(4))
    assert np.isfinite(m1["loss"].item()) and np.isfinite(m2["loss"].item())
    diffs = {n: (p.detach() - w0[n]).abs().mean().item() for n, p in model.named_parameters()}
    assert min(diffs.values()) > 0
    for n, e in state.ema_params.items():
        assert (e - w0[n]).abs().mean().item() < diffs[n]
    assert state.step == 2 and state.opt_state["count"] == 1


def test_bf16_module_follows_float32_masters():
    """A bfloat16 module trains through float32 master weights: the state
    holds copies, the update moves them, and the module's weights are the
    masters rounded to bfloat16."""
    model, batch, step, opt = _torch_setup(ttrain.TrainConfig(lr=1e-3, antipodal_prob=0.0),
                                           dtype="bfloat16")
    state = ttrain.TrainState.create(model, opt)
    before = {n: p.clone() for n, p in state.params.items()}
    state, metrics = step(state, batch, torch.Generator().manual_seed(2))
    assert np.isfinite(metrics["loss"].item()) and metrics["loss"].dtype == torch.float32
    for n, p in model.named_parameters():
        master = state.params[n]
        assert p.dtype == torch.bfloat16 and master.dtype == torch.float32
        assert p.data_ptr() != master.data_ptr()
        assert not torch.equal(master, before[n])
        assert torch.equal(p.detach(), master.to(torch.bfloat16))


def test_train_step_draws_need_a_generator_and_the_card_is_the_default():
    tc = ttrain.TrainConfig(antipodal_prob=0.0)
    model, batch, step, opt = _torch_setup(tc)
    with pytest.raises(ValueError, match="torch.Generator"):
        step(ttrain.TrainState.create(model, opt), batch)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ttrain.make_train_step(model, {}, train_cfg=tc)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ttrain.make_dual_batch(torch.Generator(), t_micro_dual(VIEWS), FRAMES, PERS_HW, EQUI_HW)


def test_from_jax_tree_maps_a_nested_tree_by_name():
    """A nested JAX tree (parameters, or gradients shaped like them) lands on
    the port's names through the transposes of from_jax_params, with or
    without the top-level 'params' key; the whole DualUNet tree is mapped in
    test_train_step_matches_jax."""
    rng = np.random.default_rng(0)
    tree = {"unet": {"conv_in": {"kernel": rng.standard_normal((3, 3, 9, 32)),
                                 "bias": rng.standard_normal(32)},
                     "down_blocks_0": {"attentions_1": {"proj_in": {
                         "kernel": rng.standard_normal((32, 48))}}},
                     "conv_norm_out": {"norm": {"scale": rng.standard_normal(32)}}}}
    got = from_jax_tree({"params": tree})
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "unet.conv_in.weight": (32, 9, 3, 3), "unet.conv_in.bias": (32,),
        "unet.down_blocks.0.attentions.1.proj_in.weight": (48, 32),
        "unet.conv_norm_out.weight": (32,)}
    np.testing.assert_array_equal(
        got["unet.conv_in.weight"].numpy(),
        tree["unet"]["conv_in"]["kernel"].transpose(3, 2, 0, 1).astype(np.float32))
    assert all(v.dtype == torch.float32 for v in got.values())
    again = from_jax_tree(tree)
    assert again.keys() == got.keys() and all(torch.equal(again[k], got[k]) for k in got)
