"""The port's VEnhancer V2V UNet (imagine360_tpu_torch/sr/unet_v2v.py)
against the JAX package's (imagine360_tpu/sr/unet_v2v.py) on the CPU, f32,
at tiny_v2v_config.

One random state dict under the public VEnhancer names, every leaf nonzero
(the zero-initialised ones too), goes into the port with `load_state_dict`
as it stands and into the JAX module through convert_v2v + apply_converted;
`from_jax_params` of the JAX tree gives it back tensor for tensor. Outputs
agree within 1e-4 of their largest element (convolutions and attention
summed in another order). Inputs come from numpy.random.default_rng. Each
JAX jit is built once, in a module-scoped fixture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagine360_tpu.sr import unet_v2v as J
from imagine360_tpu.utils.convert import apply_converted, flatten_params

from imagine360_tpu_torch.sr import unet_v2v as T
from imagine360_tpu_torch.utils.convert import from_jax_params

from torch_parity import max_abs_err, random_state_dict

REL_TOL = 1e-4
B, F, H, W, L = 1, 4, 8, 16, 7
JCFG, TCFG = J.tiny_v2v_config(), T.tiny_v2v_config()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the tier-1 run
    puts six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(B, F, H, W, 4), hint=f(B, F, H, W, 4), ctx=f(B, L, JCFG.context_dim),
                t=np.full((B,), 500.0, np.float32), t_hint=np.full((B,), 199.0, np.float32),
                s_cond=np.full((B,), 2.0, np.float32),
                mask=np.array([[1, 0, 1, 0]], np.float32))


@pytest.fixture(scope="module")
def models():
    """(JAX module, its params, the port's module, the state dict, the
    converter's output)."""
    port = T.ControlledV2VUNet(TCFG)
    sd = random_state_dict(port, 11)
    res = port.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    jm = J.ControlledV2VUNet(JCFG)
    i = _inputs(0)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(i["x"]), jnp.asarray(i["t"]), jnp.asarray(i["ctx"]),
        jnp.asarray(i["hint"]), t_hint=jnp.asarray(i["t_hint"]),
        mask_cond=jnp.asarray(i["mask"]), s_cond=jnp.asarray(i["s_cond"])))
    init = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    conv = J.convert_v2v({k: v.numpy() for k, v in sd.items()}, JCFG)
    params, missing, unexpected = apply_converted(init, dict(conv))
    return jm, params, port.eval(), sd, (conv, missing, unexpected)


def test_public_state_dict_loads_into_both(models):
    *_, sd, (conv, missing, unexpected) = models
    assert "_unmapped" not in conv, conv.get("_unmapped")
    assert not missing and not unexpected, (missing[:5], unexpected[:5])
    # the public layout's landmarks, the misspelt temporal conv among them
    assert sd["input_blocks.1.0.temopral_conv.conv1.2.weight"].shape == (16, 16, 3, 1, 1)
    assert sd["input_blocks.1.0.temopral_conv.conv4.3.weight"].shape == (16, 16, 3, 1, 1)
    for k in ("time_embed.2.weight", "out.2.weight", "middle_block.3.out_layers.3.weight",
              "VideoControlNet.zero_convs.0.0.weight", "VideoControlNet.middle_block_out.0.bias",
              "VideoControlNet.hint_time_zero_linear.weight",
              "VideoControlNet.scale_cond_zero_linear.bias",
              "output_blocks.1.3.conv.weight", "input_blocks.2.0.op.weight",
              "input_blocks.0.1.transformer_blocks.0.attn1.to_out.0.weight"):
        assert k in sd, k
    # cross-attention in the spatial transformer only
    assert "input_blocks.1.1.transformer_blocks.0.attn2.to_k.weight" in sd
    assert not any(k.startswith("input_blocks.1.2.") and "attn2" in k for k in sd)


def test_from_jax_params_gives_the_state_dict_back(models):
    _, params, _, sd, _ = models
    back = from_jax_params(flatten_params(params["params"]))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape and torch.equal(back[k], v), k


@pytest.fixture(scope="module")
def jax_forward(models):
    jm, params, *_ = models
    return jax.jit(lambda x, t, ctx, hint, th, m, s: jm.apply(
        params, x, t, ctx, hint, t_hint=th, mask_cond=m, s_cond=s))


def _controlled(port, i, t=None):
    with torch.no_grad():
        return port(torch.from_numpy(i["x"]), torch.from_numpy(i["t"] if t is None else t),
                    torch.from_numpy(i["ctx"]), torch.from_numpy(i["hint"]),
                    t_hint=torch.from_numpy(i["t_hint"]), mask_cond=torch.from_numpy(i["mask"]),
                    s_cond=torch.from_numpy(i["s_cond"]))


def test_controlled_v2v_matches_jax(models, jax_forward):
    port = models[2]
    i = _inputs(1)
    want = np.asarray(jax_forward(*(jnp.asarray(i[k]) for k in
                                    ("x", "t", "ctx", "hint", "t_hint", "mask", "s_cond"))))
    got = _controlled(port, i)
    assert got.shape == want.shape == (B, F, H, W, 4)
    assert max_abs_err(got, want) <= REL_TOL * np.abs(want).max()
    # a per-frame t equal on every frame is the same call (the JAX
    # ControlNet takes t [B] only)
    per_frame = _controlled(port, i, np.repeat(i["t"][:, None], F, axis=1))
    assert max_abs_err(per_frame, got.numpy()) <= 1e-6 * np.abs(want).max()


def test_base_unet_with_per_frame_t_matches_jax(models):
    _, params, port, _, _ = models
    i = _inputs(2)
    t = np.array([[900.0, 500.0, 120.0, 3.0]], np.float32)
    jbase = J.Vid2VidSDUNet(JCFG)
    want = np.asarray(jax.jit(jbase.apply)({"params": params["params"]["unet"]},
                                            jnp.asarray(i["x"]), jnp.asarray(t),
                                            jnp.asarray(i["ctx"])))
    base = T.Vid2VidSDUNet(TCFG)
    base.load_state_dict({k: v for k, v in port.state_dict().items()
                          if not k.startswith("VideoControlNet.")}, strict=True)
    with torch.no_grad():
        got = base.eval()(torch.from_numpy(i["x"]), torch.from_numpy(t),
                          torch.from_numpy(i["ctx"]))
    assert max_abs_err(got, want) <= REL_TOL * np.abs(want).max()


def test_hint_embedding_on_key_frames_scale_on_all(models):
    """The ControlNet's time embedding is per frame: t_hint's enters only
    where mask_cond is 1, s_cond's on every frame."""
    cn = models[2].VideoControlNet
    i = _inputs(3)
    t, th, s = (torch.from_numpy(i[k]) for k in ("t", "t_hint", "s_cond"))
    mask = torch.from_numpy(i["mask"])
    with torch.no_grad():
        base = cn.frame_embed(t, F)
        hint = cn.time_embedding(t, F, t_hint=th, mask_cond=mask) - base
        scale = cn.time_embedding(t, F, s_cond=s) - base
    keys = mask[0].bool()
    assert hint[0, keys].abs().min() > 0 and hint[0, ~keys].abs().max() == 0
    assert torch.allclose(scale[0], scale[0, :1].expand(F, -1)) and scale.abs().max() > 0


def test_norms_span_frames_where_the_reference_does():
    """GroupNorm statistics span the frames in the temporal conv stack and
    the temporal transformer, per frame elsewhere; eps 1e-6 in the
    transformers' norms, 1e-5 in the ResBlocks'."""
    m = T.Vid2VidSDUNet(TCFG)
    res = m.input_blocks[1][0]
    assert all(getattr(res.temopral_conv, f"conv{n}")[0].inflated is False for n in range(1, 5))
    assert res.in_layers[0].inflated and res.out_layers[0].inflated
    assert {res.in_layers[0].eps, res.out_layers[0].eps,
            res.temopral_conv.conv1[0].eps} == {1e-5}
    spatial, temporal = m.input_blocks[1][1], m.input_blocks[1][2]
    assert spatial.norm.inflated and temporal.norm.inflated is False
    assert spatial.norm.eps == temporal.norm.eps == 1e-6
    # a frame's values move another frame's normalisation only across frames
    x = torch.randn(1, F, 4, 4, 16, generator=torch.Generator().manual_seed(0))
    y = x.clone()
    y[:, 0] *= 3.0
    with torch.no_grad():
        assert not torch.allclose(temporal.norm(x)[:, 1], temporal.norm(y)[:, 1])
        assert torch.allclose(spatial.norm(x)[:, 1], spatial.norm(y)[:, 1])


def test_temporal_convs_pad_frames_with_zeros():
    """The (3, 1, 1) convs see zeros before the first frame and after the
    last: with conv1 taking only the previous frame, frame 0 gets its bias
    alone."""
    blk = T.TemporalConvBlock(8, 4)
    conv = blk.conv1[-1]
    with torch.no_grad():
        conv.weight.zero_()
        conv.weight[:, :, 0, 0, 0] = torch.eye(8)
        conv.bias.fill_(0.25)
        x = torch.randn(1, 3, 2, 2, 8, generator=torch.Generator().manual_seed(1)) + 5.0
        h = torch.nn.functional.silu(blk.conv1[0](x)).permute(0, 4, 1, 2, 3)
        y = conv(h).permute(0, 2, 3, 4, 1)
    assert torch.allclose(y[:, 0], torch.full_like(y[:, 0], 0.25))
    assert torch.allclose(y[:, 1], h.permute(0, 2, 3, 4, 1)[:, 0] + 0.25)


def test_zero_leaves_at_construction():
    """proj_out, the out convs, the zero convs and the two zero linears are
    zero at construction, so the ControlNet's residuals are zero and the
    controlled UNet is the base UNet."""
    torch.manual_seed(0)
    m = T.ControlledV2VUNet(TCFG).eval()
    sd = m.state_dict()
    want = {k for k in sd if any(s in k for s in (
        "proj_out.", "out_layers.3.", "conv4.3.", "out.2.", "zero_convs.", "middle_block_out.",
        "hint_time_zero_linear.", "scale_cond_zero_linear."))}
    # weights: zero exactly there (norm biases start at zero anyway)
    assert {k for k, v in sd.items() if v.dim() >= 2 and not v.any()} == \
        {k for k in want if sd[k].dim() >= 2}
    assert all(not sd[k].any() for k in want)
    i = _inputs(4)
    with torch.no_grad():
        # live base leaves so the UNet's output is not zero itself
        for k, p in m.named_parameters():
            if not k.startswith("VideoControlNet.") and not p.any():
                p.normal_(0.0, 0.05)
        control = m.VideoControlNet(torch.from_numpy(i["x"]), torch.from_numpy(i["t"]),
                                    torch.from_numpy(i["ctx"]), torch.from_numpy(i["hint"]),
                                    t_hint=torch.from_numpy(i["t_hint"]),
                                    mask_cond=torch.from_numpy(i["mask"]),
                                    s_cond=torch.from_numpy(i["s_cond"]))
        base = T.Vid2VidSDUNet.forward(m, torch.from_numpy(i["x"]), torch.from_numpy(i["t"]),
                                       torch.from_numpy(i["ctx"]))
        controlled = _controlled(m, i)
    assert len(control) == len(m.input_blocks) + 1 and all(not c.any() for c in control)
    assert base.abs().max() > 0 and torch.equal(controlled, base)


def test_scatter_hint_is_exact():
    low = np.arange(2 * 2 * 3 * 4, dtype=np.float32).reshape(1, 2, 2, 3, 4)
    want_h, want_m = J.scatter_hint(jnp.asarray(low), frames=6, interp_f_num=2)
    hint, mask = T.scatter_hint(torch.from_numpy(low), frames=6, interp_f_num=2)
    assert np.array_equal(hint.numpy(), np.asarray(want_h))
    assert np.array_equal(mask.numpy(), np.asarray(want_m))
    assert mask.tolist() == [[1, 0, 0, 1, 0, 0]]


@pytest.mark.parametrize("interp_f_num", [0, 1])
def test_refiner_prepare_and_step_match_jax(models, interp_f_num):
    """V2VRefiner.prepare (the hint noise-augmented to t_hint with the
    15-step DDIM alphas; JAX draws that noise from PRNGKey(0), handed over
    here as a tensor) and one step, CFG inactive (no text)."""
    jm, params, port, _, _ = models
    z = np.random.default_rng(5 + interp_f_num).standard_normal((F, H, W, 4)).astype(np.float32)
    jref = J.V2VRefiner(jm, params, guidance_scale=1.0, interp_f_num=interp_f_num)
    want = np.asarray(jref.prepare(jnp.asarray(z))(jnp.asarray(z), jnp.full((1,), 500.0), None))
    low = jnp.asarray(z)[None, ::interp_f_num + 1]
    hint_shape = (1, F) + z.shape[1:]
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), hint_shape, low.dtype))
    tref = T.V2VRefiner(port, guidance_scale=1.0, interp_f_num=interp_f_num)
    fn = tref.prepare(torch.from_numpy(z), noise=torch.from_numpy(noise))
    assert np.allclose(tref._hint.numpy(), np.asarray(jref._hint), atol=1e-6)
    assert np.array_equal(tref._mask.numpy(), np.asarray(jref._mask))
    got = fn(torch.from_numpy(z), torch.tensor([500.0]))
    assert got.shape == z.shape
    assert max_abs_err(got, want) <= REL_TOL * np.abs(want).max()


def test_refiner_draws_its_hint_noise_from_seed_0(models):
    port = models[2]
    z = torch.from_numpy(np.random.default_rng(9).standard_normal((F, H, W, 4)).astype(np.float32))
    a, b = T.V2VRefiner(port), T.V2VRefiner(port)
    a.prepare(z)
    b.prepare(z, noise=torch.randn((1,) + tuple(z.shape),
                                   generator=torch.Generator().manual_seed(0)))
    assert torch.equal(a._hint, b._hint)


def test_refiner_cfg_only_with_distinct_text(models):
    port = models[2]
    text = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (77, TCFG.context_dim)).astype(np.float32))
    assert T.V2VRefiner(port, text_pos=text, guidance_scale=7.5).cfg_active
    assert not T.V2VRefiner(port, text_pos=text, text_neg=text.clone()).cfg_active
    assert not T.V2VRefiner(port, text_pos=text, guidance_scale=1.0).cfg_active
    assert not T.V2VRefiner(port).cfg_active
