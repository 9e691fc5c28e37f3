"""The PyTorch port's CLIP text encoder and SAM image encoder against the
JAX package on the CPU, f32, at tiny sizes.

Inputs and every parameter (all nonzero, the SAM relative-position tables
included) come from numpy.random.default_rng and go to both packages.
Tolerance 1e-4 abs: both sides are f32 and differ only in summation order.
The checkpoint converters are held to the JAX package's: the same foreign
state dict through the port's converter and through the JAX converter +
from_jax_params gives identical tensors.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from imagine360_tpu.models import clip_text as jclip
from imagine360_tpu.models import sam as jsam

from imagine360_tpu_torch.models import clip_text as tclip
from imagine360_tpu_torch.models import sam as tsam
from imagine360_tpu_torch.utils.convert import from_jax_params

from torch_parity import jax_params, load_into, max_abs_err, random_flat_params

TOL = 1e-4
CLIP_KW = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
               intermediate_size=64, max_position_embeddings=16)
SAM_KW = dict(img_size=96, patch_size=16, embed_dim=32, depth=2, num_heads=4, out_chans=16,
              window_size=4, global_attn_indexes=(1,))


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_text_matches_jax(act):
    ids = np.random.default_rng(0).integers(0, 100, (2, 11)).astype(np.int32)
    model = jclip.CLIPTextModel(jclip.CLIPTextConfig(hidden_act=act, **CLIP_KW))
    flat = random_flat_params(model, (jnp.asarray(ids),), seed=1)
    want = model.apply(jax_params(flat), jnp.asarray(ids))
    tmodel = load_into(tclip.CLIPTextModel(tclip.CLIPTextConfig(hidden_act=act, **CLIP_KW)),
                       flat)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids))
    assert tuple(got.shape) == want.shape == (2, 11, 32)
    assert max_abs_err(got, want) <= TOL


def test_clip_causal_mask_hides_later_tokens():
    """Changing token t leaves the states of tokens before t unchanged."""
    model = tclip.CLIPTextModel(tclip.CLIPTextConfig(**CLIP_KW)).eval()
    ids = torch.arange(1, 13)[None]
    other = ids.clone()
    other[0, 7] = 99
    with torch.no_grad():
        a, b = model(ids), model(other)
    assert torch.equal(a[:, :7], b[:, :7]) and not torch.equal(a[:, 7:], b[:, 7:])


def _sam_pair(rows):
    cfg = jsam.SAMConfig(global_q_rows=rows, **SAM_KW)
    model = jsam.SAMImageEncoder(cfg)
    x = np.random.default_rng(2).standard_normal((2, 96, 96, 3)).astype(np.float32)
    flat = random_flat_params(model, (jnp.asarray(x),), seed=3)
    tmodel = load_into(tsam.SAMImageEncoder(tsam.SAMConfig(global_q_rows=rows, **SAM_KW)),
                       flat)
    return model, flat, tmodel, x


@pytest.mark.parametrize("rows", [0, 2], ids=["unchunked", "q_rows_2"])
def test_sam_encoder_matches_jax(rows):
    """Depth 2: one windowed block (6 x 6 grid padded to 8 x 8 for 4 x 4
    windows) and one global block, with the query-row chunking off and on."""
    model, flat, tmodel, x = _sam_pair(rows)
    want = model.apply(jax_params(flat), jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 6, 6, 16)
    assert max_abs_err(got, want) <= TOL


def test_sam_row_chunking_changes_nothing():
    _, flat, chunked, x = _sam_pair(2)
    whole = load_into(tsam.SAMImageEncoder(tsam.SAMConfig(global_q_rows=0, **SAM_KW)), flat)
    with torch.no_grad():
        a, b = chunked(torch.from_numpy(x)), whole(torch.from_numpy(x))
    assert max_abs_err(a, b.numpy()) <= 1e-5


def test_sam_preprocess_matches_jax():
    u8 = np.random.default_rng(4).integers(0, 256, (2, 40, 64, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tsam.sam_preprocess(u8, 64), jsam.sam_preprocess(u8, 64))


def _assert_same_state(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_convert_sam_encoder_matches_jax():
    model = tsam.SAMImageEncoder(tsam.SAMConfig(**SAM_KW))
    g = torch.Generator().manual_seed(5)
    sd = {"image_encoder." + k: torch.randn(v.shape, generator=g)
          for k, v in model.state_dict().items()}
    sd["mask_decoder.iou_token.weight"] = torch.zeros(1, 4)
    got = tsam.convert_sam_encoder(sd)
    _assert_same_state(got, from_jax_params(jsam.convert_sam_encoder(sd)))
    assert not model.load_state_dict(got, strict=True).missing_keys


def _openclip_state_dict(layers=3, V=100, D=32, FF=64, CTX=16):
    g = torch.Generator().manual_seed(6)
    r = lambda *s: torch.randn(*s, generator=g) * 0.05
    sd = {"model.token_embedding.weight": r(V, D), "model.positional_embedding": r(CTX, D),
          "model.ln_final.weight": 1 + r(D), "model.ln_final.bias": r(D),
          "model.logit_scale": torch.tensor(4.6), "model.text_projection": r(D, D),
          "model.visual.conv1.weight": r(8, 3, 2, 2), "model.attn_mask": torch.zeros(CTX, CTX)}
    for i in range(layers):
        p = f"model.transformer.resblocks.{i}."
        sd.update({p + "ln_1.weight": 1 + r(D), p + "ln_1.bias": r(D),
                   p + "attn.in_proj_weight": r(3 * D, D), p + "attn.in_proj_bias": r(3 * D),
                   p + "attn.out_proj.weight": r(D, D), p + "attn.out_proj.bias": r(D),
                   p + "ln_2.weight": 1 + r(D), p + "ln_2.bias": r(D),
                   p + "mlp.c_fc.weight": r(FF, D), p + "mlp.c_fc.bias": r(FF),
                   p + "mlp.c_proj.weight": r(D, FF), p + "mlp.c_proj.bias": r(D)})
    return sd


def test_convert_openclip_text_matches_jax():
    """Penultimate semantics: 3 resblocks in, 2 layers out; qkv split."""
    sd = _openclip_state_dict()
    got = tclip.convert_openclip_text(sd, num_layers=2)
    _assert_same_state(got, from_jax_params(jclip.convert_openclip_text(sd, num_layers=2)))
    model = tclip.CLIPTextModel(tclip.CLIPTextConfig(**CLIP_KW))
    res = model.load_state_dict(got, strict=True)
    assert not res.missing_keys and not res.unexpected_keys


def test_convert_hf_clip_text_matches_jax():
    model = tclip.CLIPTextModel(tclip.CLIPTextConfig(**CLIP_KW))
    g = torch.Generator().manual_seed(7)
    hf = {"text_model.embeddings.position_ids": torch.arange(16)[None]}
    for k, v in model.state_dict().items():
        t = torch.randn(v.shape, generator=g)
        if k == "token_embedding.weight":
            hf["text_model.embeddings.token_embedding.weight"] = t
        elif k == "position_embedding":
            hf["text_model.embeddings.position_embedding.weight"] = t
        elif k.startswith("layers."):
            k = k.replace(".fc1.", ".mlp.fc1.").replace(".fc2.", ".mlp.fc2.")
            hf["text_model.encoder." + k] = t
        else:
            hf["text_model." + k] = t
    got = tclip.convert_hf_clip_text(hf)
    _assert_same_state(got, from_jax_params(jclip.convert_hf_clip_text(hf)))
    assert not model.load_state_dict(got, strict=True).missing_keys


def test_openclip_tokenize_zero_pads():
    class FakeTok:
        def __call__(self, text, truncation, max_length, add_special_tokens):
            assert truncation and add_special_tokens
            return {"input_ids": [49406, 320, 1929, 49407]}

    out = tclip.openclip_tokenize(FakeTok(), "a dog", context_length=8)
    assert out.tolist() == [49406, 320, 1929, 49407, 0, 0, 0, 0]
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, jclip.openclip_tokenize(FakeTok(), "a dog", 8))
