"""Checkpoint loading of the PyTorch port (imagine360_tpu_torch/utils/
checkpoints.py, cli.build_modules) against the JAX package's
(imagine360_tpu/utils/checkpoints.py) on the CPU.

Reference-format files are written with torch.save from seeded random values
at the micro config (no weight file is fetched): a per-branch UNet checkpoint
for each branch ({'epoch', 'global_step', 'state_dict'}, keys under the DDP
'module.' prefix), a motion-LoRA pair for the perspective branch, and an
MVModel file with the WarpAttn blocks and stale unet. / pano_unet. copies
that the per-branch files override. Both packages load the same files. The
port's tensors equal the JAX tree carried over by
utils/convert.py:from_jax_params: bit for bit, but for the LoRA-merged weights
(up @ down in numpy and in torch, 1e-6 of the weight's max abs). One CFG
DDIM denoise step on the loaded weights agrees to 1e-4 of the output's max
abs (f32 on both sides; sums run in another order).

Also: the orbax_cache replacement (torch.save of the assembled state_dict)
round-trips and wins over the reference files; build_modules loads the VAE,
CLIP text and SAM files of an SD2.1-style tree and no longer refuses an
existing checkpoint; a missing tokenizer directory leaves the tokenizer out;
.safetensors files load where the package is installed.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagine360_tpu.models.dual import DualUNet
from imagine360_tpu.pipeline.sampler import (DualDiffusionSampler, SamplerConfig,
                                             build_dual_warp_geoms)
from imagine360_tpu.geometry import CameraRig
from imagine360_tpu.presets import micro_dual_config
from imagine360_tpu.utils import checkpoints as jckpt
from imagine360_tpu.utils.convert import flatten_params, merge_lora as jmerge_lora, unflatten

from imagine360_tpu_torch import cli as tcli
from imagine360_tpu_torch.config import RunConfig as TRunConfig
from imagine360_tpu_torch.geometry.cameras import CameraRig as TCameraRig
from imagine360_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from imagine360_tpu_torch.models.dual import DualUNet as TDualUNet
from imagine360_tpu_torch.models.sam import SAMConfig, SAMImageEncoder
from imagine360_tpu_torch.models.vae import AutoencoderKL, VAEConfig, convert_diffusers_vae
from imagine360_tpu_torch.pipeline.sampler import (DualDiffusionSampler as TSampler,
                                                   SamplerConfig as TSamplerConfig,
                                                   build_dual_warp_geoms as t_build_geoms)
from imagine360_tpu_torch.presets import micro_dual_config as t_micro
from imagine360_tpu_torch.utils import checkpoints as tckpt
from imagine360_tpu_torch.utils.convert import from_jax_params, merge_lora, strip_prefix

M, F = 4, 2
PH = PW = 16
EH, EW = 16, 32
REL_TOL = 1e-4
LORA_TOL = 1e-6
LORA_SITES = ("attention_blocks.0.to_q.weight", "attention_blocks.0.to_v.weight")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the tier-1 run
    puts six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _latents(rng):
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(pano=f32(1, F, EH, EW, 4), pers=f32(1, M, F, PH, PW, 4),
                pano_mask=(rng.random((1, F, EH, EW, 1)) > 0.5).astype(np.float32),
                pano_masked=f32(1, F, EH, EW, 4),
                pers_mask=(rng.random((1, M, F, PH, PW, 1)) > 0.5).astype(np.float32),
                pers_masked=f32(1, M, F, PH, PW, 4),
                pano_text=f32(2, 7, 32), pers_text=f32(2 * M, 7, 32),
                ref_pano=f32(2, 4, 16, 8), ref_pers=f32(2 * M, 4, 16, 8),
                rel=rng.integers(0, 50, (2, F, 6)).astype(np.float32),
                pitch=rng.integers(0, 90, (2, F)).astype(np.float32),
                fps=np.full((2,), 8.0, np.float32))


def _init_args(lat, geoms):
    j = jnp.asarray
    return (j(np.concatenate([lat["pers"], lat["pers_mask"], lat["pers_masked"]], -1)
              .repeat(2, 0)),
            j(np.concatenate([lat["pano"], lat["pano_mask"], lat["pano_masked"]], -1)
              .repeat(2, 0)),
            jnp.zeros((2,)), j(lat["pers_text"]), j(lat["pano_text"]), j(lat["fps"]),
            j(lat["ref_pers"]), j(lat["ref_pano"]), j(lat["rel"]), j(lat["pitch"]),
            geoms, jnp.zeros((3,), bool))


def _random_torch_state(model, init_args, seed):
    """Seeded nonzero values for every parameter of the JAX DualUNet, under
    the reference's (the port's) names, as a torch state_dict."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "ip_noise": jax.random.PRNGKey(1)},
        *init_args))["params"]
    rng = np.random.default_rng(seed)
    flat = {}
    for k, s in flatten_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                            shapes)).items():
        x = rng.standard_normal(s.shape).astype(np.float32)
        leaf = k.split(".")[-1]
        flat[k] = (x / np.sqrt(np.prod(s.shape[:-1])) if leaf.endswith("kernel")
                   else 1.0 + 0.1 * x if leaf == "scale" else 0.1 * x)
    return from_jax_params(flat), {k: np.zeros_like(v) for k, v in flat.items()}


@pytest.fixture(scope="module")
def reference_files(tmp_path_factory):
    """The JAX micro DualUNet, its zero tree, the written reference-format
    files and the keys the LoRA merges into."""
    d = tmp_path_factory.mktemp("ckpts")
    cfg = micro_dual_config(num_views=M)
    geoms = build_dual_warp_geoms(cfg, CameraRig.icosahedron(image_size=16).take(M), (PH, PW),
                                  (EH, EW), bias_dtype=np.float32)
    lat = _latents(np.random.default_rng(4))
    model = DualUNet(cfg)
    state, zeros = _random_torch_state(model, _init_args(lat, geoms), seed=5)
    branch = lambda pre: {"module." + k[len(pre):]: v for k, v in state.items()
                          if k.startswith(pre)}
    files = {name: str(d / f"{name}.ckpt") for name in ("pers", "pano", "mv", "lora")}
    torch.save({"epoch": 3, "global_step": 1200, "state_dict": branch("unet.")}, files["pers"])
    torch.save({"epoch": 3, "global_step": 1200, "state_dict": branch("pano_unet.")},
               files["pano"])
    # the MVModel file: WarpAttn blocks, and stale branch copies the per-branch files win over
    torch.save({k: (v if k.startswith("cp_blocks") else torch.full_like(v, 7.0))
                for k, v in state.items()}, files["mv"])
    rng = np.random.default_rng(6)
    lora, merged = {}, []
    for key in state:
        if key.startswith("unet.") and key.endswith(LORA_SITES):
            base = key[len("unet."):]
            out_dim, in_dim = state[key].shape
            stem = base[:-len(".weight")].rsplit(".", 1)
            up = f"{stem[0]}.processor.{stem[1]}_lora.up.weight"
            lora[up] = torch.from_numpy(rng.standard_normal((out_dim, 2)).astype(np.float32))
            lora[up.replace(".up.", ".down.")] = torch.from_numpy(
                rng.standard_normal((2, in_dim)).astype(np.float32))
            merged.append(key)
    assert merged
    torch.save(lora, files["lora"])
    return dict(files=files, cfg=cfg, geoms=geoms, lat=lat, model=model,
                zeros=zeros, merged=merged)


def _load_both(ref, alpha=0.5):
    f = ref["files"]
    tree, missing, unexpected = jckpt.load_dual_model(
        {"params": unflatten(ref["zeros"])}, f["mv"], f["pers"], f["pano"], f["lora"], None,
        alpha, 1.0)
    assert not missing and not unexpected
    tm = TDualUNet(t_micro(num_views=M)).eval()
    t_missing, t_unexpected = tckpt.load_dual_model(tm, f["mv"], f["pers"], f["pano"],
                                                    f["lora"], None, alpha, 1.0)
    assert not t_missing and not t_unexpected
    return tree, tm


def test_strip_prefix_and_merge_lora_match_jax():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    up = torch.from_numpy(rng.standard_normal((6, 2)).astype(np.float32))
    down = torch.from_numpy(rng.standard_normal((2, 5)).astype(np.float32))
    state = strip_prefix({"module.blk.to_q.weight": w, "other.bias": w[0]})
    assert set(state) == {"blk.to_q.weight", "other.bias"}
    for up_key, down_key in (("blk.processor.to_q_lora.up.weight",
                              "blk.processor.to_q_lora.down.weight"),
                             ("blk.to_q.lora_up.weight", "blk.to_q.lora_down.weight")):
        lora = {up_key: up, down_key: down, "blk.processor.to_k_lora.up.weight": up}
        got = merge_lora(state, lora, alpha=0.75)
        want = jmerge_lora(state, lora, alpha=0.75)
        assert set(got) == set(want)
        np.testing.assert_allclose(got["blk.to_q.weight"].numpy(), want["blk.to_q.weight"],
                                   rtol=0, atol=LORA_TOL)
        np.testing.assert_allclose(got["blk.to_q.weight"].numpy(),
                                   (w + 0.75 * up @ down).numpy(), rtol=0, atol=LORA_TOL)
        assert got["other.bias"] is state["other.bias"]    # no down weight, no base: untouched


def test_dual_checkpoints_load_like_jax_and_denoise_step_matches(reference_files):
    ref = reference_files
    tree, tm = _load_both(ref)
    want = from_jax_params(flatten_params(tree["params"]))
    got = tm.state_dict()
    assert set(got) == set(want)
    lora_keys = set(ref["merged"])
    for k, w in want.items():
        if k in lora_keys:
            assert (got[k] - w).abs().max().item() <= LORA_TOL * w.abs().max().item(), k
        else:
            assert torch.equal(got[k], w), k
    # the per-branch files won over the MVModel's stale copies; the LoRA moved its weights
    assert not any(torch.all(v == 7.0) for k, v in got.items() if not k.startswith("cp_blocks"))
    pers = torch.load(ref["files"]["pers"], weights_only=False)["state_dict"]
    for k in lora_keys:
        assert not torch.equal(got[k], pers["module." + k[len("unet."):]])

    # one CFG DDIM step on the loaded weights
    lat, j = ref["lat"], jnp.asarray
    sampler = DualDiffusionSampler(ref["model"], SamplerConfig(num_steps=1, add_ip_noise=False,
                                                               antipodal_prob=0.0))
    ip_pers, ip_pano = sampler.compute_ip(tree, j(lat["ref_pers"]), j(lat["ref_pano"]),
                                          j(lat["rel"]), j(lat["pitch"]))
    want_pano, want_pers = sampler.denoise(
        tree, jax.random.PRNGKey(0), j(lat["pano"]), j(lat["pers"]), j(lat["pano_mask"]),
        j(lat["pano_masked"]), j(lat["pers_mask"]), j(lat["pers_masked"]),
        j(lat["pano_text"]), j(lat["pers_text"]), ref["geoms"], j(lat["fps"]),
        rel_pos=j(lat["rel"]), pitch=j(lat["pitch"]), ip_tokens_pers=ip_pers,
        ip_tokens_pano=ip_pano)
    t_sampler = TSampler(tm, TSamplerConfig(num_steps=1, add_ip_noise=False,
                                            antipodal_prob=0.0))
    T = torch.from_numpy
    t_geoms = t_build_geoms(t_micro(num_views=M), TCameraRig.icosahedron(16).take(M),
                            (PH, PW), (EH, EW), device="cpu")
    tip_pers, tip_pano = t_sampler.compute_ip(T(lat["ref_pers"]), T(lat["ref_pano"]),
                                              T(lat["rel"]), T(lat["pitch"]))
    got_pano, got_pers = t_sampler.denoise(
        T(lat["pano"]), T(lat["pers"]), T(lat["pano_mask"]), T(lat["pano_masked"]),
        T(lat["pers_mask"]), T(lat["pers_masked"]), T(lat["pano_text"]),
        T(lat["pers_text"]), t_geoms, T(lat["fps"]), tip_pers, tip_pano)
    for g, w in ((got_pano, want_pano), (got_pers, want_pers)):
        w = np.asarray(w, np.float32)
        assert np.abs(g.numpy() - w).max() <= REL_TOL * np.abs(w).max()


def test_cache_round_trip_wins_over_reference_files(reference_files, tmp_path):
    """build_modules loads the reference files, caches the assembled
    state_dict as <orbax_cache>/dual.pt, and a later build restores the
    cache in their place."""
    ref = reference_files
    f = ref["files"]
    _, tm = _load_both(ref, alpha=1.0)
    cfg = TRunConfig(pano_H=128, pano_W=256, dtype="float32", orbax_cache=str(tmp_path / "c"),
                     mvmodel_pretrained_model_path=f["mv"],
                     pers_unet_pretrained_model_path=f["pers"],
                     pano_unet_pretrained_model_path=f["pano"],
                     perslora_motion_module_path=f["lora"])
    vae_cfg = VAEConfig(block_out_channels=(8, 8), norm_num_groups=4)
    first = tcli.build_modules(cfg, t_micro(num_views=M), device="cpu", vae_cfg=vae_cfg)
    cache = tmp_path / "c" / "dual.pt"
    assert cache.exists()
    want = tm.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in first.dual.state_dict().items())
    # the cache wins: change it, and the next build takes the changed value
    state = torch.load(cache, weights_only=True)
    key = next(iter(state))
    state[key] = state[key] + 1.0
    torch.save(state, cache)
    second = tcli.build_modules(cfg, t_micro(num_views=M), device="cpu", vae_cfg=vae_cfg)
    assert torch.equal(second.dual.state_dict()[key], want[key] + 1.0)
    missing, unexpected = tckpt.load_cache(TDualUNet(t_micro(num_views=M)), str(cache))
    assert not missing and not unexpected


def _sd21_tree(root, vae_cfg, text_cfg, legacy=False):
    """An SD2.1-style tree with seeded VAE and CLIP text weights in the file
    formats and names of diffusers and transformers (the VAE's mid-block
    attention in the older query / key / value / proj_attn names, 1x1-conv
    weights, with `legacy`)."""
    torch.manual_seed(0)
    vae_state = {k: torch.randn_like(v) for k, v in AutoencoderKL(vae_cfg).state_dict().items()}
    if legacy:
        for old, new in ((".query.", ".to_q."), (".key.", ".to_k."), (".value.", ".to_v."),
                         (".proj_attn.", ".to_out.0.")):
            for k in [k for k in vae_state if new in k]:
                v = vae_state.pop(k)
                vae_state[k.replace(new, old)] = v[:, :, None, None] if v.dim() == 2 else v
    os.makedirs(root / "vae")
    torch.save(vae_state, root / "vae" / "diffusion_pytorch_model.bin")
    text = CLIPTextModel(text_cfg).state_dict()
    hf = {}
    for k, v in text.items():
        k = k.replace("token_embedding.weight", "embeddings.token_embedding.weight")
        k = k.replace("position_embedding", "embeddings.position_embedding.weight")
        k = k.replace("layers.", "encoder.layers.", 1) if k.startswith("layers.") else k
        for fc in ("fc1", "fc2"):
            k = k.replace(f".{fc}.", f".mlp.{fc}.")
        hf["text_model." + k] = torch.randn_like(v)
    os.makedirs(root / "text_encoder")
    torch.save(hf, root / "text_encoder" / "pytorch_model.bin")
    return vae_state, hf


@pytest.mark.parametrize("legacy", [False, True])
def test_build_modules_loads_vae_clip_and_sam(tmp_path, legacy):
    """VAE (diffusers names, or the older attention names), CLIP text
    (transformers names) and SAM (segment_anything names) load through the
    port's converters; no tokenizer directory, no tokenizer; an existing
    SAM path is loaded, not refused."""
    vae_cfg = VAEConfig(block_out_channels=(8, 8), norm_num_groups=4)
    text_cfg = CLIPTextConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                              intermediate_size=64)
    vae_state, hf = _sd21_tree(tmp_path / "sd21", vae_cfg, text_cfg, legacy)
    sam_cfg = SAMConfig(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=2,
                        out_chans=8, window_size=2, global_attn_indexes=(1,))
    sam_state = {"image_encoder." + k: torch.randn_like(v)
                 for k, v in SAMImageEncoder(sam_cfg).state_dict().items()}
    sam_state["prompt_encoder.pe"] = torch.zeros(3)
    torch.save(sam_state, tmp_path / "sam.pth")
    cfg = TRunConfig(pano_H=128, pano_W=256, dtype="float32",
                     pretrained_model_path=str(tmp_path / "sd21"),
                     image_pretrained_model_path=str(tmp_path / "sam.pth"))
    dual_cfg = t_micro(num_views=M)
    mods = tcli.build_modules(cfg, dual_cfg, device="cpu", vae_cfg=vae_cfg, text_cfg=text_cfg,
                              sam_cfg=sam_cfg)
    want_vae = convert_diffusers_vae(vae_state)
    assert set(want_vae) == set(mods.vae.state_dict())
    assert all(torch.equal(v.reshape(want_vae[k].shape), want_vae[k])
               for k, v in mods.vae.state_dict().items())
    assert torch.equal(mods.text_encoder.token_embedding.weight,
                       hf["text_model.embeddings.token_embedding.weight"])
    assert mods.tokenizer is None
    # the micro UNet's image features are 8 wide, not SAM's 256: SAM is built, not loaded
    assert not any(p.any() for p in mods.sam.parameters())
    unet = dataclasses.replace(dual_cfg.pers, image_hidden_size=256)
    sam_wide = tcli.build_modules(cfg, dataclasses.replace(dual_cfg, pers=unet, pano=unet),
                                  device="cpu", vae_cfg=vae_cfg, text_cfg=text_cfg,
                                  sam_cfg=sam_cfg)
    assert all(torch.equal(v, sam_state["image_encoder." + k])
               for k, v in sam_wide.sam.state_dict().items())


def test_load_state_dict_formats(tmp_path):
    """.ckpt with a {'state_dict'} wrapper and 'module.' prefixes, a bare
    .bin, and .safetensors where the package is installed, all as the JAX
    package's load_state_dict reads them."""
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    torch.save({"epoch": 1, "state_dict": {"module.a.weight": w}}, tmp_path / "x.ckpt")
    torch.save({"a.weight": w}, tmp_path / "x.bin")
    for name in ("x.ckpt", "x.bin"):
        got = tckpt.load_state_dict(str(tmp_path / name))
        want = jckpt.load_state_dict(str(tmp_path / name))
        assert set(got) == set(want) == {"a.weight"} and torch.equal(got["a.weight"], w)
    safetensors_torch = pytest.importorskip("safetensors.torch")
    safetensors_torch.save_file({"a.weight": w}, str(tmp_path / "x.safetensors"))
    got = tckpt.load_state_dict(str(tmp_path / "x.safetensors"))
    want = jckpt.load_state_dict(str(tmp_path / "x.safetensors"))
    assert torch.equal(got["a.weight"], w) and np.array_equal(want["a.weight"], w.numpy())
