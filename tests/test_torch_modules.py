"""Module parity of the PyTorch port against the JAX package's Flax modules
on tiny_unet_config widths, on the CPU: ResnetBlock3D, Transformer3DModel,
MotionModule, Resampler, TemporalProjection and WarpAttn (both mask
variants).

Every Flax parameter gets a nonzero value from numpy.random.default_rng
(zero-initialised output projections would otherwise hide whole paths);
the same values reach the torch module through
imagine360_tpu_torch.utils.convert.from_jax_params, loaded strictly.

Tolerance: f32 on both sides, 1e-4 of the output's max abs (sums run in
another order in the two frameworks).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imagine360_tpu.geometry import CameraRig
from imagine360_tpu.geometry.corr_masks import warp_geometry
from imagine360_tpu.models.attention3d import Transformer3DModel
from imagine360_tpu.models.motion import MotionModule
from imagine360_tpu.models.resampler import Resampler, TemporalProjection
from imagine360_tpu.models.resnet import ResnetBlock3D
from imagine360_tpu.models.warp import WarpAttn
from imagine360_tpu.presets import tiny_unet_config
from imagine360_tpu.utils.convert import flatten_params, unflatten

from imagine360_tpu_torch.models import attention3d as t_attention3d
from imagine360_tpu_torch.models import motion as t_motion
from imagine360_tpu_torch.models import resampler as t_resampler
from imagine360_tpu_torch.models import resnet as t_resnet
from imagine360_tpu_torch.models import warp as t_warp
from imagine360_tpu_torch.utils.convert import from_jax_params

REL_TOL = 1e-4
CFG = tiny_unet_config()


def _random_flat(module, args, seed):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    rng = np.random.default_rng(seed)
    flat = {}
    for k, s in flatten_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                            shapes)).items():
        x = rng.standard_normal(s.shape).astype(np.float32)
        leaf = k.split(".")[-1]
        if leaf.endswith("kernel"):
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        elif leaf == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        flat[k] = x
    return flat


def _run_both(flax_mod, torch_mod, args, seed, prefix=("", ""), torch_args=None):
    """Apply the Flax module with random params and the torch module with
    the same params; return (torch output, flax output). The parameter keys
    are converted under prefix[0] (the module's name inside a UNet, which
    some renames key on) and prefix[1], the torch form, is then stripped."""
    flat = _random_flat(flax_mod, args, seed)
    want = jax.jit(flax_mod.apply)({"params": unflatten(flat)}, *args)
    sd = from_jax_params({prefix[0] + k: v for k, v in flat.items()})
    sd = {k[len(prefix[1]):]: v for k, v in sd.items()}
    torch_mod.load_state_dict(sd, strict=True)
    targs = torch_args if torch_args is not None else [
        torch.from_numpy(np.array(a)) for a in args]
    with torch.no_grad():
        got = torch_mod.eval()(*targs)
    return got, want


def _close(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape
        err = np.abs(g.numpy() - w).max()
        assert err <= REL_TOL * np.abs(w).max(), (err, np.abs(w).max())


def _rand(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("cin,cout", [(32, 64), (64, 64)])
def test_resnet_block(cin, cout):
    rng = np.random.default_rng(0)
    args = (_rand(rng, 2, 3, 6, 5, cin), _rand(rng, 2, CFG.time_embed_dim))
    got, want = _run_both(ResnetBlock3D(cout, eps=CFG.norm_eps), t_resnet.ResnetBlock3D(
        cin, cout, CFG.time_embed_dim, eps=CFG.norm_eps), args, seed=1)
    _close(got, want)


@pytest.mark.parametrize("channels,heads", [(32, 1), (64, 2)])
def test_transformer3d(channels, heads):
    rng = np.random.default_rng(2)
    n_ip = CFG.num_ip_tokens
    args = (_rand(rng, 2, 2, 4, 4, channels),
            _rand(rng, 2, 7 + n_ip, CFG.cross_attention_dim))
    flax_mod = Transformer3DModel(heads, channels // heads, num_ip_tokens=n_ip)
    torch_mod = t_attention3d.Transformer3DModel(channels, heads, channels // heads,
                                                 CFG.cross_attention_dim, num_ip_tokens=n_ip)
    got, want = _run_both(flax_mod, torch_mod, args, seed=3)
    _close(got, want)


@pytest.mark.parametrize("frames,channels", [(4, 32), (16, 64)])
def test_motion_module(frames, channels):
    rng = np.random.default_rng(4)
    args = (_rand(rng, 2, frames, 3, 4, channels),)
    got, want = _run_both(MotionModule(CFG.motion_heads),
                          t_motion.MotionModule(channels, CFG.motion_heads), args, seed=5,
                          prefix=("motion_modules_0.", "motion_modules.0."))
    _close(got, want)


def test_resampler():
    rng = np.random.default_rng(6)
    emb = CFG.image_hidden_size * 4
    args = (_rand(rng, 3, 20, emb),)
    kw = dict(dim=CFG.resampler_dim, depth=2, heads=CFG.resampler_heads,
              dim_head=CFG.resampler_dim_head, num_queries=CFG.num_ip_tokens,
              embedding_dim=emb, output_dim=CFG.image_cross_attention_dim)
    got, want = _run_both(Resampler(**kw), t_resampler.Resampler(**kw), args, seed=7)
    _close(got, want)


def test_temporal_projection():
    rng = np.random.default_rng(8)
    args = (_rand(rng, 2, 16, 64, CFG.image_hidden_size),)   # 8x8 tokens, 16 frames
    got, want = _run_both(TemporalProjection(dim=CFG.image_hidden_size),
                          t_resampler.TemporalProjection(dim=CFG.image_hidden_size), args,
                          seed=9, prefix=("temporal_proj.", "temporal_proj."))
    _close(got, want)


@pytest.mark.parametrize("use_opp", [False, True])
def test_warp_attn(use_opp):
    m, F, C = 4, 2, 64
    rig = CameraRig.icosahedron(image_size=16).take(m)
    g = warp_geometry(rig, (4, 4), (4, 8), dim=C)
    rng = np.random.default_rng(10)
    pers, equi = _rand(rng, 2 * m, F, 4, 4, C), _rand(rng, 2, F, 4, 8, C)
    geom = {k: jnp.asarray(v) for k, v in g.items()}
    flax_mod = WarpAttn(C, m)
    args = (pers, equi, geom, jnp.asarray(use_opp))
    t_geom = {k: torch.from_numpy(v) for k, v in g.items() if not k.endswith("_T")}
    got, want = _run_both(flax_mod, t_warp.WarpAttn(C, m), args, seed=11, torch_args=[
        torch.from_numpy(np.array(pers)), torch.from_numpy(np.array(equi)), t_geom,
        use_opp])
    _close(got, want)
