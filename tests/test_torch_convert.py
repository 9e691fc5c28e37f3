"""Weights carried between the packages: the JAX package's flat DualUNet
parameters load into the PyTorch port strictly through
imagine360_tpu_torch.utils.convert.from_jax_params, and the round trip
torch state_dict -> imagine360_tpu.utils.convert.convert_state_dict ->
from_jax_params gives back the same tensors (exactly: only transposes and
renames happen)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imagine360_tpu.geometry import CameraRig
from imagine360_tpu.models.dual import DualUNet
from imagine360_tpu.pipeline.sampler import build_dual_warp_geoms
from imagine360_tpu.presets import tiny_dual_config
from imagine360_tpu.utils.convert import convert_state_dict, flatten_params

from imagine360_tpu_torch.models.dual import DualUNet as TDualUNet
from imagine360_tpu_torch.presets import micro_dual_config as t_micro
from imagine360_tpu_torch.presets import tiny_dual_config as t_tiny
from imagine360_tpu_torch.utils.convert import from_jax_params

M, F = 4, 2


@pytest.fixture(scope="module")
def jax_flat():
    """Flat {'a.b.c': array} of a JAX DualUNet on tiny_dual_config, filled
    with distinct random values."""
    cfg = tiny_dual_config(num_views=M)
    geoms = build_dual_warp_geoms(cfg, CameraRig.icosahedron(image_size=16).take(M),
                                  (16, 16), (16, 32))
    z = lambda *s: jnp.zeros(s, jnp.float32)
    args = (z(1, M, F, 16, 16, 9), z(1, F, 16, 32, 9), z(1), z(M, 7, 32), z(1, 7, 32), z(1),
            z(M, 16, 16, 8), z(1, 16, 16, 8), z(1, F, 6), z(1, F), geoms,
            jnp.zeros((7,), bool))
    shapes = jax.eval_shape(lambda: DualUNet(cfg).init(
        {"params": jax.random.PRNGKey(0), "ip_noise": jax.random.PRNGKey(1)}, *args))
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in flatten_params(jax.tree.map(lambda s: np.zeros(s.shape),
                                                    shapes["params"])).items()}


def test_jax_params_load_strict(jax_flat):
    model = TDualUNet(t_tiny(num_views=M))
    res = model.load_state_dict(from_jax_params(jax_flat), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    sd = model.state_dict()
    # spot-check the layout changes: conv HWIO -> OIHW, dense [in,out] -> [out,in]
    np.testing.assert_array_equal(sd["unet.conv_in.weight"].numpy(),
                                  jax_flat["unet.conv_in.kernel"].transpose(3, 2, 0, 1))
    key = "pano_unet.down_blocks_0.attentions_0.transformer_blocks_0.attn1.to_out_0.kernel"
    np.testing.assert_array_equal(
        sd["pano_unet.down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_out.0.weight"]
        .numpy(), jax_flat[key].T)
    np.testing.assert_array_equal(
        sd["unet.down_blocks.0.resnets.0.norm1.weight"].numpy(),
        jax_flat["unet.down_blocks_0.resnets_0.norm1.norm.scale"])


@pytest.mark.parametrize("make_cfg", [lambda: t_tiny(num_views=M), lambda: t_micro(4)],
                         ids=["tiny", "micro"])
def test_round_trip_through_jax_names(make_cfg):
    model = TDualUNet(make_cfg())
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    sd = model.state_dict()
    back = from_jax_params(convert_state_dict(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_torch_names_match_flax_tree(jax_flat):
    """convert_state_dict of the port's state_dict gives exactly the Flax
    parameter names and shapes of the JAX DualUNet."""
    flat = convert_state_dict(TDualUNet(t_tiny(num_views=M)).state_dict())
    assert set(flat) == set(jax_flat)
    assert all(flat[k].shape == jax_flat[k].shape for k in flat)
