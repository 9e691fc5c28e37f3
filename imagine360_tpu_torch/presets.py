"""Canonical model configurations (counterpart of imagine360_tpu/presets.py).

`full_*` is the production Imagine360 setup: SD2.1 widths (320, 640, 1280,
1280), heads (5, 10, 20, 20), cross-attention dim 1024, 20 icosahedron
views. `tiny_*` and `micro_*` are the CPU-testable miniatures.
"""
from __future__ import annotations

from .models.dual import DualUNetConfig
from .models.unet3d import UNet3DConfig


def full_unet_config(dtype: str = "bfloat16") -> UNet3DConfig:
    return UNet3DConfig(dtype=dtype)


def full_dual_config(dtype: str = "bfloat16") -> DualUNetConfig:
    c = full_unet_config(dtype)
    return DualUNetConfig(pers=c, pano=c, num_views=20)


def tiny_unet_config(dtype: str = "float32") -> UNet3DConfig:
    return UNet3DConfig(
        block_out_channels=(32, 64, 64, 64),
        attention_heads=(1, 2, 2, 2),
        cross_attention_dim=32,
        image_cross_attention_dim=32,
        image_hidden_size=8,
        num_ip_tokens=8,
        resampler_dim=32, resampler_depth=1, resampler_heads=2,
        resampler_dim_head=16,
        dtype=dtype,
    )


def tiny_dual_config(num_views: int = 4, dtype: str = "float32") -> DualUNetConfig:
    c = tiny_unet_config(dtype)
    return DualUNetConfig(pers=c, pano=c, num_views=num_views)


def micro_unet_config(dtype: str = "float32") -> UNet3DConfig:
    """2-block micro UNet: the same code paths at minimal cost."""
    return UNet3DConfig(
        block_out_channels=(32, 64),
        attention_heads=(1, 2),
        cross_attention_dim=32,
        image_cross_attention_dim=32,
        image_hidden_size=8,
        num_ip_tokens=8,
        resampler_dim=32, resampler_depth=1, resampler_heads=2,
        resampler_dim_head=16,
        dtype=dtype,
    )


def micro_dual_config(num_views: int = 8, dtype: str = "float32") -> DualUNetConfig:
    c = micro_unet_config(dtype)
    return DualUNetConfig(pers=c, pano=c, num_views=num_views)
