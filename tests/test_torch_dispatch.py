"""Routes and isolation of the PyTorch port.

- Every attention site of the denoise loop (tests/test_dispatch.py's
  production table, the WarpAttn r8 sites and the resampler sites) takes a
  hand-written kernel on CUDA, never the plain einsum.
- Importing the port loads no JAX, Flax or JAX-package module.
- A wrapper given a non-CPU tensor launches its kernel or raises: with no
  nvcc there is no library and no silent plain fallback.
"""
import os
import subprocess
import sys

import pytest
import torch

from imagine360_tpu_torch.ops import kernels
from imagine360_tpu_torch.ops.dispatch import select_attention_route

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (label, (B, Sq, Sk, H, D), has_bias, expected route on CUDA)
CUDA_SITES = [
    # tests/test_dispatch.py PRODUCTION_SITES
    ("pers_spatial_s0", (640, 1024, 1024, 5, 64), False, "single"),
    ("pers_spatial_s1", (640, 256, 256, 10, 64), False, "single"),
    ("pers_spatial_s2", (640, 64, 64, 20, 64), False, "single"),
    ("pano_spatial_s0", (32, 8192, 8192, 5, 64), False, "mh_flash"),
    ("pano_spatial_s1", (32, 2048, 2048, 10, 64), False, "mh_flash"),
    ("pano_spatial_s2", (32, 512, 512, 20, 64), False, "single"),
    ("pano_spatial_s3", (32, 128, 128, 20, 64), False, "single"),
    ("pers_text_cross", (640, 1024, 77, 5, 64), False, "single"),
    ("pers_ip_cross", (640, 1024, 64, 5, 64), False, "single"),
    ("pano_text_cross_s0", (32, 8192, 77, 5, 64), False, "single"),
    ("pano_text_cross_s1", (32, 2048, 77, 10, 64), False, "single"),
    ("motion_tiny_seq", (40960, 16, 16, 8, 40), False, "single"),
    # tests/test_dispatch.py WARP_SITES, r8 included
    ("warp_s2_pano_q", (32, 2048, 5120, 10, 32), True, "shared_bias"),
    ("warp_s2_pers_q", (32, 5120, 2048, 10, 32), True, "shared_bias"),
    ("warp_s4_pano_q", (32, 512, 1280, 20, 32), True, "shared_bias"),
    ("warp_s4_pers_q", (32, 1280, 512, 20, 32), True, "shared_bias"),
    ("warp_s8_pano_q", (32, 128, 320, 40, 32), True, "shared_bias"),
    ("warp_s8_pers_q", (32, 320, 128, 40, 32), True, "shared_bias"),
    # IP conditioning: resampler (pers B=40, pano B=2) and TemporalProjection
    ("resampler_pers", (40, 64, 320, 12, 64), False, "single"),
    ("resampler_pano", (2, 64, 320, 12, 64), False, "single"),
    ("temporal_proj_f16", (10240, 16, 16, 8, 64), False, "single"),
    ("temporal_proj_f4", (10240, 4, 4, 8, 64), False, "single"),
]


@pytest.mark.parametrize("label,shape,bias,expect", CUDA_SITES,
                         ids=[s[0] for s in CUDA_SITES])
def test_cuda_route(label, shape, bias, expect):
    assert select_attention_route(*shape, bias, on_cuda=True) == expect


def test_cpu_routes_are_plain():
    for _, shape, bias, _ in CUDA_SITES:
        assert select_attention_route(*shape, bias, on_cuda=False) in ("einsum", "chunked")
    assert select_attention_route(640, 1024, 1024, 5, 64, False, False) == "chunked"
    assert select_attention_route(2, 16, 16, 2, 8, False, False) == "einsum"


# the VAE's mid-block attention (one head of 512) and the CLIP text encoder
VAE_CLIP_SITES = [
    ("vae_pers_encode", (80, 1024, 1024, 1, 512), False, "single"),
    ("vae_pano_encode", (16, 8192, 8192, 1, 512), False, "mh_flash"),
    ("vae_pano_decode", (4, 8704, 8704, 1, 512), False, "mh_flash"),
    ("clip_text_causal", (2, 77, 77, 16, 64), True, "shared_bias"),
]


@pytest.mark.parametrize("label,shape,bias,expect", VAE_CLIP_SITES,
                         ids=[s[0] for s in VAE_CLIP_SITES])
def test_vae_and_clip_routes(label, shape, bias, expect):
    assert select_attention_route(*shape, bias, on_cuda=True) == expect
    assert select_attention_route(*shape, bias, on_cuda=False) in ("einsum", "chunked")


def test_head_dim_beyond_kernels_raises_on_cuda():
    """K1 and K2 stop at 512; K3 (any biased site) at 160."""
    with pytest.raises(ValueError, match="head dim 513"):
        select_attention_route(1, 8192, 8192, 1, 513, False, on_cuda=True)
    with pytest.raises(ValueError, match="head dim 513"):
        select_attention_route(1, 64, 64, 1, 513, False, on_cuda=True)
    with pytest.raises(ValueError, match="head dim 161 with a bias"):
        select_attention_route(1, 64, 64, 1, 161, True, on_cuda=True)
    assert select_attention_route(1, 64, 64, 1, 512, False, on_cuda=True) == "single"


def test_wrapper_head_dim_limits():
    """The head-dim check the wrappers make before they touch the library:
    K1 and K2 take up to 512, K3 and K4 up to 160."""
    kernels._check_head_dim("k", 512, kernels.WIDE_MAX_HEAD_DIM)
    with pytest.raises(ValueError, match="head dim 513 outside 1..512"):
        kernels._check_head_dim("k", 513, kernels.WIDE_MAX_HEAD_DIM)
    with pytest.raises(ValueError, match="head dim 161 outside 1..160"):
        kernels._check_head_dim("k", 161)
    assert kernels.wide_counts() == {"tiny_attention": 0, "mh_flash_attention": 0}


def test_port_imports_no_jax():
    code = ("import imagine360_tpu_torch, imagine360_tpu_torch.pipeline.sampler, "
            "imagine360_tpu_torch.presets, imagine360_tpu_torch.utils.convert, "
            "imagine360_tpu_torch.cli, imagine360_tpu_torch.geometry.pano, sys; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax', 'imagine360_tpu')]; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_wrappers_raise_on_non_cpu_tensor():
    """A meta tensor is not a CPU tensor: each wrapper refuses it and does
    not run (or count) its plain version."""
    kernels.reset_counts()
    q = torch.empty(2, 8, 16, device="meta")
    x = torch.empty(2, 4, 6, 16, device="meta")
    calls = [
        lambda: kernels.tiny_attention(q, q, q, scale=1.0, heads=2),
        lambda: kernels.mh_flash_attention(q, q, q, scale=1.0, heads=2),
        lambda: kernels.shared_bias_attention(x, x, x, torch.empty(4, 4, device="meta"),
                                              scale=1.0),
        lambda: kernels.frame_attention(x, x, x, scale=1.0, heads=2),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert all(c == {"launches": 0, "plain_calls": 0} for c in kernels.counts().values())


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """With no nvcc anywhere, building the library raises instead of giving
    way to the plain versions."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    kernels.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kernels.load_library()
    finally:
        kernels.load_library.cache_clear()


def test_route_logging_once_per_shape(caplog):
    """dispatch.log_route writes one INFO line per unique (route, shape), as
    the JAX package's does (tests/test_sr_prompts.py)."""
    import logging

    from imagine360_tpu_torch.ops import dispatch

    dispatch._logged_routes.clear()
    with caplog.at_level(logging.INFO, logger="imagine360_tpu_torch.dispatch"):
        dispatch.log_route("single", 640, 1024, 1024, 5, 64, False)
        dispatch.log_route("single", 640, 1024, 1024, 5, 64, False)
        dispatch.log_route("mh_flash", 32, 8192, 8192, 5, 64, False)
    lines = [r.message for r in caplog.records]
    assert len(lines) == 2
    assert any("single" in ln for ln in lines)
    assert any("mh_flash" in ln for ln in lines)


def test_entry_points_log_each_route_once(caplog):
    """Two CPU dot_product_attention calls of one shape log one line; another
    shape and temporal_attention log one more each."""
    import logging

    from imagine360_tpu_torch.ops import attention as tattn
    from imagine360_tpu_torch.ops import dispatch

    dispatch._logged_routes.clear()
    q = torch.randn(2, 9, 2, 8)
    with caplog.at_level(logging.INFO, logger="imagine360_tpu_torch.dispatch"):
        tattn.dot_product_attention(q, q, q)
        tattn.dot_product_attention(q, q, q)
        tattn.dot_product_attention(q, q[:, :5], q[:, :5])
        x = torch.randn(1, 4, 6, 16)
        tattn.temporal_attention(x, x, x, heads=2)
        tattn.temporal_attention(x, x, x, heads=2)
    lines = [r.message for r in caplog.records]
    assert len(lines) == 3, lines
    assert "einsum" in lines[0] and "B=2 Sq=9 Sk=9 H=2 D=8 bias=False" in lines[0]
    assert "Sk=5" in lines[1]
    assert "temporal" in lines[2] and "B=6 Sq=4 Sk=4 H=2 D=8" in lines[2]


def test_tc_launches_reset_and_zero_on_cpu():
    """`tc_launches` (launches on the tensor cores of K1-K4, K5a-c, K6a, K6b
    and K7) exists on every wrapper, is zeroed by reset_counts and stays 0
    on the CPU path, where the plain versions run, bfloat16 included."""
    for fn in kernels.KERNELS:
        fn.tc_launches = 3
    kernels.reset_counts()
    assert all(fn.tc_launches == 0 for fn in kernels.KERNELS)
    q = torch.randn(2, 20, 2 * 16).bfloat16()
    kernels.tiny_attention(q, q, q, scale=0.25, heads=2)
    kernels.mh_flash_attention(q, q, q, scale=0.25, heads=2)
    q4 = q.reshape(2, 20, 2, 16)
    kernels.shared_bias_attention(q4, q4, q4, torch.zeros(20, 20), scale=0.25, with_lse=True)
    out, lse = kernels.flash_attention_lse(q4, q4, q4, scale=0.25)
    delta = kernels.attention_delta(q4, out)
    kernels.flash_bwd_dq(q4, q4, q4, None, q4, lse, delta, scale=0.25)
    kernels.flash_bwd_dkv(q4, q4, q4, None, q4, lse, delta, scale=0.25)
    qt = q4.permute(0, 2, 3, 1).contiguous()
    kernels.flash_attention_t(qt, qt, qt, scale=0.25)
    kernels.dense_matmul(q[0], q[0, :8], linear_layout=True)
    kernels.frame_attention(q4, q4, q4, scale=0.25, heads=2)
    q3 = q4.reshape(4, 20, 16)
    kernels.shared_bias_attention_folded(q3, q3, q3, torch.zeros(20, 20).bfloat16(), scale=0.25)
    assert kernels.tc_counts() == {"tiny_attention": 0, "mh_flash_attention": 0,
                                   "shared_bias_attention": 0, "frame_attention": 0,
                                   "flash_attention_lse": 0, "flash_bwd_dq": 0,
                                   "flash_bwd_dkv": 0, "flash_attention_t": 0,
                                   "shared_bias_attention_folded": 0, "dense_matmul": 0}
    assert all(fn.plain_calls == 1 for fn in kernels.TC_KERNELS)
    assert all(fn.launches == 0 for fn in kernels.TC_KERNELS)
