"""The port's kernel switchboard (imagine360_tpu_torch/ops/dispatch.py):
`I360_KERNELS` parsing, `configure()` nesting and restore, and the route
table of the production shapes with `attn_v2` on and off. Pure CPU tests of
pure functions; the shapes are those of tests/test_dispatch.py and
tests/test_torch_dispatch.py.
"""
import pytest
import torch

from imagine360_tpu.ops.dispatch import KernelConfig as JaxKernelConfig

from imagine360_tpu_torch.ops import attention as tattn
from imagine360_tpu_torch.ops import dispatch
from imagine360_tpu_torch.ops.dispatch import (KernelConfig, configure, kernel_config,
                                               reset_kernel_config, select_attention_route)


@pytest.fixture(autouse=True)
def fresh_config(monkeypatch):
    """Every test starts from, and leaves behind, the config of an empty
    environment."""
    monkeypatch.delenv("I360_KERNELS", raising=False)
    reset_kernel_config()
    yield
    monkeypatch.delenv("I360_KERNELS", raising=False)
    reset_kernel_config()


def test_defaults_are_off_and_named_as_in_jax():
    assert kernel_config() == KernelConfig(attn_v2=False, pallas_dense=False)
    jax_defaults = JaxKernelConfig()
    for name in ("attn_v2", "pallas_dense"):
        assert getattr(jax_defaults, name) is False and hasattr(KernelConfig(), name)


@pytest.mark.parametrize("spec,want", [
    ("", KernelConfig()),
    ("+attn_v2,+pallas_dense", KernelConfig(attn_v2=True, pallas_dense=True)),
    ("attn_v2", KernelConfig(attn_v2=True)),
    (" +pallas_dense , -attn_v2 ,", KernelConfig(pallas_dense=True)),
    ("+attn_v2,-attn_v2", KernelConfig()),
])
def test_env_parsing(monkeypatch, spec, want):
    monkeypatch.setenv("I360_KERNELS", spec)
    reset_kernel_config()
    assert kernel_config() == want


def test_env_is_read_once_until_reset(monkeypatch):
    assert kernel_config().attn_v2 is False
    monkeypatch.setenv("I360_KERNELS", "+attn_v2")
    assert kernel_config().attn_v2 is False
    reset_kernel_config()
    assert kernel_config().attn_v2 is True


@pytest.mark.parametrize("name", ["atn_v2", "flat_dense", "flat_proj", "conv1x1_matmul",
                                  "gn_mmstats", "flax_gn", "attn_v1", "interpret", "packed",
                                  "mh_flash", "shared_bias", "einsum_bwd", "pallas"])
def test_unknown_or_unported_switch_raises(monkeypatch, name):
    """A typo, and every JAX switch that selects no kernel of the port."""
    monkeypatch.setenv("I360_KERNELS", f"+{name}")
    reset_kernel_config()
    with pytest.raises(ValueError, match=f"unknown kernel switch '{name}'"):
        kernel_config()
    monkeypatch.delenv("I360_KERNELS")
    reset_kernel_config()
    with pytest.raises(ValueError, match="unknown kernel switch"):
        with configure(**{name: True}):
            pass
    assert kernel_config() == KernelConfig()


def test_configure_nests_and_restores():
    base = kernel_config()
    with configure(attn_v2=True) as outer:
        assert outer == kernel_config() == KernelConfig(attn_v2=True)
        with configure(pallas_dense=True):
            assert kernel_config() == KernelConfig(attn_v2=True, pallas_dense=True)
            with configure(attn_v2=False):
                assert kernel_config() == KernelConfig(pallas_dense=True)
            assert kernel_config() == KernelConfig(attn_v2=True, pallas_dense=True)
        assert kernel_config() == KernelConfig(attn_v2=True)
    assert kernel_config() is base


def test_configure_restores_after_an_exception():
    with pytest.raises(RuntimeError, match="boom"):
        with configure(attn_v2=True, pallas_dense=True):
            raise RuntimeError("boom")
    assert kernel_config() == KernelConfig()


# (label, (B, Sq, Sk, H, D), has_bias, route on CUDA by default, with attn_v2)
SITES = [
    ("pers_spatial_s0", (640, 1024, 1024, 5, 64), False, "single", "single"),
    ("pers_spatial_s1", (640, 256, 256, 10, 64), False, "single", "single"),
    ("pano_spatial_s0", (32, 8192, 8192, 5, 64), False, "mh_flash", "flash_t"),
    ("pano_spatial_s1", (32, 2048, 2048, 10, 64), False, "mh_flash", "flash_t"),
    ("pano_spatial_s2", (32, 512, 512, 20, 64), False, "single", "single"),
    ("pano_spatial_s3", (32, 128, 128, 20, 64), False, "single", "single"),
    ("pers_text_cross", (640, 1024, 77, 5, 64), False, "single", "single"),
    ("pano_text_cross_s0", (32, 8192, 77, 5, 64), False, "single", "single"),
    ("warp_r2_pano_q", (32, 2048, 5120, 10, 32), True, "shared_bias", "flash_t"),
    ("warp_r2_pers_q", (32, 5120, 2048, 10, 32), True, "shared_bias", "flash_t"),
    ("warp_r4_pano_q", (32, 512, 1280, 20, 32), True, "shared_bias", "flash_t"),
    ("warp_r4_pers_q", (32, 1280, 512, 20, 32), True, "shared_bias", "flash_t"),
    ("warp_r8_pano_q", (32, 128, 320, 40, 32), True, "shared_bias", "shared_bias"),
    ("warp_r8_pers_q", (32, 320, 128, 40, 32), True, "shared_bias", "shared_bias"),
    ("clip_text_causal", (2, 77, 77, 16, 64), True, "shared_bias", "shared_bias"),
    # a head dim of 128 or more fills a row: K6a is not for it
    ("vae_pano_encode", (16, 8192, 8192, 1, 512), False, "mh_flash", "mh_flash"),
    ("long_head_128", (4, 4096, 4096, 2, 128), False, "mh_flash", "mh_flash"),
    ("long_head_127", (4, 4096, 4096, 2, 127), False, "mh_flash", "flash_t"),
]


@pytest.mark.parametrize("label,shape,bias,off,on", SITES, ids=[s[0] for s in SITES])
def test_route_table_with_attn_v2_off_and_on(label, shape, bias, off, on):
    assert select_attention_route(*shape, bias, on_cuda=True) == off
    assert select_attention_route(*shape, bias, on_cuda=True,
                                  cfg=KernelConfig(attn_v2=True)) == on
    with configure(attn_v2=True):
        assert select_attention_route(*shape, bias, on_cuda=True) == on
        # the cfg argument wins over the active config: a pure function
        assert select_attention_route(*shape, bias, on_cuda=True, cfg=KernelConfig()) == off
    assert select_attention_route(*shape, bias, on_cuda=True) == off
    # pallas_dense is no attention switch
    assert select_attention_route(*shape, bias, on_cuda=True,
                                  cfg=KernelConfig(pallas_dense=True)) == off


# no streaming kernel under grad takes a head dim above 160
GRAD_SITES = [s for s in SITES if s[1][4] <= 160]


@pytest.mark.parametrize("label,shape,bias,off,on", GRAD_SITES, ids=[s[0] for s in GRAD_SITES])
def test_attn_v2_changes_nothing_under_grad(label, shape, bias, off, on):
    """K6a writes no lse and has no backward: the trained sites keep K3 with
    lse and K5a."""
    want = select_attention_route(*shape, bias, on_cuda=True, needs_grad=True)
    assert want in ("single", "shared_bias", "flash_lse")
    assert select_attention_route(*shape, bias, on_cuda=True, needs_grad=True,
                                  cfg=KernelConfig(attn_v2=True)) == want


def test_cpu_route_under_attn_v2_walks_the_same_branch():
    """On the CPU a "flash_t" site runs K6a's plain version; every other
    site the plain einsum, as with the switch off."""
    for _, shape, bias, _, on in SITES:
        got = select_attention_route(*shape, bias, on_cuda=False,
                                     cfg=KernelConfig(attn_v2=True))
        assert got == "flash_t" if on == "flash_t" else got in ("einsum", "chunked")
        assert select_attention_route(*shape, bias, on_cuda=False) in ("einsum", "chunked")


def test_configure_changes_the_calls_inside_it_and_only_those():
    """The config is read at call time: the same tensors take K6a's plain
    version inside the block and the plain einsum outside, and a
    non-broadcast bias is taken through its strides."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 256, 2, 16, generator=g)
    k, v = (torch.randn(2, 300, 2, 16, generator=g) for _ in range(2))
    bias = torch.randn(2, 1, 256, 300, generator=g)
    tattn.reset_counts()
    want = tattn.dot_product_attention(q, k, v, bias=bias)
    assert tattn.kernels.flash_attention_t.plain_calls == 0
    with configure(attn_v2=True):
        got = tattn.dot_product_attention(q, k, v, bias=bias)
    assert tattn.kernels.flash_attention_t.plain_calls == 1
    tattn.dot_product_attention(q, k, v, bias=bias)
    assert tattn.kernels.flash_attention_t.plain_calls == 1
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert dispatch.kernel_config() == KernelConfig()
