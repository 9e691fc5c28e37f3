"""Each hand-written CUDA kernel against its plain PyTorch version on the
card, at small ragged shapes, in float32 (1e-4 abs: same arithmetic, other
summation order) and bfloat16 (2e-2 abs, unit-scale inputs).

Marked `cuda`: they skip where torch.cuda.is_available() is false. This
file imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from imagine360_tpu_torch.ops import attention as tattn
from imagine360_tpu_torch.ops import kernels


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU mode)")
    return torch.device("cuda")


CARD_CASES = [  # (wrapper, q shape, k shape, heads, with bias)
    ("tiny_attention", (3, 100, 2 * 40), (3, 77, 2 * 40), 2, False),
    ("tiny_attention", (2, 64, 4 * 4), (2, 1024, 4 * 4), 4, True),
    ("mh_flash_attention", (2, 300, 3 * 64), (2, 1500, 3 * 64), 3, False),
    ("shared_bias_attention", (2, 200, 3, 32), (2, 333, 3, 32), 3, True),
    ("frame_attention", (2, 16, 33, 8 * 80), None, 8, False),
    ("frame_attention", (1, 5, 7, 2 * 160), None, 2, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,qs,ks,heads,with_bias", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda_device, dtype, name, qs, ks, heads, with_bias):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    ks = ks or qs
    q = torch.randn(qs, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(ks, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(ks, generator=g, device=cuda_device).to(dtype)
    fn = getattr(kernels, name)
    plain = getattr(kernels, name + "_plain")
    D = qs[-1] // heads if len(qs) == 3 or name == "frame_attention" else qs[-1]
    kw = {"scale": D ** -0.5}
    if name != "shared_bias_attention":
        kw["heads"] = heads
    args = (q, k, v)
    if with_bias:
        args += (torch.randn(qs[1], ks[1], generator=g, device=cuda_device),)
    got = fn(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_entry_points_launch_kernels_on_card(cuda_device):
    """dot_product_attention / temporal_attention on CUDA tensors go to the
    kernels and never to a plain path."""
    tattn.reset_counts()
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn(2, 40, 2, 16, generator=g, device=cuda_device)
    k = torch.randn(2, 2000, 2, 16, generator=g, device=cuda_device)
    bias = torch.randn(1, 1, 40, 2000, generator=g, device=cuda_device)
    tattn.dot_product_attention(q, q, q)
    tattn.dot_product_attention(q, k, k)
    tattn.dot_product_attention(q, k, k, bias=bias)
    x = torch.randn(1, 4, 9, 16, generator=g, device=cuda_device)
    tattn.temporal_attention(x, x, x, heads=2)
    torch.cuda.synchronize()
    assert {n: c["launches"] for n, c in kernels.counts().items()} == {
        "tiny_attention": 1, "mh_flash_attention": 1, "shared_bias_attention": 1,
        "frame_attention": 1}
    assert tattn.plain_path_calls() == 0
