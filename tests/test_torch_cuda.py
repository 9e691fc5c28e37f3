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
    # head dims above 160: the wide kernels (the VAE's one head of 512)
    ("tiny_attention", (3, 100, 512), (3, 200, 512), 1, False),
    ("tiny_attention", (2, 50, 2 * 200), (2, 1000, 2 * 200), 2, True),
    ("mh_flash_attention", (2, 100, 512), (2, 1100, 512), 1, False),
    ("mh_flash_attention", (1, 70, 2 * 300), (1, 1300, 2 * 300), 2, False),
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_causal_minus_inf_bias_on_card(cuda_device, dtype):
    """The CLIP text encoder's site: 77 tokens (no multiple of any tile), 16
    heads of 64, and a causal bias that is -inf above the diagonal. K3 gives
    exact zeros there, as the plain softmax does."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn(2, 77, 16, 64, generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    bias = torch.full((77, 77), float("-inf"), device=cuda_device).triu(1)
    got = kernels.shared_bias_attention(q, k, v, bias, scale=0.125)
    want = kernels.shared_bias_attention_plain(q, k, v, bias, scale=0.125)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    # the first token sees only itself
    assert torch.equal(got[:, 0], v[:, 0])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_wide_launches_counted_on_card(cuda_device):
    """Head dim 512 goes to the wide kernels of K1 and K2 and is counted
    there; head dim 64 is not."""
    tattn.reset_counts()
    g = torch.Generator(device=cuda_device).manual_seed(3)
    for D in (64, 512):
        q = torch.randn(1, 40, 1, D, generator=g, device=cuda_device)
        k = torch.randn(1, 1100, 1, D, generator=g, device=cuda_device)
        tattn.dot_product_attention(q, q, q)
        tattn.dot_product_attention(q, k, k)
    torch.cuda.synchronize()
    assert kernels.wide_counts() == {"tiny_attention": 1, "mh_flash_attention": 1}
    assert kernels.tiny_attention.launches == 2 and kernels.mh_flash_attention.launches == 2
    assert tattn.plain_path_calls() == 0


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
