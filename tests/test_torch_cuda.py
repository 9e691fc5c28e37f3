"""Each hand-written CUDA kernel against its plain PyTorch version on the
card, at small ragged shapes, in float32 (1e-4 abs: same arithmetic, other
summation order) and bfloat16 (2e-2 abs, unit-scale inputs; dq, dk and dv
also within 2**-7 of their largest element), the backward kernels and the
autograd functions around them included.

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
        "frame_attention": 1, "flash_attention_lse": 0, "flash_bwd_dq": 0,
        "flash_bwd_dkv": 0}
    assert tattn.plain_path_calls() == 0


# K5a, K5b, K5c and K3's lse: (q shape [B, Sq, H, D], Sk, bias shape or None);
# ragged Sq/Sk, every head-dim bucket, each kind of bias broadcast
STREAMING_CASES = [
    ((2, 200, 3, 32), 333, None),
    ((2, 130, 2, 64), 1100, (1, 1, 130, 1100)),
    ((3, 70, 2, 16), 150, (3, 2, 70, 150)),
    ((2, 65, 3, 40), 129, (1, 3, 65, 129)),
    ((2, 64, 2, 96), 64, (2, 1, 64, 64)),
    ((1, 100, 1, 160), 90, None),
    ((1, 50, 2, 128), 260, (1, 1, 50, 260)),
]


def _streaming_inputs(dev, dtype, qs, Sk, bias_shape, seed=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    B, Sq, H, D = qs
    q = torch.randn(qs, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(B, Sk, H, D, generator=g, device=dev).to(dtype) for _ in range(2))
    do = torch.randn(qs, generator=g, device=dev).to(dtype)
    bias = None if bias_shape is None else torch.randn(bias_shape, generator=g, device=dev)
    return q, k, v, do, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qs,Sk,bias_shape", STREAMING_CASES)
def test_streaming_forward_backward_kernels_on_card(cuda_device, dtype, qs, Sk, bias_shape):
    """K5a (out and lse), K5b (dq) and K5c (dk, dv) against their plain
    versions; the backward kernels read the lse of the K5a kernel."""
    q, k, v, do, bias = _streaming_inputs(cuda_device, dtype, qs, Sk, bias_shape)
    scale = qs[-1] ** -0.5
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    out, lse = kernels.flash_attention_lse(q, k, v, bias, scale=scale)
    want_out, want_lse = kernels.flash_attention_lse_plain(q, k, v, bias, scale=scale)
    torch.cuda.synchronize()
    assert (out.float() - want_out.float()).abs().max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= 1e-4
    delta = kernels.attention_delta(do, out)
    dq = kernels.flash_bwd_dq(q, k, v, bias, do, lse, delta, scale=scale)
    dk, dv = kernels.flash_bwd_dkv(q, k, v, bias, do, lse, delta, scale=scale)
    want_dq = kernels.flash_bwd_dq_plain(q, k, v, bias, do, lse, delta, scale=scale)
    want_dk, want_dv = kernels.flash_bwd_dkv_plain(q, k, v, bias, do, lse, delta, scale=scale)
    torch.cuda.synchronize()
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == dtype and torch.isfinite(got).all()
        # a bf16 gradient: also within 2 bf16 ulps of its largest element
        limit = tol if dtype == torch.float32 else min(tol, 2 ** -7 * want.abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= limit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shared_bias_lse_on_card(cuda_device, dtype):
    """K3 with its lse output: the output is bit for bit the one without,
    the lse agrees with the plain version, and the launch is counted."""
    q, k, v, _, bias = _streaming_inputs(cuda_device, dtype, (2, 200, 3, 32), 333,
                                         (1, 1, 200, 333))
    tattn.reset_counts()
    out, lse = kernels.shared_bias_attention(q, k, v, bias[0, 0], scale=0.2, with_lse=True)
    alone = kernels.shared_bias_attention(q, k, v, bias[0, 0], scale=0.2)
    _, want_lse = kernels.shared_bias_attention_plain(q, k, v, bias[0, 0], scale=0.2,
                                                      with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, alone)
    assert lse.shape == (2, 3, 200) and (lse - want_lse).abs().max().item() <= 1e-4
    assert kernels.lse_counts() == {"shared_bias_attention": 1}
    assert kernels.shared_bias_attention.launches == 2


@pytest.mark.cuda
def test_gradients_through_kernels_on_card(cuda_device):
    """Under grad the entry points take K3 with lse / K5a forward and K5b +
    K5c backward at the long sites, K1 and K4 forward with the
    einsum-reference backward at the short ones, never K2 and never a plain
    path; the gradients agree with autograd through the plain reference
    (f32, 1e-4 abs)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)

    def leaf(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).requires_grad_()

    q, k, v = leaf(2, 40, 2, 16), leaf(2, 2000, 2, 16), leaf(2, 2000, 2, 16)
    bias = torch.randn(1, 1, 40, 2000, generator=g, device=cuda_device)
    x = [leaf(1, 4, 9, 16) for _ in range(3)]

    def loss(attend, temporal):
        out = (attend(q, q, q).sum() + (attend(q, k, v) ** 2).sum()
               + (attend(q, k, v, bias) ** 2).sum() + (temporal(*x) ** 2).sum())
        return torch.autograd.grad(out, [q, k, v, *x])

    tattn.reset_counts()
    got = loss(tattn.dot_product_attention,
               lambda a, b, c: tattn.temporal_attention(a, b, c, heads=2))
    torch.cuda.synchronize()
    launches = {n: c["launches"] for n, c in kernels.counts().items()}
    assert launches == {"tiny_attention": 1, "mh_flash_attention": 0,
                        "shared_bias_attention": 1, "frame_attention": 1,
                        "flash_attention_lse": 1, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert kernels.lse_counts() == {"shared_bias_attention": 1}
    assert tattn.plain_path_calls() == 0 and tattn.einsum_backward_calls() == 2
    want = loss(lambda a, b, c, bb=None: kernels.reference_attention(a, b, c, bias=bb),
                lambda a, b, c: kernels.frame_attention_plain(a, b, c, scale=8 ** -0.5,
                                                              heads=2))
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4
