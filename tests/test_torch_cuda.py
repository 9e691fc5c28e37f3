"""Each hand-written CUDA kernel against its plain PyTorch version on the
card, at small ragged shapes, in float32 (1e-4 abs: same arithmetic, other
summation order) and bfloat16 (2e-2 abs, unit-scale inputs; dq, dk and dv
also within 2**-7 of their largest element), the backward kernels and the
autograd functions around them included.

Marked `cuda`: they skip where torch.cuda.is_available() is false. This
file imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import os
import sys

import pytest
import torch

from imagine360_tpu_torch.ops import attention as tattn
from imagine360_tpu_torch.ops import kernels
from imagine360_tpu_torch.ops.dispatch import KernelConfig, configure, kernel_config

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU mode)")
    return torch.device("cuda")


# the opt-in kernels launch only behind their switches or their own entry
# point, the lab variants of K4 only through the lab
OPT_IN_IDLE = {"flash_attention_t": 0, "shared_bias_attention_folded": 0, "dense_matmul": 0,
               "striped_v2_attention": 0, "fused_motion_attention": 0,
               "diag_motion_attention": 0}

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
    there; head dim 64 is not. In float32 no launch takes the tensor cores;
    in bfloat16 every one does, the wide ones included, and they are counted
    in both `wide_counts` and `tc_counts`."""
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
    # float32: none of them on the tensor cores
    assert kernels.tc_counts() == {"tiny_attention": 0, "mh_flash_attention": 0,
                                   "shared_bias_attention": 0, "frame_attention": 0,
                                   "flash_attention_lse": 0, "flash_bwd_dq": 0,
                                   "flash_bwd_dkv": 0, "flash_attention_t": 0,
                                   "shared_bias_attention_folded": 0, "dense_matmul": 0}
    assert tattn.plain_path_calls() == 0
    for D in (64, 512):
        q = torch.randn(1, 40, 1, D, generator=g, device=cuda_device).bfloat16()
        k = torch.randn(1, 1100, 1, D, generator=g, device=cuda_device).bfloat16()
        tattn.dot_product_attention(q, q, q)
        tattn.dot_product_attention(q, k, k)
    torch.cuda.synchronize()
    assert kernels.wide_counts() == {"tiny_attention": 2, "mh_flash_attention": 2}
    assert kernels.tiny_attention.launches == 4 and kernels.mh_flash_attention.launches == 4
    tc = kernels.tc_counts()
    assert tc["tiny_attention"] == 2 and tc["mh_flash_attention"] == 2
    assert sum(tc.values()) == 4
    assert tattn.plain_path_calls() == 0


# K1 and K2 in bfloat16 on the tensor cores (csrc/attn_mma.cuh): every
# head-dim bucket, D = 4 and 40 padded with zero columns (D = 4 also staged
# with 2-byte loads, as are inputs whose pointers are not 16-byte aligned),
# ragged query and key tails; K1 without a bias, with a random one and with
# a causal -inf one. Above D = 160 the wide tile (csrc/attn_mma_wide.cuh):
# both buckets (256, 512), D = 161 and 200 staged with 2-byte accesses, K1
# without and with a random bias. (wrapper, D, Sq, Sk, bias or "misaligned")
TC_DIMS = (4, 16, 32, 40, 64, 96, 128, 160)
TC_WIDE_DIMS = (161, 192, 200, 256, 320, 512)
TC_SQ = (1, 15, 17, 63, 65, 333)
TC_K1_SK = (1, 16, 64, 77, 1000, 1024)
TC_K2_SK = (1025, 3001)
TC_CASES = (
    [("tiny_attention", D, TC_SQ[i % 6], TC_K1_SK[i % 6], "none")
     for i, D in enumerate(TC_DIMS)]
    + [("tiny_attention", D, TC_SQ[(i + 2) % 6], TC_K1_SK[(i + 3) % 6], "random")
       for i, D in enumerate(TC_DIMS)]
    + [("tiny_attention", D, Sq, Sk, "causal")
       for D, Sq, Sk in ((64, 333, 1000), (40, 65, 77), (16, 17, 1024), (4, 15, 16))]
    + [("mh_flash_attention", D, TC_SQ[(i + 3) % 6], TC_K2_SK[i % 2], "none")
       for i, D in enumerate(TC_DIMS)]
    + [("tiny_attention", 64, 65, 77, "misaligned"),
       ("mh_flash_attention", 64, 63, 1025, "misaligned")]
    + [("tiny_attention", D, TC_SQ[(i + 1) % 6], TC_K1_SK[(i + 4) % 6], mode)
       for i, D in enumerate(TC_WIDE_DIMS) for mode in ("none", "random")]
    + [("mh_flash_attention", D, TC_SQ[(i + 4) % 6], TC_K2_SK[i % 2], "none")
       for i, D in enumerate(TC_WIDE_DIMS)]
    + [("tiny_attention", 512, 333, 1024, "misaligned"),
       ("mh_flash_attention", 256, 65, 3001, "misaligned")])


def _misaligned(x):
    """A contiguous copy of x whose data starts one element past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    return buf[1:].view(x.shape).copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("name,D,Sq,Sk,mode", TC_CASES)
def test_tensor_core_attention_on_card(cuda_device, name, D, Sq, Sk, mode):
    """bfloat16 against the plain version within chip_smoke.py's phase-2
    limit, min(2e-2, 2**-5 x max|plain|), counted in `tc_launches`; the
    same inputs in float32 take the CUDA-core kernel (1e-4) and are not."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    B, H = 2, 2

    def rnd(S):
        x = torch.randn(B, S, H * D, generator=g, device=cuda_device).bfloat16()
        return _misaligned(x) if mode == "misaligned" else x

    q, k, v = rnd(Sq), rnd(Sk), rnd(Sk)
    bias = None
    if mode == "random":
        bias = torch.rand(Sq, Sk, generator=g, device=cuda_device) * 2 - 1
    elif mode == "causal":
        bias = torch.full((Sq, Sk), float("-inf"), device=cuda_device).triu(1)
    fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    extra = (bias,) if name == "tiny_attention" else ()
    kw = dict(scale=D ** -0.5, heads=H)
    tattn.reset_counts()
    got = fn(q, k, v, *extra, **kw)
    want = plain(q, k, v, *extra, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    peak = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    assert kernels.tc_counts()[name] == fn.launches == 1
    q32, k32, v32 = q.float(), k.float(), v.float()
    got32 = fn(q32, k32, v32, *extra, **kw)
    want32 = plain(q32, k32, v32, *extra, **kw)
    torch.cuda.synchronize()
    assert (got32 - want32).abs().max().item() <= 1e-4
    assert fn.launches == 2 and kernels.tc_counts()[name] == 1
    assert tattn.plain_path_calls() == 0


# K3 and K5a in bfloat16 on the tensor cores (csrc/attn_mma.cuh, K3 with two
# problems a block under one staged bias tile, K5a with P split into bf16
# hi + lo): every head-dim bucket, ragged Sq and Sk (77 keys: the 4-byte
# bias copies), K3 under a random and a causal -inf bias, K5a without a bias
# and with both; "misaligned": q, k, v and the bias 2 or 4 bytes past a
# 16-byte boundary (2-byte tiles, 4-byte bias copies). (wrapper, D, Sq, Sk,
# mode)
TC_STREAM_SQ_SK = ((77, 77), (333, 1000), (1000, 3001), (3001, 333))
TC_STREAM_CASES = (
    [("shared_bias_attention", D, *TC_STREAM_SQ_SK[i % 4], "random")
     for i, D in enumerate(TC_DIMS)]
    + [("shared_bias_attention", D, Sq, Sk, "causal")
       for D, Sq, Sk in ((64, 77, 77), (32, 333, 333), (4, 1000, 1000))]
    + [("flash_attention_lse", D, *TC_STREAM_SQ_SK[(i + 1) % 4], "none")
       for i, D in enumerate(TC_DIMS)]
    + [("flash_attention_lse", 64, 333, 1000, "random"),
       ("flash_attention_lse", 40, 77, 77, "causal"),
       ("shared_bias_attention", 32, 333, 1000, "misaligned"),
       ("flash_attention_lse", 64, 1000, 333, "misaligned")])


@pytest.mark.cuda
@pytest.mark.parametrize("name,D,Sq,Sk,mode", TC_STREAM_CASES)
def test_tensor_core_streaming_on_card(cuda_device, name, D, Sq, Sk, mode):
    """bfloat16 against the plain version within chip_smoke.py's phase-2
    limits, min(2e-2, 2**-5 x max|plain|) and 1e-4 for the lse, counted in
    `tc_launches`; K3's output with its lse equal bit for bit to the one
    without; the same inputs in float32 take the CUDA-core kernel (1e-4)
    and are not counted."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    B, H = 2, 2
    fix = _misaligned if mode == "misaligned" else (lambda x: x)
    q, k, v = (fix(torch.randn(B, S, H, D, generator=g, device=cuda_device).bfloat16())
               for S in (Sq, Sk, Sk))
    bias = None
    if mode in ("random", "misaligned"):
        bias = fix(torch.rand(Sq, Sk, generator=g, device=cuda_device) * 2 - 1)
    elif mode == "causal":
        bias = torch.full((Sq, Sk), float("-inf"), device=cuda_device).triu(1)
    shared = name == "shared_bias_attention"
    fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    kw = dict(scale=D ** -0.5)
    if shared:
        kw["with_lse"] = True
    else:
        bias = None if bias is None else bias[None, None]
    tattn.reset_counts()
    out, lse = fn(q, k, v, bias, **kw)
    want, want_lse = plain(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    peak = want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    launches = 1
    if shared:
        assert torch.equal(out, fn(q, k, v, bias, scale=D ** -0.5))
        launches = 2
    assert kernels.tc_counts()[name] == fn.launches == launches
    q32, k32, v32 = q.float(), k.float(), v.float()
    out32, lse32 = fn(q32, k32, v32, bias, **kw)
    want32, want_lse32 = plain(q32, k32, v32, bias, **kw)
    torch.cuda.synchronize()
    assert (out32 - want32).abs().max().item() <= 1e-4
    assert (lse32 - want_lse32).abs().max().item() <= 1e-4
    assert fn.launches == launches + 1 and kernels.tc_counts()[name] == launches
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 96, 128, 160])
def test_shared_bias_ragged_group_on_card(cuda_device, D):
    """K3 in bfloat16 at every head-dim bucket, at 5 (batch, head) problems
    and 333 keys (full 64-key tiles, the most shared memory a block takes):
    two problems a block up to D = 64 leave a ragged last group, which
    stores nothing. The output and the lse are within the plain version's
    limits, the output with the lse equals the one without bit for bit, and
    both launches took the tensor cores."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    B, H, Sq, Sk = 1, 5, 130, 333
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda_device).bfloat16()
    k, v = (torch.randn(B, Sk, H, D, generator=g, device=cuda_device).bfloat16()
            for _ in range(2))
    bias = torch.rand(Sq, Sk, generator=g, device=cuda_device) * 2 - 1
    kw = dict(scale=D ** -0.5)
    want, want_lse = kernels.shared_bias_attention_plain(q, k, v, bias, with_lse=True, **kw)
    tattn.reset_counts()
    out, lse = kernels.shared_bias_attention(q, k, v, bias, with_lse=True, **kw)
    alone = kernels.shared_bias_attention(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    peak = want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    assert torch.equal(out, alone)
    assert kernels.tc_counts()["shared_bias_attention"] == 2
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("Sk", [2048, 8192])
@pytest.mark.parametrize("bias", ["none", "random"])
def test_flash_lse_output_matches_plain_on_card(cuda_device, Sk, bias):
    """K5a in bfloat16 at the keys and head dim of the training sites: its
    output equals the plain version's (float32 probabilities, one rounding
    to bf16) bit for bit in at least chip_smoke.K5A_MATCH of the elements,
    which P rounded once to bf16 does not reach (59%,
    tests/test_torch_flash_lse_split.py); this is what the split of P into
    bf16 hi + lo buys."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    B, Sq, H, D = 1, 256, 2, 64
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda_device).bfloat16()
    k, v = (torch.randn(B, Sk, H, D, generator=g, device=cuda_device).bfloat16()
            for _ in range(2))
    b = None
    if bias == "random":
        b = torch.rand(1, 1, Sq, Sk, generator=g, device=cuda_device) * 2 - 1
    tattn.reset_counts()
    out, _ = kernels.flash_attention_lse(q, k, v, b, scale=D ** -0.5)
    want, _ = kernels.flash_attention_lse_plain(q, k, v, b, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert (out == want).float().mean().item() >= chip_smoke.K5A_MATCH
    assert kernels.tc_counts()["flash_attention_lse"] == 1


# K6a in bfloat16 on the tensor cores (csrc/flash_t.cu on the body of
# csrc/attn_mma.cuh with sequence-minor tiles, P split into bf16 hi + lo): head
# dims 4 to 160 (D = 4, 8, 40 and 96 padded with zero rows), ragged Sq or Sk
# (not multiples of 8: 2-byte staging), the 16-byte path where Sq, Sk and D
# are multiples of 8, a bias per batch row, per head, per both or shared;
# "misaligned": q, k, v 2 bytes past a 16-byte boundary (2-byte staging).
# (B, H, D, Sq, Sk, bias shape or None, mode)
TC_T_CASES = [
    (2, 2, 8, 77, 333, (1, 1, 77, 333), ""),
    (2, 3, 40, 64, 1000, (2, 1, 64, 1000), ""),
    (1, 2, 96, 130, 200, (1, 2, 130, 200), ""),
    (2, 2, 160, 200, 328, None, ""),
    (2, 2, 16, 1000, 3001, None, ""),
    (2, 2, 32, 256, 512, (2, 2, 256, 512), ""),
    (1, 2, 64, 1024, 2048, None, ""),
    (2, 2, 128, 65, 129, (1, 1, 65, 129), ""),
    (2, 2, 4, 64, 64, None, ""),
    (2, 2, 64, 64, 512, (1, 1, 64, 512), "misaligned"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,D,Sq,Sk,bias_shape,mode", TC_T_CASES)
def test_tensor_core_flash_t_on_card(cuda_device, B, H, D, Sq, Sk, bias_shape, mode):
    """K6a in bfloat16 against its plain version within chip_smoke.py's
    phase-2 limit, min(2e-2, 2**-5 x max|plain|), counted in `tc_launches`;
    the same inputs in float32 take the CUDA-core kernel (1e-4) and are
    not."""
    g = torch.Generator(device=cuda_device).manual_seed(14)
    fix = _misaligned if mode == "misaligned" else (lambda x: x)
    q, k, v = (fix(torch.randn(B, H, D, S, generator=g, device=cuda_device).bfloat16())
               for S in (Sq, Sk, Sk))
    bias = None if bias_shape is None else torch.randn(bias_shape, generator=g,
                                                       device=cuda_device)
    tattn.reset_counts()
    got = kernels.flash_attention_t(q, k, v, bias, scale=D ** -0.5)
    want = kernels.flash_attention_t_plain(q, k, v, bias, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == (B, H, Sq, D) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    peak = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    assert kernels.tc_counts()["flash_attention_t"] == kernels.flash_attention_t.launches == 1
    q32, k32, v32 = q.float(), k.float(), v.float()
    got32 = kernels.flash_attention_t(q32, k32, v32, bias, scale=D ** -0.5)
    want32 = kernels.flash_attention_t_plain(q32, k32, v32, bias, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert (got32 - want32).abs().max().item() <= 1e-4
    assert kernels.flash_attention_t.launches == 2
    assert kernels.tc_counts()["flash_attention_t"] == 1
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("D,Sk,bias", [(64, 2048, False), (64, 8192, False), (32, 5120, True),
                                       (32, 2048, True)])
def test_flash_t_output_matches_plain_on_card(cuda_device, D, Sk, bias):
    """K6a in bfloat16 at the keys and head dims of its phase-2 sites (the
    WarpAttn ones with a uniform [-1, 1) bias): its output equals the plain
    version's (float32 probabilities, one rounding to bf16) bit for bit in
    at least chip_smoke.K5A_MATCH of the elements, as K5a's does."""
    g = torch.Generator(device=cuda_device).manual_seed(15)
    B, H, Sq = 1, 2, 256
    q = torch.randn(B, H, D, Sq, generator=g, device=cuda_device).bfloat16()
    k, v = (torch.randn(B, H, D, Sk, generator=g, device=cuda_device).bfloat16()
            for _ in range(2))
    b = None
    if bias:
        b = torch.rand(1, 1, Sq, Sk, generator=g, device=cuda_device) * 2 - 1
    tattn.reset_counts()
    out = kernels.flash_attention_t(q, k, v, b, scale=D ** -0.5)
    want = kernels.flash_attention_t_plain(q, k, v, b, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert (out == want).float().mean().item() >= chip_smoke.K5A_MATCH
    assert kernels.tc_counts()["flash_attention_t"] == 1


# K5b and K5c in bfloat16 on the tensor cores (csrc/flash_bwd_dq.cu and
# csrc/flash_bwd_dkv.cu on the tiles of csrc/attn_mma_bwd.cuh, dS and for
# K5c P split into bf16 hi + lo): head dims 4 to 160 (D = 4 staged with
# 2-byte accesses, as are misaligned pointers), ragged Sq and Sk, a bias per
# batch row, per head, per both or shared (77 keys: 4-byte bias copies), and
# a row whose every key is masked with -inf ("masked": its lse is the
# floored -1e30, its P and dS 0).
# (q shape [B, Sq, H, D], Sk, bias shape or None, mode)
TC_BWD_CASES = [
    ((2, 77, 2, 8), 333, (1, 1, 77, 333), ""),
    ((2, 200, 3, 40), 1000, (2, 1, 200, 1000), ""),
    ((1, 130, 2, 96), 200, (1, 2, 130, 200), ""),
    ((2, 100, 1, 160), 90, None, ""),
    ((2, 300, 2, 32), 1100, (2, 2, 300, 1100), ""),
    ((2, 64, 2, 64), 64, None, ""),
    ((1, 1000, 2, 16), 77, (1, 1, 1000, 77), ""),
    ((2, 65, 2, 128), 129, None, ""),
    ((2, 70, 2, 4), 150, None, ""),
    ((2, 130, 2, 64), 333, (1, 1, 130, 333), "misaligned"),
    ((2, 100, 2, 64), 300, (1, 1, 100, 300), "masked"),
    ((1, 90, 2, 160), 140, (1, 1, 90, 140), "masked"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("qs,Sk,bias_shape,mode", TC_BWD_CASES)
def test_tensor_core_flash_bwd_dkv_on_card(cuda_device, qs, Sk, bias_shape, mode):
    """K5c in bfloat16 against its plain version on the lse and delta of the
    plain forward, dk and dv each within min(2e-2, 2**-7 x max|plain|) (the
    phase-2 limit is the second), finite, counted in `tc_launches`; the
    same inputs in float32 take the CUDA-core kernel (1e-4) and are not."""
    q, k, v, do, bias = _streaming_inputs(cuda_device, torch.bfloat16, qs, Sk, bias_shape,
                                          seed=16)
    if mode == "masked":
        bias[..., 5, :] = float("-inf")
    if mode == "misaligned":
        q, k, v, do, bias = map(_misaligned, (q, k, v, do, bias))
    scale = qs[-1] ** -0.5

    def grads(q, k, v, do):
        out, lse = kernels.flash_attention_lse_plain(q, k, v, bias, scale=scale)
        if mode == "masked":
            assert (lse[:, :, 5] == -1e30).all()
        delta = kernels.attention_delta(do, out)
        args = (q, k, v, bias, do, lse, delta)
        return (kernels.flash_bwd_dkv(*args, scale=scale),
                kernels.flash_bwd_dkv_plain(*args, scale=scale))

    tattn.reset_counts()
    got, want = grads(q, k, v, do)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
        peak = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= min(2e-2, 2 ** -7 * peak)
    assert kernels.tc_counts()["flash_bwd_dkv"] == kernels.flash_bwd_dkv.launches == 1
    got32, want32 = grads(q.float(), k.float(), v.float(), do.float())
    torch.cuda.synchronize()
    for a, b in zip(got32, want32):
        assert (a - b).abs().max().item() <= 1e-4
    assert kernels.flash_bwd_dkv.launches == 2 and kernels.tc_counts()["flash_bwd_dkv"] == 1
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("qs,Sk,bias_shape,mode", TC_BWD_CASES)
def test_tensor_core_flash_bwd_dq_on_card(cuda_device, qs, Sk, bias_shape, mode):
    """K5b in bfloat16 against its plain version on the lse and delta of the
    plain forward, dq within min(2e-2, 2**-7 x max|plain|) (the phase-2
    limit is the second), finite, 0 in a fully masked row, counted in
    `tc_launches`; the same inputs in float32 take the CUDA-core kernel
    (1e-4) and are not."""
    q, k, v, do, bias = _streaming_inputs(cuda_device, torch.bfloat16, qs, Sk, bias_shape,
                                          seed=17)
    if mode == "masked":
        bias[..., 5, :] = float("-inf")
    if mode == "misaligned":
        q, k, v, do, bias = map(_misaligned, (q, k, v, do, bias))
    scale = qs[-1] ** -0.5

    def grads(q, k, v, do):
        out, lse = kernels.flash_attention_lse_plain(q, k, v, bias, scale=scale)
        if mode == "masked":
            assert (lse[:, :, 5] == -1e30).all()
        delta = kernels.attention_delta(do, out)
        args = (q, k, v, bias, do, lse, delta)
        return (kernels.flash_bwd_dq(*args, scale=scale),
                kernels.flash_bwd_dq_plain(*args, scale=scale))

    tattn.reset_counts()
    got, want = grads(q, k, v, do)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    peak = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -7 * peak)
    if mode == "masked":
        assert (got[:, 5] == 0).all()
    assert kernels.tc_counts()["flash_bwd_dq"] == kernels.flash_bwd_dq.launches == 1
    got32, want32 = grads(q.float(), k.float(), v.float(), do.float())
    torch.cuda.synchronize()
    assert (got32 - want32).abs().max().item() <= 1e-4
    assert kernels.flash_bwd_dq.launches == 2 and kernels.tc_counts()["flash_bwd_dq"] == 1
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
        "flash_bwd_dkv": 0, **OPT_IN_IDLE}
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
@pytest.mark.parametrize("qs,Sk,bias_shape", STREAMING_CASES)
def test_tensor_core_flash_lse_bias_shapes_on_card(cuda_device, qs, Sk, bias_shape):
    """K5a in bfloat16 at every bias shape of STREAMING_CASES
    (each broadcast of [1|B, 1|H, Sq, Sk]) within the phase-2 limits, on the
    tensor cores."""
    q, k, v, _, bias = _streaming_inputs(cuda_device, torch.bfloat16, qs, Sk, bias_shape)
    scale = qs[-1] ** -0.5
    tattn.reset_counts()
    out, lse = kernels.flash_attention_lse(q, k, v, bias, scale=scale)
    want, want_lse = kernels.flash_attention_lse_plain(q, k, v, bias, scale=scale)
    torch.cuda.synchronize()
    peak = want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    assert kernels.tc_counts()["flash_attention_lse"] == 1


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
                        "flash_attention_lse": 1, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                        **OPT_IN_IDLE}
    assert kernels.lse_counts() == {"shared_bias_attention": 1}
    assert tattn.plain_path_calls() == 0 and tattn.einsum_backward_calls() == 2
    want = loss(lambda a, b, c, bb=None: kernels.reference_attention(a, b, c, bias=bb),
                lambda a, b, c: kernels.frame_attention_plain(a, b, c, scale=8 ** -0.5,
                                                              heads=2))
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4


# ---- the opt-in kernels: K6a, K6b, K7 ----------------------------------------

# (B, H, D, Sq, Sk, bias shape or None): ragged Sq/Sk, every head-dim bucket
FLASH_T_CASES = [
    (2, 3, 32, 200, 333, None),
    (2, 2, 64, 130, 1100, (1, 1, 130, 1100)),
    (3, 2, 16, 70, 150, (3, 2, 70, 150)),
    (2, 3, 40, 65, 129, (1, 3, 65, 129)),
    (2, 2, 96, 64, 64, (2, 1, 64, 64)),
    (1, 1, 160, 100, 90, None),
    (1, 2, 128, 50, 260, (1, 1, 50, 260)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,D,Sq,Sk,bias_shape", FLASH_T_CASES)
def test_flash_attention_t_on_card(cuda_device, dtype, B, H, D, Sq, Sk, bias_shape):
    g = torch.Generator(device=cuda_device).manual_seed(6)
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda_device)
    q, k, v = rnd(B, H, D, Sq).to(dtype), rnd(B, H, D, Sk).to(dtype), rnd(B, H, D, Sk).to(dtype)
    bias = None if bias_shape is None else rnd(*bias_shape)
    got = kernels.flash_attention_t(q, k, v, bias, scale=D ** -0.5)
    want = kernels.flash_attention_t_plain(q, k, v, bias, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == (B, H, Sq, D) and got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,D,Sq,Sk,t_rows", [(6, 32, 200, 333, 4), (5, 64, 130, 1100, 2),
                                               (7, 16, 70, 150, 8), (3, 160, 65, 129, 4),
                                               (2, 96, 64, 64, 1), (600, 32, 100, 90, 8)])
def test_shared_bias_folded_on_card(cuda_device, dtype, bias_dtype, BH, D, Sq, Sk, t_rows):
    """Ragged BH groups, Sq and Sk; float32 and bfloat16 bias; with the lse."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda_device)
    q, k, v = rnd(BH, Sq, D).to(dtype), rnd(BH, Sk, D).to(dtype), rnd(BH, Sk, D).to(dtype)
    bias = rnd(Sq, Sk).to(bias_dtype)
    tattn.reset_counts()
    got, lse = kernels.shared_bias_attention_folded(q, k, v, bias, scale=D ** -0.5,
                                                    with_lse=True, t_rows=t_rows)
    alone = kernels.shared_bias_attention_folded(q, k, v, bias, scale=D ** -0.5,
                                                 t_rows=t_rows)
    want, want_lse = kernels.shared_bias_attention_folded_plain(q, k, v, bias, scale=D ** -0.5,
                                                                with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(got, alone)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert lse.shape == (BH, Sq) and (lse - want_lse).abs().max().item() <= 1e-4
    assert kernels.shared_bias_attention_folded.launches == 2
    assert kernels.shared_bias_attention_folded.lse_launches == 1


# K4 in bfloat16 on the tensor cores (csrc/frame_attention.cu): frame counts
# 1 to 64 (padded to 16: one to four key tiles), head dims 40, 80 and 160 of
# the motion modules and 1 and 37 (no multiple of 8: 2-byte staging), ragged
# HW (a last pack past HW where the plan packs several locations), inputs 2
# bytes past a 16-byte boundary (2-byte staging). (F, D, heads, HW, mode)
TC_FRAME_CASES = [(1, 40, 8, 33, ""), (5, 80, 4, 7, ""), (16, 160, 2, 65, ""),
                  (33, 40, 8, 9, ""), (64, 80, 2, 5, ""), (16, 1, 3, 17, ""),
                  (5, 37, 2, 11, ""), (16, 40, 8, 1000, ""), (16, 80, 8, 257, "misaligned"),
                  (33, 160, 1, 3, "misaligned")]


def _frame_inputs(device, F, D, heads, HW, mode, seed=11, B=2):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd():
        x = torch.randn(B, F, HW, heads * D, generator=g, device=device).bfloat16()
        return _misaligned(x) if mode == "misaligned" else x

    return rnd(), rnd(), rnd()


@pytest.mark.cuda
@pytest.mark.parametrize("F,D,heads,HW,mode", TC_FRAME_CASES)
def test_tensor_core_frame_attention_on_card(cuda_device, F, D, heads, HW, mode):
    """bfloat16 against the plain version within chip_smoke.py's phase-2
    limit, min(2e-2, 2**-5 x max|plain|), counted in `tc_launches`; the
    same inputs in float32 take the CUDA-core kernel (1e-4) and are not."""
    q, k, v = _frame_inputs(cuda_device, F, D, heads, HW, mode)
    kw = dict(scale=D ** -0.5, heads=heads)
    tattn.reset_counts()
    got = kernels.frame_attention(q, k, v, **kw)
    want = kernels.frame_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    peak = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    assert kernels.tc_counts()["frame_attention"] == kernels.frame_attention.launches == 1
    q32, k32, v32 = q.float(), k.float(), v.float()
    got32 = kernels.frame_attention(q32, k32, v32, **kw)
    want32 = kernels.frame_attention_plain(q32, k32, v32, **kw)
    torch.cuda.synchronize()
    assert (got32 - want32).abs().max().item() <= 1e-4
    assert kernels.frame_attention.launches == 2 and kernels.tc_counts()["frame_attention"] == 1
    assert tattn.plain_path_calls() == 0


# packs the plan does not pick at these shapes: several locations of a head
# group (head-group runs of a frame not contiguous), a ragged last pack, R
# not dividing the packs. (F, D, heads, HW, G, HG, R)
TC_FRAME_PLANS = [(16, 40, 8, 37, 4, 2, 3), (5, 80, 4, 9, 2, 4, 1), (33, 16, 4, 10, 8, 1, 2),
                  (16, 37, 2, 7, 2, 1, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("F,D,heads,HW,G,HG,R", TC_FRAME_PLANS)
def test_frame_attention_plans_on_card(cuda_device, monkeypatch, F, D, heads, HW, G, HG, R):
    q, k, v = _frame_inputs(cuda_device, F, D, heads, HW, "", seed=12)
    monkeypatch.setattr(kernels, "frame_attention_plan", lambda *a: (G, HG, R))
    kw = dict(scale=D ** -0.5, heads=heads)
    got = kernels.frame_attention(q, k, v, **kw)
    want = kernels.frame_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    peak = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)


# K6b in bfloat16 on the tensor cores (csrc/shared_bias_folded.cu on the body
# of csrc/attn_mma.cuh, P split into bf16 hi + lo, up to two folded rows a
# block under one bias tile): ragged BH (a last group computed again and not
# stored), Sq and Sk; a float32 bias staged 16 or 4 bytes at a time and a
# bfloat16 one staged 16 or 2 bytes at a time; head dim 160 (one row a
# block); "misaligned": q, k, v and the bias 2 bytes past a 16-byte
# boundary. (BH, D, Sq, Sk, t_rows, bias dtype, mode)
TC_FOLDED_CASES = [(5, 32, 200, 333, 2, torch.float32, ""),
                   (5, 32, 200, 333, 2, torch.bfloat16, ""),
                   (3, 64, 130, 1024, 2, torch.bfloat16, ""),
                   (4, 160, 65, 129, 2, torch.float32, ""),
                   (7, 40, 64, 64, 1, torch.bfloat16, ""), (1, 4, 17, 5, 8, torch.float32, ""),
                   (3, 16, 77, 77, 2, torch.float32, "misaligned"),
                   (2, 96, 300, 1000, 2, torch.bfloat16, "misaligned")]


@pytest.mark.cuda
@pytest.mark.parametrize("BH,D,Sq,Sk,t_rows,bias_dtype,mode", TC_FOLDED_CASES)
def test_tensor_core_shared_bias_folded_on_card(cuda_device, BH, D, Sq, Sk, t_rows, bias_dtype,
                                                mode):
    """bfloat16 against the plain version within chip_smoke.py's phase-2
    limit, the lse within 1e-4 and the output the same with and without
    it, every launch counted in `tc_launches`; float32 inputs take the
    CUDA-core kernel and are not."""
    g = torch.Generator(device=cuda_device).manual_seed(14)
    mis = _misaligned if mode == "misaligned" else (lambda x: x)
    rnd = lambda *s: mis(torch.randn(*s, generator=g, device=cuda_device).bfloat16())
    q, k, v = rnd(BH, Sq, D), rnd(BH, Sk, D), rnd(BH, Sk, D)
    bias = mis((torch.rand(Sq, Sk, generator=g, device=cuda_device) * 2 - 1).to(bias_dtype))
    kw = dict(scale=D ** -0.5, t_rows=t_rows)
    tattn.reset_counts()
    got, lse = kernels.shared_bias_attention_folded(q, k, v, bias, with_lse=True, **kw)
    alone = kernels.shared_bias_attention_folded(q, k, v, bias, **kw)
    want, want_lse = kernels.shared_bias_attention_folded_plain(q, k, v, bias, scale=D ** -0.5,
                                                                with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(got, alone) and bool(torch.isfinite(got).all())
    peak = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    fn = kernels.shared_bias_attention_folded
    assert kernels.tc_counts()[fn.__name__] == fn.launches == 2
    got32 = fn(q.float(), k.float(), v.float(), bias, **kw)
    want32 = kernels.shared_bias_attention_folded_plain(q.float(), k.float(), v.float(), bias,
                                                        scale=D ** -0.5)
    torch.cuda.synchronize()
    assert (got32 - want32).abs().max().item() <= 1e-4
    assert fn.launches == 3 and kernels.tc_counts()[fn.__name__] == 2
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_lse", [False, True])
def test_shared_bias_folded_output_matches_plain_on_card(cuda_device, bias_dtype, with_lse):
    """K6b in bfloat16 at the WarpAttn head dim with 2048 keys: its output
    equals the plain version's (float32 probabilities, one rounding to bf16)
    bit for bit in at least chip_smoke.K5A_MATCH of the elements, as K5a's
    does: the split of P into bf16 hi + lo."""
    g = torch.Generator(device=cuda_device).manual_seed(15)
    BH, Sq, Sk, D = 8, 256, 2048, 32
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda_device).bfloat16()
    q, k, v = rnd(BH, Sq, D), rnd(BH, Sk, D), rnd(BH, Sk, D)
    bias = (torch.rand(Sq, Sk, generator=g, device=cuda_device) * 2 - 1).to(bias_dtype)
    kw = dict(scale=D ** -0.5, with_lse=with_lse)
    first = lambda out: out[0] if with_lse else out
    out = first(kernels.shared_bias_attention_folded(q, k, v, bias, **kw))
    want = first(kernels.shared_bias_attention_folded_plain(q, k, v, bias, **kw))
    torch.cuda.synchronize()
    assert (out == want).float().mean().item() >= chip_smoke.K5A_MATCH


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,K,M", [(1000, 77, 321), (128, 320, 320), (1, 1, 1), (129, 17, 130),
                                   (4096, 1280, 1280)])
def test_dense_matmul_on_card(cuda_device, dtype, N, K, M):
    """Ragged and aligned shapes, both weight layouts, against the plain
    float32 product cast once (TF32 off)."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    x = torch.randn(N, K, generator=g, device=cuda_device).to(dtype)
    w = torch.randn(M, K, generator=g, device=cuda_device).to(dtype)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = kernels.dense_matmul(x, w, linear_layout=True)
        got_km = kernels.dense_matmul(x, w.t().contiguous())
        want = kernels.dense_matmul_plain(x, w, linear_layout=True)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert got.shape == (N, M) and got.dtype == dtype
    peak = want.float().abs().max().item()
    tol = 1e-5 * peak if dtype == torch.float32 else 2 ** -7 * peak   # one bf16 ulp of the peak
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, got_km)


# K7 in bfloat16 on the tensor cores (csrc/dense_matmul.cu): 16-byte staging
# where K (M for a [K, M] weight) is a multiple of 8 and the pointers are
# aligned, 2-byte staging elsewhere (K = 77 and 33, M = 321 and 7 for a
# [K, M] weight, pointers 2 bytes past a 16-byte boundary), ragged row and
# column tiles, N = 1. (N, K, M, mode)
TC_DENSE_CASES = [(1000, 77, 321, ""), (1, 320, 320, ""), (300, 320, 320, "misaligned"),
                  (129, 64, 200, ""), (4096, 640, 640, ""), (257, 1280, 72, "misaligned"),
                  (5, 8, 8, ""), (130, 33, 7, "")]


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,M,mode", TC_DENSE_CASES)
def test_tensor_core_dense_matmul_on_card(cuda_device, N, K, M, mode):
    """bfloat16 with an [M, K] and a [K, M] weight against the plain float32
    product cast once, within one bf16 ulp of the largest output (phase 2's
    limit), both counted in `tc_launches`; the same inputs in float32 take
    the CUDA-core kernel (1e-5 x max|plain|, TF32 off) and are not."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.randn(N, K, generator=g, device=cuda_device).bfloat16()
    w = torch.randn(M, K, generator=g, device=cuda_device).bfloat16()
    w_km = w.t().contiguous()
    if mode == "misaligned":
        x, w, w_km = map(_misaligned, (x, w, w_km))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        tattn.reset_counts()
        for xs, ws, ws_km, rel in ((x, w, w_km, 2 ** -7),
                                   (x.float(), w.float(), w_km.float(), 1e-5)):
            want = kernels.dense_matmul_plain(xs, ws, linear_layout=True)
            peak = want.float().abs().max().item()
            for got in (kernels.dense_matmul(xs, ws, linear_layout=True),
                        kernels.dense_matmul(xs, ws_km)):
                torch.cuda.synchronize()
                assert got.shape == (N, M) and got.dtype == xs.dtype
                assert bool(torch.isfinite(got).all())
                assert (got.float() - want.float()).abs().max().item() <= rel * peak
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert kernels.dense_matmul.launches == 4 and kernels.tc_counts()["dense_matmul"] == 2
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
def test_opt_in_routes_on_card(cuda_device):
    """Under configure(attn_v2=True, pallas_dense=True) the long sites take
    K6a and MMDense takes K7; outside the block both are idle again; under
    grad attn_v2 changes nothing and MMDense raises."""
    from imagine360_tpu_torch.models.layers import MMDense

    g = torch.Generator(device=cuda_device).manual_seed(9)
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda_device)
    q, k = rnd(2, 300, 2, 16), rnd(2, 2000, 2, 16)
    bias = rnd(1, 1, 300, 2000)
    mm = MMDense(24, 40).to(cuda_device).requires_grad_(False)
    x = rnd(3, 50, 24)
    want = (tattn.dot_product_attention(q, k, k), tattn.dot_product_attention(q, k, k, bias=bias),
            mm(x))
    tattn.reset_counts()
    with configure(attn_v2=True, pallas_dense=True):
        got = (tattn.dot_product_attention(q, k, k),
               tattn.dot_product_attention(q, k, k, bias=bias), mm(x))
        tattn.dot_product_attention(q, q, q)            # 300 keys, no bias: K1 still
        with pytest.raises(RuntimeError, match="no backward"):
            mm(x.clone().requires_grad_())
        qg = q.clone().requires_grad_()
        tattn.dot_product_attention(qg, k, k).sum().backward()
    torch.cuda.synchronize()
    assert kernel_config() == KernelConfig()
    launches = {n: c["launches"] for n, c in kernels.counts().items()}
    assert launches["flash_attention_t"] == 2 and launches["dense_matmul"] == 1
    assert launches["mh_flash_attention"] == 0 and launches["shared_bias_attention"] == 0
    assert launches["tiny_attention"] == 1 and launches["flash_attention_lse"] == 1
    assert tattn.plain_path_calls() == 0
    for a, b in zip(got, want):
        assert a.shape == b.shape and (a - b).abs().max().item() <= 1e-4
    tattn.reset_counts()
    tattn.dot_product_attention(q, k, k)
    mm(x)
    assert kernels.flash_attention_t.launches == 0 and kernels.dense_matmul.launches == 0


# ---- the motion-attention lab: L1, L2, L3 ----------------------------------

# (B, F, HW, C, heads): ragged frame counts, odd and wide head dims
LAB_SHAPES = [(2, 16, 24, 8 * 40, 8), (1, 5, 12, 2 * 160, 2), (3, 7, 8, 3 * 33, 3),
              (2, 32, 4, 4 * 16, 4), (1, 1, 6, 2 * 8, 2)]


def _lab_inputs(dev, dtype, shape, seed):
    B, F, HW, C, heads = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, F, HW, C, generator=g, device=dev).to(dtype) for _ in range(3))
    return g, q, k, v, dict(scale=(C // heads) ** -0.5, heads=heads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LAB_SHAPES)
def test_striped_v2_and_diag_on_card(cuda_device, dtype, shape):
    """L1 at every (G, R) that divides the site and L3 at every G, against
    K4's plain version and the K4 kernel."""
    _, q, k, v, kw = _lab_inputs(cuda_device, dtype, shape, 8)
    HW = shape[2]
    want = kernels.frame_attention_plain(q, k, v, **kw).float()
    prod = kernels.frame_attention(q, k, v, **kw).float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    tattn.reset_counts()
    n1 = n3 = 0
    for G in (1, 2, 3, 4):
        if HW % G:
            continue
        got = kernels.diag_motion_attention(q, k, v, G=G, **kw)
        n3 += 1
        torch.cuda.synchronize()
        assert got.dtype == dtype and (got.float() - want).abs().max().item() <= tol, G
        assert (got.float() - prod).abs().max().item() <= tol
        if kernels.striped_v2_smem_bytes(G, shape[1], shape[3], shape[4],
                                         q.element_size()) > kernels.SMEM_LIMIT:
            continue         # the float32 pack of 4 x 320 channels x 16 frames does not fit
        for R in (1, 2, 3):
            if (HW // G) % R:
                continue
            got = kernels.striped_v2_attention(q, k, v, G=G, R=R, **kw)
            n1 += 1
            torch.cuda.synchronize()
            assert got.dtype == dtype and (got.float() - want).abs().max().item() <= tol, (G, R)
    assert kernels.striped_v2_attention.launches == n1 > 0
    assert kernels.diag_motion_attention.launches == n3 > 0
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_kind", ["block_diag", "random", "random_bf16", "minus_inf"])
@pytest.mark.parametrize("exp_bf16", [False, True])
@pytest.mark.parametrize("shape", LAB_SHAPES[:4])
def test_fused_motion_on_card(cuda_device, dtype, bias_kind, exp_bf16, shape):
    """L2 against its plain version under a block-diagonal, a random (float32
    and bfloat16) and a partly -inf bias, with and without exp_bf16; the
    sequence lengths G*F are ragged against the 16-row query tile."""
    from imagine360_tpu_torch.ops import motion_lab

    g, q, k, v, kw = _lab_inputs(cuda_device, dtype, shape, 9)
    F, HW = shape[1], shape[2]
    tattn.reset_counts()
    n = 0
    for G in (1, 2, 4):
        if HW % G:
            continue
        S = G * F
        if bias_kind == "block_diag":
            bias = torch.from_numpy(motion_lab.block_diag_bias(G, F, F)[0]).to(cuda_device)
        else:
            bias = torch.randn(1, S, S, generator=g, device=cuda_device)
            if bias_kind == "random_bf16":
                bias = bias.bfloat16()
            if bias_kind == "minus_inf":     # the diagonal stays: no row is fully masked
                drop = torch.rand(S, S, generator=g, device=cuda_device) < 0.3
                drop &= ~torch.eye(S, dtype=torch.bool, device=cuda_device)
                bias = bias.masked_fill(drop[None], float("-inf"))
        got = kernels.fused_motion_attention(q, k, v, bias, G=G, exp_bf16=exp_bf16, **kw)
        want = kernels.fused_motion_attention_plain(q, k, v, bias, G=G, exp_bf16=exp_bf16, **kw)
        n += 1
        torch.cuda.synchronize()
        # exp_bf16: a logit on a bfloat16 rounding boundary may round the other
        # way in another summation order, one bfloat16 ulp of that probability
        tol = 2e-2 if dtype == torch.bfloat16 or exp_bf16 else 1e-4
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        assert (got.float() - want.float()).abs().max().item() <= tol, G
    assert kernels.fused_motion_attention.launches == n > 0
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
def test_lab_wrappers_raise_on_card_for_what_does_not_fit(cuda_device):
    """A pack beyond a block's shared memory raises; nothing shrinks it and
    nothing falls back to the plain version."""
    x = torch.zeros(1, 16, 32, 1280, device=cuda_device, dtype=torch.bfloat16)
    bias = torch.zeros(1, 512, 512, device=cuda_device)
    kw = dict(scale=1.0, heads=8)
    tattn.reset_counts()
    with pytest.raises(ValueError, match="shared memory"):
        kernels.striped_v2_attention(x, x, x, G=2, R=1, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fused_motion_attention(x, x, x, bias, G=32, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.diag_motion_attention(x, x, x, G=16, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.diag_motion_attention(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2),
                                      G=2, **kw)
    with pytest.raises(ValueError, match="bias must be"):
        kernels.fused_motion_attention(x, x, x, bias.cpu(), G=32, **kw)
    assert tattn.plain_path_calls() == 0
    assert all(fn.launches == 0 for fn in kernels.LAB_KERNELS)


@pytest.mark.cuda
def test_run_lab_on_card(cuda_device):
    """The lab at a small site: every variant within the bf16 limit of K4's
    plain version and of the K4 kernel, every one launched and timed."""
    from imagine360_tpu_torch.ops import motion_lab

    tattn.reset_counts()
    rows = motion_lab.run_lab(cuda_device, [("small", (4, 16, 64, 320, 8))], iters=2)
    kinds = {r["variant"].split("_G")[0] for r in rows}
    assert kinds == {"frame_attention", "striped_v2", "fused", "diag"}
    for r in rows:
        tol = 5e-2 if r["params"].get("exp_bf16") else 2e-2
        assert r["max_abs_err"] <= tol and r["k4_max_abs_err"] <= tol, r
        assert r["launches"] == 4 and r["plain_calls"] == 0 and r["ms"] > 0 and r["k4_ms"] > 0
    assert tattn.plain_path_calls() == 0
