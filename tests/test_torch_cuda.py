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
                                   "shared_bias_attention_folded": 0, "dense_matmul": 0,
                                   "striped_v2_attention": 0, "fused_motion_attention": 0,
                                   "diag_motion_attention": 0}
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


# K1 and K2 in bfloat16 at D = 64 without a bias on the wgmma body
# (csrc/attn_wgmma.cuh) where kernels.wgmma_route says so: ragged query and
# key tails (no multiple of 128), one partial key tile (77 and 64 keys: K2
# takes the body there, K1 keeps flash_tile_mma), Sq of 33 and 64 (one of
# the block's two consumers has rows), K1 at the least Sq and Sk of its
# rule and at Sq <= 32; "misaligned": q, k and v 2 bytes past a 16-byte
# boundary, which the rule sends to flash_tile_mma. (wrapper, B, Sq, Sk, H,
# mode)
WGMMA_CASES = [("mh_flash_attention", 2, 300, 1500, 3, "none"),
               ("mh_flash_attention", 2, 1000, 3001, 2, "none"),
               ("mh_flash_attention", 3, 129, 127, 2, "none"),
               ("mh_flash_attention", 2, 100, 77, 5, "none"),
               ("mh_flash_attention", 2, 64, 64, 5, "none"),
               ("mh_flash_attention", 1, 1, 1, 1, "none"),
               ("tiny_attention", 2, 33, 129, 5, "none"),
               ("tiny_attention", 2, 333, 1000, 2, "none"),
               ("tiny_attention", 3, 1024, 1024, 1, "none"),
               ("tiny_attention", 2, 100, 77, 5, "none"),
               ("tiny_attention", 2, 1000, 64, 5, "none"),
               ("tiny_attention", 2, 32, 1000, 5, "none"),
               ("tiny_attention", 2, 65, 1000, 2, "misaligned"),
               ("mh_flash_attention", 2, 63, 1025, 2, "misaligned")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,Sq,Sk,H,mode", WGMMA_CASES)
def test_wgmma_attention_on_card(cuda_device, name, B, Sq, Sk, H, mode):
    """bfloat16 at D = 64 against the plain version within chip_smoke.py's
    phase-2 limit, min(2e-2, 2**-5 x max|plain|), on the body the rule
    names: counted in `wgmma_launches` (and `tc_launches`) where it names
    the wgmma body, in `tc_launches` alone where it keeps flash_tile_mma."""
    g = torch.Generator(device=cuda_device).manual_seed(20)
    fix = _misaligned if mode == "misaligned" else (lambda x: x)
    q, k, v = (fix(torch.randn(B, S, H * 64, generator=g, device=cuda_device).bfloat16())
               for S in (Sq, Sk, Sk))
    fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    tattn.reset_counts()
    got = fn(q, k, v, scale=0.125, heads=H)
    want = plain(q, k, v, scale=0.125, heads=H)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    peak = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    routed = kernels.wgmma_route(name, torch.bfloat16, Sq, Sk, H, 64, False,
                                 (q.data_ptr(), k.data_ptr(), v.data_ptr(), 0))
    assert routed == (mode == "none" and (name == "mh_flash_attention" or (Sq > 32 and Sk > 128)))
    assert kernels.wgmma_counts()[name] == int(routed)
    assert kernels.tc_counts()[name] == fn.launches == 1
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,Sq,Sk,H", [("mh_flash_attention", 3, 200, 77, 2),
                                           ("mh_flash_attention", 2, 129, 1025, 5),
                                           ("tiny_attention", 2, 300, 333, 5)])
def test_wgmma_tensor_map_boundary_on_card(cuda_device, name, B, Sq, Sk, H):
    """The last (batch, head) of k and v ends where NaN rows begin, and the
    output's last row where a sentinel row begins (the wgmma C entry called
    on views of larger buffers): the 4-D tensor maps zero-fill the key tail
    inside its batch and read no NaN (0 x NaN would poison P·V), and the
    store clips the query tail, so the output matches the plain version and
    the sentinel is untouched."""
    g = torch.Generator(device=cuda_device).manual_seed(21)
    rnd = lambda S: torch.randn(B, S, H * 64, generator=g, device=cuda_device).bfloat16()
    q, k, v = rnd(Sq), rnd(Sk), rnd(Sk)
    kbuf = torch.full((B + 1, Sk, H * 64), float("nan"), device=cuda_device).bfloat16()
    vbuf = kbuf.clone()
    kbuf[:B], vbuf[:B] = k, v
    obuf = torch.full((B + 1, Sq, H * 64), 7.0, device=cuda_device).bfloat16()
    fn = getattr(kernels.load_library(), f"i360_{name}_wgmma")
    err = fn(q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(), obuf.data_ptr(), B, Sq, Sk, H, 64,
             0.125, torch.cuda.current_stream().cuda_stream)
    want = getattr(kernels, name + "_plain")(q, k, v, scale=0.125, heads=H)
    torch.cuda.synchronize()
    assert err == 0
    got = obuf[:B]
    peak = want.float().abs().max().item()
    assert bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    assert bool((obuf[B] == 7.0).all())


@pytest.mark.cuda
def test_wgmma_refuses_what_it_does_not_take_on_card(cuda_device):
    """The wgmma C entries launch nothing and return cudaErrorInvalidValue
    (1) for a head dim other than 64 or a pointer off a 16-byte boundary,
    and K1's for more than 1024 keys."""
    x = torch.zeros(1, 2048, 128, device=cuda_device, dtype=torch.bfloat16)
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    p = x.data_ptr()
    for name in ("tiny_attention", "mh_flash_attention"):
        fn = getattr(lib, f"i360_{name}_wgmma")
        assert fn(p, p, p, p, 1, 64, 1024, 4, 32, 0.1, stream) == 1
        assert fn(p + 2, p, p, p, 1, 64, 1024, 2, 64, 0.1, stream) == 1
        assert fn(p, p, p, p + 8, 1, 64, 1024, 2, 64, 0.1, stream) == 1
    assert lib.i360_tiny_attention_wgmma(p, p, p, p, 1, 64, 1025, 1, 64, 0.1, stream) == 1
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_wgmma_launches_counted_through_dispatch_on_card(cuda_device):
    """Through ops/attention.py's dispatch, as the models call it: bf16
    self-attention at D = 64 over 2048 tokens (K2) and 1024 tokens (K1)
    takes the wgmma body, text cross-attention over 77 keys (K1) and 16
    frames (K1) keep flash_tile_mma, D = 512 the wide kernel; every launch
    on the tensor cores, none on a plain path."""
    g = torch.Generator(device=cuda_device).manual_seed(22)
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda_device).bfloat16()
    tattn.reset_counts()
    x2, x1, ctx = rnd(1, 2048, 5, 64), rnd(2, 1024, 5, 64), rnd(2, 77, 5, 64)
    tattn.dot_product_attention(x2, x2, x2)
    tattn.dot_product_attention(x1, x1, x1)
    tattn.dot_product_attention(x1, ctx, ctx)
    f = rnd(40, 16, 8, 64)
    tattn.dot_product_attention(f, f, f)
    w = rnd(1, 1100, 1, 512)
    tattn.dot_product_attention(w, w, w)
    torch.cuda.synchronize()
    assert kernels.wgmma_counts() == {"tiny_attention": 1, "mh_flash_attention": 1,
                                      "flash_attention_lse": 0, "flash_attention_t": 0,
                                      "shared_bias_attention_folded": 0, "dense_matmul": 0,
                                      "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                                      "shared_bias_attention": 0}
    assert kernels.tiny_attention.launches == 3 and kernels.mh_flash_attention.launches == 2
    assert kernels.wide_counts() == {"tiny_attention": 0, "mh_flash_attention": 1}
    assert kernels.tc_counts()["tiny_attention"] == 3
    assert kernels.tc_counts()["mh_flash_attention"] == 2
    assert tattn.plain_path_calls() == 0


# K5a and K6a in bfloat16 at D = 64 without a bias on the wgmma body
# (csrc/attn_wgmma.cuh with P split, K5a with the lse, K6a on
# sequence-minor tiles) where kernels.wgmma_route says so: ragged query and
# key tails (K6a's multiples of 8, as its rule asks), one partial key tile,
# Sq of 1, 8, 64 and 129 (one of the block's two consumers has rows);
# "misaligned": q, k and v 2 bytes past a 16-byte boundary, and for K6a
# "ragged" Sq and Sk no multiples of 8, both of which the rule sends to
# flash_tile_mma. (wrapper, B, Sq, Sk, H, mode)
WGMMA_SPLIT_CASES = [("flash_attention_lse", 2, 300, 1500, 3, "none"),
                     ("flash_attention_lse", 2, 1000, 3001, 2, "none"),
                     ("flash_attention_lse", 3, 129, 127, 2, "none"),
                     ("flash_attention_lse", 2, 100, 77, 5, "none"),
                     ("flash_attention_lse", 2, 64, 64, 5, "none"),
                     ("flash_attention_lse", 1, 1, 1, 1, "none"),
                     ("flash_attention_lse", 2, 65, 1000, 2, "misaligned"),
                     ("flash_attention_t", 2, 304, 1504, 3, "none"),
                     ("flash_attention_t", 2, 1000, 3000, 2, "none"),
                     ("flash_attention_t", 3, 136, 120, 2, "none"),
                     ("flash_attention_t", 2, 104, 72, 5, "none"),
                     ("flash_attention_t", 1, 8, 8, 1, "none"),
                     ("flash_attention_t", 2, 64, 1000, 2, "misaligned"),
                     ("flash_attention_t", 2, 300, 1500, 3, "ragged")]


def _split_inputs(name, B, Sq, Sk, H, g, dev, fix=lambda x: x):
    """q, k, v bfloat16 in the wrapper's layout: K5a [B, S, H, 64], K6a
    [B, H, 64, S]."""
    shape = (lambda S: (B, S, H, 64)) if name == "flash_attention_lse" else \
        (lambda S: (B, H, 64, S))
    return tuple(fix(torch.randn(*shape(S), generator=g, device=dev).bfloat16())
                 for S in (Sq, Sk, Sk))


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,Sq,Sk,H,mode", WGMMA_SPLIT_CASES)
def test_wgmma_split_attention_on_card(cuda_device, name, B, Sq, Sk, H, mode):
    """bfloat16 against the plain version within chip_smoke.py's phase-2
    limit, min(2e-2, 2**-5 x max|plain|), K5a's lse within 1e-4, on the body
    the rule names: counted in `wgmma_launches` (and `tc_launches`) where it
    names the wgmma body, in `tc_launches` alone where it keeps
    flash_tile_mma."""
    g = torch.Generator(device=cuda_device).manual_seed(23)
    fix = _misaligned if mode == "misaligned" else (lambda x: x)
    q, k, v = _split_inputs(name, B, Sq, Sk, H, g, cuda_device, fix)
    fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    tattn.reset_counts()
    got, want = fn(q, k, v, scale=0.125), plain(q, k, v, scale=0.125)
    torch.cuda.synchronize()
    if name == "flash_attention_lse":
        (got, lse), (want, want_lse) = got, want
        assert (lse - want_lse).abs().max().item() <= 1e-4
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    peak = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    routed = kernels.wgmma_route(name, torch.bfloat16, Sq, Sk, H, 64, False,
                                 (q.data_ptr(), k.data_ptr(), v.data_ptr(), 0))
    assert routed == (mode == "none")
    assert kernels.wgmma_counts()[name] == int(routed)
    assert kernels.tc_counts()[name] == fn.launches == 1
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,Sq,Sk,H", [("flash_attention_lse", 3, 200, 77, 2),
                                           ("flash_attention_lse", 2, 129, 1025, 5),
                                           ("flash_attention_t", 3, 200, 72, 2),
                                           ("flash_attention_t", 2, 136, 1032, 5)])
def test_wgmma_split_tensor_map_boundary_on_card(cuda_device, name, B, Sq, Sk, H):
    """The last (batch, head) of k and v ends where NaN rows begin (K5a: the
    next batch row; K6a: the next (batch, head) slab), and the output's
    last row where a sentinel row begins, K5a's lse too (the wgmma C entry
    called on views of larger buffers): the tensor maps zero-fill the key
    tail inside its slab and read no NaN, and the stores clip the query
    tail, so the output (and lse) match the plain version and the sentinels
    are untouched."""
    g = torch.Generator(device=cuda_device).manual_seed(24)
    q, k, v = _split_inputs(name, B, Sq, Sk, H, g, cuda_device)
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    if name == "flash_attention_lse":
        kbuf = torch.full((B + 1, Sk, H, 64), float("nan"), device=cuda_device).bfloat16()
        obuf = torch.full((B + 1, Sq, H, 64), 7.0, device=cuda_device).bfloat16()
        lbuf = torch.full((B * H + 1, Sq), 7.0, device=cuda_device)
    else:
        kbuf = torch.full((B, H, 64, Sk), float("nan"), device=cuda_device).bfloat16()
        kbuf = torch.cat([kbuf, kbuf[:1]]).contiguous()
        obuf = torch.full((B + 1, H, Sq, 64), 7.0, device=cuda_device).bfloat16()
    vbuf = kbuf.clone()
    kbuf[:B], vbuf[:B] = k, v
    ptrs = (q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(), obuf.data_ptr())
    if name == "flash_attention_lse":
        err = lib.i360_flash_attention_lse_wgmma(*ptrs, lbuf.data_ptr(), B, Sq, Sk, H, 64, 0.125,
                                                 stream)
        want, want_lse = kernels.flash_attention_lse_plain(q, k, v, scale=0.125)
    else:
        err = lib.i360_flash_attention_t_wgmma(*ptrs, B, Sq, Sk, H, 64, 0.125, stream)
        want = kernels.flash_attention_t_plain(q, k, v, scale=0.125)
    torch.cuda.synchronize()
    assert err == 0
    got = obuf[:B]
    peak = want.float().abs().max().item()
    assert bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    assert bool((obuf[B] == 7.0).all())
    if name == "flash_attention_lse":
        assert (lbuf[:B * H].view(B, H, Sq) - want_lse).abs().max().item() <= 1e-4
        assert bool((lbuf[B * H] == 7.0).all())


@pytest.mark.cuda
def test_wgmma_split_refuses_what_it_does_not_take_on_card(cuda_device):
    """K5a's and K6a's wgmma C entries launch nothing and return
    cudaErrorInvalidValue (1) for a head dim other than 64 or a q, k, v or
    out pointer off a 16-byte boundary, K5a's for a null lse (an lse off a
    16-byte boundary launches: it leaves by scalar stores, not by TMA), and
    K6a's for an Sq or Sk that is no multiple of 8."""
    x = torch.zeros(1, 4096, 128, device=cuda_device, dtype=torch.bfloat16)
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    p = x.data_ptr()
    lse = lib.i360_flash_attention_lse_wgmma
    assert lse(p, p, p, p, p, 1, 64, 1024, 4, 32, 0.1, stream) == 1
    assert lse(p + 2, p, p, p, p, 1, 64, 1024, 2, 64, 0.1, stream) == 1
    assert lse(p, p, p, p + 8, p, 1, 64, 1024, 2, 64, 0.1, stream) == 1
    assert lse(p, p, p, p, None, 1, 64, 1024, 2, 64, 0.1, stream) == 1
    o = torch.empty(1, 64, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    lbuf = torch.full((2 * 64 + 1,), 7.0, device=cuda_device)
    assert lse(p, p, p, o.data_ptr(), lbuf.data_ptr() + 4, 1, 64, 1024, 2, 64, 0.1, stream) == 0
    torch.cuda.synchronize()
    assert bool((lbuf[0] == 7.0).all()) and bool(torch.isfinite(lbuf[1:]).all())
    t = lib.i360_flash_attention_t_wgmma
    assert t(p, p, p, p, 1, 64, 1024, 2, 32, 0.1, stream) == 1
    assert t(p, p + 2, p, p, 1, 64, 1024, 2, 64, 0.1, stream) == 1
    assert t(p, p, p, p, 1, 60, 1024, 2, 64, 0.1, stream) == 1
    assert t(p, p, p, p, 1, 64, 1020, 2, 64, 0.1, stream) == 1
    torch.cuda.synchronize()


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


# K5b and K5c on the wgmma body (csrc/attn_wgmma_bwd.cuh): (B, Sq, Sk, H,
# mode), the training step's pano shapes at fewer batch rows (s0, s1, the
# pano rows of one of 2 ranks), ragged ones (K5c keeps Sq = 77 and 333,
# no multiple of 4, on mma.sync), and a q off a 16-byte boundary (mma.sync)
WGMMA_BWD_CASES = [(1, 8192, 8192, 5, "none"), (2, 2048, 2048, 10, "none"),
                   (1, 4096, 8192, 5, "none"), (2, 200, 333, 2, "none"),
                   (2, 1000, 77, 2, "none"), (1, 77, 200, 2, "none"), (1, 333, 1000, 3, "none"),
                   (2, 64, 64, 1, "none"), (2, 200, 1000, 2, "misaligned")]


def _bwd_inputs(dev, B, Sq, Sk, H, seed, fix=lambda x: x):
    """chip_smoke.bwd_inputs at D = 64 from `seed`, `fix` applied to q, k,
    v and dO: the arguments of K5b and K5c without a bias."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do, lse, delta = chip_smoke.bwd_inputs(kernels, (B, Sq, Sk, H, 64), gen, dev)
    return tuple(map(fix, (q, k, v))) + (None, fix(do), lse, delta)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_bwd_dq", "flash_bwd_dkv"])
@pytest.mark.parametrize("B,Sq,Sk,H,mode", WGMMA_BWD_CASES)
def test_wgmma_bwd_on_card(cuda_device, name, B, Sq, Sk, H, mode):
    """K5b's dq and K5c's dk, dv in bfloat16 against the plain version, each
    within chip_smoke.py's phase-2 limit, 2**-7 x max|plain|, finite, on the
    body the rule names: counted in `wgmma_launches` (and `tc_launches`)
    where it names the wgmma body, in `tc_launches` alone where it keeps
    the mma.sync tile. On the wgmma body the output (dk and dv together)
    equals the plain version's bit for bit in at least chip_smoke.K5A_MATCH
    of its elements, which dS (and P) rounded once to bf16 misses."""
    fix = _misaligned if mode == "misaligned" else (lambda x: x)
    args = _bwd_inputs(cuda_device, B, Sq, Sk, H, 31, fix)
    fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    tattn.reset_counts()
    got, want = fn(*args, scale=0.125), plain(*args, scale=0.125)
    torch.cuda.synchronize()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
        peak = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= chip_smoke.GRAD_BF16_REL * peak
    routed = kernels.wgmma_route(name, torch.bfloat16, Sq, Sk, H, 64, False,
                                 (args[0].data_ptr(),))
    assert routed == (mode == "none" and (name == "flash_bwd_dq" or Sq % 4 == 0))
    if routed:
        assert chip_smoke.match_share(name, got, want) >= chip_smoke.K5A_MATCH
    assert kernels.wgmma_counts()[name] == int(routed)
    assert kernels.tc_counts()[name] == fn.launches == 1
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H", [(3, 200, 77, 2), (2, 132, 1025, 5), (1, 64, 64, 1)])
def test_wgmma_bwd_tensor_map_boundary_on_card(cuda_device, B, Sq, Sk, H):
    """The last batch row of k and v (K5b) or of q and dO (K5c) ends where
    NaN rows begin, and the last row of dq, dk and dv where a sentinel row
    begins (the wgmma C entries called on views of larger buffers): the
    tensor maps zero-fill the tails inside their (batch, head) slab and read
    no NaN, and the stores clip the rows past Sq and Sk, so the gradients
    match the plain version and the sentinels are untouched."""
    q, k, v, _, do, lse, delta = _bwd_inputs(cuda_device, B, Sq, Sk, H, 32)
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    nan = lambda S: torch.full((B + 1, S, H, 64), float("nan"), device=cuda_device).bfloat16()
    seven = lambda S: torch.full((B + 1, S, H, 64), 7.0, device=cuda_device).bfloat16()
    args = (q, k, v, None, do, lse, delta)
    # K5b: k and v against NaN rows, dq against sentinels
    kbuf, vbuf, qout = nan(Sk), nan(Sk), seven(Sq)
    kbuf[:B], vbuf[:B] = k, v
    err = lib.i360_flash_bwd_dq_wgmma(q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(),
                                      do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                      qout.data_ptr(), B, Sq, Sk, H, 64, 0.125, stream)
    # K5c: q and dO against NaN rows, dk and dv against sentinels
    qbuf, gbuf, kout, vout = nan(Sq), nan(Sq), seven(Sk), seven(Sk)
    qbuf[:B], gbuf[:B] = q, do
    err2 = lib.i360_flash_bwd_dkv_wgmma(qbuf.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        gbuf.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                        kout.data_ptr(), vout.data_ptr(), B, Sq, Sk, H, 64,
                                        0.125, stream)
    torch.cuda.synchronize()
    assert err == 0 and err2 == 0
    want_dq = kernels.flash_bwd_dq_plain(*args, scale=0.125)
    want_dk, want_dv = kernels.flash_bwd_dkv_plain(*args, scale=0.125)
    for buf, want in ((qout, want_dq), (kout, want_dk), (vout, want_dv)):
        got = buf[:B]
        assert bool(torch.isfinite(got).all())
        peak = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= chip_smoke.GRAD_BF16_REL * peak
        assert bool((buf[B] == 7.0).all())


@pytest.mark.cuda
def test_wgmma_bwd_refuses_what_it_does_not_take_on_card(cuda_device):
    """K5b's and K5c's wgmma C entries launch nothing and return
    cudaErrorInvalidValue (1) for a head dim other than 64, a null lse or
    delta, or a q, k, v, dO or output pointer off a 16-byte boundary; K5c's
    also for an lse or delta off one (TMA reads them) and for an Sq that is
    no multiple of 4 (the rows' maps); K5b's takes an lse off a 16-byte
    boundary (it reads the rows by scalar loads)."""
    x = torch.zeros(1, 4096, 128, device=cuda_device, dtype=torch.bfloat16)
    rows = torch.zeros(4096, device=cuda_device)
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    p, r = x.data_ptr(), rows.data_ptr()
    dq, dkv = lib.i360_flash_bwd_dq_wgmma, lib.i360_flash_bwd_dkv_wgmma
    assert dq(p, p, p, p, r, r, p, 1, 64, 1024, 4, 32, 0.1, stream) == 1
    assert dq(p, p, p, p, None, r, p, 1, 64, 1024, 2, 64, 0.1, stream) == 1
    assert dq(p, p, p, p, r, None, p, 1, 64, 1024, 2, 64, 0.1, stream) == 1
    for i in range(5):
        ptrs = [p + 2 * (j == i) for j in range(5)]
        assert dq(*ptrs[:4], r, r, ptrs[4], 1, 64, 1024, 2, 64, 0.1, stream) == 1
    assert dkv(p, p, p, p, r, r, p, p, 1, 64, 1024, 4, 32, 0.1, stream) == 1
    assert dkv(p, p, p, p, r, r, p, p, 1, 62, 1024, 2, 64, 0.1, stream) == 1
    for i in range(8):
        ptrs = [(r if j in (4, 5) else p) + (4 if j in (4, 5) else 2) * (j == i)
                for j in range(8)]
        assert dkv(*ptrs, 1, 64, 1024, 2, 64, 0.1, stream) == 1
    out = torch.empty(1, 64, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    assert dq(p, p, p, p, r + 4, r + 4, out.data_ptr(), 1, 64, 1024, 2, 64, 0.1, stream) == 0
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())


# K5b and K5c on the biased D = 32 wgmma body (csrc/attn_wgmma_bwd_bias.cuh):
# (B, Sq, Sk, H, mode), the training step's WarpAttn shapes at fewer batch
# rows (r2 both ways at 10 heads, r4 at 20 and 40, r8), ragged ones against
# the 128-row tiles, the 64-row ring tiles and the row slots (B·H of 5, 6,
# 9: K5b's four and K5c's two a block); "view": the bias a rank's row block
# of a 2-rank mesh's matrix; "masked": query row 5 masked on every key with
# -inf (its lse the floored -1e30, its P and dS 0); K5c keeps Sq = 77 and
# 333 (no multiple of 4) on mma.sync, and both keep a q off a 16-byte
# boundary ("misaligned"), a bias per head ("per_head") and Sk = 330 (bias
# rows of no multiple of 16 bytes) there
WGMMA_BWD_BIAS_CASES = [(1, 2048, 5120, 10, ""), (1, 5120, 2048, 10, ""),
                        (1, 512, 1280, 20, ""), (1, 1280, 512, 40, ""), (2, 128, 320, 40, ""),
                        (2, 320, 128, 40, "view"), (3, 200, 332, 2, ""), (1, 77, 200, 5, ""),
                        (3, 1000, 76, 3, "view"), (1, 333, 1000, 6, "masked"),
                        (2, 64, 64, 3, ""), (2, 200, 336, 2, "misaligned"),
                        (2, 200, 336, 2, "per_head"), (2, 200, 330, 2, "")]


def _bwd_bias_inputs(dev, B, Sq, Sk, H, seed, mode=""):
    """The arguments of K5b and K5c at D = 32 under a uniform [-1, 1)
    float32 bias [1, 1, Sq, Sk] (`mode` as WGMMA_BWD_BIAS_CASES), on the
    plain forward's lse and delta."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bias = _warp_bias(gen, dev, Sq, Sk, mode == "view")[None, None]
    if mode == "per_head":
        bias = torch.rand(1, H, Sq, Sk, generator=gen, device=dev) * 2 - 1
    if mode == "masked":
        bias[..., 5, :] = float("-inf")
    q, k, v, do, lse, delta = chip_smoke.bwd_inputs(kernels, (B, Sq, Sk, H, 32), gen, dev, bias)
    fix = _misaligned if mode == "misaligned" else (lambda x: x)
    return tuple(map(fix, (q, k, v))) + (bias, fix(do), lse, delta)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_bwd_dq", "flash_bwd_dkv"])
@pytest.mark.parametrize("B,Sq,Sk,H,mode", WGMMA_BWD_BIAS_CASES)
def test_wgmma_bwd_bias_on_card(cuda_device, name, B, Sq, Sk, H, mode):
    """K5b's dq and K5c's dk, dv in bfloat16 at D = 32 under a bias against
    the plain version, each within chip_smoke.py's phase-2 limit, 2**-7 x
    max|plain|, finite (0 in a fully masked query row of dq), on the body
    the rule names: counted in `wgmma_launches` (and `tc_launches`) where
    bwd_bias_wgmma_route names the biased body, in `tc_launches` alone
    where it keeps the mma.sync tile. On the biased body the output (dk and
    dv together) equals the plain version's bit for bit in at least
    chip_smoke.K5A_MATCH of its elements."""
    args = _bwd_bias_inputs(cuda_device, B, Sq, Sk, H, 51, mode)
    scale = 32 ** -0.5
    fn, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    tattn.reset_counts()
    got, want = fn(*args, scale=scale), plain(*args, scale=scale)
    torch.cuda.synchronize()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
        peak = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= chip_smoke.GRAD_BF16_REL * peak
    if mode == "masked" and name == "flash_bwd_dq":
        assert (got[:, 5] == 0).all()
    routed = mode in ("", "view", "masked") and Sk % 4 == 0 and (
        name == "flash_bwd_dq" or Sq % 4 == 0)
    assert kernels.bwd_bias_wgmma_route(
        name, torch.bfloat16, Sq, Sk, 32, (0, 0) if mode != "per_head" else (0, Sq * Sk),
        (args[0].data_ptr(), args[3].data_ptr())) == routed
    if routed:
        assert chip_smoke.match_share(name, got, want) >= chip_smoke.K5A_MATCH
    assert kernels.wgmma_counts()[name] == int(routed)
    assert kernels.tc_counts()[name] == fn.launches == 1
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H", [(3, 200, 76, 2), (2, 132, 1028, 5), (1, 64, 64, 1)])
def test_wgmma_bwd_bias_tensor_map_boundary_on_card(cuda_device, B, Sq, Sk, H):
    """The last batch row of k and v (K5b) or of q and dO (K5c) ends where
    NaN rows begin, the bias where NaN rows begin, and the last row of dq,
    dk and dv where a sentinel row begins (the biased C entries called on
    views of larger buffers): the tensor maps zero-fill the tails inside
    their (batch, head) slab and the bias rows past Sq and read no NaN, and
    the stores clip the rows past Sq and Sk, so the gradients match the
    plain version and the sentinels are untouched."""
    q, k, v, bias, do, lse, delta = _bwd_bias_inputs(cuda_device, B, Sq, Sk, H, 52)
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    nan = lambda S: torch.full((B + 1, S, H, 32), float("nan"), device=cuda_device).bfloat16()
    seven = lambda S: torch.full((B + 1, S, H, 32), 7.0, device=cuda_device).bfloat16()
    bbuf = torch.full((Sq + 8, Sk), float("nan"), device=cuda_device)
    bbuf[:Sq] = bias[0, 0]
    args = (q, k, v, bias, do, lse, delta)
    scale = 32 ** -0.5
    kbuf, vbuf, qout = nan(Sk), nan(Sk), seven(Sq)
    kbuf[:B], vbuf[:B] = k, v
    err = lib.i360_flash_bwd_dq_bias_wgmma(q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(),
                                           do.data_ptr(), bbuf.data_ptr(), lse.data_ptr(),
                                           delta.data_ptr(), qout.data_ptr(), B, Sq, Sk, H, 32,
                                           scale, stream)
    qbuf, gbuf, kout, vout = nan(Sq), nan(Sq), seven(Sk), seven(Sk)
    qbuf[:B], gbuf[:B] = q, do
    err2 = lib.i360_flash_bwd_dkv_bias_wgmma(qbuf.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             gbuf.data_ptr(), bbuf.data_ptr(), lse.data_ptr(),
                                             delta.data_ptr(), kout.data_ptr(), vout.data_ptr(),
                                             B, Sq, Sk, H, 32, scale, stream)
    torch.cuda.synchronize()
    assert err == 0 and err2 == 0
    want_dq = kernels.flash_bwd_dq_plain(*args, scale=scale)
    want_dk, want_dv = kernels.flash_bwd_dkv_plain(*args, scale=scale)
    for buf, want in ((qout, want_dq), (kout, want_dk), (vout, want_dv)):
        got = buf[:B]
        assert bool(torch.isfinite(got).all())
        peak = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= chip_smoke.GRAD_BF16_REL * peak
        assert bool((buf[B] == 7.0).all())


@pytest.mark.cuda
def test_wgmma_bwd_bias_refuses_what_it_does_not_take_on_card(cuda_device):
    """K5b's and K5c's biased C entries launch nothing and return
    cudaErrorInvalidValue (1) for a head dim other than 32, a null bias,
    lse or delta, a bias row that is no multiple of 16 bytes (Sk = 330), or
    a q, k, v, dO, bias or output pointer off a 16-byte boundary; K5c's
    also for an lse or delta off one (TMA reads them) and for an Sq that is
    no multiple of 4; K5b's takes an lse off a 16-byte boundary (scalar
    loads)."""
    x = torch.zeros(1, 4096, 64, device=cuda_device, dtype=torch.bfloat16)
    bias = torch.zeros(64 * 1024, device=cuda_device)
    rows = torch.zeros(4096, device=cuda_device)
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    p, b, r = x.data_ptr(), bias.data_ptr(), rows.data_ptr()
    dq, dkv = lib.i360_flash_bwd_dq_bias_wgmma, lib.i360_flash_bwd_dkv_bias_wgmma
    assert dq(p, p, p, p, b, r, r, p, 1, 64, 1024, 2, 64, 0.1, stream) == 1
    assert dq(p, p, p, p, None, r, r, p, 1, 64, 1024, 2, 32, 0.1, stream) == 1
    assert dq(p, p, p, p, b, None, r, p, 1, 64, 1024, 2, 32, 0.1, stream) == 1
    assert dq(p, p, p, p, b, r, None, p, 1, 64, 1024, 2, 32, 0.1, stream) == 1
    assert dq(p, p, p, p, b, r, r, p, 1, 64, 330, 2, 32, 0.1, stream) == 1
    for i in range(6):      # q, k, v, dO, the bias, dq
        ptrs = [(b if j == 4 else p) + (4 if j == 4 else 2) * (j == i) for j in range(6)]
        assert dq(*ptrs[:5], r, r, ptrs[5], 1, 64, 1024, 2, 32, 0.1, stream) == 1
    assert dkv(p, p, p, p, b, r, r, p, p, 1, 64, 1024, 2, 64, 0.1, stream) == 1
    assert dkv(p, p, p, p, b, r, r, p, p, 1, 62, 1024, 2, 32, 0.1, stream) == 1
    assert dkv(p, p, p, p, b, r, r, p, p, 1, 64, 330, 2, 32, 0.1, stream) == 1
    assert dkv(p, p, p, p, None, r, r, p, p, 1, 64, 1024, 2, 32, 0.1, stream) == 1
    for i in range(9):      # q, k, v, dO, the bias, lse, delta, dk, dv
        base = [p, p, p, p, b, r, r, p, p]
        ptrs = [base[j] + (4 if j in (4, 5, 6) else 2) * (j == i) for j in range(9)]
        assert dkv(*ptrs, 1, 64, 1024, 2, 32, 0.1, stream) == 1
    out = torch.empty(1, 64, 2, 32, device=cuda_device, dtype=torch.bfloat16)
    assert dq(p, p, p, p, b, r + 4, r + 4, out.data_ptr(), 1, 64, 1024, 2, 32, 0.1,
              stream) == 0
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())


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
    float32 product cast once (TF32 off); the two layouts give the same
    output where they take the same body (float32, or bfloat16 off the
    wgmma GEMM's rule). Where the [M, K] one takes the wgmma GEMM (and the
    [K, M] one the mma.sync tile), each is within the limit, and the wgmma
    output is the exact product rounded once to bfloat16: equal to it bit
    for bit in at least 99% of its elements, and every element within half
    a bfloat16 ulp of its own value plus the float32 sum's error bound,
    K x 2**-23 x sum|x||w|. A slab left out, taken twice or put in
    another tile misses by a slab's whole sum."""
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
    assert (got_km.float() - want.float()).abs().max().item() <= tol
    if not kernels.dense_wgmma_route(dtype, K, M, True, (x.data_ptr(), w.data_ptr(), 0)):
        assert torch.equal(got, got_km)
        return
    exact = x.double() @ w.double().t()
    ulp = torch.ldexp(torch.ones_like(exact),
                      torch.frexp(torch.maximum(exact.abs(), got.double().abs()))[1] - 8)
    bound = 0.5 * ulp + K * 2.0 ** -23 * (x.double().abs() @ w.double().abs().t())
    assert bool(((got.double() - exact).abs() <= bound).all())
    assert (got == exact.float().to(dtype)).float().mean().item() >= 0.99


# K6b and K7 in bfloat16 on their wgmma bodies (csrc/attn_wgmma_bias.cuh,
# the persistent GEMM of csrc/dense_matmul.cu) where kernels.folded_wgmma_route
# and kernels.dense_wgmma_route say so.
# K6b: (BH, Sq, Sk, t_rows, bias dtype, mode): ragged BH (a last group of
# fewer rows than the body's four), Sq (one of the two consumers without
# rows at 17 and 64; 129 rows: a second query tile with one row), Sk (a
# partial 64-key tile; float32 rows of a multiple of 4 keys, bfloat16 of 8),
# t_rows 2, 4 and 8 (which the wgmma body does not read); "misaligned": q,
# k, v and the bias 2 bytes past a 16-byte boundary, "ragged_bias": a bias
# row of 333 keys (not a multiple of 16 bytes), both of which the rule
# sends to the mma.sync body.
WGMMA_FOLDED_CASES = [(5, 200, 336, 4, torch.float32, ""),
                      (5, 200, 336, 4, torch.bfloat16, ""),
                      (3, 130, 1024, 4, torch.bfloat16, ""),
                      (7, 64, 64, 8, torch.float32, ""),
                      (1, 17, 8, 4, torch.float32, ""),
                      (9, 129, 1000, 4, torch.float32, ""),
                      (4, 300, 1000, 4, torch.bfloat16, ""),
                      (3, 100, 336, 4, torch.float32, "misaligned"),
                      (3, 100, 333, 4, torch.float32, "ragged_bias"),
                      (6, 100, 336, 2, torch.bfloat16, "")]


@pytest.mark.cuda
@pytest.mark.parametrize("BH,Sq,Sk,t_rows,bias_dtype,mode", WGMMA_FOLDED_CASES)
def test_wgmma_folded_on_card(cuda_device, BH, Sq, Sk, t_rows, bias_dtype, mode):
    """bfloat16 at D = 32 against the plain version within chip_smoke.py's
    phase-2 limit, the lse within 1e-4 and the output the same with and
    without it, on the body the rule names: counted in `wgmma_launches` (and
    `tc_launches`) where it names the wgmma body, in `tc_launches` alone
    where it keeps the mma.sync body."""
    g = torch.Generator(device=cuda_device).manual_seed(31)
    mis = _misaligned if mode == "misaligned" else (lambda x: x)
    rnd = lambda *s: mis(torch.randn(*s, generator=g, device=cuda_device).bfloat16())
    q, k, v = rnd(BH, Sq, 32), rnd(BH, Sk, 32), rnd(BH, Sk, 32)
    bias = mis((torch.rand(Sq, Sk, generator=g, device=cuda_device) * 2 - 1).to(bias_dtype))
    kw = dict(scale=32 ** -0.5, t_rows=t_rows)
    tattn.reset_counts()
    got, lse = kernels.shared_bias_attention_folded(q, k, v, bias, with_lse=True, **kw)
    alone = kernels.shared_bias_attention_folded(q, k, v, bias, **kw)
    want, want_lse = kernels.shared_bias_attention_folded_plain(q, k, v, bias, scale=32 ** -0.5,
                                                                with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(got, alone) and bool(torch.isfinite(got).all())
    peak = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    routed = kernels.folded_wgmma_route(torch.bfloat16, Sk, 32, bias_dtype,
                                        (q.data_ptr(), k.data_ptr(), v.data_ptr(), 0,
                                         bias.data_ptr()))
    assert routed == (mode == "")
    fn = kernels.shared_bias_attention_folded
    assert kernels.wgmma_counts()[fn.__name__] == 2 * int(routed)
    assert kernels.tc_counts()[fn.__name__] == fn.launches == 2
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,Sq,Sk", [(5, 200, 336), (3, 129, 1032)])
def test_wgmma_folded_tensor_map_boundary_on_card(cuda_device, bias_dtype, BH, Sq, Sk):
    """k and v end where a NaN slab begins, the bias where NaN rows begin,
    and the output and lse where sentinel rows begin (the wgmma C entry
    called on views of larger buffers): the maps zero-fill the key and query
    tails inside their slab and read no NaN, the stores clip the query tail,
    so out and lse match the plain version and the sentinels are
    untouched."""
    g = torch.Generator(device=cuda_device).manual_seed(32)
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda_device).bfloat16()
    q, k, v = rnd(BH, Sq, 32), rnd(BH, Sk, 32), rnd(BH, Sk, 32)
    bias = (torch.rand(Sq, Sk, generator=g, device=cuda_device) * 2 - 1).to(bias_dtype)
    kbuf = torch.full((BH + 1, Sk, 32), float("nan"), device=cuda_device).bfloat16()
    vbuf = kbuf.clone()
    kbuf[:BH], vbuf[:BH] = k, v
    bbuf = torch.full((Sq + 8, Sk), float("nan"), device=cuda_device).to(bias_dtype)
    bbuf[:Sq] = bias
    obuf = torch.full((BH + 1, Sq, 32), 7.0, device=cuda_device).bfloat16()
    lbuf = torch.full((BH * Sq + Sq,), 7.0, device=cuda_device)
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    err = lib.i360_shared_bias_attention_folded_wgmma(
        q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(), bbuf.data_ptr(), obuf.data_ptr(),
        lbuf.data_ptr(), BH, Sq, Sk, 32, 32 ** -0.5, int(bias_dtype == torch.bfloat16), stream)
    want, want_lse = kernels.shared_bias_attention_folded_plain(q, k, v, bias, scale=32 ** -0.5,
                                                                with_lse=True)
    torch.cuda.synchronize()
    assert err == 0
    got = obuf[:BH]
    peak = want.float().abs().max().item()
    assert bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    assert (lbuf[:BH * Sq].view(BH, Sq) - want_lse).abs().max().item() <= 1e-4
    assert bool((obuf[BH] == 7.0).all()) and bool((lbuf[BH * Sq:] == 7.0).all())


@pytest.mark.cuda
def test_wgmma_folded_refuses_what_it_does_not_take_on_card(cuda_device):
    """K6b's wgmma C entry launches nothing and returns
    cudaErrorInvalidValue (1) for a head dim other than 32, a null bias, a
    q, k, v, out or bias pointer off a 16-byte boundary, and a bias row that
    is no multiple of 16 bytes (float32 Sk = 330, bfloat16 Sk = 332)."""
    x = torch.zeros(4, 1024, 32, device=cuda_device, dtype=torch.bfloat16)
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    p = x.data_ptr()
    fn = lib.i360_shared_bias_attention_folded_wgmma
    assert fn(p, p, p, p, p, None, 2, 64, 128, 64, 0.1, 0, stream) == 1
    assert fn(p, p, p, None, p, None, 2, 64, 128, 32, 0.1, 0, stream) == 1
    assert fn(p + 2, p, p, p, p, None, 2, 64, 128, 32, 0.1, 0, stream) == 1
    assert fn(p, p, p, p, p + 8, None, 2, 64, 128, 32, 0.1, 0, stream) == 1
    assert fn(p, p, p, p + 4, p, None, 2, 64, 128, 32, 0.1, 0, stream) == 1
    assert fn(p, p, p, p, p, None, 2, 64, 330, 32, 0.1, 0, stream) == 1
    assert fn(p, p, p, p, p, None, 2, 64, 332, 32, 0.1, 1, stream) == 1
    torch.cuda.synchronize()


# K3 and K6a in bfloat16 at D = 32 under one bias shared by every row, on
# the biased wgmma body of csrc/attn_wgmma_bias.cuh where
# kernels.shared_bias_wgmma_route and kernels.flash_t_bias_wgmma_route say
# so: K3 on [B, S, H, 32] rows through 4-D tensor maps, K6a on its
# sequence-minor tiles. K3: (B, Sq, Sk, H, mode): B·H not a multiple of the
# body's four rows a block (9, 5, 3, 1), ragged Sq (333; 17 and 64: the
# second consumer without rows; 129: a second query tile of one row) and Sk
# (1000, 336: a partial 64-key tile; float32 bias rows of a multiple of 4
# keys); "view": the bias a row block of a larger matrix, as a rank of a
# mesh keeps it (chip_smoke.site_bias); "misaligned": q, k, v 2 bytes past
# a 16-byte boundary, "ragged_bias": a bias row of 333 keys (no multiple of
# 16 bytes), both of which the rule sends to the mma.sync body.
WGMMA_WARP_K3_CASES = [(3, 333, 1000, 3, ""), (1, 200, 336, 5, ""), (2, 64, 64, 2, "view"),
                       (1, 17, 8, 1, ""), (2, 129, 1000, 5, "view"), (4, 333, 1000, 3, "view"),
                       (3, 100, 336, 3, "misaligned"), (3, 100, 333, 3, "ragged_bias")]


def _warp_bias(g, dev, Sq, Sk, view):
    """A uniform [-1, 1) float32 bias [Sq, Sk]; with `view` rank 1's rows of
    a 2-rank mesh's [2 Sq, Sk] matrix (a view at a row offset)."""
    bias = torch.rand(2 * Sq if view else Sq, Sk, generator=g, device=dev) * 2 - 1
    return bias[Sq:] if view else bias


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,mode", WGMMA_WARP_K3_CASES)
def test_wgmma_shared_bias_on_card(cuda_device, B, Sq, Sk, H, mode):
    """K3 in bfloat16 at D = 32 against the plain version within
    chip_smoke.py's phase-2 limit, the lse within 1e-4 and the output the
    same with and without it, on the body the rule names: counted in
    `wgmma_launches` (and `tc_launches`) where it names the wgmma body, in
    `tc_launches` alone where it keeps the mma.sync body."""
    g = torch.Generator(device=cuda_device).manual_seed(41)
    mis = _misaligned if mode == "misaligned" else (lambda x: x)
    rnd = lambda *s: mis(torch.randn(*s, generator=g, device=cuda_device).bfloat16())
    q, k, v = rnd(B, Sq, H, 32), rnd(B, Sk, H, 32), rnd(B, Sk, H, 32)
    bias = _warp_bias(g, cuda_device, Sq, Sk, mode == "view")
    kw = dict(scale=32 ** -0.5)
    tattn.reset_counts()
    got, lse = kernels.shared_bias_attention(q, k, v, bias, with_lse=True, **kw)
    alone = kernels.shared_bias_attention(q, k, v, bias, **kw)
    want, want_lse = kernels.shared_bias_attention_plain(q, k, v, bias, with_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, alone) and bool(torch.isfinite(got).all())
    peak = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    assert lse.shape == (B, H, Sq) and (lse - want_lse).abs().max().item() <= 1e-4
    routed = kernels.shared_bias_wgmma_route(torch.bfloat16, Sk, 32,
                                             (q.data_ptr(), k.data_ptr(), v.data_ptr(), 0,
                                              bias.data_ptr()))
    assert routed == (mode in ("", "view"))
    fn = kernels.shared_bias_attention
    assert kernels.wgmma_counts()[fn.__name__] == 2 * int(routed)
    assert kernels.tc_counts()[fn.__name__] == fn.launches == 2
    assert kernels.lse_counts() == {fn.__name__: 1}
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H", [(3, 333, 1000, 3), (1, 129, 336, 5)])
def test_wgmma_shared_bias_tensor_map_boundary_on_card(cuda_device, B, Sq, Sk, H):
    """k and v end where a NaN batch slab begins, the bias where NaN rows
    begin, and the output and lse where sentinel rows begin (the wgmma C
    entry called on views of larger buffers): the 4-D maps zero-fill the
    key and query tails inside their batch row and read no NaN, the stores
    clip the query tail, so out and lse match the plain version and the
    sentinels are untouched."""
    g = torch.Generator(device=cuda_device).manual_seed(42)
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda_device).bfloat16()
    q, k, v = rnd(B, Sq, H, 32), rnd(B, Sk, H, 32), rnd(B, Sk, H, 32)
    bias = torch.rand(Sq, Sk, generator=g, device=cuda_device) * 2 - 1
    kbuf = torch.full((B + 1, Sk, H, 32), float("nan"), device=cuda_device).bfloat16()
    vbuf = kbuf.clone()
    kbuf[:B], vbuf[:B] = k, v
    bbuf = torch.full((Sq + 8, Sk), float("nan"), device=cuda_device)
    bbuf[:Sq] = bias
    obuf = torch.full((B + 1, Sq, H, 32), 7.0, device=cuda_device).bfloat16()
    lbuf = torch.full((B * H * Sq + Sq,), 7.0, device=cuda_device)
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    err = lib.i360_shared_bias_attention_wgmma(
        q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(), bbuf.data_ptr(), obuf.data_ptr(),
        lbuf.data_ptr(), B, Sq, Sk, H, 32, 32 ** -0.5, stream)
    want, want_lse = kernels.shared_bias_attention_plain(q, k, v, bias, scale=32 ** -0.5,
                                                         with_lse=True)
    torch.cuda.synchronize()
    assert err == 0
    got = obuf[:B]
    peak = want.float().abs().max().item()
    assert bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    assert (lbuf[:B * H * Sq].view(B, H, Sq) - want_lse).abs().max().item() <= 1e-4
    assert bool((obuf[B] == 7.0).all()) and bool((lbuf[B * H * Sq:] == 7.0).all())


@pytest.mark.cuda
def test_wgmma_shared_bias_refuses_what_it_does_not_take_on_card(cuda_device):
    """K3's wgmma C entry launches nothing and returns
    cudaErrorInvalidValue (1) for a head dim other than 32, a null bias, a
    q, k, v, out or bias pointer off a 16-byte boundary, and a bias row
    that is no multiple of 16 bytes (Sk = 330)."""
    x = torch.zeros(4, 1024, 32, device=cuda_device, dtype=torch.bfloat16)
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    p = x.data_ptr()
    fn = lib.i360_shared_bias_attention_wgmma
    assert fn(p, p, p, p, p, None, 1, 64, 128, 2, 64, 0.1, stream) == 1
    assert fn(p, p, p, None, p, None, 1, 64, 128, 2, 32, 0.1, stream) == 1
    assert fn(p + 2, p, p, p, p, None, 1, 64, 128, 2, 32, 0.1, stream) == 1
    assert fn(p, p + 8, p, p, p, None, 1, 64, 128, 2, 32, 0.1, stream) == 1
    assert fn(p, p, p, p, p + 8, None, 1, 64, 128, 2, 32, 0.1, stream) == 1
    assert fn(p, p, p, p + 4, p, None, 1, 64, 128, 2, 32, 0.1, stream) == 1
    assert fn(p, p, p, p, p, None, 1, 64, 330, 2, 32, 0.1, stream) == 1
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("view", [False, True])
def test_wgmma_shared_bias_output_matches_plain_on_card(cuda_device, with_lse, view):
    """K3 in bfloat16 at the WarpAttn head dim with 2048 keys (the bias a
    row block of a larger matrix with `view`), on its wgmma body: within
    the phase-2 limit of the plain version, the lse within 1e-4, and as
    many outputs equal to the plain version's bit for bit as P rounded once
    to bf16 keeps (at least 45%: the CPU emulation of this body keeps
    49-51%, tests/test_torch_wgmma_warp.py; the plain version, as K3's TPU
    kernel, rounds the normalised P, the body the unnormalised one, so no
    K3 body reaches chip_smoke.K5A_MATCH)."""
    g = torch.Generator(device=cuda_device).manual_seed(43)
    B, Sq, Sk, H = 2, 256, 2048, 5
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda_device).bfloat16()
    q, k, v = rnd(B, Sq, H, 32), rnd(B, Sk, H, 32), rnd(B, Sk, H, 32)
    bias = _warp_bias(g, cuda_device, Sq, Sk, view)
    kw = dict(scale=32 ** -0.5, with_lse=with_lse)
    tattn.reset_counts()
    out = kernels.shared_bias_attention(q, k, v, bias, **kw)
    want = kernels.shared_bias_attention_plain(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    if with_lse:
        (out, lse), (want, want_lse) = out, want
        assert (lse - want_lse).abs().max().item() <= 1e-4
    peak = want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    assert (out == want).float().mean().item() >= 0.45
    assert kernels.wgmma_counts()["shared_bias_attention"] == 1


# K6a: (B, H, Sq, Sk, bias shape, mode): B·H not a multiple of four (9, 5),
# Sq and Sk multiples of 8 with ragged tails against the 128-query and
# 64-key tiles (136, 1000; 8, 64), a bias [1, 1, Sq, Sk] or [Sq, Sk]-rows
# shared by every batch row and head; "ragged": Sq = 333 (no multiple of
# 8), a per-head bias [1, H, Sq, Sk], no bias, each of which the rule sends
# to the mma.sync body.
WGMMA_WARP_K6A_CASES = [(3, 3, 136, 1000, (1, 1), ""), (1, 5, 200, 336, (1, 1), ""),
                        (2, 2, 8, 64, (1, 1), ""), (1, 2, 1024, 2048, (1, 1), ""),
                        (2, 2, 333, 1000, (1, 1), "ragged"), (2, 2, 136, 1000, (1, 2), ""),
                        (2, 2, 136, 1000, None, "")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Sk,bias_head,mode", WGMMA_WARP_K6A_CASES)
def test_wgmma_flash_t_bias_on_card(cuda_device, B, H, Sq, Sk, bias_head, mode):
    """K6a in bfloat16 at D = 32 against the plain version within
    chip_smoke.py's phase-2 limit, on the body the rules name: the biased
    wgmma body where the bias is shared by every row (counted in
    `wgmma_launches`), the mma.sync body for a per-head bias, no bias or
    Sq no multiple of 8; at 2048 keys its output also equals the plain
    version's bit for bit in at least chip_smoke.K5A_MATCH of the
    elements."""
    g = torch.Generator(device=cuda_device).manual_seed(44)
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda_device).bfloat16()
    q, k, v = rnd(B, H, 32, Sq), rnd(B, H, 32, Sk), rnd(B, H, 32, Sk)
    bias = None
    if bias_head is not None:
        bias = torch.rand(*bias_head, Sq, Sk, generator=g, device=cuda_device) * 2 - 1
    tattn.reset_counts()
    got = kernels.flash_attention_t(q, k, v, bias, scale=32 ** -0.5)
    want = kernels.flash_attention_t_plain(q, k, v, bias, scale=32 ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == (B, H, Sq, 32) and bool(torch.isfinite(got).all())
    peak = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    routed = kernels.flash_t_bias_wgmma_route(
        torch.bfloat16, Sq, Sk, 32, bias_head == (1, 1),
        (q.data_ptr(), k.data_ptr(), v.data_ptr(), 0, 0 if bias is None else bias.data_ptr()))
    assert routed == (mode == "" and bias_head == (1, 1))
    fn = kernels.flash_attention_t
    assert kernels.wgmma_counts()[fn.__name__] == int(routed)
    assert kernels.tc_counts()[fn.__name__] == fn.launches == 1
    if Sk == 2048:
        assert (got == want).float().mean().item() >= chip_smoke.K5A_MATCH
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Sk", [(3, 3, 136, 1000), (1, 2, 200, 72)])
def test_wgmma_flash_t_bias_tensor_map_boundary_on_card(cuda_device, B, H, Sq, Sk):
    """q, k and v end where a NaN (batch, head) slab begins, the bias where
    NaN rows begin, and the output where a sentinel slab begins (the C
    entry on views of larger buffers): the sequence-minor maps zero-fill
    the query and key tails inside their slab, the stores clip the query
    tail, so the output matches the plain version and the sentinels are
    untouched."""
    g = torch.Generator(device=cuda_device).manual_seed(45)
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda_device).bfloat16()
    q, k, v = rnd(B, H, 32, Sq), rnd(B, H, 32, Sk), rnd(B, H, 32, Sk)
    bias = torch.rand(Sq, Sk, generator=g, device=cuda_device) * 2 - 1
    nan = lambda S: torch.full((B * H + 1, 32, S), float("nan"), device=cuda_device).bfloat16()
    qbuf, kbuf, vbuf = nan(Sq), nan(Sk), nan(Sk)
    qbuf[:B * H], kbuf[:B * H], vbuf[:B * H] = (x.reshape(B * H, 32, -1) for x in (q, k, v))
    bbuf = torch.full((Sq + 8, Sk), float("nan"), device=cuda_device)
    bbuf[:Sq] = bias
    obuf = torch.full((B * H + 1, Sq, 32), 7.0, device=cuda_device).bfloat16()
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    err = lib.i360_flash_attention_t_bias_wgmma(
        qbuf.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(), bbuf.data_ptr(), obuf.data_ptr(), B,
        Sq, Sk, H, 32, 32 ** -0.5, stream)
    want = kernels.flash_attention_t_plain(q, k, v, bias[None, None], scale=32 ** -0.5)
    torch.cuda.synchronize()
    assert err == 0
    got = obuf[:B * H].view(B, H, Sq, 32)
    peak = want.float().abs().max().item()
    assert bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() <= min(2e-2, 2 ** -5 * peak)
    assert bool((obuf[B * H] == 7.0).all())


@pytest.mark.cuda
def test_wgmma_flash_t_bias_refuses_what_it_does_not_take_on_card(cuda_device):
    """K6a's biased wgmma C entry launches nothing and returns
    cudaErrorInvalidValue (1) for a head dim other than 32, a null bias, a
    pointer off a 16-byte boundary, and Sq or Sk no multiple of 8."""
    x = torch.zeros(4, 32, 2048, device=cuda_device, dtype=torch.bfloat16)
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    p = x.data_ptr()
    fn = lib.i360_flash_attention_t_bias_wgmma
    assert fn(p, p, p, p, p, 1, 64, 128, 2, 64, 0.1, stream) == 1
    assert fn(p, p, p, None, p, 1, 64, 128, 2, 32, 0.1, stream) == 1
    assert fn(p + 2, p, p, p, p, 1, 64, 128, 2, 32, 0.1, stream) == 1
    assert fn(p, p, p, p + 4, p, 1, 64, 128, 2, 32, 0.1, stream) == 1
    assert fn(p, p, p, p, p + 8, 1, 64, 128, 2, 32, 0.1, stream) == 1
    assert fn(p, p, p, p, p, 1, 60, 128, 2, 32, 0.1, stream) == 1
    assert fn(p, p, p, p, p, 1, 64, 132, 2, 32, 0.1, stream) == 1
    torch.cuda.synchronize()


# K7: (N, K, M, mode): N ragged against the 128-row tiles and of one row;
# K a multiple of 8 and not of the 64-element slab (72, 8); M the model's
# (320, 640, 1280: the tile's 160 columns divide them) and others (200, 8, 1000:
# the last column tile clipped); "misaligned": x, w and out 2 bytes past a
# 16-byte boundary, "ragged": K = 77 (the ragged site), both of which the
# rule sends to the mma.sync tile.
WGMMA_DENSE_CASES = [(1000, 320, 320, ""), (129, 64, 200, ""), (4096, 1280, 1280, ""),
                     (300, 72, 160, ""), (1, 8, 8, ""), (257, 640, 640, ""),
                     (2000, 320, 1000, ""), (300, 320, 320, "misaligned"),
                     (1000, 77, 320, "ragged")]


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,M,mode", WGMMA_DENSE_CASES)
def test_wgmma_dense_on_card(cuda_device, N, K, M, mode):
    """bfloat16 with nn.Linear's [M, K] weight against the plain float32
    product cast once, within one bf16 ulp of the largest output (phase 2's
    limit), on the body the rule names: counted in `wgmma_launches` (and
    `tc_launches`) where it names the wgmma GEMM; and on grids of 1, 3 and
    the card's SMs (several tiles a block) the same output."""
    g = torch.Generator(device=cuda_device).manual_seed(33)
    mis = _misaligned if mode == "misaligned" else (lambda x: x)
    x = mis(torch.randn(N, K, generator=g, device=cuda_device).bfloat16())
    w = mis(torch.randn(M, K, generator=g, device=cuda_device).bfloat16())
    tattn.reset_counts()
    got = kernels.dense_matmul(x, w, linear_layout=True)
    want = kernels.dense_matmul_plain(x, w, linear_layout=True)
    torch.cuda.synchronize()
    peak = want.float().abs().max().item()
    assert got.shape == (N, M) and bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -7 * peak
    routed = kernels.dense_wgmma_route(torch.bfloat16, K, M, True,
                                       (x.data_ptr(), w.data_ptr(), 0))
    assert routed == (mode == "")
    assert kernels.wgmma_counts()["dense_matmul"] == int(routed)
    assert kernels.tc_counts()["dense_matmul"] == kernels.dense_matmul.launches == 1
    assert tattn.plain_path_calls() == 0
    if routed:
        lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
        sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        for grid in (1, 3, sms):
            out = torch.empty_like(got)
            assert lib.i360_dense_matmul_wgmma(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                               N, K, M, grid, stream) == 0
            torch.cuda.synchronize()
            assert torch.equal(out, got)


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,M", [(1000, 320, 320), (130, 72, 200)])
def test_wgmma_dense_tensor_map_boundary_on_card(cuda_device, N, K, M):
    """x ends where NaN rows begin and out where sentinel rows and columns
    begin (out a view of a wider buffer would break the map's rows, so the
    sentinel rows follow it; the wgmma C entry called on views of larger
    buffers): the loads zero-fill the row tail and read no NaN, the stores
    clip it, so the output matches the plain version and the sentinels are
    untouched."""
    g = torch.Generator(device=cuda_device).manual_seed(34)
    x = torch.randn(N, K, generator=g, device=cuda_device).bfloat16()
    w = torch.randn(M, K, generator=g, device=cuda_device).bfloat16()
    xbuf = torch.full((N + 200, K), float("nan"), device=cuda_device).bfloat16()
    xbuf[:N] = x
    obuf = torch.full((N + 200, M), 7.0, device=cuda_device).bfloat16()
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    plan = kernels.dense_wgmma_plan(N, K, M, 132)
    err = lib.i360_dense_matmul_wgmma(xbuf.data_ptr(), w.data_ptr(), obuf.data_ptr(), N, K, M,
                                      plan["grid"], stream)
    want = kernels.dense_matmul_plain(x, w, linear_layout=True)
    torch.cuda.synchronize()
    assert err == 0
    peak = want.float().abs().max().item()
    assert (obuf[:N].float() - want.float()).abs().max().item() <= 2 ** -7 * peak
    assert bool((obuf[N:] == 7.0).all())


@pytest.mark.cuda
def test_wgmma_dense_refuses_what_it_does_not_take_on_card(cuda_device):
    """K7's wgmma C entry launches nothing and returns cudaErrorInvalidValue
    (1) for a K or M that is no multiple of 8, an x, w or out pointer off a
    16-byte boundary, and no blocks."""
    x = torch.zeros(1024, 1024, device=cuda_device, dtype=torch.bfloat16)
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    p = x.data_ptr()
    fn = lib.i360_dense_matmul_wgmma
    assert fn(p, p, p, 64, 77, 64, 1, stream) == 1
    assert fn(p, p, p, 64, 64, 20, 1, stream) == 1
    assert fn(p + 2, p, p, 64, 64, 64, 1, stream) == 1
    assert fn(p, p + 8, p, 64, 64, 64, 1, stream) == 1
    assert fn(p, p, p + 4, 64, 64, 64, 1, stream) == 1
    assert fn(p, p, p, 64, 64, 64, 0, stream) == 1
    torch.cuda.synchronize()


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
    """L1 at every (G, R) that divides the site and fits (bfloat16: on K4's
    tile, G up to 8, striped_v2_mma_plan) and L3 at every G up to 4, against
    K4's plain version and the K4 kernel."""
    _, q, k, v, kw = _lab_inputs(cuda_device, dtype, shape, 8)
    B, F, HW, C, heads = shape
    bf16 = dtype == torch.bfloat16
    want = kernels.frame_attention_plain(q, k, v, **kw).float()
    prod = kernels.frame_attention(q, k, v, **kw).float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    tattn.reset_counts()
    n1 = n3 = 0
    for G in (1, 2, 3, 4, 8):
        if HW % G:
            continue
        if G <= 4:
            got = kernels.diag_motion_attention(q, k, v, G=G, **kw)
            n3 += 1
            torch.cuda.synchronize()
            assert got.dtype == dtype and (got.float() - want).abs().max().item() <= tol, G
            assert (got.float() - prod).abs().max().item() <= tol
        for R in (1, 2, 3):
            if (HW // G) % R:
                continue
            if bf16:
                try:
                    kernels.striped_v2_mma_plan(G, F, C // heads, heads)
                except ValueError:
                    continue
            elif kernels.striped_v2_smem_bytes(G, F, C, heads, 4) > kernels.SMEM_LIMIT:
                continue     # the float32 pack of 4 x 320 channels x 16 frames does not fit
            got = kernels.striped_v2_attention(q, k, v, G=G, R=R, **kw)
            n1 += 1
            torch.cuda.synchronize()
            assert got.dtype == dtype and (got.float() - want).abs().max().item() <= tol, (G, R)
            assert (got.float() - prod).abs().max().item() <= tol, (G, R)
    assert kernels.striped_v2_attention.launches == n1 > 0
    assert kernels.diag_motion_attention.launches == n3 > 0
    # L1 and L3 take the tensor cores for every bfloat16 call, none in float32
    assert kernels.diag_motion_attention.tc_launches == (n3 if bf16 else 0)
    assert kernels.striped_v2_attention.tc_launches == (n1 if bf16 else 0)
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("F,G,R", [(64, 2, 2), (40, 1, 4), (17, 4, 1)])
def test_striped_v2_tensor_cores_long_frames(cuda_device, F, G, R):
    """bf16 L1 over four 16-frame tiles (F = 64, K4's limit), a ragged last
    tile, one or several packs a block, against K4's plain version; F = 65
    raises."""
    _, q, k, v, kw = _lab_inputs(cuda_device, torch.bfloat16, (1, F, 16, 2 * 40, 2), 13)
    tattn.reset_counts()
    got = kernels.striped_v2_attention(q, k, v, G=G, R=R, **kw).float()
    want = kernels.frame_attention_plain(q, k, v, **kw).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-2
    assert kernels.striped_v2_attention.tc_launches == kernels.striped_v2_attention.launches == 1
    x = torch.zeros(1, 65, 16, 80, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="frames"):
        kernels.striped_v2_attention(x, x, x, G=G, R=R, **kw)
    assert kernels.striped_v2_attention.launches == 1 and tattn.plain_path_calls() == 0


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
    # L2 takes the tensor cores for every bfloat16 call
    assert kernels.fused_motion_attention.tc_launches == (n if dtype == torch.bfloat16 else 0)
    assert tattn.plain_path_calls() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("exp_bf16", [False, True])
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,heads,offset", [(8 * 40, 8, 0), (4 * 80, 4, 0), (2 * 160, 2, 0),
                                            (8 * 40, 8, 1)])
def test_fused_motion_tensor_cores_long_ragged(cuda_device, exp_bf16, bias_dtype, C, heads,
                                               offset):
    """bf16 L2 on a ragged sequence of 32 x 7 = 224 tokens (four query tiles,
    four key tiles, the last of each ragged) under a partly -inf bias, at 2
    heads a block (head dims 40 and 80) and 1 (head dim 160, where two do not
    fit; fused_motion_mma_plan), and with `offset` 1 on tensors that start 2
    bytes off a 16-byte boundary (the 2-byte path)."""
    B, F, HW, G = 2, 7, 64, 32
    S = G * F
    g = torch.Generator(device=cuda_device).manual_seed(11)
    n = B * F * HW * C
    q, k, v = (torch.randn(n + offset, generator=g, device=cuda_device).bfloat16()[offset:]
               .view(B, F, HW, C) for _ in range(3))
    bias = torch.rand(1, S, S, generator=g, device=cuda_device) * 2 - 1
    drop = torch.rand(S, S, generator=g, device=cuda_device) < 0.3
    drop &= ~torch.eye(S, dtype=torch.bool, device=cuda_device)
    bias = bias.masked_fill(drop[None], float("-inf")).to(bias_dtype)
    kw = dict(scale=(C // heads) ** -0.5, heads=heads, G=G, exp_bf16=exp_bf16)
    tattn.reset_counts()
    got = kernels.fused_motion_attention(q, k, v, bias, **kw)
    want = kernels.fused_motion_attention_plain(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    fn = kernels.fused_motion_attention
    assert fn.tc_launches == fn.launches == 1


# (shape, G, the plan's heads a stage, heads a stage run): the plan, and
# fewer heads a stage
DIAG_PLAN_CASES = [((2, 16, 64, 8 * 40, 8), 32, 1, 1),
                   ((2, 16, 64, 8 * 40, 8), 16, 1, 1),
                   ((2, 16, 64, 8 * 40, 8), 4, 4, 4),
                   ((2, 16, 64, 8 * 40, 8), 4, 4, 2),
                   ((2, 16, 64, 8 * 40, 8), 4, 4, 1),
                   ((1, 16, 16, 8 * 160, 8), 8, 1, 1),
                   ((1, 32, 8, 4 * 40, 4), 2, 4, 4),
                   ((1, 32, 8, 4 * 40, 4), 2, 4, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,G,plan,hg", DIAG_PLAN_CASES)
def test_diag_motion_tensor_core_plans(cuda_device, monkeypatch, shape, G, plan, hg):
    """bf16 L3 under its plan (diag_motion_mma_plan: one or four heads a
    stage, 16 or 32 frames) and with fewer heads a stage; against K4's plain
    version and the K4 kernel."""
    B, F, HW, C, heads = shape
    D = C // heads
    assert kernels.diag_motion_mma_plan(G, F, D, heads)[0] == plan
    if hg != plan:
        smem = kernels._frame_stage_bytes(F, D, G, hg)
        monkeypatch.setattr(kernels, "diag_motion_mma_plan", lambda *a: (hg, smem))
    _, q, k, v, kw = _lab_inputs(cuda_device, torch.bfloat16, shape, 12)
    tattn.reset_counts()
    got = kernels.diag_motion_attention(q, k, v, G=G, **kw).float()
    want = kernels.frame_attention_plain(q, k, v, **kw).float()
    prod = kernels.frame_attention(q, k, v, **kw).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-2
    assert (got - prod).abs().max().item() <= 2e-2
    assert kernels.diag_motion_attention.tc_launches == kernels.diag_motion_attention.launches == 1


@pytest.mark.cuda
def test_lab_wrappers_raise_on_card_for_what_does_not_fit(cuda_device):
    """A pack beyond a block's shared memory raises; nothing shrinks it and
    nothing falls back to the plain version. (L2 in bfloat16 streams over the
    keys and fits every pack: its float32 kernel holds a head's K and V.)"""
    x = torch.zeros(1, 16, 32, 1280, device=cuda_device, dtype=torch.bfloat16)
    bias = torch.zeros(1, 512, 512, device=cuda_device)
    kw = dict(scale=1.0, heads=8)
    tattn.reset_counts()
    with pytest.raises(ValueError, match="shared memory"):
        kernels.striped_v2_attention(x, x, x, G=2, R=1, **kw)
    x32 = x.float()
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fused_motion_attention(x32, x32, x32, bias, G=32, **kw)
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
    # K4 and L1-L3 on the tensor cores for every call
    for fn in (kernels.frame_attention, *kernels.LAB_KERNELS):
        assert fn.tc_launches == fn.launches > 0, fn.__name__


# ---- the SR stage: blur, wavelet colour fix, the temporal-decoder VAE -------


@pytest.mark.cuda
def test_sr_blur_and_wavelet_on_card(cuda_device):
    """float32 on the card against the same ops on the CPU: the blur (both
    borders) and the wavelet colour fix (radius 16 past a 10-row frame) are
    elementwise sums in one order, 1e-6 abs."""
    from imagine360_tpu_torch.ops.blur import gaussian_blur_5x5
    from imagine360_tpu_torch.sr.wavelet_fix import wavelet_color_fix

    g = torch.Generator().manual_seed(14)
    x = torch.randn(2, 3, 10, 37, generator=g)
    t, s = torch.rand(2, 3, 10, 37, generator=g), torch.rand(2, 3, 10, 37, generator=g)
    for wrap in (False, True):
        got = gaussian_blur_5x5(x.to(cuda_device), wrap_w=wrap).cpu()
        assert (got - gaussian_blur_5x5(x, wrap_w=wrap)).abs().max().item() <= 1e-6
    got = wavelet_color_fix(t.to(cuda_device), s.to(cuda_device)).cpu()
    assert (got - wavelet_color_fix(t, s)).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_temporal_vae_decode_bf16_on_card(cuda_device):
    """The tiny temporal decoder in bf16 on the card (its mid-block attention
    through K1 on the tensor cores) against float32 on the CPU (plain
    attention), a 5-frame video and a 1-frame one, tiled as the SR stage
    decodes: within 5e-2 of the output's largest element (bf16 activations
    through some 20 convolutions; bf16 on the CPU is 1.8% off)."""
    from imagine360_tpu_torch.models.vae import VAEConfig
    from imagine360_tpu_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
    from imagine360_tpu_torch.sr.tiled_decode import tiled_chunked_decode

    torch.manual_seed(15)
    vae = AutoencoderKLTemporalDecoder(VAEConfig(block_out_channels=(32, 32),
                                                 layers_per_block=1)).eval()
    with torch.no_grad():
        for p in vae.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    card = AutoencoderKLTemporalDecoder(vae.cfg).to(cuda_device, torch.bfloat16).eval()
    card.load_state_dict(vae.state_dict())
    z = torch.randn(6, 4, 7, 11, generator=torch.Generator().manual_seed(16))
    with torch.no_grad():
        want = tiled_chunked_decode(vae.decode, z, tile_hw=(4, 6), chunk=5, scale=2)
        tattn.reset_counts()
        got = tiled_chunked_decode(card.decode, z.to(cuda_device), tile_hw=(4, 6), chunk=5,
                                   scale=2).cpu()
    torch.cuda.synchronize()
    assert got.shape == want.shape == (6, 3, 14, 22) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 5e-2 * want.abs().max().item()
    assert kernels.tiny_attention.tc_launches == kernels.tiny_attention.launches > 0
    assert tattn.plain_path_calls() == 0


# ---- the SR engines: the enhancer with the pano refiner, the V2V UNet ------

SR_CARD_CASES = [  # (wrapper, q shape, heads): SR-shaped, many batch rows, 16 frames
    ("mh_flash_attention", (16, 1500, 2 * 64), 2),        # spatial self-attention
    ("tiny_attention", (4096, 16, 5 * 64), 5),            # V2V temporal transformer
    ("frame_attention", (1, 16, 4096, 320), 8),           # motion modules
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,qs,heads", SR_CARD_CASES)
def test_sr_shaped_kernels_on_card(cuda_device, dtype, name, qs, heads):
    """K2, K1 and K4 at reduced SR shapes against their plain versions:
    1e-4 abs in float32, min(2e-2, 2**-5 x the largest output) in bf16."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    q, k, v = (torch.randn(qs, generator=g, device=cuda_device).to(dtype) for _ in range(3))
    kw = dict(scale=(qs[-1] // heads) ** -0.5, heads=heads)
    tattn.reset_counts()
    got = getattr(kernels, name)(q, k, v, **kw)
    want = getattr(kernels, name + "_plain")(q, k, v, **kw).float()
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else min(2e-2, 2 ** -5 * want.abs().max().item())
    assert (got.float() - want).abs().max().item() <= tol
    fn = getattr(kernels, name)
    assert fn.launches == 1 and fn.tc_launches == (dtype == torch.bfloat16)


def sr_enhancer_bf16_vs_f32(device, seed=18):
    """(bf16 output on `device`, float32 output on the CPU, plain-path
    attention calls of the bf16 run) of the tiny SR enhancer with the pano
    refiner (tiny_unet_config, seeded weights, a 16-wide f8 VAE), 3 frames
    of 32 x 64, one seeded EnhancerNoise for both."""
    from imagine360_tpu_torch.models.unet3d import UNet3DConditionModel
    from imagine360_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from imagine360_tpu_torch.presets import tiny_unet_config
    from imagine360_tpu_torch.sr.enhance import EnhancerConfig, EnhancerNoise, Video360Enhancer
    from imagine360_tpu_torch.sr.refiner import PanoRefiner
    from imagine360_tpu_torch.utils.init import seeded_init_

    g = torch.Generator().manual_seed(seed)
    unet, vae = UNet3DConditionModel(tiny_unet_config()), AutoencoderKL(
        VAEConfig(block_out_channels=(16, 16, 16, 16), layers_per_block=1, norm_num_groups=16))
    seeded_init_(unet, g)
    seeded_init_(vae, g)
    cfg = EnhancerConfig(chunk_frames=2, tile_hw=(6, 16))
    frames = torch.rand(3, 32, 64, 3, generator=g)
    outs = []
    for dev, dtype in ((device, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        enh = Video360Enhancer(PanoRefiner(unet.to(dev, dtype).eval()),
                               vae.to(dev, dtype).eval(), cfg)
        if not outs:
            shape = enh.latent_shape(frames.shape)
            noise = EnhancerNoise(*(torch.randn(s, generator=g) for s in (
                shape, shape, (enh.refine_steps,) + shape)))
            tattn.reset_counts()
        outs.append(enh(frames, noise=noise).float().cpu())
        if len(outs) == 1:
            plain = tattn.plain_path_calls()
    return outs + [plain]


@pytest.mark.cuda
def test_sr_pano_enhancer_bf16_on_card(cuda_device):
    """The tiny enhancer with the pano refiner in bf16 on the card (K1 and
    K4 on the tensor cores) against float32 on the CPU. bf16 latents through
    the VAE, four refine steps and the decode drift further than the decode
    alone: bf16 on the CPU is 3.6-6.7% off at the largest error over seeds
    18, 1, 2, 3, 0.42-0.52% in the mean. So the mean error is held to 1e-2
    and the largest to 1e-1 of the largest element."""
    got, want, plain = sr_enhancer_bf16_vs_f32(cuda_device)
    assert got.shape == want.shape == (3, 64, 128, 3) and bool(torch.isfinite(got).all())
    err = (got - want).abs()
    peak = want.abs().max().item()
    assert err.mean().item() <= 1e-2 * peak and err.max().item() <= 1e-1 * peak, (
        err.mean().item(), err.max().item(), peak)
    for fn in (kernels.tiny_attention, kernels.frame_attention):
        assert fn.tc_launches == fn.launches > 0, fn.__name__
    assert plain == 0


def v2v_bf16_vs_f32(device):
    """(bf16 output on `device`, float32 output on the CPU, plain-path
    attention calls of the bf16 run) of the tiny ControlledV2VUNet with
    seeded weights (its zero leaves too)."""
    from imagine360_tpu_torch.sr.unet_v2v import ControlledV2VUNet, tiny_v2v_config
    from imagine360_tpu_torch.utils.init import seeded_init_

    g = torch.Generator().manual_seed(19)
    model = ControlledV2VUNet(tiny_v2v_config())
    seeded_init_(model, g)
    x, hint = torch.randn(1, 4, 8, 16, 4, generator=g), torch.randn(1, 4, 8, 16, 4, generator=g)
    ctx = torch.randn(1, 77, 24, generator=g)
    kw = dict(t_hint=torch.tensor([199.0]), mask_cond=torch.tensor([[1.0, 0.0, 1.0, 0.0]]),
              s_cond=torch.tensor([2.0]))
    outs = []
    tattn.reset_counts()
    for dev, dtype in ((device, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        m = model.to(dev, dtype).eval()
        with torch.no_grad():
            outs.append(m(x.to(dev), torch.tensor([500.0], device=dev), ctx.to(dev),
                          hint.to(dev), **{k: v.to(dev) for k, v in kw.items()}).float().cpu())
        if len(outs) == 1:
            plain = tattn.plain_path_calls()
    return outs + [plain]


@pytest.mark.cuda
def test_v2v_forward_bf16_on_card(cuda_device):
    """The tiny V2V UNet with its ControlNet in bf16 on the card (spatial,
    cross and temporal attention through K1 on the tensor cores) against
    float32 on the CPU: within 5e-2 of the largest element (bf16 on the CPU
    is 2.1% off)."""
    got, want, plain = v2v_bf16_vs_f32(cuda_device)
    assert got.shape == want.shape == (1, 4, 8, 16, 4) and bool(torch.isfinite(got).all())
    err, peak = (got - want).abs().max().item(), want.abs().max().item()
    assert err <= 5e-2 * peak, (err, peak)
    assert kernels.tiny_attention.tc_launches == kernels.tiny_attention.launches > 0
    assert plain == 0
