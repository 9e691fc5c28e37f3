"""The plain versions of the training-step kernels (K5a forward with lse, K5b
dq, K5c dk/dv, K3 with its lse) against the JAX package's Pallas kernels run
in interpret mode on the CPU, against PyTorch's autograd through the plain
reference, and the autograd functions of ops/attention.py against autograd.

Inputs come from numpy.random.default_rng and go to both packages. The port
runs its plain versions here (CPU tensors); the CUDA kernels are held
against the same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: float32 1e-5 abs (the same arithmetic in float32, another
summation order: the Pallas kernels sum block by block); bfloat16 2e-2 abs
on unit-scale inputs (both sides take bf16 inputs up to float32, so only the
final rounding to bf16 differs).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from imagine360_tpu.ops.pallas_attention import (_flash_shared_bias_t, flash_attention_bwd,
                                                 flash_attention_fwd_res)

from imagine360_tpu_torch.ops import attention as tattn
from imagine360_tpu_torch.ops import kernels
from imagine360_tpu_torch.ops.dispatch import select_attention_route

B, SQ, SK, H, D = 2, 200, 300, 2, 32      # ragged: no multiple of any block
SCALE = D ** -0.5
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BIAS_SHAPES = {"none": None, "shared": (1, 1, SQ, SK), "full": (B, H, SQ, SK)}


def _inputs(dtype, bias_kind, seed=0):
    """numpy float32 q, k, v, g (values exact in `dtype`) and a float32 bias."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(getattr(torch, dtype)).float().numpy()

    q, k, v, g = rnd(B, SQ, H, D), rnd(B, SK, H, D), rnd(B, SK, H, D), rnd(B, SQ, H, D)
    shape = BIAS_SHAPES[bias_kind]
    bias = None if shape is None else rng.standard_normal(shape).astype(np.float32)
    return q, k, v, g, bias


def _torch(dtype, *arrays):
    return [None if a is None else torch.from_numpy(a).to(getattr(torch, dtype))
            for a in arrays]


def _err(got, want):
    return float(np.abs(got.detach().float().numpy() - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_kind", ["none", "shared", "full"])
def test_streaming_plain_versions_match_pallas_interpret(dtype, bias_kind):
    q, k, v, g, bias = _inputs(dtype, bias_kind)
    jd = jnp.dtype(dtype)
    jq, jk, jv, jg = (jnp.asarray(a, jd) for a in (q, k, v, g))
    jb = None if bias is None else jnp.asarray(bias)
    want_out, want_lse = flash_attention_fwd_res(jq, jk, jv, bias=jb, scale=SCALE,
                                                 interpret=True)
    want_dq, want_dk, want_dv = flash_attention_bwd(jq, jk, jv, jb, want_out, want_lse, jg,
                                                    scale=SCALE, interpret=True)

    tq, tk, tv, tg = _torch(dtype, q, k, v, g)
    tb = None if bias is None else torch.from_numpy(bias)
    out, lse = kernels.flash_attention_lse_plain(tq, tk, tv, tb, scale=SCALE)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32 and lse.shape == (B, H, SQ)
    tol = TOL[dtype]
    assert _err(out, want_out.astype(jnp.float32)) <= tol
    assert _err(lse, want_lse[:, :, :SQ, 0]) <= 1e-5
    # the backward of each side reads its own forward's out and lse
    delta = kernels.attention_delta(tg, out)
    dq = kernels.flash_bwd_dq_plain(tq, tk, tv, tb, tg, lse, delta, scale=SCALE)
    dk, dv = kernels.flash_bwd_dkv_plain(tq, tk, tv, tb, tg, lse, delta, scale=SCALE)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == tq.dtype
        assert _err(got, want.astype(jnp.float32)) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_bias_plain_with_lse_matches_pallas_interpret(dtype):
    q, k, v, _, bias = _inputs(dtype, "shared", seed=1)
    jd = jnp.dtype(dtype)

    def fold(x):     # [B, S, H, D] -> [B*H, D, S], the Pallas kernel's layout
        return jnp.asarray(x, jd).transpose(0, 2, 3, 1).reshape(B * H, D, -1)

    want_out, want_lse = _flash_shared_bias_t(fold(q), fold(k), fold(v),
                                              jnp.asarray(bias[0, 0].T), SCALE, t_rows=4,
                                              with_lse=True, interpret=True)
    want_out = want_out.astype(jnp.float32).reshape(B, H, D, SQ).transpose(0, 3, 1, 2)
    tq, tk, tv = _torch(dtype, q, k, v)
    out, lse = kernels.shared_bias_attention(tq, tk, tv, torch.from_numpy(bias[0, 0]),
                                             scale=SCALE, with_lse=True)
    assert _err(out, want_out) <= TOL[dtype]
    assert lse.shape == (B, H, SQ)
    assert _err(lse, want_lse.reshape(B, H, -1)[:, :, :SQ]) <= 1e-5
    # without the lse the output is the same tensor
    assert torch.equal(out, kernels.shared_bias_attention(
        tq, tk, tv, torch.from_numpy(bias[0, 0]), scale=SCALE))


def _autograd_reference(q, k, v, bias, g):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = kernels.reference_attention(*leaves, bias=bias, scale=SCALE)
    return out, torch.autograd.grad(out, leaves, g)


@pytest.mark.parametrize("bias_kind", ["none", "shared", "full"])
def test_plain_backward_formulas_match_autograd(bias_kind):
    """flash_bwd_dq_plain / _dkv_plain are written from the formulas, not
    through autograd: hold them, and reference_attention_vjp, against
    autograd of the plain reference (float32, 1e-5)."""
    q, k, v, g, bias = _torch("float32", *_inputs("float32", bias_kind, seed=2))
    out, (rq, rk, rv) = _autograd_reference(q, k, v, bias, g)
    got_out, lse = kernels.flash_attention_lse_plain(q, k, v, bias, scale=SCALE)
    assert _err(got_out, out.detach().numpy()) <= 1e-5
    delta = kernels.attention_delta(g, got_out)
    dq = kernels.flash_bwd_dq_plain(q, k, v, bias, g, lse, delta, scale=SCALE)
    dk, dv = kernels.flash_bwd_dkv_plain(q, k, v, bias, g, lse, delta, scale=SCALE)
    for got, want in zip((dq, dk, dv) + kernels.reference_attention_vjp(q, k, v, bias, g, SCALE),
                         (rq, rk, rv) * 2):
        assert _err(got, want.numpy()) <= 1e-5


def test_lse_of_fully_masked_row_is_finite():
    """A row whose every key is masked with -inf: the max stays at the
    kernels' finite -1e30, the zero denominator becomes 1, the output is 0
    and the backward gives zeros, not NaN."""
    q, k, v, g, _ = _torch("float32", *_inputs("float32", "none", seed=3))
    bias = torch.zeros(1, 1, SQ, SK)
    bias[0, 0, 5] = float("-inf")
    out, lse = kernels.flash_attention_lse_plain(q, k, v, bias, scale=SCALE)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (out[:, 5] == 0).all() and (lse[:, :, 5] == -1e30).all()
    delta = kernels.attention_delta(g, out)
    dq = kernels.flash_bwd_dq_plain(q, k, v, bias, g, lse, delta, scale=SCALE)
    dk, dv = kernels.flash_bwd_dkv_plain(q, k, v, bias, g, lse, delta, scale=SCALE)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv)) and (dq[:, 5] == 0).all()


FUNCTION_CASES = {
    "shared_bias": lambda q, k, v, b: tattn._StreamingAttention.apply(q, k, v, b[0, 0], SCALE,
                                                                      True),
    "flash_lse_no_bias": lambda q, k, v, b: tattn._StreamingAttention.apply(q, k, v, None,
                                                                            SCALE, False),
    "flash_lse_full_bias": lambda q, k, v, b: tattn._StreamingAttention.apply(q, k, v, b, SCALE,
                                                                              False),
    "tiny": lambda q, k, v, b: tattn._TinyAttention.apply(q, k, v, SCALE),
}


@pytest.mark.parametrize("case", sorted(FUNCTION_CASES))
def test_autograd_functions_match_autograd(case):
    """Each torch.autograd.Function (on the CPU, its kernels' plain versions
    inside) against autograd through the plain reference, float32, 1e-5."""
    bias_kind = {"shared_bias": "shared", "flash_lse_full_bias": "full"}.get(case, "none")
    q, k, v, g, bias = _torch("float32", *_inputs("float32", bias_kind, seed=4))
    want_out, want = _autograd_reference(q, k, v, bias, g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tattn.reset_counts()
    out = FUNCTION_CASES[case](*leaves, bias)
    got = torch.autograd.grad(out, leaves, g)
    assert _err(out, want_out.detach().numpy()) <= 1e-5
    for a, b in zip(got, want):
        assert _err(a, b.numpy()) <= 1e-5
    assert tattn.einsum_backward_calls() == (1 if case == "tiny" else 0)


def test_frame_attention_function_matches_autograd():
    rng = np.random.default_rng(5)
    x = [torch.from_numpy(rng.standard_normal((2, 6, 9, 32)).astype(np.float32)) for _ in range(4)]
    leaves = [t.clone().requires_grad_() for t in x[:3]]
    want_out = kernels.frame_attention_plain(*leaves, scale=0.25, heads=2)
    want = torch.autograd.grad(want_out, leaves, x[3])
    leaves2 = [t.clone().requires_grad_() for t in x[:3]]
    tattn.reset_counts()
    out = tattn.temporal_attention(*leaves2, heads=2)
    got = torch.autograd.grad(out, leaves2, x[3])
    assert _err(out, want_out.detach().numpy()) <= 1e-5
    for a, b in zip(got, want):
        assert _err(a, b.numpy()) <= 1e-5
    assert tattn.einsum_backward_calls() == 1


@pytest.mark.parametrize("bias_kind,route_calls", [
    ("none", {"tiny_attention": 1}),
    ("shared", {"shared_bias_attention": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}),
    ("full", {"flash_attention_lse": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}),
])
def test_entry_point_under_grad_takes_the_functions(bias_kind, route_calls):
    """dot_product_attention under grad goes through the autograd functions
    on the CPU too (each wrapper runs its plain version and counts it), a
    bias gets no gradient, and one that requires grad raises."""
    q, k, v, g, bias = _torch("float32", *_inputs("float32", bias_kind, seed=6))
    want_out, want = _autograd_reference(q, k, v, bias, g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tattn.reset_counts()
    out = tattn.dot_product_attention(*leaves, bias=bias, scale=SCALE)
    got = torch.autograd.grad(out, leaves, g)
    for a, b in zip(got, want):
        assert _err(a, b.numpy()) <= 1e-5
    calls = {n: c["plain_calls"] for n, c in kernels.counts().items() if c["plain_calls"]}
    assert calls == route_calls
    if bias is not None:
        with pytest.raises(ValueError, match="constant"):
            tattn.dot_product_attention(*leaves, bias=bias.requires_grad_(), scale=SCALE)
    # without grad the same call takes the plain einsum path, as before
    tattn.reset_counts()
    with torch.no_grad():
        tattn.dot_product_attention(*leaves, bias=None if bias is None else bias.detach(),
                                    scale=SCALE)
    assert tattn.dot_product_attention.plain_calls == 1


@pytest.mark.parametrize("shape,has_bias,shared,expect", [
    ((16, 8192, 8192, 5, 64), False, True, "flash_lse"),        # pano spatial s0
    ((16, 2048, 2048, 10, 64), False, True, "flash_lse"),       # pano spatial s1
    ((16, 2048, 5120, 10, 32), True, True, "shared_bias"),      # WarpAttn r2
    ((16, 128, 320, 40, 32), True, True, "shared_bias"),        # WarpAttn r8
    ((16, 2048, 5120, 10, 32), True, False, "flash_lse"),       # a per-head bias
    ((320, 1024, 1024, 5, 64), False, True, "single"),          # perspective spatial s0
    ((16, 8192, 77, 5, 64), False, True, "single"),             # pano text cross
])
def test_routes_under_grad(shape, has_bias, shared, expect):
    assert select_attention_route(*shape, has_bias, on_cuda=True, needs_grad=True,
                                  bias_is_shared=shared) == expect
    # the CPU takes the same route under grad, and the plain einsum without
    assert select_attention_route(*shape, has_bias, on_cuda=False, needs_grad=True,
                                  bias_is_shared=shared) == expect
    assert select_attention_route(*shape, has_bias, on_cuda=False) in ("einsum", "chunked")


def test_routes_under_grad_head_dim_limit():
    """K5a-c take head dims up to 160: a longer streamed site under grad
    raises on the card and falls to the plain einsum on the CPU; K1 still
    takes 512 under grad (its backward is the einsum reference)."""
    with pytest.raises(ValueError, match="under grad"):
        select_attention_route(1, 8192, 8192, 1, 512, False, on_cuda=True, needs_grad=True)
    assert select_attention_route(1, 8192, 8192, 1, 512, False, on_cuda=False,
                                  needs_grad=True) == "chunked"
    assert select_attention_route(1, 64, 64, 1, 512, False, on_cuda=True,
                                  needs_grad=True) == "single"
    assert select_attention_route(1, 8192, 8192, 1, 512, False, on_cuda=True) == "mh_flash"


def test_new_wrappers_run_plain_versions_on_cpu():
    """On CPU tensors the wrappers of K5a-c and of K3 with lse run their
    plain versions, counted as plain-path calls and as no launch."""
    q, k, v, g, bias = _torch("float32", *_inputs("float32", "shared", seed=7))
    tattn.reset_counts()
    out, lse = kernels.flash_attention_lse(q, k, v, bias, scale=SCALE)
    delta = kernels.attention_delta(g, out)
    kernels.flash_bwd_dq(q, k, v, bias, g, lse, delta, scale=SCALE)
    kernels.flash_bwd_dkv(q, k, v, bias, g, lse, delta, scale=SCALE)
    kernels.shared_bias_attention(q, k, v, bias[0, 0], scale=SCALE, with_lse=True)
    assert tattn.plain_path_calls() == 4
    assert all(c["launches"] == 0 for c in kernels.counts().values())
    assert kernels.lse_counts() == {"shared_bias_attention": 0}
