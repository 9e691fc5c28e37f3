"""The opt-in kernels of the PyTorch port, on the CPU: the plain versions of
K6a (`flash_attention_t`), K6b (`shared_bias_attention_folded`) and K7
(`dense_matmul`) against the JAX package's Pallas kernels in interpret mode,
and `MMDense` against `nn.Linear`.

Inputs come from numpy.random.default_rng and go to both packages, float32.
Tolerance: 1e-5 of the output's max abs (the same arithmetic, summed tile by
tile in the Pallas kernels and at once in the plain versions); 1e-4 abs for
the float32 lse.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn as nn

from imagine360_tpu.ops.pallas_attention import _flash_bhds, _flash_shared_bias
from imagine360_tpu.ops.pallas_dense import dense_matmul as jax_dense_matmul

from imagine360_tpu_torch.models.attention3d import Transformer3DModel
from imagine360_tpu_torch.models.layers import MMDense
from imagine360_tpu_torch.models.motion import TemporalTransformer3DModel
from imagine360_tpu_torch.ops import kernels
from imagine360_tpu_torch.ops.dispatch import configure

REL_TOL = 1e-5
LSE_TOL = 1e-4


def _close(got, want, tol=REL_TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _qkv(rng, B, H, D, Sq, Sk):
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f32(B, H, D, Sq), f32(B, H, D, Sk), f32(B, H, D, Sk)


# (B, H, D, Sq, Sk, bias shape or None): aligned and ragged, each bias broadcast
FLASH_T_CASES = [
    (2, 2, 32, 256, 384, None),
    (2, 2, 32, 200, 300, None),          # ragged Sq and Sk, no bias
    (1, 3, 64, 130, 260, (1, 1, 130, 260)),
    (2, 2, 16, 128, 200, (2, 2, 128, 200)),
    (2, 3, 40, 100, 128, (1, 3, 100, 128)),
    (2, 1, 96, 70, 150, (2, 1, 70, 150)),
]


@pytest.mark.parametrize("B,H,D,Sq,Sk,bias_shape", FLASH_T_CASES)
def test_flash_attention_t_plain_matches_pallas(B, H, D, Sq, Sk, bias_shape):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, B, H, D, Sq, Sk)
    bias = None if bias_shape is None else rng.standard_normal(bias_shape).astype(np.float32)
    scale = float(D ** -0.5)
    want = _flash_bhds(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       None if bias is None else jnp.asarray(bias), scale,
                       block_q=128, block_k=128, interpret=True)
    T = torch.from_numpy
    kernels.reset_counts()
    got = kernels.flash_attention_t(T(q), T(k), T(v), None if bias is None else T(bias),
                                    scale=scale)
    assert kernels.flash_attention_t.plain_calls == 1
    assert got.shape == (B, H, Sq, D) and got.is_contiguous()
    _close(got, want)


@pytest.mark.parametrize("bias_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,D,Sq,Sk,t_rows", [(4, 32, 160, 272, 2), (6, 16, 128, 128, 4),
                                               (3, 64, 100, 300, 1)])
def test_shared_bias_folded_plain_matches_pallas(BH, D, Sq, Sk, t_rows, bias_dtype):
    """Output and lse; the JAX kernel returns the lse padded to its query
    block, [BH, Sqp, 1], the port [BH, Sq]. A bfloat16 bias is widened inside
    both."""
    rng = np.random.default_rng(1)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v, bias = f32(BH, Sq, D), f32(BH, Sk, D), f32(BH, Sk, D), f32(Sq, Sk)
    scale = float(D ** -0.5)
    jbias = jnp.asarray(bias).astype(bias_dtype)
    want, want_lse = _flash_shared_bias(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias,
                                        scale, block_q=128, block_k=128, t_rows=t_rows,
                                        interpret=True, with_lse=True)
    T = torch.from_numpy
    tbias = T(bias).to(getattr(torch, bias_dtype))
    got, got_lse = kernels.shared_bias_attention_folded(T(q), T(k), T(v), tbias, scale=scale,
                                                        with_lse=True, t_rows=t_rows)
    _close(got, want)
    assert got_lse.shape == (BH, Sq) and got_lse.dtype == torch.float32
    assert np.abs(got_lse.numpy() - np.asarray(want_lse)[:, :Sq, 0]).max() <= LSE_TOL
    alone = kernels.shared_bias_attention_folded(T(q), T(k), T(v), tbias, scale=scale)
    assert torch.equal(alone, got)


def test_folded_and_natural_shared_bias_agree():
    """K6b's plain version on [BH, S, D] equals K3's on [B, S, H, D] up to
    K3's rounding-free float32 path."""
    rng = np.random.default_rng(2)
    B, H, Sq, Sk, D = 2, 3, 40, 50, 8
    T = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, k, v, bias = T(B, Sq, H, D), T(B, Sk, H, D), T(B, Sk, H, D), T(Sq, Sk)
    fold = lambda x: x.permute(0, 2, 1, 3).reshape(B * H, x.shape[1], D)
    got = kernels.shared_bias_attention_folded(fold(q), fold(k), fold(v), bias, scale=0.3)
    want = kernels.shared_bias_attention_plain(q, k, v, bias, scale=0.3)
    _close(got.reshape(B, H, Sq, D).permute(0, 2, 1, 3), want.numpy())


@pytest.mark.parametrize("N,K,M", [(256, 320, 320), (512, 2560, 1280), (128, 320, 64)])
def test_dense_matmul_plain_matches_pallas(N, K, M):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, K)).astype(np.float32)
    w = rng.standard_normal((K, M)).astype(np.float32)
    want = jax_dense_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True)
    kernels.reset_counts()
    got = kernels.dense_matmul(torch.from_numpy(x), torch.from_numpy(w))
    _close(got, want)
    # the [M, K] weight of nn.Linear through the same wrapper
    got_t = kernels.dense_matmul(torch.from_numpy(x),
                                 torch.from_numpy(np.ascontiguousarray(w.T)),
                                 linear_layout=True)
    _close(got_t, want)
    assert kernels.dense_matmul.plain_calls == 2 and kernels.dense_matmul.launches == 0


def test_dense_matmul_plain_ragged_and_bf16():
    """Any N, K, M >= 1 (the TPU kernel's tile gate is not carried over);
    bfloat16 accumulates in float32 and is cast once."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1000, 77)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((321, 77)).astype(np.float32))
    got = kernels.dense_matmul(x, w, linear_layout=True)
    _close(got, (x.double() @ w.double().t()).float().numpy())
    xb, wb = x.bfloat16(), w.bfloat16()
    gb = kernels.dense_matmul(xb, wb, linear_layout=True)
    assert gb.dtype == torch.bfloat16 and gb.shape == (1000, 321)
    assert torch.equal(gb, (xb.float() @ wb.float().t()).bfloat16())
    one = kernels.dense_matmul(x[:1, :1], w[:1, :1], linear_layout=True)
    assert one.shape == (1, 1) and torch.equal(one, x[:1, :1] * w[:1, :1])


@pytest.mark.parametrize("name", ["flash_attention_t", "shared_bias_attention_folded",
                                  "dense_matmul"])
def test_opt_in_wrappers_raise_on_non_cpu_tensor(name):
    """A meta tensor is not a CPU tensor: the wrapper refuses it and neither
    runs nor counts its plain version."""
    kernels.reset_counts()
    meta = lambda *s: torch.empty(*s, device="meta")
    calls = {
        "flash_attention_t": lambda: kernels.flash_attention_t(
            meta(1, 2, 8, 16), meta(1, 2, 8, 16), meta(1, 2, 8, 16), scale=1.0),
        "shared_bias_attention_folded": lambda: kernels.shared_bias_attention_folded(
            meta(2, 16, 8), meta(2, 16, 8), meta(2, 16, 8), meta(16, 16), scale=1.0),
        "dense_matmul": lambda: kernels.dense_matmul(meta(4, 8), meta(8, 4)),
    }
    with pytest.raises(ValueError, match="CUDA tensors"):
        calls[name]()
    assert kernels.counts()[name] == {"launches": 0, "plain_calls": 0}


# ---- MMDense ---------------------------------------------------------------


def _linear_pair(rng, k, m, bias=True):
    lin = nn.Linear(k, m, bias=bias)
    with torch.no_grad():
        for p in lin.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32)))
    mm = MMDense(k, m, bias=bias)
    res = mm.load_state_dict(lin.state_dict(), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    return lin, mm


@pytest.mark.parametrize("bias", [True, False])
def test_mmdense_is_linear_with_the_switch_off(bias):
    rng = np.random.default_rng(5)
    lin, mm = _linear_pair(rng, 24, 40, bias)
    assert list(mm.state_dict()) == list(lin.state_dict())
    x = torch.from_numpy(rng.standard_normal((2, 3, 50, 24)).astype(np.float32))
    kernels.reset_counts()
    assert torch.equal(mm(x), lin(x))
    assert kernels.dense_matmul.plain_calls == 0
    # and it trains like nn.Linear
    mm(x).sum().backward()
    assert mm.weight.grad is not None


@pytest.mark.parametrize("bias", [True, False])
def test_mmdense_matches_linear_with_the_switch_on(bias):
    rng = np.random.default_rng(6)
    lin, mm = _linear_pair(rng, 24, 40, bias)
    x = torch.from_numpy(rng.standard_normal((2, 3, 50, 24)).astype(np.float32))
    kernels.reset_counts()
    with torch.no_grad(), configure(pallas_dense=True):
        got = mm(x)
    assert kernels.dense_matmul.plain_calls == 1
    assert got.shape == (2, 3, 50, 40)
    _close(got, lin(x).detach().numpy())


def test_mmdense_raises_under_grad_with_the_switch_on():
    rng = np.random.default_rng(7)
    _, mm = _linear_pair(rng, 8, 8)
    x = torch.zeros(4, 8)
    with configure(pallas_dense=True):
        with pytest.raises(RuntimeError, match="no backward"):
            mm(x)
        mm.requires_grad_(False)
        with pytest.raises(RuntimeError, match="no backward"):
            mm(x.clone().requires_grad_())
        mm(x)                          # nothing requires grad: allowed
        with torch.no_grad():
            mm.requires_grad_(True)(x)


def test_mmdense_sits_at_the_four_jax_sites():
    """proj_in / proj_out of the spatial transformer and of the motion
    module's temporal transformer, and nowhere else in them."""
    for model in (Transformer3DModel(32, 2, 16, 8, use_ip=False),
                  TemporalTransformer3DModel(32, 2)):
        sites = sorted(n for n, m in model.named_modules() if isinstance(m, MMDense))
        assert sites == ["proj_in", "proj_out"]
