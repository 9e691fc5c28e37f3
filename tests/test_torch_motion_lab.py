"""The motion-attention lab of the PyTorch port, on the CPU: the plain
versions of L1 (`striped_v2_attention`), L2 (`fused_motion_attention`) and L3
(`diag_motion_attention`) against the JAX lab's Pallas kernels in interpret
mode, the bias helpers bit for bit, and `run_lab` as the slice as a whole.

Inputs come from numpy.random.default_rng and go to both packages, float32.
Tolerance: 1e-5 abs (the same arithmetic in another summation order; outputs
are softmax averages of unit-scale values). L2 with `exp_bf16` rounds every
exponent and every probability to bfloat16: 2e-2 abs.
"""
import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from imagine360_tpu.ops import attention as jattn
from imagine360_tpu.ops.pallas_attention import _striped_bias, temporal_packed_attention

from imagine360_tpu_torch.ops import kernels, motion_lab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import exp_motion_kernels as jexp  # noqa: E402
import kernel_lab as jlab  # noqa: E402

TOL = 1e-5
EXP_BF16_TOL = 2e-2
B, F, HW, C, H = 2, 4, 16, 32, 4
SCALE = float((C // H) ** -0.5)


def _qkv(seed, shape=(B, F, HW, C)):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _err(got, want):
    got = got.detach().float().numpy() if hasattr(got, "detach") else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max())


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_striped_v2(q, k, v, G, R, unroll):
    """scripts/kernel_lab.py:_striped_v2_kernel under the block specs of its
    wrapper, in interpret mode (the wrapper has no `interpret` argument)."""
    T = HW // G
    spec = pl.BlockSpec((1, F, R, G, C), lambda b, t: (b, 0, t, 0, 0))
    kernel = functools.partial(jlab._striped_v2_kernel, scale=SCALE, H=H, D=C // H, G=G, F=F,
                               R=R, unroll=unroll)
    five = lambda x: jnp.asarray(x).reshape(B, F, T, G, C)
    out = pl.pallas_call(
        kernel, grid=(B, T // R),
        in_specs=[spec, spec, spec, pl.BlockSpec((1, F * G, F * G), lambda b, t: (0, 0, 0))],
        out_specs=spec, out_shape=jax.ShapeDtypeStruct((B, F, T, G, C), jnp.float32),
        interpret=True)(five(q), five(k), five(v), jnp.asarray(_striped_bias(G, F)))
    return out.reshape(B, F, HW, C)


# ---- L1 --------------------------------------------------------------------


@pytest.mark.parametrize("G,R,unroll", [(4, 2, True), (4, 2, False), (2, 4, False),
                                        (8, 2, False), (4, 1, False), (16, 1, False)])
def test_striped_v2_plain_matches_pallas(G, R, unroll):
    q, k, v = _qkv(0)
    want = _jax_striped_v2(q, k, v, G, R, unroll)
    kernels.reset_counts()
    got = kernels.striped_v2_attention(*_t(q, k, v), scale=SCALE, heads=H, G=G, R=R)
    assert kernels.striped_v2_attention.plain_calls == 1
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("G", [4, 16])
def test_striped_v2_plain_matches_production_kernel(G):
    """The "vs production" check of the JAX lab: K4's TPU kernel itself."""
    q, k, v = _qkv(1)
    want = temporal_packed_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), SCALE, H, G,
                                     interpret=True)
    got = kernels.striped_v2_attention(*_t(q, k, v), scale=SCALE, heads=H, G=G, R=1)
    assert _err(got, want) <= TOL
    assert _err(kernels.frame_attention(*_t(q, k, v), scale=SCALE, heads=H), want) <= TOL


# ---- L2 --------------------------------------------------------------------


def _bias(kind, G, seed=7):
    """(numpy float32 values, torch bias, jax bias) of a [1, G*F, G*F] bias."""
    if kind == "block_diag":
        vals = motion_lab.block_diag_bias(G, F, F)[0]
    else:
        vals = np.random.default_rng(seed).standard_normal((1, G * F, G * F)).astype(np.float32)
    if kind == "bf16":
        tb = torch.from_numpy(vals).bfloat16()
        return tb.float().numpy(), tb, jnp.asarray(vals).astype(jnp.bfloat16)
    return vals, torch.from_numpy(vals), jnp.asarray(vals)


@pytest.mark.parametrize("kind,G", [("block_diag", 4), ("block_diag", 8), ("random", 4),
                                    ("random", 2), ("bf16", 4)])
def test_fused_motion_plain_matches_pallas(kind, G):
    q, k, v = _qkv(2)
    _, tbias, jbias = _bias(kind, G)
    want = jexp.fused_motion_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias,
                                       SCALE, H, G=G, interpret=True)
    kernels.reset_counts()
    got = kernels.fused_motion_attention(*_t(q, k, v), tbias, scale=SCALE, heads=H, G=G)
    assert kernels.fused_motion_attention.plain_calls == 1
    assert _err(got, want) <= TOL
    per_location = kernels.frame_attention_plain(*_t(q, k, v), scale=SCALE, heads=H)
    if kind == "block_diag":
        assert _err(got, per_location.numpy()) <= TOL
    else:       # the bias is an operand: the port follows it away from K4's function
        assert _err(got, per_location.numpy()) > 1.0


@pytest.mark.parametrize("kind", ["block_diag", "random"])
def test_fused_motion_plain_exp_bf16_matches_pallas(kind):
    q, k, v = _qkv(3)
    G = 4
    _, tbias, jbias = _bias(kind, G)
    want = jexp.fused_motion_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias,
                                       SCALE, H, G=G, exp_bf16=True, interpret=True)
    got = kernels.fused_motion_attention(*_t(q, k, v), tbias, scale=SCALE, heads=H, G=G,
                                         exp_bf16=True)
    assert _err(got, want) <= EXP_BF16_TOL
    exact = kernels.fused_motion_attention(*_t(q, k, v), tbias, scale=SCALE, heads=H, G=G)
    err = _err(got, exact.numpy())
    assert 0.0 < err <= EXP_BF16_TOL      # the casts are there, and cost this little


def test_fused_motion_plain_bf16_inputs():
    """bfloat16 q, k, v: probabilities rounded to bfloat16 before P V, output
    in bfloat16, on both sides."""
    q, k, v = _qkv(4)
    G = 4
    _, tbias, jbias = _bias("block_diag", G)
    jb = lambda x: jnp.asarray(x).astype(jnp.bfloat16)
    want = jexp.fused_motion_attention(jb(q), jb(k), jb(v), jbias, SCALE, H, G=G,
                                       interpret=True)
    got = kernels.fused_motion_attention(*(x.bfloat16() for x in _t(q, k, v)), tbias,
                                         scale=SCALE, heads=H, G=G)
    assert got.dtype == torch.bfloat16
    assert _err(got, np.asarray(want.astype(jnp.float32))) <= 2e-2


# ---- L3 --------------------------------------------------------------------


@pytest.mark.parametrize("G", [2, 4, 16])
def test_diag_motion_plain_matches_pallas(G):
    q, k, v = _qkv(5)
    want = jexp.diag_motion_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), SCALE, H,
                                      G=G, interpret=True)
    kernels.reset_counts()
    got = kernels.diag_motion_attention(*_t(q, k, v), scale=SCALE, heads=H, G=G)
    assert kernels.diag_motion_attention.plain_calls == 1
    assert _err(got, want) <= TOL


# ---- helpers ---------------------------------------------------------------


@pytest.mark.parametrize("G,Sq,Sk", [(4, 4, 4), (32, 16, 16), (3, 5, 7)])
def test_block_diag_bias_bit_for_bit(G, Sq, Sk):
    got, want = motion_lab.block_diag_bias(G, Sq, Sk), jattn._block_diag_bias(G, Sq, Sk)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("G,frames", [(4, 4), (32, 16), (3, 5)])
def test_striped_bias_bit_for_bit(G, frames):
    got, want = motion_lab.striped_bias(G, frames), _striped_bias(G, frames)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("frames,hw", [(16, 1024), (16, 16), (4, 24), (64, 100), (1024, 7)])
def test_temporal_group_matches_jax(frames, hw):
    assert motion_lab.temporal_group(frames, hw) == jattn._temporal_group(frames, hw)
    assert motion_lab.PACK_TARGET == jattn._PACK_TARGET


def test_striped_and_block_diag_bias_are_one_mask_in_two_row_orders():
    G, frames = 4, 3
    striped = motion_lab.striped_bias(G, frames)[0]
    block = motion_lab.block_diag_bias(G, frames, frames)[0, 0]
    order = np.arange(G * frames).reshape(G, frames).T.reshape(-1)    # row f*G+g <- g*F+f
    assert np.array_equal(striped, block[np.ix_(order, order)])


def test_padded_rows_are_an_odd_number_of_words():
    for elems in (1, 7, 40, 80, 160, 1280, 2560):
        for itemsize in (2, 4):
            row = kernels._padded_row(elems, itemsize)
            assert row >= elems and row * itemsize % 4 == 0 and (row * itemsize // 4) % 2 == 1
            assert row - elems <= 8 // itemsize


def test_diag_plan_prefers_two_blocks_an_sm_and_raises_beyond_one():
    hg, rs, warps, smem = kernels.diag_motion_plan(16, 16, 40, 8, 2)
    assert (hg, rs, warps) == (1, 42, 8) and smem <= kernels.SMEM_LIMIT // 2
    hg, _, _, smem = kernels.diag_motion_plan(4, 16, 40, 8, 2)
    assert hg > 1 and smem <= kernels.SMEM_LIMIT // 2
    hg, _, _, smem = kernels.diag_motion_plan(32, 16, 40, 8, 2)     # one block an SM
    assert hg == 1 and kernels.SMEM_LIMIT // 2 < smem <= kernels.SMEM_LIMIT
    with pytest.raises(ValueError, match="does not fit"):
        kernels.diag_motion_plan(16, 16, 160, 8, 2)


# ---- wrappers --------------------------------------------------------------


def _bad_call(case):
    q, k, v = _t(*_qkv(6))
    kw = dict(scale=SCALE, heads=H)
    if case == "hw_not_multiple_of_G":
        return lambda: kernels.striped_v2_attention(q, k, v, G=3, R=1, **kw), "multiple of the"
    if case == "packs_not_multiple_of_R":
        return lambda: kernels.striped_v2_attention(q, k, v, G=4, R=3, **kw), "multiple of R"
    if case == "diag_hw_not_multiple_of_G":
        return lambda: kernels.diag_motion_attention(q, k, v, G=5, **kw), "multiple of the"
    if case == "bias_shape":
        bias = torch.zeros(1, 4 * F, 4 * F + 1)
        return lambda: kernels.fused_motion_attention(q, k, v, bias, G=4, **kw), "bias must be"
    if case == "bias_rank":
        bias = torch.zeros(4 * F, 4 * F)
        return lambda: kernels.fused_motion_attention(q, k, v, bias, G=4, **kw), "bias must be"
    if case == "bias_dtype":
        bias = torch.zeros(1, 4 * F, 4 * F, dtype=torch.float64)
        return lambda: kernels.fused_motion_attention(q, k, v, bias, G=4, **kw), "bias must be"
    if case == "heads":
        return lambda: kernels.diag_motion_attention(q, k, v, G=4, scale=SCALE, heads=5), \
            "bad shapes"
    assert case == "diag_frames"
    x = torch.zeros(1, 33, 4, 8)
    return lambda: kernels.diag_motion_attention(x, x, x, G=2, scale=1.0, heads=2), "frames"


@pytest.mark.parametrize("case", ["hw_not_multiple_of_G", "packs_not_multiple_of_R",
                                  "diag_hw_not_multiple_of_G", "bias_shape", "bias_rank",
                                  "bias_dtype", "heads", "diag_frames"])
def test_lab_wrappers_raise_value_error(case):
    call, match = _bad_call(case)
    kernels.reset_counts()
    with pytest.raises(ValueError, match=match):
        call()
    assert all(fn.plain_calls == 0 for fn in kernels.LAB_KERNELS)


@pytest.mark.parametrize("name", ["striped_v2_attention", "fused_motion_attention",
                                  "diag_motion_attention"])
def test_lab_wrappers_count_one_plain_call_and_refuse_other_devices(name):
    q, k, v = _t(*_qkv(8))
    bias = torch.from_numpy(motion_lab.block_diag_bias(4, F, F)[0])
    fn = getattr(kernels, name)
    extra = {"striped_v2_attention": dict(G=4, R=2), "fused_motion_attention": dict(G=4),
             "diag_motion_attention": dict(G=4)}[name]
    args = lambda *x: x + ((bias,) if name == "fused_motion_attention" else ())
    kernels.reset_counts()
    for n in (1, 2):
        fn(*args(q, k, v), scale=SCALE, heads=H, **extra)
        assert kernels.counts()[name] == {"launches": 0, "plain_calls": n}
    # a meta tensor is not a CPU tensor: refused, neither run nor counted
    kernels.reset_counts()
    meta = torch.empty(B, F, HW, C, device="meta")
    bias = bias.to("meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*args(meta, meta, meta), scale=SCALE, heads=H, **extra)
    assert kernels.counts()[name] == {"launches": 0, "plain_calls": 0}


# ---- the lab ---------------------------------------------------------------

TINY_SITES = [("tiny_a", (2, 4, 16, 32, 4)), ("tiny_b", (1, 5, 32, 48, 2))]


def test_run_lab_on_the_cpu():
    """The slice as a whole: every variant of every site within 1e-5 of K4's
    plain version, one plain call each, no time measured."""
    kernels.reset_counts()
    rows = motion_lab.run_lab("cpu", TINY_SITES, dtype=torch.float32)
    by_site = {s: [r["variant"] for r in rows if r["site"] == s] for s, _ in TINY_SITES}
    for site, shape in TINY_SITES:
        names = [n for n, _, _ in motion_lab.lab_variants(shape, 4)]
        assert by_site[site] == names and names[0] == "frame_attention"
        kinds = {n.split("_G")[0] for n in names}
        assert kinds == {"frame_attention", "striped_v2", "fused", "diag"}
    assert "fused_G8_expbf16" not in by_site["tiny_a"]          # G = 32 only
    for r in rows:
        tol = EXP_BF16_TOL if r["params"].get("exp_bf16") else TOL
        assert r["max_abs_err"] <= tol, r
        assert r["plain_calls"] == 1 and r["launches"] == 0
        assert r["ms"] is None and r["k4_ms"] is None and r["k4_max_abs_err"] is None
    assert sum(c["plain_calls"] for c in kernels.counts().values()) == len(rows)


def test_run_lab_keeps_the_named_variants():
    rows = motion_lab.run_lab("cpu", TINY_SITES[:1], variants=("diag_G4", "fused_G8"),
                              dtype=torch.float32, check=False)
    assert [r["variant"] for r in rows] == ["fused_G8", "diag_G4"]
    assert "max_abs_err" not in rows[0]


def test_lab_variants_at_the_full_width_sites():
    """What fits a block's shared memory in bfloat16: at C = 320 packs of at
    most 4 locations for L1 and every pack of L2 and L3; at C = 1280 (head dim
    160) one location for L1, no 512-token sequence for L2, at most 8
    locations for L3."""
    names = lambda shape: {n for n, _, _ in motion_lab.lab_variants(shape, 2)}
    lab = names((40, 16, 1024, 320, 8))
    assert {"striped_v2_G4_R32", "striped_v2_G4_R64", "striped_v2_G2_R64", "striped_v2_G4_R8",
            "striped_v2_G1_R1", "fused_G8", "fused_G16", "fused_G32", "fused_G32_expbf16",
            "diag_G16", "diag_G32", "diag_G8", "diag_G4"} <= lab
    assert not {"striped_v2_G16_R8", "striped_v2_G8_R16", "striped_v2_G8_R32"} & lab
    deep = names((40, 16, 16, 1280, 8))
    assert deep == {"frame_attention", "striped_v2_G1_R8", "striped_v2_G1_R1", "fused_G8",
                    "fused_G16", "diag_G8", "diag_G4"}
    for shape in ((40, 16, 256, 640, 8), (2, 16, 8192, 320, 8), (2, 16, 128, 1280, 8)):
        kinds = {n.split("_G")[0] for n in names(shape)}
        assert kinds == {"frame_attention", "striped_v2", "fused", "diag"}


def test_lab_script_on_the_cpu(tmp_path, capsys):
    script = _load_script("torch_motion_lab")
    assert script.main(["--device", "cpu", "--site", "tiny", "--dtype", "float32",
                        "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "card: cpu" and len(out) > 5
    assert (tmp_path / "motion_lab.json").exists()
    if not torch.cuda.is_available():
        assert script.main([]) == 1                # the default device is the card


def test_lab_and_scripts_import_no_jax():
    code = ("import importlib.util, sys; import imagine360_tpu_torch.ops.motion_lab; "
            "mods = [importlib.util.spec_from_file_location(n, p) for n, p in "
            "(('torch_motion_lab', 'scripts/torch_motion_lab.py'), "
            "('chip_smoke', 'chip_smoke.py'))]; "
            "[s.loader.exec_module(importlib.util.module_from_spec(s)) for s in mods]; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax', 'imagine360_tpu')]; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
