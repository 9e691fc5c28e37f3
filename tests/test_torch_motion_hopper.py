"""The walks and arithmetic of L2's and L3's Hopper bodies, emulated on the
CPU, and the rules that send launches to them.

L2 (`kernels.fused_motion_attention`) in bfloat16 at head dims 40, 80 and
160 without exp_bf16, F dividing 64, S = G*F a multiple of 128 and
16-byte-aligned pointers (`kernels.fused_wgmma_route`) runs
csrc/motion_wgmma.cuh: block x is query tile x % nqt, head group, pack and
batch row (query tile fastest); it owns 128 query rows of T row slots (the
heads h0 .. h0 + T - 1 of one pack, T = `kernels.fused_wgmma_slots(D)`, past
H the last head again, computed and not stored); for each 64-key tile one
[128, 64] bias tile serves its T slots: S = Q·Kᵀ over k-steps of 16
columns (at D = 40 a sixth 8-column chunk of zeros in Q's and K's
buffers), x = s·scale + bias, the running max m in natural units, α =
2^((m_old - m)·log2 e), P = 2^(x·log2 e - m·log2 e), the row sum over the
unrounded P, O = O·α + bf16(P)·V in float32, O / l rounded once.
`emulate_fused_wgmma` repeats that walk and order in torch.

L3 (`kernels.diag_motion_attention`) in bfloat16 at 16 frames with D % 8 ==
0 and aligned pointers (`kernels.diag_route`) runs K4's Hopper body under
its own ownership (csrc/motion_diag.cu on csrc/frame_tma.cuh): block x takes
packs x, x + grid, ... of G locations and streams each pack as items of SG
locations x HG heads, head group fastest, a sub-pack's locations past its
pack skipped; each problem is K4's. `emulate_diag_tma` repeats that walk with
K4's arithmetic.

The tests hold both, on seeded bfloat16 inputs (B = 2, F = 16, HW = 48, 2-8
heads, D = 40, 80 and 160, G = 8 and 16; L2 under a block-diagonal, a random
float32 and a random bfloat16 bias), to chip_smoke.py's phase-2 limit for a
bfloat16 output (chip_smoke.bf16_limit) against the port's plain versions
and the JAX lab's kernels (scripts/exp_motion_kernels.py) in interpret mode;
show that L2's zero chunk adds nothing and that L3's emulation equals K4's
(tests/test_torch_frame_tma.py:emulate_frame_tma) bit for bit; and pin both
rules at every lab site and pack of chip_smoke.py, their refusals, and
chip_smoke's check of the launches by body.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagine360_tpu_torch.ops import kernels, motion_lab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402
import exp_motion_kernels as jexp  # noqa: E402
from test_torch_frame_tma import emulate_frame_tma  # noqa: E402

torch.set_num_threads(2)

LOG2E = 1.4426950408889634
F = 16
B, HW = 2, 48
SMS = 132
BQ, BK = kernels.FUSED_WGMMA_ROWS, kernels.FUSED_WGMMA_KEYS


def _inputs(heads, D, seed, hw=HW):
    rng = np.random.default_rng(seed)
    x = lambda: torch.from_numpy(rng.standard_normal((B, F, hw, heads * D),
                                                     dtype=np.float32)).bfloat16()
    return x(), x(), x()


def _bias(kind, G, seed):
    """[1, G*F, G*F] as chip_smoke.lab_bias makes it, from numpy."""
    if kind == "block_diag":
        return torch.from_numpy(motion_lab.block_diag_bias(G, F, F)[0])
    S = G * F
    b = torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, (1, S, S))
                         .astype(np.float32))
    return b.bfloat16() if kind == "random_bf16" else b


def _packed(x, b, l0, nloc, h, D):
    """Rows g*F + f (location l0 + g, frame f) of head h: [nloc*F, D] float."""
    return x[b, :, l0:l0 + nloc, h * D:(h + 1) * D].permute(1, 0, 2).reshape(nloc * F, D).float()


def emulate_fused_wgmma(q, k, v, bias, scale, heads, G, overrun=None):
    """csrc/motion_wgmma.cuh:fused_wgmma_body's walk and order on bfloat16
    q/k/v [B, 16, HW, C] and a float32 or bfloat16 bias [1, S, S]. Returns
    (out, the blocks' row slots: [(block, b, pack, query tile, heads of the
    slots)]). At D = 40 Q·Kᵀ runs over 48 columns, the sixth chunk zero in
    Q's and K's buffers; `overrun`, if given, is a function (b, l0, nloc, h)
    -> [nloc*F, 8] that fills K's sixth chunk instead (what a tile would
    read there without the zero chunk)."""
    Bq, Fq, HWq, C = q.shape
    D = C // heads
    T = kernels.fused_wgmma_slots(D)
    S = G * F
    nqt, nhg, npk = S // BQ, -(-heads // T), HWq // G
    DC = -(-D // 16) * 2
    scale32 = torch.tensor(scale, dtype=torch.float32)
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    bias32 = bias[0].float()
    out = torch.full_like(q, float("nan"))
    slots = []

    def padded(x, b, l0, nloc, h, fill=None):
        rows = _packed(x, b, l0, nloc, h, D)
        if DC * 8 == D:
            return rows
        extra = rows.new_zeros(nloc * F, DC * 8 - D) if fill is None else fill(b, l0, nloc, h)
        return torch.cat([rows, extra], 1)

    for blk in range(Bq * npk * nhg * nqt):
        qt, rest = blk % nqt, blk // nqt
        hg, rest = rest % nhg, rest // nhg
        pk, b = rest % npk, rest // npk
        q0, h0 = qt * BQ, hg * T
        nv = min(T, heads - h0)
        hs = [h0 + min(j, nv - 1) for j in range(T)]      # past H: the last head again
        slots.append((blk, b, pk, qt, hs))
        loc0 = pk * G
        qs = [padded(q, b, loc0 + q0 // F, BQ // F, h) for h in hs]
        o = torch.zeros(T, BQ, D)
        m = torch.full((T, BQ, 1), -1e30)
        lsum = torch.zeros(T, BQ, 1)
        for t in range(S // BK):
            l0 = loc0 + t * BK // F
            bt = bias32[q0:q0 + BQ, t * BK:(t + 1) * BK]          # one bias tile, T slots
            for j, h in enumerate(hs):
                kk = padded(k, b, l0, BK // F, h, overrun)
                s = torch.zeros(BQ, BK)
                for ks in range(DC // 2):                         # k-steps of 16 columns
                    s += qs[j][:, 16 * ks:16 * ks + 16] @ kk[:, 16 * ks:16 * ks + 16].T
                x = torch.addcmul(bt, s, scale32)                 # s·scale + bias
                mn = torch.maximum(m[j], x.amax(1, keepdim=True))
                alpha = torch.exp2((m[j] - mn) * log2e)
                p = torch.exp2(x * log2e - mn * log2e)
                lsum[j] = lsum[j] * alpha + p.sum(1, keepdim=True)
                m[j] = mn
                o[j] = o[j] * alpha + p.bfloat16().float() @ _packed(v, b, l0, BK // F, h, D)
        for j in range(nv):
            res = (o[j] / lsum[j]).bfloat16()                     # [BQ rows g*F + f, D]
            h = h0 + j
            out[b, :, loc0 + q0 // F:loc0 + (q0 + BQ) // F, h * D:(h + 1) * D] = \
                res.reshape(BQ // F, F, D).permute(1, 0, 2)
    return out, slots


def _k4_problem(qp, kp, vp, sl2, NG):
    """One (location, head) problem in K4's Hopper order (csrc/frame_tma.cuh;
    the ops of test_torch_frame_tma.emulate_frame_tma): [16, D] bfloat16
    rows of q, k, v -> [16, D] bfloat16."""
    KS = (NG + 1) // 2
    cols = lambda t, gr: t[:, 8 * gr:8 * gr + 8]
    s = torch.zeros(F, F)
    for ks in range(KS):
        g0, g1 = 2 * ks, min(2 * ks + 1, NG - 1)
        a = torch.cat([cols(qp, g0), cols(qp, g1)], 1).float()
        kb = torch.cat([cols(kp, g0), cols(kp, g1)], 1).float()
        if 2 * ks + 1 >= NG:
            a[:, 8:] = 0
        s += a @ kb.T
    x = s * sl2
    mx = x.amax(dim=1, keepdim=True)
    e = torch.exp2(x - mx)
    pb = (e * (1.0 / e.sum(dim=1, keepdim=True))).bfloat16().float()
    o = torch.empty(F, 8 * 2 * KS)
    for n2 in range(KS):
        ga, gb = 2 * n2, min(2 * n2 + 1, NG - 1)
        o[:, 16 * n2:16 * n2 + 8] = pb @ cols(vp, ga).float()
        o[:, 16 * n2 + 8:16 * n2 + 16] = pb @ cols(vp, gb).float()
    return o[:, :8 * NG].bfloat16()


def emulate_diag_tma(q, k, v, scale, heads, G, plan):
    """csrc/frame_tma.cuh:frame_tma_body<NG, PACKED>'s walk (L3) on bfloat16
    q/k/v [B, 16, HW, C] under `plan` (kernels.diag_tma_plan's keys SG, HG,
    grid; SG divides G): block x takes packs x, x + grid, ...; a pack is
    G / SG items of SG locations x heads / HG head groups, head group
    fastest. Returns (out, the problems in the order the blocks compute
    them: (block, item, b, location, head))."""
    Bq, Fq, HWq, C = q.shape
    D = C // heads
    SG, HG = plan["SG"], plan["HG"]
    assert G % SG == 0
    nhg, npk, nsp = heads // HG, HWq // G, G // SG
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    out = torch.full_like(q, float("nan"))
    order = []
    for blk in range(plan["grid"]):
        i = 0
        for pk in range(blk, Bq * npk, plan["grid"]):
            b, p0 = pk // npk, (pk % npk) * G
            for ii in range(nsp * nhg):
                hg, sp = ii % nhg, ii // nhg
                for p in range(SG * HG):
                    g, j = divmod(p, HG)
                    loc = p0 + sp * SG + g
                    h = hg * HG + j
                    order.append((blk, i, b, loc, h))
                    sl = lambda x: x[b, :, loc, h * D:(h + 1) * D]
                    out[b, :, loc, h * D:(h + 1) * D] = _k4_problem(sl(q), sl(k), sl(v), sl2,
                                                                    D // 8)
                i += 1
    return out, order


def _err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _limit(want):
    return chip_smoke.bf16_limit(want.float().abs().max().item())


def _j(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _from_jax(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


# L2 cases: (heads, D, G, bias kind); 6 heads of 40 leave a ragged head group
FUSED = [(8, 40, 16, "block_diag"), (8, 40, 8, "random"), (6, 40, 16, "random_bf16"),
         (4, 80, 16, "random"), (4, 80, 8, "block_diag"), (2, 160, 8, "random_bf16"),
         (2, 160, 16, "random")]
# L3 cases: (heads, D, G)
DIAG = [(8, 40, 16), (8, 40, 8), (4, 80, 16), (2, 160, 8)]


@pytest.fixture(scope="module")
def jax_outputs():
    """{case: (inputs, the JAX lab kernel's output in interpret mode)} of
    FUSED (with the bias) and DIAG."""
    outs = {}
    for heads, D, G, kind in FUSED:
        q, k, v = _inputs(heads, D, seed=heads * D + G)
        bias = _bias(kind, G, seed=G + D)
        ref = jexp.fused_motion_attention(_j(q), _j(k), _j(v), jnp.asarray(bias.float().numpy()),
                                          D ** -0.5, heads, G=G, interpret=True)
        outs[("fused", heads, D, G, kind)] = (q, k, v, bias), _from_jax(ref)
    for heads, D, G in DIAG:
        q, k, v = _inputs(heads, D, seed=7 * heads + D + G)
        ref = jexp.diag_motion_attention(_j(q), _j(k), _j(v), D ** -0.5, heads, G=G,
                                         interpret=True)
        outs[("diag", heads, D, G)] = (q, k, v), _from_jax(ref)
    return outs


@pytest.mark.parametrize("heads,D,G,kind", FUSED)
def test_fused_emulation_matches_plain_and_jax(heads, D, G, kind, jax_outputs):
    """L2's Hopper order against the port's plain version and the JAX lab's
    kernel (interpret mode), within the phase-2 bf16 limit (and the two
    references within it of each other); every (batch, location, head)
    output written once, the blocks' slots T heads of one pack, the query
    tile fastest, a ragged head group's last slots repeating its last head."""
    (q, k, v, bias), ref = jax_outputs[("fused", heads, D, G, kind)]
    scale = D ** -0.5
    got, slots = emulate_fused_wgmma(q, k, v, bias, scale, heads, G)
    want = kernels.fused_motion_attention_plain(q, k, v, bias, scale=scale, heads=heads, G=G)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    assert _err(got, want) <= _limit(want)
    assert _err(got, ref) <= _limit(ref)
    assert _err(want, ref) <= _limit(ref)
    T = kernels.fused_wgmma_slots(D)
    nqt = G * F // BQ
    assert len(slots) == B * (HW // G) * -(-heads // T) * nqt
    assert [s[3] for s in slots[:nqt]] == list(range(nqt))
    for blk, b, pk, qt, hs in slots:
        assert len(hs) == T and hs == sorted(hs) and hs[-1] <= heads - 1
        assert hs[0] % T == 0 and all(h == min(hs[0] + j, heads - 1) for j, h in enumerate(hs))


def test_fused_slots_and_the_sixth_chunk():
    """At D = 40 Q·Kᵀ's third k-step covers columns 32-47: with Q's and K's
    sixth chunk zero, what the output holds equals the 40-column order bit
    for bit whatever K's chunk would hold, as long as Q's is zero; with the
    next head's columns in both chunks (no zero chunk) the output misses the
    limit. D = 80 and 160 have whole k-steps. The slots a block takes keep
    O within 80 floats a thread."""
    heads, D, G = 8, 40, 16
    q, k, v = _inputs(heads, D, seed=5)
    bias = _bias("random", G, seed=9)
    scale = D ** -0.5
    base, _ = emulate_fused_wgmma(q, k, v, bias, scale, heads, G)
    other = torch.from_numpy(np.random.default_rng(3).standard_normal((4 * F, 8),
                                                                      dtype=np.float32))
    moved, _ = emulate_fused_wgmma(q, k, v, bias, scale, heads, G,
                                   overrun=lambda b, l0, n, h: other.bfloat16().float())
    assert torch.equal(base, moved)
    want = kernels.fused_motion_attention_plain(q, k, v, bias, scale=scale, heads=heads, G=G)
    # without the zero chunk both Q and K carry the next head's first 8
    # columns there (heads 0-6; head 7's run ends the row: zeros)
    nxt = lambda x: lambda b, l0, n, h: (
        _packed(x, b, l0, n, h + 1, D)[:, :8] if h + 1 < heads else torch.zeros(n * F, 8))
    unzeroed = _emulate_with_fills(q, k, v, bias, scale, heads, G, nxt(q), nxt(k))
    assert _err(base, want) <= _limit(want) < _err(unzeroed, want)
    assert [kernels.fused_wgmma_slots(d) * d // 2 for d in (40, 80, 160)] == [80, 80, 80]
    assert [(-(-d // 16) * 2) for d in (40, 80, 160)] == [6, 10, 20]


def _emulate_with_fills(q, k, v, bias, scale, heads, G, q_fill, k_fill):
    """emulate_fused_wgmma's order at D = 40, one (pack, head) at a time,
    with Q's sixth chunk from q_fill and K's from k_fill (what the tiles
    would read there without the zero chunk)."""
    Bq, Fq, HWq, C = q.shape
    D, S = C // heads, G * F
    out = torch.full_like(q, float("nan"))
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    for b in range(Bq):
        for pk in range(HWq // G):
            loc0 = pk * G
            for h in range(heads):
                for q0 in range(0, S, BQ):
                    qs = torch.cat([_packed(q, b, loc0 + q0 // F, BQ // F, h, D),
                                    q_fill(b, loc0 + q0 // F, BQ // F, h)], 1)
                    o, m, lsum = torch.zeros(BQ, D), torch.full((BQ, 1), -1e30), \
                        torch.zeros(BQ, 1)
                    for t in range(S // BK):
                        l0 = loc0 + t * BK // F
                        kk = torch.cat([_packed(k, b, l0, BK // F, h, D),
                                        k_fill(b, l0, BK // F, h)], 1)
                        s = torch.zeros(BQ, BK)
                        for ks in range(3):
                            s += qs[:, 16 * ks:16 * ks + 16] @ kk[:, 16 * ks:16 * ks + 16].T
                        x = torch.addcmul(bias[0].float()[q0:q0 + BQ, t * BK:(t + 1) * BK], s,
                                          torch.tensor(scale, dtype=torch.float32))
                        mn = torch.maximum(m, x.amax(1, keepdim=True))
                        alpha = torch.exp2((m - mn) * log2e)
                        p = torch.exp2(x * log2e - mn * log2e)
                        lsum = lsum * alpha + p.sum(1, keepdim=True)
                        m = mn
                        o = o * alpha + p.bfloat16().float() @ _packed(v, b, l0, BK // F, h, D)
                    out[b, :, loc0 + q0 // F:loc0 + (q0 + BQ) // F, h * D:(h + 1) * D] = \
                        (o / lsum).bfloat16().reshape(BQ // F, F, D).permute(1, 0, 2)
    return out


@pytest.mark.parametrize("heads,D,G", DIAG)
def test_diag_emulation_matches_plain_jax_and_k4(heads, D, G, jax_outputs):
    """L3's walk with K4's arithmetic against the port's plain version and
    the JAX lab's kernel (interpret mode) within the phase-2 bf16 limit, and
    equal bit for bit to K4's Hopper emulation (any plan: the walk does not
    enter a problem); every problem computed once, block x's packs x, x +
    grid, ..., a pack's items consecutive."""
    (q, k, v), ref = jax_outputs[("diag", heads, D, G)]
    scale = D ** -0.5
    plan = kernels.diag_tma_plan(B, F, HW, heads, D, G, SMS)
    got, order = emulate_diag_tma(q, k, v, scale, heads, G, plan)
    want = kernels.diag_motion_attention_plain(q, k, v, scale=scale, heads=heads, G=G)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    assert _err(got, want) <= _limit(want)
    assert _err(got, ref) <= _limit(ref)
    k4, _ = emulate_frame_tma(q, k, v, scale, heads, kernels.frame_tma_plan(B, F, HW, heads, D,
                                                                            SMS))
    assert torch.equal(got, k4)
    assert sorted(o[2:] for o in order) == [(b, loc, h) for b in range(B) for loc in range(HW)
                                            for h in range(heads)]
    npk = HW // G
    for blk, i, b, loc, h in order:
        assert (b * npk + loc // G) % plan["grid"] == blk


def test_diag_sub_packs_and_plans():
    """A plan of other items than the rule's (SG = 2 of G = 8, head groups
    of 2, 5 blocks over 6 packs) computes each problem once, the same bit
    for bit; at every lab site and pack the plan's SG divides G, its box
    fits FRAME_TMA_ITEM_BYTES, its walk, shared memory and grid hold."""
    heads, D, G = 4, 40, 8
    q, k, v = _inputs(heads, D, seed=21, hw=24)
    scale = D ** -0.5
    plan = dict(SG=2, HG=2, grid=5)
    got, order = emulate_diag_tma(q, k, v, scale, heads, G, plan)
    want, _ = emulate_diag_tma(q, k, v, scale, heads, G,
                               kernels.diag_tma_plan(B, F, 24, heads, D, G, SMS))
    assert torch.equal(got, want)
    assert len(order) == B * 24 * heads == len(set(o[2:] for o in order))
    for site, (Bs, Fs, HWs, C, hs) in chip_smoke.LAB_SITES:
        for Gs in motion_lab.DIAG_PACKS:
            if HWs % Gs:
                continue
            p = kernels.diag_tma_plan(Bs, Fs, HWs, hs, C // hs, Gs, SMS)
            assert Gs % p["SG"] == 0 and hs % p["HG"] == 0, site
            assert kernels.frame_tma_walk_ok(p["SG"] * p["HG"], p["S"], p["NW"]), site
            assert p["smem"] <= kernels.SMEM_LIMIT and p["grid"] == min(p["packs"], SMS)
            assert p["SG"] * p["HG"] * Fs * (C // hs) * 2 <= kernels.FRAME_TMA_ITEM_BYTES or \
                p["SG"] * p["HG"] == 1


def _lab_packs():
    """[(site, shape, variant name, kwargs)] of every L2 and L3 variant that
    chip_smoke's phase 8 runs (motion_lab.lab_variants at LAB_SITES) and of
    phase 2's lab sites."""
    out = []
    for site, shape in chip_smoke.LAB_SITES:
        for name, fn, kw in motion_lab.lab_variants(shape, 2):
            if fn in (kernels.fused_motion_attention, kernels.diag_motion_attention):
                out.append((site, shape, name, kw))
    for name, site, shape in chip_smoke.SITES:
        if site in chip_smoke.LAB_PARAMS and name in ("fused_motion_attention",
                                                      "diag_motion_attention"):
            kw = {x: y for x, y in chip_smoke.LAB_PARAMS[site].items() if x in ("G", "exp_bf16")}
            out.append((site, shape, f"{name}:{site}", kw))
    return out


def test_routes_at_every_lab_pack():
    """Every L2 pack of the lab takes the Hopper body but exp_bf16 (which
    stays on `mma.sync` by the rule), every L3 pack takes K4's Hopper body
    under L3's ownership, as the routes, the bodies and chip_smoke.shape_body
    say; phase 2's six lab sites are among them."""
    packs = _lab_packs()
    assert {p[2] for p in packs} >= {"fused_G32", "fused_G32_expbf16", "fused_G8", "fused_G16",
                                     "diag_G16", "diag_G4", "diag_G32", "diag_G8"}
    assert sum(":" in p[2] for p in packs) == 6
    for site, (Bs, Fs, HWs, C, hs), name, kw in packs:
        D, G = C // hs, kw["G"]
        if "fused" in name:
            e = kw.get("exp_bf16", False)
            for bd in (torch.float32, torch.bfloat16):
                assert kernels.fused_wgmma_route(torch.bfloat16, Fs, G, hs, D, bd, e) == (not e)
            want = "fused_mma_sync" if e else "fused_wgmma"
            assert kernels.fused_body(torch.bfloat16, Fs, G, hs, D, torch.float32, e) == want
            assert chip_smoke.shape_body(kernels, "fused_motion_attention",
                                         (Bs, Fs, HWs, C, hs, G, e)) == want, (site, name)
        else:
            assert kernels.diag_route(torch.bfloat16, Fs, HWs, hs, D, G), (site, name)
            assert chip_smoke.shape_body(kernels, "diag_motion_attention",
                                         (Bs, Fs, HWs, C, hs, G)) == "diag_tma", (site, name)


def test_routes_refuse_off_rule_calls():
    """float32, exp_bf16 (L2), a head dim off the rule (L2: not 40, 80 or 160;
    L3: no multiple of 8 or above 160), S not a multiple of 128 or F not
    dividing 64 (L2), other frame counts (L3), and a pointer off a 16-byte
    boundary stay off the Hopper bodies: the `mma.sync` bodies in bfloat16,
    the CUDA cores in float32."""
    f32, bf = torch.float32, torch.bfloat16
    assert kernels.fused_wgmma_route(bf, 16, 32, 8, 40, f32, False, ptrs=(0, 16, 4096, 2 ** 40,
                                                                           32))
    assert kernels.fused_body(f32, 16, 32, 8, 40, f32, False) == "fused_cuda_cores"
    assert not kernels.fused_wgmma_route(bf, 16, 32, 8, 40, f32, True)
    assert not kernels.fused_wgmma_route(bf, 16, 32, 8, 40, torch.float16, False)
    for D in (8, 32, 48, 64, 120, 128, 36, 44):
        assert not kernels.fused_wgmma_route(bf, 16, 32, 8, D, f32, False), D
    for F_, G in ((16, 4), (16, 12), (12, 32), (32, 2), (128, 1), (8, 8)):
        assert not kernels.fused_wgmma_route(bf, F_, G, 8, 40, f32, False), (F_, G)
    for F_, G in ((16, 8), (32, 4), (8, 16), (64, 2), (4, 32)):
        assert kernels.fused_wgmma_route(bf, F_, G, 8, 40, f32, False), (F_, G)
    for ptrs in ((2, 0, 0, 0, 0), (0, 8, 0, 0, 0), (0, 0, 4, 0, 0), (0, 0, 0, 8, 0),
                 (0, 0, 0, 0, 4)):
        assert not kernels.fused_wgmma_route(bf, 16, 32, 8, 40, f32, False, ptrs=ptrs)
        assert kernels.fused_body(bf, 16, 32, 8, 40, f32, False, ptrs=ptrs) == "fused_mma_sync"
    args = (16, 1024, 8, 40, 16)
    assert kernels.diag_route(bf, *args, ptrs=(0, 16, 4096, 2 ** 40))
    assert not kernels.diag_route(f32, *args)
    assert kernels.diag_body(f32, *args) == "diag_cuda_cores"
    for F_ in (1, 8, 15, 17, 32):
        assert not kernels.diag_route(bf, F_, 1024, 8, 40, 16)
    for D in (1, 37, 44, 100, 168):
        assert not kernels.diag_route(bf, 16, 1024, 2, D, 16)
    for D in (8, 24, 64, 120, 160):
        assert kernels.diag_route(bf, 16, 1024, 2, D, 16)
    assert not kernels.diag_route(bf, 16, 1000, 8, 40, 16)       # G does not divide HW
    for ptrs in ((2, 0, 0, 0), (0, 8, 0, 0), (0, 0, 4, 0), (0, 0, 0, 8)):
        assert not kernels.diag_route(bf, *args, ptrs=ptrs)
        assert kernels.diag_body(bf, *args, ptrs=ptrs) == "diag_mma_sync"


def test_chip_smoke_counts_lab_bodies():
    """chip_smoke names, from L2's and L3's launches by shape, the body each
    took (frame_body_expected against kernels.frame_body_counts, beside
    K4's), lists them apart in path_launches, counts the new bodies'
    instantiations in phase 1 and names their sources; on the CPU the
    wrappers run their plain versions and count no body."""
    assert chip_smoke.MMA_KERNEL_NAMES["diag_motion_tma_kernel"] == 20
    assert chip_smoke.WGMMA_KERNEL_NAMES["fused_motion_wgmma_kernel"] == 6
    for table in chip_smoke.LAB_BODY_SOURCES.values():
        for src in table.values():
            assert os.path.isfile(os.path.join(ROOT, src))
    assert not set(kernels.FRAME_BODIES) & set(kernels.FUSED_BODIES) | set(kernels.DIAG_BODIES) \
        & set(kernels.FRAME_BODIES)
    kernels.reset_counts()
    try:
        q, k, v = _inputs(2, 40, seed=1, hw=16)
        kernels.fused_motion_attention(q, k, v, _bias("block_diag", 8, 0), scale=0.1, heads=2,
                                       G=8)
        kernels.diag_motion_attention(q, k, v, scale=0.1, heads=2, G=8)
        assert kernels.frame_body_counts() == {}
        fused, diag = kernels.fused_motion_attention, kernels.diag_motion_attention
        fused.shape_launches.update({(40, 16, 1024, 320, 8, 32, False): 12,
                                     (40, 16, 1024, 320, 8, 32, True): 12})
        fused.launches = fused.tc_launches = 24
        diag.shape_launches.update({(40, 16, 1024, 320, 8, 16): 12,
                                    (2, 16, 128, 1280, 8, 4): 12})
        diag.launches = diag.tc_launches = 24
        kernels.frame_attention.shape_launches.update({(40, 16, 1024, 320, 8): 3})
        kernels.frame_attention.launches = kernels.frame_attention.tc_launches = 3
        fused.body_launches.update(fused_wgmma=12, fused_mma_sync=12)
        diag.body_launches.update(diag_tma=24)
        kernels.frame_attention.body_launches.update(tma=3)
        want = {"fused_wgmma": 12, "fused_mma_sync": 12, "diag_tma": 24, "tma": 3}
        assert chip_smoke.frame_body_expected(kernels) == want == kernels.frame_body_counts()
        chip_smoke.check_frame_bodies("test", kernels)
        launches = chip_smoke.path_launches(kernels)
        assert launches["fused_motion_attention_fused_wgmma"] == 12
        assert launches["fused_motion_attention_fused_mma_sync"] == 12
        assert launches["diag_motion_attention_diag_tma"] == 24
        assert launches["diag_motion_attention_diag_mma_sync"] == 0
        fused.body_launches["fused_wgmma"] += 1
        fused.body_launches["fused_mma_sync"] -= 1
        with pytest.raises(SystemExit, match="L2 and L3"):
            chip_smoke.check_frame_bodies("test", kernels)
    finally:
        kernels.reset_counts()
