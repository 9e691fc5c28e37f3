"""The walk and arithmetic of K4's Hopper body, emulated on the CPU, and the
rule that sends launches to it.

In bfloat16 at 16 frames with a head dim D that is a multiple of 8 up to
160 and 16-byte-aligned pointers (`kernels.frame_route`: every motion-module
launch of the models), `kernels.frame_attention` runs csrc/frame_tma.cuh: a
persistent grid whose block x takes work items x, x + grid, ... (an item is
G neighbouring locations x HG heads of one batch row, numbered head group
fastest, then location pack, then batch row; `kernels.frame_tma_plan`). One
producer thread loads each item's q, k and v as one TMA box each through
the 4-D map {CW, B*16, C / CW, HW} (CW = 8 x the odd part of D / 8), box
{CW, 16, HG*D / CW, G}: in shared memory [G][HG*D / CW][16][CW], locations
past HW zero-filled. Consumer warps take the item's problems in turn: S =
Q·Kᵀ over k-steps of two 8-column groups, the second group of the last
k-step, where D / 8 is odd, read from the last group again with Q's half
of the A fragment zeroed; S scaled by scale·log2(e), the whole row's max,
P = 2^(S - m) normalised and rounded once to bfloat16, O = P·V with float32
sums, the column tile past D computed and dropped; O leaves by a TMA store
of the problem's [D / CW][16][CW] box; a problem past HW is skipped.
`emulate_frame_tma` repeats that walk, layout and order in torch. The tests
hold it, on seeded bfloat16 inputs (B = 2, F = 16, HW = 24, 2-8 heads, D =
40, 80 and 160; the plan's items and a ragged one of 5 locations), to
chip_smoke.py's phase-2 limit for a bfloat16 output (chip_smoke.bf16_limit)
against

- the port's plain version (`frame_attention_plain`),
- the JAX package's Pallas kernel run in interpret mode on the CPU, as the
  JAX package's tests run it (`temporal_packed_attention`);

show that the zeroed half of the last k-step adds nothing (and that the
columns it reads would, unzeroed); check the consumers' parity rule
(`kernels.frame_tma_walk_ok`) against a simulation of the walk; and pin
`kernels.frame_route` at every K4 site of chip_smoke.py (the denoise loop's
motion stages, the SR stage's, the per-shard shapes of 2 and 4 ranks), its
refusals, and chip_smoke's check of K4's bodies by shape.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagine360_tpu.ops.pallas_attention import temporal_packed_attention

from imagine360_tpu_torch.ops import kernels

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

LOG2E = 1.4426950408889634
F = 16
B, HW = 2, 24
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132
# (heads, D): the motion modules' head dims 40, 80 and 160, each at C = 320
CASES = [(8, 40), (4, 80), (2, 160)]
# a plan the rule does not pick here: 5 locations (24 % 5 = 4: a ragged
# last pack) x 2 heads, 3 stages, 2 consumer warps
RAGGED = dict(G=5, HG=2, S=3, NW=2, bps=1)


def _odd(n):
    while n % 2 == 0:
        n //= 2
    return n


def _goff(gr, NG):
    """Element offset of 8-column group gr's first column in a problem's
    tile (csrc/frame_tma.cuh goff)."""
    CWG = _odd(NG)
    return (gr // CWG) * F * 8 * CWG + (gr % CWG) * 8


def _inputs(heads, D, seed):
    rng = np.random.default_rng(seed)
    x = lambda: torch.from_numpy(rng.standard_normal((B, F, HW, heads * D),
                                                     dtype=np.float32)).bfloat16()
    return x(), x(), x()


def _full_plan(plan, heads, D):
    """A plan with its item count and grid, as frame_tma_plan gives them."""
    items = B * -(-HW // plan["G"]) * (heads // plan["HG"])
    return dict(plan, items=items, grid=min(items, SMS * plan["bps"]))


def emulate_frame_tma(q, k, v, scale, heads, plan, zero_overrun=True, overrun_k=None):
    """csrc/frame_tma.cuh:frame_tma_body's walk, layout and order on
    bfloat16 q/k/v [B, 16, HW, C]. Returns (out, the problems in the order
    the blocks compute them: (block, item, b, location, head)). With
    `zero_overrun` False, the second half of an odd head dim's last k-step
    keeps Q's columns (the body zeroes them); `overrun_k`, if given,
    replaces the K columns that half reads."""
    Bq, Fq, HWq, C = q.shape
    D = C // heads
    NG = D // 8
    CW = 8 * _odd(NG)
    M, KS, TILE = NG // _odd(NG), (NG + 1) // 2, F * D
    G, HG = plan["G"], plan["HG"]
    nhg, nlp = heads // HG, -(-HWq // G)
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)

    def view(x):        # the map {CW, B*16, C / CW, HW}, HW padded with zeros to nlp * G
        xv = x.reshape(Bq * F, HWq, C // CW, CW)
        return torch.cat([xv, xv.new_zeros(Bq * F, nlp * G - HWq, C // CW, CW)], 1)

    def box(xv, b, lp, hg):     # [G][HG*M][16][CW], flat
        return xv[b * F:(b + 1) * F, lp * G:(lp + 1) * G, hg * HG * M:(hg + 1) * HG * M]\
            .permute(1, 2, 0, 3).reshape(-1)

    qv, kv, vv = view(q), view(k), view(v)
    out = torch.full_like(q, float("nan")).reshape(Bq * F, HWq, C // CW, CW)
    cols = lambda t, base, gr: t[base + _goff(gr, NG) + torch.arange(F)[:, None] * CW
                                 + torch.arange(8)]     # [16 rows, 8 columns] of a group
    order = []
    for blk in range(plan["grid"]):
        for it in range(blk, plan["items"], plan["grid"]):
            hg, t = it % nhg, it // nhg
            lp, b = t % nlp, t // nlp
            sq, sk, sv = box(qv, b, lp, hg), box(kv, b, lp, hg), box(vv, b, lp, hg)
            for p in range(G * HG):
                g, j = divmod(p, HG)
                loc = lp * G + g
                if loc >= HWq:
                    continue             # past a ragged last pack: skipped
                order.append((blk, it, b, loc, hg * HG + j))
                base = p * TILE
                s = torch.zeros(F, F)
                for ks in range(KS):
                    g0, g1 = 2 * ks, min(2 * ks + 1, NG - 1)
                    a = torch.cat([cols(sq, base, g0), cols(sq, base, g1)], 1).float()
                    kb = torch.cat([cols(sk, base, g0), cols(sk, base, g1)], 1).float()
                    if 2 * ks + 1 >= NG:
                        if zero_overrun:
                            a[:, 8:] = 0
                        if overrun_k is not None:
                            kb[:, 8:] = overrun_k
                    s += a @ kb.T
                x = s * sl2
                m = x.amax(dim=1, keepdim=True)
                e = torch.exp2(x - m)
                pb = (e * (1.0 / e.sum(dim=1, keepdim=True))).bfloat16().float()
                o = torch.empty(F, 8 * 2 * KS)
                for n2 in range(KS):
                    ga, gb = 2 * n2, min(2 * n2 + 1, NG - 1)
                    o[:, 16 * n2:16 * n2 + 8] = pb @ cols(sv, base, ga).float()
                    o[:, 16 * n2 + 8:16 * n2 + 16] = pb @ cols(sv, base, gb).float()
                # staging [M][16][CW] of the first NG column tiles, then the store
                stage = torch.empty(M * F * CW, dtype=torch.bfloat16)
                for n in range(NG):
                    stage[_goff(n, NG) + torch.arange(F)[:, None] * CW + torch.arange(8)] = \
                        o[:, 8 * n:8 * n + 8].bfloat16()
                h = hg * HG + j
                out[b * F:(b + 1) * F, loc, h * M:(h + 1) * M] = \
                    stage.reshape(M, F, CW).permute(1, 0, 2)
    return out.reshape(Bq, Fq, HWq, C), order


def _jax(q, k, v, scale, heads):
    """The JAX package's Pallas kernel in interpret mode, 4 locations a
    packed sequence (24 % 4 == 0)."""
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    out = temporal_packed_attention(j(q), j(k), j(v), scale, heads, 4, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.fixture(scope="module")
def jax_outputs():
    """{(heads, D): (inputs, the JAX kernel's output)} of CASES."""
    outs = {}
    for heads, D in CASES:
        q, k, v = _inputs(heads, D, seed=heads * D)
        outs[(heads, D)] = (q, k, v), _jax(q, k, v, D ** -0.5, heads)
    return outs


def _err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _limit(want):
    return chip_smoke.bf16_limit(want.float().abs().max().item())


@pytest.mark.parametrize("plan_kind", ["plan", "ragged"])
@pytest.mark.parametrize("heads,D", CASES)
def test_emulated_body_matches_plain_and_jax(heads, D, plan_kind, jax_outputs):
    """The body's walk and order against the port's plain version and the
    JAX Pallas kernel (interpret mode), both within the phase-2 bf16 limit
    (and the two references within it of each other), under the plan the
    rule picks here and under a ragged one; every (batch, location, head)
    problem computed once, the items of block x being x, x + grid, ..."""
    (q, k, v), ref = jax_outputs[(heads, D)]
    scale = D ** -0.5
    plan = kernels.frame_tma_plan(B, F, HW, heads, D, SMS) if plan_kind == "plan" else \
        _full_plan(RAGGED, heads, D)
    got, order = emulate_frame_tma(q, k, v, scale, heads, plan)
    want = kernels.frame_attention_plain(q, k, v, scale=scale, heads=heads)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    assert _err(got, want) <= _limit(want)
    assert _err(got, ref) <= _limit(ref)
    assert _err(want, ref) <= _limit(ref)
    assert sorted(o[2:] for o in order) == [(b, loc, h) for b in range(B) for loc in range(HW)
                                            for h in range(heads)]
    for blk in range(plan["grid"]):
        items = [o[1] for o in order if o[0] == blk]
        assert sorted(set(items)) == [i for i in range(blk, plan["items"], plan["grid"])
                                      if any(o[1] == i for o in order)]


def test_plans_agree_bit_for_bit():
    """The plan only changes the walk: the rule's plan and the ragged one
    give the same output bit for bit."""
    heads, D = 8, 40
    q, k, v = _inputs(heads, D, seed=3)
    a, _ = emulate_frame_tma(q, k, v, D ** -0.5, heads, kernels.frame_tma_plan(B, F, HW, heads,
                                                                               D, SMS))
    b, _ = emulate_frame_tma(q, k, v, D ** -0.5, heads, _full_plan(RAGGED, heads, D))
    assert torch.equal(a, b)


def test_zeroed_columns_add_nothing():
    """At D = 40 the third k-step's second half reads the last 8-column group
    again; with Q's half of the A fragment zeroed, whatever K holds there
    adds nothing (the output is the same bit for bit with those K columns
    replaced by other finite values), and unzeroed it would count those
    columns twice and miss the phase-2 limit."""
    heads, D = 8, 40
    q, k, v = _inputs(heads, D, seed=11)
    plan = kernels.frame_tma_plan(B, F, HW, heads, D, SMS)
    scale = D ** -0.5
    base, _ = emulate_frame_tma(q, k, v, scale, heads, plan)
    other = torch.from_numpy(np.random.default_rng(5).standard_normal((F, 8), dtype=np.float32))
    moved, _ = emulate_frame_tma(q, k, v, scale, heads, plan, overrun_k=other.bfloat16().float())
    assert torch.equal(base, moved)
    want = kernels.frame_attention_plain(q, k, v, scale=scale, heads=heads)
    unzeroed, _ = emulate_frame_tma(q, k, v, scale, heads, plan, zero_overrun=False)
    assert _err(base, want) <= _limit(want) < _err(unzeroed, want)
    # even head dims have no such half
    assert all((D // 8) % 2 == 0 for D in (80, 160))


def _walk_ok_by_simulation(P, S, NW, items=64):
    """Every consumer warp, taking problems w, w + NW, ... of items of P
    problems, waits on each stage it uses at its first turn (i < S) and
    then at every turn of it, none skipped: its waits by parity are then
    unambiguous."""
    for w in range(NW):
        seen = sorted({qi // P for qi in range(w, items * P, NW)})
        for s in range(S):
            turns = [i // S for i in seen if i % S == s]
            if turns and (turns[0] != 0 or turns != list(range(len(turns)))):
                return False
    return True


def test_walk_rule_matches_a_simulation():
    """kernels.frame_tma_walk_ok (csrc/frame_tma.cuh ft_walk_ok) holds only
    where a simulation of the consumers' walk finds no skipped turn of a
    stage, for 1-12 problems an item, 1-8 stages and 1-8 warps, and at
    every P >= NW and every NW a multiple of P with NW / P dividing S; 4
    problems an item on 8 warps and 3 stages (a warp on every second item,
    so on each stage every second turn) is refused by both; the plans the
    rule picks at every K4 site keep it, and their blocks fit."""
    for P in range(1, 13):
        for S in range(1, 9):
            for NW in range(1, 9):
                ok = kernels.frame_tma_walk_ok(P, S, NW)
                assert not ok or _walk_ok_by_simulation(P, S, NW), (P, S, NW)
                assert ok == (P >= NW or (NW % P == 0 and S % (NW // P) == 0))
    assert not kernels.frame_tma_walk_ok(4, 3, 8) and not _walk_ok_by_simulation(4, 3, 8)
    for _, shape in _k4_sites():
        Bs, Fs, HWs, C, heads = shape
        plan = kernels.frame_tma_plan(Bs, Fs, HWs, heads, C // heads, SMS)
        assert kernels.frame_tma_walk_ok(plan["G"] * plan["HG"], plan["S"], plan["NW"])
        assert plan["smem"] <= kernels.SMEM_LIMIT and plan["items"] >= plan["grid"]


def _k4_sites():
    """[(site, shape)] of chip_smoke's K4 sites and their per-shard shapes."""
    sites = [(s, shape) for n, s, shape in chip_smoke.SITES if n == "frame_attention"]
    full = dict(sites)
    for n, site, what, worlds in chip_smoke.SHARD_SITES:
        if n == "frame_attention":
            sites += [(f"{site}_w{w}", chip_smoke.shard_shape(full[site], what, w))
                      for w in worlds]
    return sites


def test_route_at_every_k4_site():
    """Every K4 site of chip_smoke.py (the eight motion stages of a denoise
    step, the SR stage's two, the per-shard shapes of 2 and 4 ranks) takes
    the Hopper body, as frame_route and chip_smoke.shape_body say."""
    sites = _k4_sites()
    assert {s for s, _ in sites} >= {"motion_pers_s0", "motion_pano_s3", "sr_motion_s0",
                                     "sr_motion_s1", "motion_pers_s0_w4", "motion_pano_s0_w2"}
    assert len(sites) == 14
    for site, (Bs, Fs, HWs, C, heads) in sites:
        assert kernels.frame_route(torch.bfloat16, Fs, HWs, heads, C // heads), site
        assert kernels.frame_body(torch.bfloat16, Fs, HWs, heads, C // heads) == "tma", site
        assert chip_smoke.shape_body(kernels, "frame_attention", (Bs, Fs, HWs, C, heads)) == \
            "tma", site


def test_route_refuses_off_rule_calls():
    """float32, other frame counts, a head dim no multiple of 8 or above 160,
    and a pointer off a 16-byte boundary (q, k, v or out) stay off the
    Hopper body: the `mma.sync` tile in bfloat16, the CUDA cores in
    float32."""
    args = (16, 1024, 8, 40)
    assert kernels.frame_route(torch.bfloat16, *args, ptrs=(0, 16, 4096, 2 ** 40))
    assert not kernels.frame_route(torch.float32, *args)
    assert kernels.frame_body(torch.float32, *args) == "cuda_cores"
    for F_ in (1, 15, 17, 33, 64):
        assert not kernels.frame_route(torch.bfloat16, F_, 1024, 8, 40)
    for D in (1, 37, 44, 100, 168, 512):
        assert not kernels.frame_route(torch.bfloat16, 16, 1024, 2, D)
    for D in (8, 24, 64, 120, 160):
        assert kernels.frame_route(torch.bfloat16, 16, 1024, 2, D)
    for ptrs in ((2, 0, 0, 0), (0, 8, 0, 0), (0, 0, 4, 0), (0, 0, 0, 8)):
        assert not kernels.frame_route(torch.bfloat16, *args, ptrs=ptrs)
        assert kernels.frame_body(torch.bfloat16, *args, ptrs=ptrs) == "mma_sync"


def test_chip_smoke_counts_k4_by_body():
    """chip_smoke names, from K4's launches by shape, the body each took
    (frame_body_expected against kernels.frame_body_counts, the check of
    phases 4-13), lists them apart in path_launches, counts the Hopper
    body's instantiations in phase 1 and names its source; on the CPU the
    wrapper runs its plain version and counts no body."""
    assert chip_smoke.MMA_KERNEL_NAMES["frame_attention_tma_kernel"] == 20
    assert chip_smoke.FRAME_BODY_SOURCES["tma"].endswith("frame_tma.cuh")
    for src in chip_smoke.FRAME_BODY_SOURCES.values():
        assert os.path.isfile(os.path.join(ROOT, src))
    kernels.reset_counts()
    try:
        q, k, v = _inputs(2, 40, seed=1)
        kernels.frame_attention(q, k, v, scale=0.1, heads=2)
        assert kernels.frame_attention.plain_calls == 1 and kernels.frame_body_counts() == {}
        shapes = {(40, 16, 1024, 320, 8): 10, (2, 16, 128, 1280, 8): 2,
                  (2, 15, 64, 320, 8): 1}
        kernels.frame_attention.shape_launches.update(shapes)
        kernels.frame_attention.launches = kernels.frame_attention.tc_launches = 13
        kernels.frame_attention.body_launches.update(tma=12, mma_sync=1)
        assert chip_smoke.frame_body_expected(kernels) == {"tma": 12, "mma_sync": 1} == \
            kernels.frame_body_counts()
        chip_smoke.check_frame_bodies("test", kernels)
        launches = chip_smoke.path_launches(kernels)
        assert launches["frame_attention_tma"] == 12 and launches["frame_attention_mma_sync"] == 1
        kernels.frame_attention.body_launches["tma"] -= 1
        kernels.frame_attention.body_launches["mma_sync"] += 1
        with pytest.raises(SystemExit, match="K4 launches by body"):
            chip_smoke.check_frame_bodies("test", kernels)
    finally:
        kernels.reset_counts()
