"""The motion-attention lab of the PyTorch port: the variants of the
frame-axis attention kernel (L1 striped_v2, L2 fused, L3 diag) against K4,
checked and timed at the motion sites.

    python scripts/torch_motion_lab.py [--device cuda|cpu] [--site NAME,...]
                                       [--dtype bfloat16|float32] [--iters N]
                                       [--variants NAME,...] [--plans]
                                       [--out DIR]

For every site it prints one line per variant that fits: its largest
absolute difference from K4's plain version and from the K4 kernel, its
time (mean of --iters calls, CUDA events) and K4's in the same run. Sites:
`lab` is the perspective stage-0 motion site (40, 16, 1024, 320), 8 heads;
`motion_pers_s0`..`motion_pers_s3` and `motion_pano_s0`..`motion_pano_s3`
are every motion stage of both branches of full_dual_config, the sites of
chip_smoke.py's phase 8; `tiny` is a CPU-sized site. The default is `lab`.
`--variants` keeps only the named variants (`frame_attention` is K4).
A variant beyond chip_smoke.py's limits (bf16: min(2e-2, 2**-5 x
max|plain|), the exp_bf16 variant 5e-2; float32: 1e-4) makes the script
exit 1. With --plans (bf16 on the card) it also times L2 and L3 at every
pack of the lab under every other plan that fits a block: L2 at 1 or 2
heads a block (`kernels.fused_motion_mma_plan` picks), L3 at every number
of heads a stage that divides the heads (`kernels.diag_motion_mma_plan`
picks), one line each with `chosen` true for the plan the wrapper takes.
(L1 has one plan: one stage of a whole pack, `kernels.striped_v2_mma_plan`.)

Runs on the card (needs nvcc; imports no JAX); without one it exits 1
unless --device cpu, where the wrappers run their plain versions and no
time is measured.
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from imagine360_tpu_torch.ops import kernels, motion_lab  # noqa: E402

SITES = {"lab": chip_smoke.LAB_SITES[0][1], "tiny": (2, 4, 16, 32, 4),
         **dict(chip_smoke.LAB_SITES)}


def tolerance(row, dtype) -> float:
    """The limit of a row's difference from K4's plain version, as phases 2
    and 8 of chip_smoke.py set it."""
    if row["params"].get("exp_bf16"):
        return chip_smoke.EXP_BF16_TOL
    if dtype == torch.float32:
        return chip_smoke.F32_TOL
    return chip_smoke.bf16_tol(row["kernel"], row["peak"])


def plan_rows(site, shape, iters):
    """L2 and L3 in bfloat16 at `site` under each plan that fits a block:
    the wrapper's plan function is swapped for one that returns it."""
    B, F, HW, C, heads = shape
    D = C // heads
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(B, F, HW, C, generator=gen, device=dev).bfloat16() for _ in range(3))
    kw = dict(scale=D ** -0.5, heads=heads)
    want = kernels.frame_attention_plain(q, k, v, **kw).float()
    fused = kernels.fused_motion_mma_plan
    chosen = fused(D, heads)[0]
    cases = []
    for G, exp_bf16 in motion_lab.FUSED_PACKS:
        if HW % G:
            continue
        bias = torch.from_numpy(motion_lab.block_diag_bias(G, F, F)[0]).to(dev)
        for hb in range(1, min(kernels.FUSED_MMA_MAX_HEADS, heads) + 1):
            plan = fused(D, hb)           # hb heads a block, if it fits
            if heads % hb or plan[0] != hb:
                continue
            cases.append((f"fused_G{G}" + ("_expbf16" if exp_bf16 else ""), "fused_motion_mma_plan",
                          plan, hb == chosen, lambda G=G, e=exp_bf16, b=bias:
                          kernels.fused_motion_attention(q, k, v, b, G=G, exp_bf16=e, **kw)))
    for G in motion_lab.DIAG_PACKS:
        if HW % G:
            continue
        try:
            chosen_diag = kernels.diag_motion_mma_plan(G, F, D, heads)
        except ValueError:
            continue
        for hg in (h for h in range(1, heads + 1) if heads % h == 0):
            smem = kernels._frame_stage_bytes(F, D, G, hg)
            if smem <= kernels.SMEM_LIMIT:
                cases.append((f"diag_G{G}", "diag_motion_mma_plan", (hg, smem),
                              hg == chosen_diag[0], lambda G=G:
                              kernels.diag_motion_attention(q, k, v, G=G, **kw)))
    rows = []
    for variant, planner, plan, is_chosen, call in cases:
        saved = getattr(kernels, planner)
        setattr(kernels, planner, lambda *a, plan=plan: plan)
        try:
            err = (call().float() - want).abs().max().item()
            ms = motion_lab.cuda_ms(call, iters)
        finally:
            setattr(kernels, planner, saved)
        rows.append(dict(site=site, shape=list(shape), variant=variant, plan=list(plan[:-1]),
                         smem=plan[-1], chosen=is_chosen, ms=ms, max_abs_err=err))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--site", default="lab", help=f"comma list of {', '.join(SITES)}")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--variants", default=None, help="comma list of variant names (all)")
    ap.add_argument("--plans", action="store_true",
                    help="also time L2 and L3 under every plan that fits (bf16, card)")
    ap.add_argument("--out", default=None, help="directory for motion_lab.json")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu for the plain versions)", file=sys.stderr)
        return 1
    dtype = getattr(torch, args.dtype)
    card = "cpu"
    if args.device == "cuda":
        card = chip_smoke.smi_line()
        kernels.load_library()
    print(f"card: {card}", flush=True)
    sites = [(name, SITES[name]) for name in args.site.split(",")]
    kernels.reset_counts()
    rows = motion_lab.run_lab(args.device, sites, iters=args.iters, dtype=dtype,
                              variants=args.variants and args.variants.split(","))
    bad = 0
    for row in rows:
        row["tol"] = tolerance(row, dtype)
        row["ok"] = row["max_abs_err"] <= row["tol"]
        bad += not row["ok"]
        print(json.dumps(row), flush=True)
    plans = []
    if args.plans and args.device == "cuda" and dtype == torch.bfloat16:
        for name, shape in sites:
            plans += plan_rows(name, shape, args.iters)
        for row in plans:
            print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "motion_lab.json"), "w") as f:
            json.dump({"card": card, "dtype": args.dtype, "rows": rows, "plans": plans,
                       "counts": kernels.counts()}, f, indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
