"""Check and time K4 (csrc/frame_attention.cu) and K6b
(csrc/shared_bias_folded.cu) in bfloat16 on the tensor cores, at their
chip_smoke.py phase-2 sites, on one card:

    python scripts/torch_frame_folded_check.py [--out DIR]

Builds the library (kernels.build_library), prints both kernels'
registers, spill bytes and HMMA counts (chip_smoke.check_mma_build), then
at every K4 site of chip_smoke.SITES the error against the plain version
(phase 2's bf16 limit) and the time of the plan `kernels.frame_attention_plan`
picks beside every other pack (G locations x HG heads) that fits a block,
and at every K6b site its error, its share of outputs equal to the plain
version's and its time at 1 and 2 folded rows a block. Times: mean ms over
10 calls after a warm-up, CUDA events; beside them the library call
(F.scaled_dot_product_attention) and the site's bound. Prints one JSON
line per row; `--out DIR` also writes them to DIR/frame_folded.jsonl.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from imagine360_tpu_torch.ops import kernels  # noqa: E402

ITERS = 10
PACK_G = (1, 2, 4)


def k4_rows(dev, gen, sms):
    rows = []
    for name, site, shape in chip_smoke.SITES:
        if name != "frame_attention":
            continue
        B, F, HW, C, heads = shape
        D = C // heads
        kern, plain, library = chip_smoke.site_call(kernels, name, site, shape, gen, dev)
        want = plain()
        peak = want.float().abs().max().item()
        bound_ms, bound_by = chip_smoke.site_bound(name, shape)
        base = dict(kernel=name, site=site, shape=list(shape), bound_ms=bound_ms,
                    bound_by=bound_by, plain_ms=chip_smoke.cuda_ms(plain, ITERS),
                    library_ms=chip_smoke.cuda_ms(library, ITERS),
                    tol=chip_smoke.bf16_tol(name, peak))
        chosen = kernels.frame_attention_plan(B, F, HW, heads, D, sms)
        plans = [chosen] + [
            (G, HG, kernels.frame_attention_walk(B, F, HW, heads, D, sms, G, HG))
            for HG in range(1, heads + 1) if heads % HG == 0 for G in PACK_G
            if 2 * kernels._frame_stage_bytes(F, D, G, HG) <= kernels.SMEM_LIMIT
            and (G, HG) != chosen[:2]]
        planner = kernels.frame_attention_plan
        try:
            for plan in plans:
                kernels.frame_attention_plan = lambda *a, plan=plan: plan
                err = (kern().float() - want.float()).abs().max().item()
                ms = chip_smoke.cuda_ms(kern, ITERS)
                rows.append(dict(base, plan=list(plan), chosen=plan == chosen, max_abs_err=err,
                                 ms=ms, share_of_bound=bound_ms / ms))
                print(json.dumps(rows[-1]), flush=True)
                if not err <= base["tol"]:
                    raise SystemExit(f"FAIL: K4 at {site} plan {plan} err {err}")
        finally:
            kernels.frame_attention_plan = planner
    return rows


def k6b_rows(dev, gen):
    rows = []
    for name, site, shape in chip_smoke.SITES:
        if name != "shared_bias_attention_folded":
            continue
        kern, plain, library = chip_smoke.site_call(kernels, name, site, shape, gen, dev)
        first = lambda out: out[0] if isinstance(out, tuple) else out
        err, peak, finite, ok = chip_smoke.compare(
            kern, plain, lambda pk: chip_smoke.bf16_tol(name, pk))
        match = (first(kern()) == first(plain())).float().mean().item()
        bound_ms, bound_by = chip_smoke.site_bound(name, shape, site=site)
        row = dict(kernel=name, site=site, shape=list(shape), max_abs_err=err,
                   tol=chip_smoke.bf16_tol(name, peak), match=match, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=chip_smoke.cuda_ms(library, ITERS),
                   plain_ms=chip_smoke.cuda_ms(plain, ITERS),
                   ms=chip_smoke.cuda_ms(kern, ITERS))
        BH, Sq, Sk, D = shape
        q, k, v = (torch.randn(BH, S, D, generator=gen, device=dev).bfloat16()
                   for S in (Sq, Sk, Sk))
        bias = torch.rand(Sq, Sk, generator=gen, device=dev) * 2 - 1
        row["ms_by_t_rows"] = {t: chip_smoke.cuda_ms(
            lambda t=t: kernels.shared_bias_attention_folded(q, k, v, bias, scale=D ** -0.5,
                                                             t_rows=t), ITERS) for t in (1, 2)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not (finite and ok and match >= chip_smoke.K5A_MATCH):
            raise SystemExit(f"FAIL: K6b at {site} err {err} match {match}")
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"card: {chip_smoke.smi_line()}", flush=True)
    lib = kernels.build_library()
    kernels.load_library()
    try:
        report = chip_smoke.check_mma_build(kernels, lib)
    except SystemExit as e:    # report it, and check and time the kernels all the same
        print(e, flush=True)
        report = {}
    for fn, (regs, spill, hmma) in report.items():
        if "frame_attention_mma" in fn or "shared_bias_folded_mma" in fn:
            print(json.dumps(dict(function=fn, registers=regs, spill_bytes=spill, hmma=hmma)))
    gen = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = k4_rows(dev, gen, sms) + k6b_rows(dev, gen)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "frame_folded.jsonl"), "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
