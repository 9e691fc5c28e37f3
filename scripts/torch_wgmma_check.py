"""Check and time the `wgmma` body of K1 and K2 (csrc/attn_wgmma.cuh) on an
NVIDIA GPU, for the checkout this script lies in.

    python scripts/torch_wgmma_check.py [--iters N] [--out DIR]

1. Builds the checkout's kernels and logs, through `chip_smoke.check_mma_build`,
   the registers, spill bytes and HGMMA instructions of
   `tiny_attention_wgmma_kernel` and `mh_flash_wgmma_kernel` (and what ptxas
   says about their products).
2. Every bf16 D = 64 site of K1 and K2 without a bias in
   chip_smoke.SITES and at the per-shard shapes of chip_smoke.SHARD_SITES:
   the wrapper takes the body `kernels.wgmma_route` names (`routed`), the
   `wgmma` body (called through its C entry where the rule leaves the site
   on `mma.sync`, to show why) against the plain version (on the (batch,
   head) rows of chip_smoke.SR_SUBSETS where all logits do not fit) and
   against the `mma.sync` body on every row (chip_smoke.py's phase-2 limit,
   min(2e-2, 2**-5 x max|plain|)), and its time beside the
   `mma.sync` body's (its C entry called directly on the same inputs) and
   F.scaled_dot_product_attention's (a yardstick the port never calls), in
   turns: mma.sync, wgmma, wgmma, mma.sync, CUDA events, N calls each after
   a warm-up.

Prints one JSON line per site (also written to DIR/wgmma_check.jsonl with
--out). The small ragged shapes and the tensor-map boundaries are
tests/test_torch_cuda.py's (`-k wgmma`). Needs nvcc and a card; imports no
JAX.
"""
import argparse
import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from imagine360_tpu_torch.ops import kernels  # noqa: E402

NAMES = ("tiny_attention", "mh_flash_attention")


def c_entry(name, body):
    lib = kernels.load_library()
    return getattr(lib, f"i360_{name}_wgmma" if body == "wgmma" else f"i360_{name}")


def run_body(name, body, q, k, v, out, H):
    """One launch of the `wgmma` or `mma.sync` body through its C entry on
    [B, S, H*64] bf16 tensors (views allowed: the pointers are taken as
    they are)."""
    B, Sq, C = q.shape
    Sk, D = k.shape[1], C // H
    stream = torch.cuda.current_stream().cuda_stream
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    if body == "wgmma":
        err = c_entry(name, body)(*args, out.data_ptr(), B, Sq, Sk, H, D, D ** -0.5, stream)
    elif name == "tiny_attention":
        err = c_entry(name, body)(*args, None, out.data_ptr(), B, Sq, Sk, H, D, D ** -0.5, 1,
                                  stream)
    else:
        err = c_entry(name, body)(*args, out.data_ptr(), B, Sq, Sk, H, D, D ** -0.5, 1, stream)
    if err != 0:
        raise SystemExit(f"FAIL: {name} {body} launch error {err}")
    return out


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def site_shapes():
    """(wrapper, site, shape) of every bf16 D = 64 bias-free site of K1 and
    K2 with more than 32 query rows: chip_smoke.SITES and the per-shard
    shapes of chip_smoke.SHARD_SITES."""
    sites = {site: (name, shape) for name, site, shape in chip_smoke.SITES}
    out = [(name, site, shape) for name, site, shape in chip_smoke.SITES
           if name in NAMES and shape[4] == 64 and shape[1] > 32 and not site.endswith("_bias")]
    for name, site, what, worlds in chip_smoke.SHARD_SITES:
        if name in NAMES:
            for w in worlds:
                out.append((name, f"{site}_w{w}", chip_smoke.shard_shape(sites[site][1], what, w)))
    return out


def site_check(name, site, shape, gen, dev, iters):
    B, Sq, Sk, H, D = shape
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).bfloat16()
    q, k, v = rnd(B, Sq, H * D), rnd(B, Sk, H * D), rnd(B, Sk, H * D)
    routed = kernels.wgmma_route(name, torch.bfloat16, Sq, Sk, H, D)
    kernels.reset_counts()
    got = getattr(kernels, name)(q, k, v, scale=D ** -0.5, heads=H)
    if kernels.wgmma_counts()[name] != int(routed):
        raise SystemExit(f"FAIL: {name} at {site} took the wrong body (rule: wgmma {routed})")
    if not routed:
        got = run_body(name, "wgmma", q, k, v, got, H)
    torch.cuda.synchronize()
    base = site.split("_w")[0] if site not in chip_smoke.SR_SUBSETS else site
    rows, heads = chip_smoke.SR_SUBSETS.get(base, (B, H))
    sub = lambda x: x[:rows, :, :heads * D]
    plain = getattr(kernels, name + "_plain")(sub(q), sub(k), sub(v), scale=D ** -0.5,
                                              heads=heads)
    tol = chip_smoke.bf16_tol(name, plain.float().abs().max().item())
    err = max_err(sub(got), plain)
    del plain
    old = run_body(name, "mma", q, k, v, torch.empty_like(q), H)
    vs_old = max_err(got, old)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    hf = lambda x: x.view(B, -1, H, D).transpose(1, 2)
    out_w, out_m = torch.empty_like(q), torch.empty_like(q)
    t = {}
    for label in ("mma_a", "wgmma_a", "wgmma_b", "mma_b"):
        body = "wgmma" if label.startswith("wgmma") else "mma"
        t[label] = chip_smoke.cuda_ms(
            lambda: run_body(name, body, q, k, v, out_w if body == "wgmma" else out_m, H), iters)
    library_ms = chip_smoke.cuda_ms(lambda: sdpa(hf(q), hf(k), hf(v)), iters)
    ops = 4.0 * math.prod(shape)
    bound_ms, bound_by = chip_smoke.site_bound(name, shape, site=site)
    ms, mma_ms = (t["wgmma_a"] + t["wgmma_b"]) / 2, (t["mma_a"] + t["mma_b"]) / 2
    rec = dict(check="site", kernel=name, site=site, shape=list(shape), routed=routed,
               max_abs_err=err,
               tol=tol, plain_rows_heads=[rows, heads], vs_mma_max_abs_diff=vs_old, ms=ms,
               mma_ms=mma_ms, times=t, tflops=ops / (ms * 1e-3) / 1e12,
               mma_tflops=ops / (mma_ms * 1e-3) / 1e12, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms)
    print(json.dumps(rec), flush=True)
    if not (err <= tol and bool(torch.isfinite(got).all())):
        raise SystemExit(f"FAIL: {rec}")
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None, help="directory for wgmma_check.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = chip_smoke.smi_line()
    print(f"card: {card}", flush=True)
    lib = kernels.build_library()
    kernels.load_library()
    report = chip_smoke.check_mma_build(kernels, lib)
    wg = {f: r for f, r in report.items() if any(n in f for n in chip_smoke.WGMMA_KERNEL_NAMES)}
    print(json.dumps(dict(check="build", wgmma_kernels=wg)), flush=True)
    recs = []
    gen = torch.Generator(device=dev).manual_seed(1)
    for name, site, shape in site_shapes():
        recs.append(dict(site_check(name, site, shape, gen, dev, args.iters), card=card))
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "wgmma_check.jsonl"), "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in recs))
    print("wgmma check passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
