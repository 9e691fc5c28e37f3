"""Check and time the `wgmma` bodies of K1, K2, K5a and K6a
(csrc/attn_wgmma.cuh), of K3, K6a and K6b (csrc/attn_wgmma_bias.cuh), of K7
(csrc/dense_matmul.cu) and of K5b and K5c (csrc/attn_wgmma_bwd.cuh, and at
D = 32 under a bias csrc/attn_wgmma_bwd_bias.cuh) on an NVIDIA GPU, for the
checkout this script lies in.

    python scripts/torch_wgmma_check.py [--iters N] [--out DIR] [--kernels A,B]

1. Builds the checkout's kernels and logs, through `chip_smoke.check_mma_build`,
   the registers, spill bytes and HGMMA instructions of the wgmma kernels
   (chip_smoke.WGMMA_KERNEL_NAMES: `tiny_attention_wgmma_kernel`,
   `mh_flash_wgmma_kernel`, `flash_lse_wgmma_kernel`,
   `flash_t_wgmma_kernel`, `shared_bias_folded_wgmma_kernel`,
   `dense_matmul_wgmma_kernel`, `flash_bwd_dq_wgmma_kernel`,
   `flash_bwd_dkv_wgmma_kernel`, `shared_bias_wgmma_kernel`,
   `flash_t_bias_wgmma_kernel`, `flash_bwd_dq_bias_wgmma_kernel`,
   `flash_bwd_dkv_bias_wgmma_kernel`) and what ptxas says about their
   products.
2. Every bf16 D = 64 site of K1, K2, K5a and K6a without a bias in
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
   a warm-up. K5a and K6a (P split into bf16 hi + lo on both bodies) also
   give the share of outputs equal to the plain version's bit for bit on
   both bodies (`match`, at least chip_smoke.K5A_MATCH), and K5a its lse's
   error on both (at most chip_smoke.LSE_TOL).
3. Every K6b and K7 site of chip_smoke.SITES that its rule gives the wgmma
   body: chip_smoke.site_row (the wrapper against the plain version in bf16
   and f32, K6b's `match`, the library call, and both bodies in turns,
   mma.sync, wgmma, wgmma, mma.sync, the mma.sync one through
   chip_smoke.mma_body); K6b's mma.sync body also at 1 and 2 folded rows
   a block (`mma_ms_by_t_rows`). K7's other tile width (256 columns) is a
   variant of scripts/torch_wgmma_variants.py.
4. Every K5b and K5c site of chip_smoke.SITES and per-shard shape of
   chip_smoke.SHARD_SITES that the rule gives the D = 64 wgmma body (the
   training step's pano sites): chip_smoke.site_row (the wrapper against the plain
   version in bf16 and f32 on the plain forward's lse and delta, within
   2**-7 x max|plain|; both bodies in turns, the mma.sync one through
   chip_smoke.mma_body; the library call, forward and gradients, and
   PyTorch's flash-attention backward alone, `library_bwd_ms`).
5. Every WarpAttn site of K3 (with its lse and without) and of K6a in
   chip_smoke.SITES, and K3's per-shard shapes of chip_smoke.SHARD_SITES
   (the bias a row block of a larger one), that the rules give the biased
   body (`kernels.shared_bias_wgmma_route`,
   `kernels.flash_t_bias_wgmma_route`): chip_smoke.site_row (the wrapper
   against the plain version in bf16 and f32, `match`, K3's lse, the
   library call, and both bodies in turns, the mma.sync one through
   chip_smoke.mma_body).
6. Every K5b and K5c WarpAttn site of chip_smoke.SITES (the ten shapes of a
   training step) and their per-shard shapes of chip_smoke.SHARD_SITES (a
   rank's rows of the bias, a view of the larger matrix), which
   `kernels.bwd_bias_wgmma_route` gives the biased D = 32 body:
   chip_smoke.site_row as in step 4, under the site's bias (`match` against
   chip_smoke.K5A_MATCH, both bodies in turns, `library_bwd_ms` =
   PyTorch's memory-efficient attention backward alone under the bias).

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

NAMES = ("tiny_attention", "mh_flash_attention", "flash_attention_lse", "flash_attention_t")
OPT_IN = ("shared_bias_attention_folded", "dense_matmul")
BWD = ("flash_bwd_dq", "flash_bwd_dkv")    # on csrc/attn_wgmma_bwd.cuh
WARP = ("shared_bias_attention", "flash_attention_t")   # their WarpAttn sites, D = 32
SPLIT = ("flash_attention_lse", "flash_attention_t")   # P split into bf16 hi + lo


def c_entry(name, body):
    lib = kernels.load_library()
    return getattr(lib, f"i360_{name}_wgmma" if body == "wgmma" else f"i360_{name}")


def run_body(name, body, q, k, v, out, H, lse=None):
    """One launch of the `wgmma` or `mma.sync` body through its C entry on
    bf16 tensors in the wrapper's layout (K1, K2 [B, S, H*64]; K5a
    [B, S, H, 64] with lse [B, H, Sq]; K6a [B, H, 64, S]; views allowed: the
    pointers are taken as they are). K5a's and K6a's `mma.sync` body goes
    through chip_smoke.mma_body, as phase 2 calls it."""
    B, Sq, Sk, _, D = shape_of(name, q, k, H)
    stream = torch.cuda.current_stream().cuda_stream
    fn, scale = c_entry(name, body), D ** -0.5
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    if name in SPLIT and body != "wgmma":
        chip_smoke.mma_body(kernels, name, q, k, v, scale, out, lse)
        return out
    if name == "flash_attention_lse":
        err = fn(*args, out.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, D, scale, stream)
    elif name == "flash_attention_t":
        err = fn(*args, out.data_ptr(), B, Sq, Sk, H, D, scale, stream)
    elif body == "wgmma":
        err = fn(*args, out.data_ptr(), B, Sq, Sk, H, D, scale, stream)
    elif name == "tiny_attention":
        err = fn(*args, None, out.data_ptr(), B, Sq, Sk, H, D, scale, 1, stream)
    else:
        err = fn(*args, out.data_ptr(), B, Sq, Sk, H, D, scale, 1, stream)
    if err != 0:
        raise SystemExit(f"FAIL: {name} {body} launch error {err}")
    return out


def shape_of(name, q, k, H):
    """(B, Sq, Sk, H, D) of a call in the wrapper's layout."""
    if name == "flash_attention_lse":
        return (q.shape[0], q.shape[1], k.shape[1], H, q.shape[3])
    if name == "flash_attention_t":
        return (q.shape[0], q.shape[3], k.shape[3], H, q.shape[2])
    return (q.shape[0], q.shape[1], k.shape[1], H, q.shape[2] // H)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def site_shapes():
    """(wrapper, site, shape) of every bf16 D = 64 bias-free site of K1,
    K2, K5a and K6a with more than 32 query rows: chip_smoke.SITES and the
    per-shard shapes of chip_smoke.SHARD_SITES."""
    sites = {site: (name, shape) for name, site, shape in chip_smoke.SITES}
    out = [(name, site, shape) for name, site, shape in chip_smoke.SITES
           if name in NAMES and shape[4] == 64 and shape[1] > 32
           and not chip_smoke.site_has_bias(site)]
    for name, site, what, worlds in chip_smoke.SHARD_SITES:
        if name in NAMES:
            for w in worlds:
                out.append((name, f"{site}_w{w}", chip_smoke.shard_shape(sites[site][1], what, w)))
    return out


def site_check(name, site, shape, gen, dev, iters):
    B, Sq, Sk, H, D = shape
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).bfloat16()
    scale = D ** -0.5
    if name == "flash_attention_lse":
        q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D)
        hf = lambda x: x.transpose(1, 2)
        call = lambda: kernels.flash_attention_lse(q, k, v, scale=scale)
    elif name == "flash_attention_t":
        q, k, v = rnd(B, H, D, Sq), rnd(B, H, D, Sk), rnd(B, H, D, Sk)
        hf = lambda x: x.transpose(2, 3)
        call = lambda: (kernels.flash_attention_t(q, k, v, scale=scale),)
    else:
        q, k, v = rnd(B, Sq, H * D), rnd(B, Sk, H * D), rnd(B, Sk, H * D)
        hf = lambda x: x.view(B, -1, H, D).transpose(1, 2)
        call = lambda: (getattr(kernels, name)(q, k, v, scale=scale, heads=H),)
    new_out = lambda: torch.empty(B, H, Sq, D, device=dev, dtype=q.dtype) \
        if name == "flash_attention_t" else torch.empty_like(q)
    new_lse = lambda: torch.empty(B, H, Sq, device=dev, dtype=torch.float32)
    routed = kernels.wgmma_route(name, torch.bfloat16, Sq, Sk, H, D)
    kernels.reset_counts()
    got = call()
    if kernels.wgmma_counts()[name] != int(routed):
        raise SystemExit(f"FAIL: {name} at {site} took the wrong body (rule: wgmma {routed})")
    got, got_lse = got[0], (got[1] if len(got) > 1 else None)
    if not routed:
        got = run_body(name, "wgmma", q, k, v, got, H, got_lse)
    torch.cuda.synchronize()
    base = site.split("_w")[0] if site not in chip_smoke.SR_SUBSETS else site
    rows, heads = chip_smoke.SR_SUBSETS.get(base, (B, H))
    if name in SPLIT:
        sub = lambda x: x
        plain, plain_lse = getattr(kernels, name + "_plain")(q, k, v, scale=scale), None
        if name == "flash_attention_lse":
            plain, plain_lse = plain
    else:
        sub, plain_lse = (lambda x: x[:rows, :, :heads * D]), None
        plain = getattr(kernels, name + "_plain")(sub(q), sub(k), sub(v), scale=scale,
                                                  heads=heads)
    tol = chip_smoke.bf16_tol(name, plain.float().abs().max().item())
    err = max_err(sub(got), plain)
    old_lse = new_lse()
    old = run_body(name, "mma", q, k, v, new_out(), H, old_lse)
    torch.cuda.synchronize()
    vs_old = max_err(got, old)
    split = {}
    if name in SPLIT:
        split = dict(match=(got == plain).float().mean().item(),
                     mma_match=(old == plain).float().mean().item(),
                     mma_max_abs_err=max_err(old, plain))
        if plain_lse is not None:
            split.update(lse_max_abs_err=max_err(got_lse, plain_lse),
                         mma_lse_max_abs_err=max_err(old_lse, plain_lse))
    del plain, plain_lse
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out_w, out_m, lse_w, lse_m = new_out(), new_out(), new_lse(), new_lse()
    t = {}
    for label in ("mma_a", "wgmma_a", "wgmma_b", "mma_b"):
        body = "wgmma" if label.startswith("wgmma") else "mma"
        t[label] = chip_smoke.cuda_ms(
            lambda: run_body(name, body, q, k, v, out_w if body == "wgmma" else out_m, H,
                             lse_w if body == "wgmma" else lse_m), iters)
    if name == "flash_attention_t":    # the library's fused kernels want D contiguous
        q, k, v = (x.transpose(2, 3).contiguous() for x in (q, k, v))
        hf = lambda x: x
    library_ms = chip_smoke.cuda_ms(lambda: sdpa(hf(q), hf(k), hf(v)), iters)
    ops = 4.0 * math.prod(shape)
    bound_ms, bound_by = chip_smoke.site_bound(name, shape, site=site)
    ms, mma_ms = (t["wgmma_a"] + t["wgmma_b"]) / 2, (t["mma_a"] + t["mma_b"]) / 2
    rec = dict(check="site", kernel=name, site=site, shape=list(shape), routed=routed,
               max_abs_err=err,
               tol=tol, plain_rows_heads=[rows, heads], vs_mma_max_abs_diff=vs_old, ms=ms,
               mma_ms=mma_ms, times=t, tflops=ops / (ms * 1e-3) / 1e12,
               mma_tflops=ops / (mma_ms * 1e-3) / 1e12, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms, **split)
    print(json.dumps(rec), flush=True)
    if not (err <= tol and bool(torch.isfinite(got).all())
            and min(split.get("match", 1), split.get("mma_match", 1)) >= chip_smoke.K5A_MATCH
            and max(split.get("lse_max_abs_err", 0),
                    split.get("mma_lse_max_abs_err", 0)) <= chip_smoke.LSE_TOL):
        raise SystemExit(f"FAIL: {rec}")
    return rec


def opt_in_check(name, site, shape, gen, dev, shard=None):
    """Step 3 at one K6b or K7 site, step 4 at one K5b or K5c site, step 5
    at one WarpAttn site of K3 or K6a, step 6 at one WarpAttn site of K5b or
    K5c."""
    rec = chip_smoke.site_row(kernels, name, site, shape, gen, dev, shard=shard)
    rec = dict(rec, check="opt_in_site" if name in OPT_IN else "warp_site" if name not in BWD
               else "bwd_warp_site" if shape[4] == kernels.BIAS_WGMMA_HEAD_DIM else "bwd_site")
    print(json.dumps(rec), flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None, help="directory for wgmma_check.jsonl")
    ap.add_argument("--kernels", default=",".join(dict.fromkeys(NAMES + OPT_IN + BWD + WARP)),
                    help="wrappers to check (default: all nine)")
    args = ap.parse_args()
    only = args.kernels.split(",")
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
        if name in only:
            recs.append(dict(site_check(name, site, shape, gen, dev, args.iters), card=card))
            torch.cuda.empty_cache()
    for name, site, shape in chip_smoke.SITES:
        if (name in OPT_IN and name in only
                and chip_smoke.shape_routed(kernels, name, shape,
                                            bias_dtype=chip_smoke.site_bias_dtype(site))):
            recs.append(dict(opt_in_check(name, site, shape, gen, dev), card=card))
            torch.cuda.empty_cache()
    sites = {site: shape for _, site, shape in chip_smoke.SITES}
    bwd = [(name, site, shape, None) for name, site, shape in chip_smoke.SITES if name in BWD]
    bwd += [(name, f"{site}_w{w}", chip_smoke.shard_shape(sites[site], what, w), (w, w - 1))
            for name, site, what, worlds in chip_smoke.SHARD_SITES if name in BWD
            for w in worlds]
    for name, site, shape, shard in bwd:     # step 4: D = 64
        if name in only and shape[4] != kernels.BIAS_WGMMA_HEAD_DIM and chip_smoke.shape_routed(
                kernels, name, shape, chip_smoke.site_has_bias(site)):
            recs.append(dict(opt_in_check(name, site, shape, gen, dev, shard), card=card))
            torch.cuda.empty_cache()
    warp = [(name, site, shape, None) for name, site, shape in chip_smoke.SITES
            if name.replace("_lse", "") in WARP and chip_smoke.site_has_bias(site)]
    warp += [(name, f"{site}_w{w}", chip_smoke.shard_shape(sites[site], what, w), (w, w - 1))
             for name, site, what, worlds in chip_smoke.SHARD_SITES if name in WARP
             for w in worlds]
    for name, site, shape, shard in warp:
        if name.replace("_lse", "") in only and chip_smoke.shape_routed(kernels, name, shape,
                                                                        True):
            recs.append(dict(opt_in_check(name, site, shape, gen, dev, shard), card=card))
            torch.cuda.empty_cache()
    for name, site, shape, shard in bwd:     # step 6: the WarpAttn sites, D = 32
        if name in only and shape[4] == kernels.BIAS_WGMMA_HEAD_DIM and chip_smoke.shape_routed(
                kernels, name, shape, chip_smoke.site_has_bias(site)):
            recs.append(dict(opt_in_check(name, site, shape, gen, dev, shard), card=card))
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "wgmma_check.jsonl"), "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in recs))
    print("wgmma check passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
