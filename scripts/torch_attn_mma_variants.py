"""Time variants of K3, K5a and K5c that the kernel library does not build,
beside the library's own kernels, on an NVIDIA GPU.

    python scripts/torch_attn_mma_variants.py [--iters N] [--out FILE]

K3 (`shared_bias_attention`, bf16 on the tensor cores) at the WarpAttn sites
of chip_smoke.py phase 2, with G = 1, 2 and 4 (batch, head) problems a block
under one staged bias tile; the library builds G = 2 at these head dims
(csrc/shared_bias.cu k3_groups). Every G must give the library's output bit
for bit.

K5a (`flash_attention_lse`, bf16) at the training sites of phase 2, with P·V
on the exact split P = hi + lo (the library's kernel) and on P rounded once
to bf16: the time of each, and the share of outputs equal bit for bit to the
plain version's (float32 probabilities, one rounding of the output), of which
phase 2 demands at least chip_smoke.K5A_MATCH. The split variant must give
the library's output bit for bit.

K5c (`flash_bwd_dkv`, bf16) at the training sites train_pano_spatial_s0 and
the two WarpAttn r2 ones of phase 2, with Pᵀ·dO and dSᵀ·Q on the exact
split of P and dS into bf16 hi + lo (the library's kernel) and on both
rounded once to bf16: the time of each, and for dk and dv the largest error
against the plain version in units of phase 2's limit, 2**-7 x max|plain|,
and the share of elements equal to the plain version's bit for bit. The
split variant must give the library's dk and dv bit for bit.

The variants come from scripts/torch_attn_mma_variants.cu, which includes the
library's sources, so they are the library's own templates at other
parameters. Times: mean ms over N calls after a warm-up (CUDA events,
chip_smoke.cuda_ms); the versions of one site run in the order a b c c b a
and each time is the mean of its two runs. One JSON line a site.

Needs nvcc and a card; imports no JAX.
"""
import argparse
import ctypes
import hashlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from imagine360_tpu_torch.ops import kernels  # noqa: E402

SRC = Path(__file__).with_suffix(".cu")
K3_GROUPS = (1, 2, 4)


def start_build():
    """(library path, nvcc process or None) of the variants, built into
    kernels.BUILD_DIR once per digest of this source and the library's."""
    h = hashlib.sha256(kernels._sources_digest().encode() + SRC.read_bytes())
    lib = kernels.BUILD_DIR / f"libi360_variants_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, None
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = open(lib.with_suffix(".log"), "w")
    proc = subprocess.Popen([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-shared",
                             "-I", str(kernels.CSRC), "-o", str(lib), str(SRC)],
                            stdout=log, stderr=subprocess.STDOUT)
    return lib, proc


def load(lib, proc):
    if proc is not None and proc.wait() != 0:
        raise SystemExit(f"nvcc failed on {SRC.name}:\n"
                         f"{lib.with_suffix('.log').read_text()[-8000:]}")
    so = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.exp_shared_bias_groups.argtypes = [P, P, P, P, P, I, I, I, I, I, F, I, P]
    so.exp_flash_lse_split.argtypes = [P, P, P, P, P, I, I, I, I, I, F, I, P]
    so.exp_flash_bwd_dkv_split.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, I, P]
    so.exp_shared_bias_groups.restype = so.exp_flash_lse_split.restype = ctypes.c_int
    so.exp_flash_bwd_dkv_split.restype = ctypes.c_int
    return so


def call(fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise SystemExit(f"{fn.__name__}: launch failed with cudaError {err}")


def interleaved(fns, iters):
    """{name: mean ms} of the thunks in `fns`, run in the order a b c c b a."""
    order = list(fns) + list(reversed(fns))
    ms = {name: 0.0 for name in fns}
    for name in order:
        ms[name] += chip_smoke.cuda_ms(fns[name], iters) / 2
    return ms


def k3_site(so, site, shape, gen, dev, iters):
    B, Sq, Sk, H, D = shape
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).bfloat16()
    q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D)
    bias = torch.rand(Sq, Sk, generator=gen, device=dev) * 2 - 1
    scale = D ** -0.5
    outs = {G: torch.empty_like(q) for G in K3_GROUPS}

    def variant(G):
        return lambda: call(so.exp_shared_bias_groups, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            bias.data_ptr(), outs[G].data_ptr(), B, Sq, Sk, H, D, scale, G)

    fns = {"library": lambda: kernels.shared_bias_attention(q, k, v, bias, scale=scale)}
    fns.update({f"G={G}": variant(G) for G in K3_GROUPS})
    want = fns["library"]()
    for G in K3_GROUPS:
        variant(G)()
    torch.cuda.synchronize()
    same = {f"G={G}": bool(torch.equal(outs[G], want)) for G in K3_GROUPS}
    ms = interleaved(fns, iters)
    return dict(kernel="shared_bias_attention", site=site, shape=list(shape), ms=ms,
                tflops={n: 4.0 * math.prod(shape) / (t * 1e-3) / 1e12 for n, t in ms.items()},
                same_as_library=same), all(same.values())


def k5a_site(so, site, shape, gen, dev, iters):
    B, Sq, Sk, H, D = shape
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).bfloat16()
    q, k, v = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D)
    scale = D ** -0.5
    outs = {s: (torch.empty_like(q), torch.empty(B, H, Sq, device=dev)) for s in (1, 0)}

    def variant(split):
        out, lse = outs[split]
        return lambda: call(so.exp_flash_lse_split, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), lse.data_ptr(), B, Sq, Sk, H, D, scale, split)

    fns = {"library": lambda: kernels.flash_attention_lse(q, k, v, scale=scale),
           "split": variant(1), "rounded": variant(0)}
    got, _ = fns["library"]()
    variant(1)()
    variant(0)()
    want, _ = kernels.flash_attention_lse_plain(q, k, v, scale=scale)
    torch.cuda.synchronize()
    match = {"library": (got == want).float().mean().item()}
    match.update({n: (outs[s][0] == want).float().mean().item()
                  for n, s in (("split", 1), ("rounded", 0))})
    err = {n: (outs[s][0].float() - want.float()).abs().max().item()
           for n, s in (("split", 1), ("rounded", 0))}
    same = bool(torch.equal(outs[1][0], got))
    del want
    ms = interleaved(fns, iters)
    return dict(kernel="flash_attention_lse", site=site, shape=list(shape), ms=ms,
                tflops={n: 4.0 * math.prod(shape) / (t * 1e-3) / 1e12 for n, t in ms.items()},
                match=match, max_abs_err=err, split_same_as_library=same,
                k5a_match=chip_smoke.K5A_MATCH), same


def k5c_site(so, site, shape, gen, dev, iters):
    B, Sq, Sk, H, D = shape
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).bfloat16()
    q, k, v, do = rnd(B, Sq, H, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D), rnd(B, Sq, H, D)
    bias = None
    if "warp" in site:
        bias = (torch.rand(Sq, Sk, generator=gen, device=dev) * 2 - 1)[None, None]
    scale = D ** -0.5
    out, lse = kernels.flash_attention_lse_plain(q, k, v, bias, scale=scale)
    delta = kernels.attention_delta(do, out)
    del out
    args = (q, k, v, bias, do, lse, delta)
    outs = {s: (torch.empty_like(k), torch.empty_like(v)) for s in (1, 0)}

    def variant(split):
        dk, dv = outs[split]
        ptrs = [None if t is None else t.data_ptr() for t in (*args, dk, dv)]
        return lambda: call(so.exp_flash_bwd_dkv_split, *ptrs, B, Sq, Sk, H, D, scale, split)

    fns = {"library": lambda: kernels.flash_bwd_dkv(*args, scale=scale),
           "split": variant(1), "rounded": variant(0)}
    got = fns["library"]()
    variant(1)()
    variant(0)()
    want = kernels.flash_bwd_dkv_plain(*args, scale=scale)
    torch.cuda.synchronize()
    names = (("split", 1), ("rounded", 0))
    # the largest error of dk and dv in units of phase 2's limit
    err = {n: {g: (outs[s][i].float() - want[i].float()).abs().max().item()
               / (chip_smoke.GRAD_BF16_REL * want[i].float().abs().max().item())
               for i, g in enumerate(("dk", "dv"))} for n, s in names}
    match = {n: {g: (outs[s][i] == want[i]).float().mean().item()
                 for i, g in enumerate(("dk", "dv"))} for n, s in names}
    same = all(torch.equal(a, b) for a, b in zip(outs[1], got))
    del want
    ms = interleaved(fns, iters)
    ops = chip_smoke.OPS_PER_ELEMENT["flash_bwd_dkv"] * math.prod(shape)
    return dict(kernel="flash_bwd_dkv", site=site, shape=list(shape), ms=ms,
                tflops={n: ops / (t * 1e-3) / 1e12 for n, t in ms.items()},
                err_over_limit=err, match=match, split_same_as_library=same), same


K5C_SITES = ("train_pano_spatial_s0", "train_warp_r2_pano_q", "train_warp_r2_pers_q")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = chip_smoke.smi_line()
    print(f"card: {card}", flush=True)
    lib, proc = start_build()          # compiles beside the library's build
    kernels.load_library()
    so = load(lib, proc)
    gen = torch.Generator(device=dev).manual_seed(1)
    recs, ok = [], True
    for name, site, shape in chip_smoke.SITES:
        if name == "shared_bias_attention" and site.startswith("warp"):
            rec, good = k3_site(so, site, shape, gen, dev, args.iters)
        elif name == "flash_attention_lse":
            rec, good = k5a_site(so, site, shape, gen, dev, args.iters)
        elif name == "flash_bwd_dkv" and site in K5C_SITES:
            rec, good = k5c_site(so, site, shape, gen, dev, args.iters)
        else:
            continue
        rec["card"] = card
        recs.append(rec)
        ok = ok and good
        print(json.dumps(recs[-1]), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in recs)
    if not ok:
        print("FAIL: a variant that must equal the library's output does not", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
