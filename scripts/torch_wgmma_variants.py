"""Time variants of the `wgmma` attention body (csrc/attn_wgmma.cuh) against
the body as committed, on an NVIDIA GPU, for the checkout this script lies
in.

    python scripts/torch_wgmma_variants.py [--variants A,B] [--iters N] [--out FILE]

Each variant is the committed header with fixed text changes:

- `final`: the header as it is (the overlap of a tile's softmax with the
  previous tile's P·V inside a warpgroup, three stages, ex2.approx.ftz);
- `stages2`, `stages4`: the K/V ring at two or four stages;
- `exp2f`: 2^x by exp2f (three more instructions a logit, for subnormal
  results) instead of ex2.approx.ftz;
- `serial_exp2f`: one tile at a time (Q·Kᵀ, wait, softmax, P·V, wait) and
  exp2f, at three stages; `serial_exp2f_stages2` at two, the first form of
  the body.

Every variant computes the same arithmetic (ftz moves only results below
2^-126). Each is compiled alone (one kernel and a C entry, `nvcc` in
parallel) into imagine360_tpu_torch/_build/wgmma_variants/, then at every
site the variants run in turns (all, then all again; CUDA events, N calls
each after a warm-up): ms and TFLOP/s of each, its error against the plain
version on the first batch row (chip_smoke.py's phase-2 limit), and whether
its output equals `final`'s bit for bit. One JSON line a site.

Needs nvcc and a card; imports no JAX.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from imagine360_tpu_torch.ops import kernels  # noqa: E402

HEADER = kernels.CSRC / "attn_wgmma.cuh"
OUT_DIR = kernels.BUILD_DIR / "wgmma_variants"
VARIANTS = ("final", "stages2", "stages4", "exp2f", "serial_exp2f", "serial_exp2f_stages2")
# (wrapper, (B, Sq, Sk, H, D)): the sites of K1 and K2 on the wgmma body
SITES = [("mh_flash_attention", (32, 8192, 8192, 5, 64)),
         ("mh_flash_attention", (32, 2048, 2048, 10, 64)),
         ("mh_flash_attention", (16, 8448, 8448, 10, 64)),
         ("tiny_attention", (640, 1024, 1024, 5, 64)),
         ("tiny_attention", (32, 512, 512, 20, 64)),
         ("tiny_attention", (64, 333, 1000, 5, 64)),
         ("mh_flash_attention", (4, 1000, 3001, 5, 64))]

STAGES = "constexpr int kWgStages = 3;"
# the consumer's key loop, from its S registers to the last P·V
LOOP_START = "    float sc[64];                       // S of the tile in flight\n"
LOOP_END = "    // epilogue: divide by the sum, bf16 into this consumer's own Q rows\n"
SERIAL_LOOP = """    mbar_wait(barQ, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kWgStages;
      const uint32_t parity = (t / kWgStages) & 1;
      float sc[64];
      mbar_wait(full_k(s), parity);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWgD / 16; ++ks)
        wgmma_m64n128k16_ss(sc, dq + 2 * ks, wg_desc(sK + s * kWgTileBytes) + 2 * ks, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      float alpha0, alpha1;
      uint32_t pa[8][4];
      wg_softmax(sc, sl2, min(kWgBK, Sk - t * kWgBK), tg, m0, m1, l0, l1, alpha0, alpha1, pa);
      wg_rescale(o, alpha0, alpha1);
      mbar_wait(full_v(s), parity);
      fence_regs(o);
      wgmma_fence();
      const uint64_t dv = wg_desc(sV + s * kWgTileBytes);
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) wgmma_m64n64k16_rs(o, pa[kk], dv + 128 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

"""
KERNEL = """#include "{header}"
namespace i360 {{
__global__ void __launch_bounds__(kWgThreads, 1)
wgmma_variant_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
                     int Sq, int Sk, int H, int nqt, float sl2) {{
  extern __shared__ __align__(1024) unsigned char variant_smem[];
  attn_wgmma_tile(&mq, &mk, &mv, &mo, Sq, Sk, H, nqt, sl2, variant_smem);
}}
}}  // namespace i360
extern "C" int wgmma_variant(const void* q, const void* k, const void* v, void* out, int B,
                             int Sq, int Sk, int H, float scale, void* stream) {{
  return i360::launch_attn_wgmma(i360::wgmma_variant_kernel, q, k, v, out, B, Sq, Sk, H, scale,
                                 (cudaStream_t)stream);
}}
"""


def replace_once(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f"the header no longer has exactly one {old[:60]!r}")
    return text.replace(old, new)


def variant_header(name):
    """The committed header with the variant's text changes."""
    text = HEADER.read_text()
    if name.endswith("stages2") or name == "stages4":
        text = replace_once(text, STAGES, f"constexpr int kWgStages = {name[-1]};")
    if "exp2f" in name:
        start = text.index("__device__ __forceinline__ void wg_softmax(")
        end = text.index("// O's rows g")
        text = text[:start] + text[start:end].replace("ex2_ftz(", "exp2f(") + text[end:]
    if name.startswith("serial"):
        start, end = text.index(LOOP_START), text.index(LOOP_END)
        text = text[:start] + SERIAL_LOOP + text[end:]
    return text


def build(names):
    """{variant: ctypes function}, each compiled alone and in parallel."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, procs = kernels.find_nvcc(), {}
    for name in names:
        (OUT_DIR / f"{name}.cuh").write_text(variant_header(name))
        (OUT_DIR / f"{name}.cu").write_text(KERNEL.format(header=f"{name}.cuh"))
        log = open(OUT_DIR / f"{name}.log", "w")
        procs[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-I", str(kernels.CSRC), "-o",
             str(OUT_DIR / f"lib_{name}.so"), str(OUT_DIR / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        report = (OUT_DIR / f"{name}.log").read_text() if proc.wait() == 0 else None
        if report is None:
            raise SystemExit(f"nvcc failed on {name}:\n{(OUT_DIR / f'{name}.log').read_text()}")
        notes = [line.replace("ptxas info    :", "").strip() for line in report.splitlines()
                 if "Used" in line or "spill" in line or "C75" in line]
        print(json.dumps(dict(variant=name, ptxas=notes)), flush=True)
        lib = ctypes.CDLL(str(OUT_DIR / f"lib_{name}.so"))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.wgmma_variant.argtypes = [P, P, P, P, I, I, I, I, F, P]
        lib.wgmma_variant.restype = ctypes.c_int
        fns[name] = lib.wgmma_variant
    return fns


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    names = args.variants.split(",")
    if names[0] != "final" or any(n not in VARIANTS for n in names):
        raise SystemExit(f"--variants: `final` first, then any of {VARIANTS}")
    card = chip_smoke.smi_line()
    print(f"card: {card}", flush=True)
    t0 = time.time()
    fns = build(names)
    print(f"built {len(fns)} variants in {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    recs = []
    for wrapper, (B, Sq, Sk, H, D) in SITES:
        rnd = lambda S: torch.randn(B, S, H * D, generator=gen, device=dev).bfloat16()
        q, k, v = rnd(Sq), rnd(Sk), rnd(Sk)
        outs = {n: torch.empty_like(q) for n in fns}

        def run(n):
            err = fns[n](q.data_ptr(), k.data_ptr(), v.data_ptr(), outs[n].data_ptr(), B, Sq, Sk,
                         H, D ** -0.5, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise SystemExit(f"FAIL: variant {n} launch error {err}")

        for n in fns:
            run(n)
        torch.cuda.synchronize()
        plain = kernels.mh_flash_attention_plain(q[:1], k[:1], v[:1], scale=D ** -0.5, heads=H)
        tol = chip_smoke.bf16_tol(wrapper, plain.float().abs().max().item())
        times = {n: [] for n in fns}
        for _ in range(2):
            for n in fns:
                times[n].append(chip_smoke.cuda_ms(lambda: run(n), args.iters))
        ops = 4.0 * B * Sq * Sk * H * D
        rec = dict(kernel=wrapper, shape=[B, Sq, Sk, H, D], tol=tol, card=card, variants={})
        for n in fns:
            ms = sum(times[n]) / 2
            rec["variants"][n] = dict(
                ms=ms, runs=times[n], tflops=ops / (ms * 1e-3) / 1e12,
                max_abs_err=(outs[n][:1].float() - plain.float()).abs().max().item(),
                equals_final=bool(torch.equal(outs[n], outs["final"])))
        print(json.dumps(rec), flush=True)
        if any(r["max_abs_err"] > tol for r in rec["variants"].values()):
            raise SystemExit(f"FAIL: a variant past the limit at {rec['shape']}")
        recs.append(rec)
        del q, k, v, outs
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in recs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
