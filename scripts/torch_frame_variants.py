"""Time the forms of K4's Hopper body (csrc/frame_tma.cuh) on an NVIDIA GPU,
beside the `mma.sync` tile it replaced, for the checkout this script lies
in.

    python scripts/torch_frame_variants.py [--sites A,B] [--forms A,B] [--iters N] [--out FILE]

Plan forms run the committed library's C entry, i360_frame_attention_tma,
with another plan than `kernels.frame_tma_plan` gives (`final`): `S2`,
`S3`, `S6`, a ring of 2, 3 or 6 stages; `NW4`, one consumer warpgroup (4
warps) instead of two; `G2`, `G4`, items of 2 or 4 locations with as
many times fewer heads (about the plan's bytes an item; the plan takes one
location), on the deepest ring up to the plan's that fits; `bps2`, two blocks an SM, each with the deepest ring and the
most consumer warps that let two blocks' shared memory fit. A form whose
walk `kernels.frame_tma_walk_ok` refuses, or whose block does not fit, is
left out at that site. Code forms are built from an edited copy of the
committed header into `_build/frame_variants/` (nvcc, one process each;
the header itself is not changed, and the script stops where the text it
edits is gone): `st_global`, the output written from the registers by
4-byte `st.global` stores instead of the staging tiles and TMA stores.
`mma_sync` is the replaced body, through the C entry i360_frame_attention
(bf16, the packs of `kernels.frame_attention_plan`).

At every K4 site of chip_smoke.py (SITES: the eight motion stages of a
denoise step, the SR stage's two) and at the per-shard shapes of a 2- and
4-rank mesh (chip_smoke.SHARD_SITES), on seeded bf16 inputs: every form's
output equals the committed body's bit for bit (they differ in the walk
alone) and the `mma.sync` body's too (the same products in the same
order); the committed body is held to the plain version (chip_smoke's
phase-2 limit, on the first 4096 locations where the float32 logits of
all would be large). Times are device time (chip_smoke.queued_ms: the
calls queued behind a spin kernel), each form twice in turns, forward
then reverse order. One JSON line a site, then the card's line. Needs
nvcc and a card; imports no JAX.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from imagine360_tpu_torch.ops import kernels  # noqa: E402

HEADER = kernels.CSRC / "frame_tma.cuh"
OUT_DIR = kernels.BUILD_DIR / "frame_variants"
PLAN_FORMS = ("final", "S2", "S3", "S6", "NW4", "G2", "G4", "bps2")
CODE_FORMS = ("st_global",)
FORMS = PLAN_FORMS + CODE_FORMS + ("mma_sync",)
PLAIN_LOCATIONS = 4096

# the committed epilogue, from its first line to the end of the block's
# loop, and what `st_global` puts there
EPILOGUE_START = "    // epilogue: O into staging buffer `stores` & 1,"
EPILOGUE_END = "  if (lane == 0) bulk_wait_all();"
ST_GLOBAL_EPILOGUE = """    // st_global: O from the registers, 4 bytes a lane and row
    bf16* orow = ft_out + ((long)b * kFtF * HW + loc) * ft_C + (long)(hg * HG + j) * D + tg * 2;
#pragma unroll
    for (int n = 0; n < NG; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<__nv_bfloat162*>(orow + (long)(g8 + 8 * r) * HW * ft_C + n * 8) =
            __floats2bfloat162_rn(o[n][2 * r], o[n][2 * r + 1]);
    }
  }
"""
VARIANT_SOURCE = """#include <cuda_bf16.h>
__device__ __nv_bfloat16* ft_out;   // st_global's output and its row length
__device__ int ft_C;
#include "{header}"

template <int NG>
__global__ void __launch_bounds__(i360::kFtThreads, 1)
ft_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo, int B,
          int HW, int H, int G, int HG, int S, int NW, float sl2) {{
  extern __shared__ __align__(128) unsigned char smem[];
  i360::frame_tma_body<NG>(&mq, &mk, &mv, &mo, B, HW, H, G, HG, S, NW, sl2, smem);
}}

extern "C" int ft_variant(const void* q, const void* k, const void* v, void* out, int B, int F,
                          int HW, int H, int D, float scale, int G, int HG, int S, int NW,
                          int bps, void* stream) {{
  auto s = (cudaStream_t)stream;
  const int C = H * D;
  if (F != i360::kFtF) return (int)cudaErrorInvalidValue;
  cudaMemcpyToSymbolAsync(ft_out, &out, sizeof(out), 0, cudaMemcpyHostToDevice, s);
  cudaMemcpyToSymbolAsync(ft_C, &C, sizeof(C), 0, cudaMemcpyHostToDevice, s);
  switch (D) {{
    case 40: return i360::launch_frame_tma<5>(ft_kernel<5>, q, k, v, out, B, HW, H, G, HG, S,
                                               NW, bps, scale, s);
    case 80: return i360::launch_frame_tma<10>(ft_kernel<10>, q, k, v, out, B, HW, H, G, HG, S,
                                                NW, bps, scale, s);
    case 160: return i360::launch_frame_tma<20>(ft_kernel<20>, q, k, v, out, B, HW, H, G, HG,
                                                 S, NW, bps, scale, s);
  }}
  return (int)cudaErrorInvalidValue;
}}
"""


def variant_header(name):
    """The committed header with the code form's text changes."""
    text = HEADER.read_text()
    if name == "st_global":
        for marker in (EPILOGUE_START, EPILOGUE_END):
            if text.count(marker) != 1:
                raise SystemExit(f"the header no longer has exactly one {marker!r}")
        start, end = text.index(EPILOGUE_START), text.index(EPILOGUE_END)
        text = text[:start] + ST_GLOBAL_EPILOGUE + text[end:]
    return text


def build(names):
    """{code form: ctypes function}, each compiled alone and in parallel. A
    form that fails to compile is reported and left out."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, procs = kernels.find_nvcc(), {}
    for name in names:
        (OUT_DIR / f"{name}.cuh").write_text(variant_header(name))
        (OUT_DIR / f"{name}.cu").write_text(VARIANT_SOURCE.format(header=f"{name}.cuh"))
        log = open(OUT_DIR / f"{name}.log", "w")
        procs[name] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-I", str(OUT_DIR), "-I", str(kernels.CSRC),
             "-o", str(OUT_DIR / f"lib_{name}.so"), str(OUT_DIR / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        code = proc.wait()
        report = (OUT_DIR / f"{name}.log").read_text()
        if code != 0:
            print(json.dumps(dict(form=name, nvcc_failed=report[-4000:])), flush=True)
            continue
        notes = [line.replace("ptxas info    :", "").strip() for line in report.splitlines()
                 if "Used" in line or "spill" in line or "warning" in line]
        print(json.dumps(dict(form=name, ptxas=notes)), flush=True)
        lib = ctypes.CDLL(str(OUT_DIR / f"lib_{name}.so"))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ft_variant.argtypes = [P, P, P, P, I, I, I, I, I, F, I, I, I, I, I, P]
        lib.ft_variant.restype = ctypes.c_int
        fns[name] = lib.ft_variant
    return fns


def form_plan(name, base, D, heads):
    """The plan of a plan form from the committed plan `base`, or None where
    the form does not apply (a walk the rule refuses, a block that does not
    fit)."""
    plan = dict(base)
    if name in ("S2", "S3", "S6"):
        plan["S"] = int(name[1])
    elif name == "NW4":
        plan["NW"] = 4
    elif name in ("G2", "G4"):
        # 2 or 4 locations an item with as many times fewer heads (the
        # largest divisor of the heads at most the plan's HG / G, so about
        # the plan's bytes an item), on the deepest ring up to the plan's
        # that the walk rule and the block's shared memory allow
        plan["G"] = int(name[1])
        plan["HG"] = max(h for h in range(1, heads + 1)
                         if heads % h == 0 and h <= max(1, base["HG"] // plan["G"]))
        P = plan["G"] * plan["HG"]
        fits = [S for S in range(base["S"], 1, -1)
                if kernels.frame_tma_walk_ok(P, S, base["NW"])
                and kernels.frame_tma_smem_bytes(D, P, S, base["NW"]) <= kernels.SMEM_LIMIT]
        if not fits:
            return None
        plan["S"] = fits[0]
    elif name == "bps2":
        plan["bps"] = 2
        fits = [(S, NW) for S in (4, 3, 2) for NW in (8, 4)
                if kernels.frame_tma_walk_ok(base["G"] * base["HG"], S, NW)
                and 2 * (kernels.frame_tma_smem_bytes(D, base["G"] * base["HG"], S, NW) + 1024)
                <= kernels.SM_SHARED_BYTES]
        if not fits:
            return None
        plan["S"], plan["NW"] = fits[0]
    P = plan["G"] * plan["HG"]
    if (not kernels.frame_tma_walk_ok(P, plan["S"], plan["NW"])
            or kernels.frame_tma_smem_bytes(D, P, plan["S"], plan["NW"]) > kernels.SMEM_LIMIT):
        return None
    return plan


def sites():
    """[(site, (B, F, HW, C, heads))]: chip_smoke's K4 sites and the
    per-shard shapes of its SHARD_SITES at 2 and 4 ranks."""
    out = [(site, shape) for name, site, shape in chip_smoke.SITES if name == "frame_attention"]
    full = dict(out)
    for name, site, what, worlds in chip_smoke.SHARD_SITES:
        if name == "frame_attention":
            out += [(f"{site}_w{w}", chip_smoke.shard_shape(full[site], what, w)) for w in worlds]
    return out


def run_site(site, shape, forms, fns, gen, dev, iters, sms):
    B, F, HW, C, heads = shape
    D = C // heads
    scale = D ** -0.5
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    q, k, v = (torch.randn(B, F, HW, C, generator=gen, device=dev).bfloat16() for _ in range(3))
    base = kernels.frame_tma_plan(B, F, HW, heads, D, sms)
    mma_plan = kernels.frame_attention_plan(B, F, HW, heads, D, sms)
    calls, plans = {}, {}
    for name in forms:
        out = torch.empty_like(q)
        if name == "mma_sync":
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, F, HW, heads, D,
                    scale, 1, *mma_plan, stream)
            fn = lib.i360_frame_attention
        else:
            plan = base if name in CODE_FORMS else form_plan(name, base, D, heads)
            if plan is None or (name in CODE_FORMS and name not in fns):
                continue
            plans[name] = {key: plan[key] for key in ("G", "HG", "S", "NW", "bps")}
            fn = fns.get(name, lib.i360_frame_attention_tma)
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, F, HW, heads, D,
                    scale, *plans[name].values(), stream)

        def call(fn=fn, args=args, name=name, out=out):
            err = fn(*args)
            if err != 0:
                raise SystemExit(f"{name} at {site}: launch error {err}")
            return out
        calls[name] = call
    outs = {name: call() for name, call in calls.items()}
    torch.cuda.synchronize()
    ref = outs["final"]
    n = min(HW, PLAIN_LOCATIONS)
    want = kernels.frame_attention_plain(q[:, :, :n], k[:, :, :n], v[:, :, :n], scale=scale,
                                         heads=heads)
    err = (ref[:, :, :n].float() - want.float()).abs().max().item()
    limit = chip_smoke.bf16_limit(want.float().abs().max().item())
    equal = {name: bool(torch.equal(o, ref)) for name, o in outs.items()}
    del outs, want
    times = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            times[name].append(chip_smoke.queued_ms(calls[name], iters))
    bound_ms, bound_by = chip_smoke.site_bound("frame_attention", shape)
    row = dict(site=site, shape=list(shape), max_abs_err=err, limit=limit, equal=equal,
               bound_ms=bound_ms, bound_by=bound_by, plans=plans,
               ms={name: sum(t) / len(t) for name, t in times.items()}, times=times)
    del q, k, v, calls
    torch.cuda.empty_cache()
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", default=None, help="comma-separated site names (default: all)")
    ap.add_argument("--forms", default=",".join(FORMS))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_frame_variants: no CUDA device", file=sys.stderr)
        return 1
    forms = args.forms.split(",")
    if "final" not in forms:
        forms.insert(0, "final")
    unknown = set(forms) - set(FORMS)
    if unknown:
        raise SystemExit(f"unknown forms {sorted(unknown)}; known {FORMS}")
    dev = torch.device("cuda", 0)
    kernels.load_library()
    fns = build([f for f in forms if f in CODE_FORMS])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = None if args.sites is None else set(args.sites.split(","))
    gen = torch.Generator(device=dev).manual_seed(5)
    out = open(args.out, "w") if args.out else None
    bad = []
    for site, shape in sites():
        if want is not None and site not in want:
            continue
        row = run_site(site, shape, forms, fns, gen, dev, args.iters, sms)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
        if row["max_abs_err"] > row["limit"] or not all(row["equal"].values()):
            bad.append(site)
    print(chip_smoke.smi_line(), flush=True)
    if bad:
        print(f"FAIL: a form disagrees at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
