"""Time the forms of L2's and L3's Hopper bodies (csrc/motion_wgmma.cuh,
csrc/motion_diag.cu on csrc/frame_tma.cuh) on an NVIDIA GPU, beside the
`mma.sync` bodies they replaced, for the checkout this script lies in.

    python scripts/torch_motion_hopper_variants.py [--sites A,B] [--forms A,B] [--iters N] [--out FILE]

L2 code forms are built from an edited copy of the committed header into
`_build/motion_hopper_variants/` (nvcc, one process each; the header
itself is not changed, and the script stops where the text it edits is
gone), at head dim 40 with a float32 bias: `T2`, `T1`, two or one (pack,
head) row slots under each bias tile instead of four; `T2_S3`, `T1_S3`,
the same on a ring of three stages (four slots and three stages do not fit
a block); `gather`, `T2_gather`, K and V by 16-byte cp.async gathers of
the producer warpgroup's 128 threads (a row's T·D / 8 chunks neighbours in
memory, completion by cp.async.mbarrier.arrive) instead of TMA boxes of
16-byte rows. L2's `final` is the committed body through its C entry
(i360_fused_motion_attention_wgmma), `mma_sync` the replaced body
(i360_fused_motion_attention, bf16, HB heads a block of
`kernels.fused_motion_mma_plan`). L3 plan forms run the committed C entry
(i360_diag_motion_attention_tma) with another plan than
`kernels.diag_tma_plan` gives (`final`): `HG4`, `HG2`, items of half or a
quarter of the plan's heads (two or four items a location; at D = 40,
where the plan takes all eight heads); `SG2`, two locations of half the
heads an item; `S2`, `S3`, a ring of 2 or 3 stages; `bps2`, two blocks an
SM, each with the deepest ring and the most consumer warps that let two
blocks' shared memory fit. A form whose walk `kernels.frame_tma_walk_ok`
refuses, or whose block does not fit, is left out at that site. L3's
`mma_sync` is its replaced body (i360_diag_motion_attention, bf16) and
`k4` K4's Hopper body at the same site (i360_frame_attention_tma).

Sites: every pack of L2 (G = 8, 16, 32; the block-diagonal float32 bias)
and of L3 (G = 16, 32, 8, 4) that divides a motion site of chip_smoke's
phase 8 (LAB_SITES), `final` beside `mma_sync` (and `k4`) at each, so that
the rule's choice can be read at every site; the forms at the lab site
(FORM_SITES). On seeded bf16 inputs every L3 form's output equals the committed
body's and K4's bit for bit (they differ in the walk alone); every L2 form
and the committed body are held to the plain version (chip_smoke's phase-2
limit, on the first 128 locations). Times are device time
(chip_smoke.queued_ms: the calls queued behind a spin kernel), each form
twice in turns, forward then reverse order. One JSON line a site, then the
card's line. Needs nvcc and a card; imports no JAX.
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
from imagine360_tpu_torch.ops import kernels, motion_lab  # noqa: E402

HEADER = kernels.CSRC / "motion_wgmma.cuh"
OUT_DIR = kernels.BUILD_DIR / "motion_hopper_variants"
L2_CODE_FORMS = ("T2", "T1", "T2_S3", "T1_S3", "gather", "T2_gather")
L3_PLAN_FORMS = ("HG4", "HG2", "SG2", "S2", "S3", "bps2")
FORMS = ("final", "mma_sync", "k4") + L2_CODE_FORMS + L3_PLAN_FORMS
PLAIN_LOCATIONS = 128
# (kind, site, shape, G): every L2 pack of the lab but exp_bf16 and every L3
# pack at every lab site (chip_smoke.LAB_SITES, motion_lab's packs); the
# forms run where (kind, site, G) is in FORM_SITES, elsewhere the committed
# body beside the replaced one (and L3 beside K4's body)
SITES = [(kind, site, shape, G) for site, shape in chip_smoke.LAB_SITES
         for kind, packs in (("L2", sorted({g for g, e in motion_lab.FUSED_PACKS if not e})),
                             ("L3", motion_lab.DIAG_PACKS))
         for G in packs if shape[2] % G == 0]
FORM_SITES = {("L2", "motion_pers_s0", 32), ("L3", "motion_pers_s0", 16),
              ("L3", "motion_pers_s0", 4)}

# the committed text each L2 code form changes
SLOTS_LINE = ("__host__ __device__ constexpr int mw_slots(int D) "
              "{ return D <= 40 ? 4 : D <= 80 ? 2 : 1; }")
STAGES_LINE = "constexpr int kMwStages = 2;        // stages of the ring"
# `gather`: the full barriers also wait for the 128 producer threads' cp.async
# arrivals, the TMA loop loads no K or V, the gathers follow it, and each
# consumer orders their generic-proxy writes before its wgmma reads
GATHER_EDITS = [
    ("      mbar_init(full(s), 1);", "      mbar_init(full(s), 1 + 128);"),
    ("      for (int t = 0; t < ntiles; ++t) {", "      for (int t = 0; t < 0; ++t) {"),
    ("  } else {\n    asm volatile(\"setmaxnreg.inc.sync.aligned.u32 %0;\\n\"",
     """    {
      // the bias tile by TMA (thread 0), K and V by every producer thread:
      // 16-byte piece jc of row (g, f) of a key tile is chunk jc % DV of
      // slot jc / DV, read at frame f, location l + g, column
      // head·D + 8·(jc % DV), the T·DV pieces of a row neighbours in memory
      const int pt = threadIdx.x, lf = 31 - __clz(F);   // F is a power of two
      const long C = (long)H * D, fstride = (long)HW * C;
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kMwStages;
        if (t >= kMwStages) mbar_wait(empty(s), ((t / kMwStages) - 1) & 1);
        if (pt == 0) {
          mbar_expect_tx(full(s), P::kBias);
          for (int bx2 = 0; bx2 < FbBias<TB>::kBoxes; ++bx2)
            tma_load_2d(stage(s) + bx2 * FbBias<TB>::kBoxBytes, mb, full(s),
                        t * kMwBK + bx2 * FbBias<TB>::kBoxCols, q0);
        }
        const long base = ((long)b * F * HW + loc0 + t * kMwBK / F) * C;
        for (int u = pt; u < kMwBK * T * P::DV; u += 128) {
          const int row = u / (T * P::DV), jc = u - row * (T * P::DV);
          const int j = jc / P::DV, c = jc - j * P::DV;
          const long off = base + (row & (F - 1)) * fstride + (row >> lf) * C +
                           (long)head_of(j) * D + 8 * c;
          const uint32_t dst = kt_of(s, j) + (c * kMwBK + row) * 16;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(dst), "l"(::mw_k + off)
                       : "memory");
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(dst + P::kKSlot),
                       "l"(::mw_v + off) : "memory");
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\\n" ::"r"(full(s))
                     : "memory");
      }
    }
  } else {\n    asm volatile(\"setmaxnreg.inc.sync.aligned.u32 %0;\\n\""""),
    ("      mbar_wait(full(s), (t / kMwStages) & 1);",
     "      mbar_wait(full(s), (t / kMwStages) & 1);\n"
     "      asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");"),
]
VARIANT_SOURCE = """#include <cuda_bf16.h>
__device__ const __nv_bfloat16* mw_k;   // `gather`'s K and V
__device__ const __nv_bfloat16* mw_v;
#include "{header}"

__global__ void __launch_bounds__(i360::kWgThreads, 1)
mw_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
          const __grid_constant__ CUtensorMap mb, int F, int HW, int H, int G, float scale) {{
  extern __shared__ __align__(1024) unsigned char smem[];
  i360::fused_wgmma_body<40, float>(&mq, &mk, &mv, &mo, &mb, F, HW, H, G, scale, smem);
}}

extern "C" int mw_variant(const void* q, const void* k, const void* v, const void* bias,
                          void* out, int B, int F, int HW, int H, int D, int G, float scale,
                          int bias_dtype, void* stream) {{
  if (D != 40 || bias_dtype != 0) return (int)cudaErrorInvalidValue;
  cudaMemcpyToSymbolAsync(mw_k, &k, sizeof(k), 0, cudaMemcpyHostToDevice, (cudaStream_t)stream);
  cudaMemcpyToSymbolAsync(mw_v, &v, sizeof(v), 0, cudaMemcpyHostToDevice, (cudaStream_t)stream);
  return i360::launch_fused_wgmma<40, float>(mw_kernel, q, k, v, bias, out, B, F, HW, H, G,
                                             scale, (cudaStream_t)stream);
}}
"""


def variant_header(name):
    """The committed header with the code form's text changes."""
    text = HEADER.read_text()
    for line in [SLOTS_LINE, STAGES_LINE] + [old for old, _ in GATHER_EDITS]:
        if text.count(line) != 1:
            raise SystemExit(f"the header no longer has exactly one {line!r}")
    parts = name.split("_")
    for slots in (2, 1):
        if f"T{slots}" in parts:
            text = text.replace(SLOTS_LINE,
                                SLOTS_LINE.replace("D <= 40 ? 4", f"D <= 40 ? {slots}"))
    if "S3" in parts:
        text = text.replace(STAGES_LINE, STAGES_LINE.replace("= 2;", "= 3;"))
    if "gather" in parts:
        for old, new in GATHER_EDITS:
            text = text.replace(old, new)
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
        lib.mw_variant.argtypes = [P, P, P, P, P, I, I, I, I, I, I, F, I, P]
        lib.mw_variant.restype = ctypes.c_int
        fns[name] = lib.mw_variant
    return fns


def l3_plan(name, base, D, heads):
    """The plan of an L3 plan form from the committed plan `base`, or None
    where the form does not apply."""
    plan = dict(base)
    if name in ("HG4", "HG2"):
        plan["HG"] = base["HG"] // (8 // int(name[2]))
        if plan["HG"] < 1 or heads % plan["HG"]:
            return None
    elif name == "SG2":
        plan["SG"], plan["HG"] = 2, max(1, base["HG"] // 2)
    elif name in ("S2", "S3"):
        plan["S"] = int(name[1])
    elif name == "bps2":
        plan["bps"] = 2
        fits = [(S, NW) for S in (4, 3, 2) for NW in (8, 4)
                if kernels.frame_tma_walk_ok(plan["SG"] * plan["HG"], S, NW)
                and 2 * (kernels.frame_tma_smem_bytes(D, plan["SG"] * plan["HG"], S, NW) + 1024)
                <= kernels.SM_SHARED_BYTES]
        if not fits:
            return None
        plan["S"], plan["NW"] = fits[0]
    P = plan["SG"] * plan["HG"]
    if name != "bps2":
        plan["NW"] = max(n for n in range(1, kernels.FRAME_TMA_WARPS + 1)
                         if kernels.frame_tma_walk_ok(P, plan["S"], n))
    if kernels.frame_tma_smem_bytes(D, P, plan["S"], plan["NW"]) > kernels.SMEM_LIMIT:
        return None
    return plan


def run_site(kind, site, shape, G, forms, fns, gen, dev, iters, sms):
    B, F, HW, C, heads = shape
    D = C // heads
    scale = D ** -0.5
    lib, stream = kernels.load_library(), torch.cuda.current_stream().cuda_stream
    q, k, v = (torch.randn(B, F, HW, C, generator=gen, device=dev).bfloat16() for _ in range(3))
    ptr = lambda t: t.data_ptr()
    calls, plans = {}, {}
    bias = torch.from_numpy(motion_lab.block_diag_bias(G, F, F)[0]).to(dev)
    if (kind, site, G) not in FORM_SITES:
        forms = [f for f in forms if f in ("final", "mma_sync", "k4")]
    for name in forms:
        out = torch.empty_like(q)
        if kind == "L2":
            if name == "final":
                fn, args = lib.i360_fused_motion_attention_wgmma, (
                    ptr(q), ptr(k), ptr(v), ptr(bias), ptr(out), B, F, HW, heads, D, G, scale, 0,
                    stream)
            elif name == "mma_sync":
                hb = kernels.fused_motion_mma_plan(D, heads)[0]
                fn, args = lib.i360_fused_motion_attention, (
                    ptr(q), ptr(k), ptr(v), ptr(bias), ptr(out), B, F, HW, heads, D, G, 0, hb,
                    scale, 0, 1, 0, stream)
            elif name in fns and D == 40:
                fn, args = fns[name], (ptr(q), ptr(k), ptr(v), ptr(bias), ptr(out), B, F, HW,
                                       heads, D, G, scale, 0, stream)
            else:
                continue
        else:
            base = kernels.diag_tma_plan(B, F, HW, heads, D, G, sms)
            if name == "mma_sync":
                try:
                    hg = kernels.diag_motion_mma_plan(G, F, D, heads)[0]
                except ValueError:
                    continue         # a pack the one-stage tile cannot hold
                fn, args = lib.i360_diag_motion_attention, (
                    ptr(q), ptr(k), ptr(v), ptr(out), B, F, HW, heads, D, G, hg, 0, 0, scale, 1,
                    stream)
            elif name == "k4":
                p = kernels.frame_tma_plan(B, F, HW, heads, D, sms)
                fn, args = lib.i360_frame_attention_tma, (
                    ptr(q), ptr(k), ptr(v), ptr(out), B, F, HW, heads, D, scale,
                    *(p[x] for x in ("G", "HG", "S", "NW", "bps")), stream)
            elif name == "final" or name in L3_PLAN_FORMS:
                plan = base if name == "final" else l3_plan(name, base, D, heads)
                if plan is None:
                    continue
                plans[name] = {x: plan[x] for x in ("SG", "HG", "S", "NW", "bps")}
                fn, args = lib.i360_diag_motion_attention_tma, (
                    ptr(q), ptr(k), ptr(v), ptr(out), B, F, HW, heads, D, G,
                    *plans[name].values(), scale, stream)
            else:
                continue

        def call(fn=fn, args=args, name=name, out=out):
            err = fn(*args)
            if err != 0:
                raise SystemExit(f"{name} at {kind} {site}: launch error {err}")
            return out
        calls[name] = call
    outs = {name: call() for name, call in calls.items()}
    torch.cuda.synchronize()
    n = min(HW, PLAIN_LOCATIONS)
    cut = lambda x: x[:, :, :n]
    if kind == "L2":
        want = kernels.fused_motion_attention_plain(cut(q), cut(k), cut(v), bias, scale=scale,
                                                    heads=heads, G=G)
    else:
        want = kernels.frame_attention_plain(cut(q), cut(k), cut(v), scale=scale, heads=heads)
    limit = chip_smoke.bf16_limit(want.float().abs().max().item())
    errs = {name: (cut(o).float() - want.float()).abs().max().item() for name, o in outs.items()}
    ref = outs["final"]
    equal = {name: bool(torch.equal(o, ref)) for name, o in outs.items()}
    del outs, want
    times = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            times[name].append(chip_smoke.queued_ms(calls[name], iters))
    name = "fused_motion_attention" if kind == "L2" else "diag_motion_attention"
    bound_ms, bound_by = chip_smoke.site_bound(name, shape, site="lab_fused_G32"
                                               if kind == "L2" else "")
    row = dict(kernel=kind, site=site, shape=list(shape), G=G, max_abs_err=errs, limit=limit,
               equal=equal, bound_ms=bound_ms, bound_by=bound_by, plans=plans,
               ms={name: sum(t) / len(t) for name, t in times.items()}, times=times)
    del q, k, v, calls
    torch.cuda.empty_cache()
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", default=None,
                    help="comma-separated KIND:site:G (default: all of SITES)")
    ap.add_argument("--forms", default=",".join(FORMS))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_motion_hopper_variants: no CUDA device", file=sys.stderr)
        return 1
    forms = args.forms.split(",")
    if "final" not in forms:
        forms.insert(0, "final")
    unknown = set(forms) - set(FORMS)
    if unknown:
        raise SystemExit(f"unknown forms {sorted(unknown)}; known {FORMS}")
    dev = torch.device("cuda", 0)
    kernels.load_library()
    fns = build([f for f in forms if f in L2_CODE_FORMS])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = None if args.sites is None else set(args.sites.split(","))
    gen = torch.Generator(device=dev).manual_seed(6)
    out = open(args.out, "w") if args.out else None
    bad = []
    for kind, site, shape, G in SITES:
        if want is not None and f"{kind}:{site}:{G}" not in want:
            continue
        row = run_site(kind, site, shape, G, forms, fns, gen, dev, args.iters, sms)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
        ok = all(e <= row["limit"] for e in row["max_abs_err"].values())
        if kind == "L3":
            ok = ok and all(eq for name, eq in row["equal"].items() if name != "mma_sync")
        if not ok:
            bad.append(f"{kind}:{site}:{G}")
    print(chip_smoke.smi_line(), flush=True)
    if bad:
        print(f"FAIL: a form disagrees at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
